// Forward-backward (the Baum-Welch E-step) over chain+loop graphs for Hopper
// (sm_90a): kernel K3f, the forward pass, and kernel K3b, the backward pass.
//
// Replaces mogasr/decoder/fb_pallas.py::_fwd_kernel and ::_bwd_kernel
// (forward_backward_pallas), the log-semiring twins of the Viterbi kernel.
// They compute what mogasr_torch/decoder/forward_backward.py computes, to a
// float tolerance (the logsumexp over states sums in another order):
// alpha per frame, the data log-likelihood lse(alpha_last + final_logp), and
// the state log-posteriors log_gamma = alpha + beta - loglik, NEG_INF on
// frames at or past n_frames.
//
// What bounds them: latency, not arithmetic or bytes. Bytes are the gathered
// emissions in (once per pass), the alphas out of K3f and back into K3b, and
// log_gamma out of K3b: ~35 MB for a 32 x 700-frame training batch of
// ~200-state align graphs, ~10 us at 3.35 TB/s. But frame t needs frame t-1
// (t+1 in K3b) of the whole graph, and each frame does one block-wide
// logsumexp (the loop state's exit in K3f, its entry in K3b): a serial chain
// of T frames with two block barriers each. So, as in viterbi.cu, one block
// owns one utterance and loops over its frames; the graph log-probs of
// ceil(J/blockDim) states per thread live in registers; the row the
// neighbours read (alpha in K3f, emit + beta in K3b) is double-buffered in
// shared memory, so the j-1 (j+1) neighbour reads the previous frame's row;
// emissions are gathered in the kernel from ll[b, t, emit_id[b, j]] * scale
// (the reference materialises [B, T, J] first), one frame ahead of their use.
// Frames past n_frames[b] are skipped. K3b writes log_gamma directly and
// never stores beta, which saves a [B, T, J] write and read.
//
// CTC skip transitions (mogasr/decoder/forward_backward.py; fb_pallas has no
// such arm) are a template arm of both kernels: one more term per state,
// lse'd last as in the plain version -- alpha[j-2] + skip_logp[j] in K3f,
// skip_logp[j+2] + emit(t+1, j+2) + beta_{t+1}[j+2] in K3b (NEG_INF past the
// ends) -- with skip_logp read through the read-only cache each frame, so
// graphs without skips run the code without it.
//
// Arithmetic: logaddexp is max + log1p(exp(-|a - b|)), jnp.logaddexp's and
// torch.logaddexp's form; the logsumexp is max-shifted, as fb_pallas's
// _lse_lanes. NEG_INF is -1e30, finite, so sums reach -2e30 and never NaN;
// accurate expf/log1pf/logf (no fast math) keep exp(x - m) exactly 1 and 0
// where the reference has them. The file is built with -fmad=false so each
// product and sum round alone, as in the plain version.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_SPT = 8;  // states per thread

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// Block-wide logsumexp of every thread's x[0..SPT) (lanes past J hold
// -INFINITY), max-shifted. red_max and red_sum hold one slot per warp; every
// thread reads all of them, so the result needs no broadcast. Two barriers.
template <int SPT>
__device__ __forceinline__ float block_logsumexp(const float (&x)[SPT], float* red_max,
                                                 float* red_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  float m = x[0];
#pragma unroll
  for (int k = 1; k < SPT; ++k) m = fmaxf(m, x[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red_max[warp] = m;
  __syncthreads();
  m = red_max[0];
  for (int w = 1; w < n_warps; ++w) m = fmaxf(m, red_max[w]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < SPT; ++k) s += expf(x[k] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) red_sum[warp] = s;
  __syncthreads();
  s = red_sum[0];
  for (int w = 1; w < n_warps; ++w) s += red_sum[w];
  return m + logf(s);
}

template <int SPT, bool SKIP>
__global__ void __launch_bounds__(1024, 1) fb_forward_kernel(
    const float* __restrict__ ll,  // [B, T, P]
    int T, int P, float scale,
    const int* __restrict__ emit_id,        // [B, J]
    const float* __restrict__ self_logp,    // [B, J]
    const float* __restrict__ adv_logp,     // [B, J]
    const float* __restrict__ enter_logp,   // [B, J]
    const float* __restrict__ exit_logp,    // [B, J]
    const float* __restrict__ init_logp,    // [B, J]
    const float* __restrict__ final_logp,   // [B, J]
    const float* __restrict__ skip_logp,    // [B, J]; read only when SKIP
    const int* __restrict__ n_frames,       // [B]
    int J,
    float* __restrict__ alphas,   // [B, T, J]: rows 0 .. max(n_frames, 1) - 1
    float* __restrict__ loglik) { // [B]
  extern __shared__ float alpha_buf[];  // [2, J]
  __shared__ float red_max[32], red_sum[32];
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const size_t g = (size_t)b * J;
  const float* llb = ll + (size_t)b * T * P;
  float* ab = alphas + (size_t)b * T * J;
  const int nf = min(n_frames[b], T);

  int eid[SPT];
  float sl[SPT], al[SPT], el[SPT], xl[SPT];
  float* cur = alpha_buf;
  float* nxt = alpha_buf + J;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int j = tid + k * nth;
    if (j < J) {
      eid[k] = emit_id[g + j];
      if (eid[k] < 0 || eid[k] >= P) __trap();  // no read outside ll's row
      sl[k] = self_logp[g + j];
      al[k] = adv_logp[g + j];
      el[k] = enter_logp[g + j];
      xl[k] = exit_logp[g + j];
      const float a0 = init_logp[g + j] + llb[eid[k]] * scale;
      cur[j] = a0;
      ab[j] = a0;  // frame 0 is always written, as in the reference
    } else {
      eid[k] = 0;
      sl[k] = al[k] = el[k] = xl[k] = NEG_INF;
    }
  }
  __syncthreads();

  for (int t = 1; t < nf; ++t) {
    const float* llt = llb + (size_t)t * P;
    float em[SPT], x[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      em[k] = j < J ? __ldg(llt + eid[k]) * scale : 0.f;
      x[k] = j < J ? cur[j] + xl[k] : -INFINITY;
    }
    const float exit_lse = block_logsumexp<SPT>(x, red_max, red_sum);
    float* abt = ab + (size_t)t * J;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      if (j >= J) continue;
      const float stay = cur[j] + sl[k];
      const float adv = j > 0 ? cur[j - 1] + al[k] : NEG_INF;
      const float ent = exit_lse + el[k];
      float a = logaddexp(logaddexp(stay, adv), ent);
      if (SKIP) a = logaddexp(a, j > 1 ? cur[j - 2] + __ldg(skip_logp + g + j) : NEG_INF);
      a += em[k];
      nxt[j] = a;
      abt[j] = a;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  float x[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int j = tid + k * nth;
    x[k] = j < J ? cur[j] + final_logp[g + j] : -INFINITY;
  }
  const float lse = block_logsumexp<SPT>(x, red_max, red_sum);
  if (tid == 0) loglik[b] = lse;
}

template <int SPT, bool SKIP>
__global__ void __launch_bounds__(1024, 1) fb_backward_kernel(
    const float* __restrict__ ll,  // [B, T, P]
    int T, int P, float scale,
    const int* __restrict__ emit_id,        // [B, J]
    const float* __restrict__ self_logp,    // [B, J]
    const float* __restrict__ adv_logp,     // [B, J]
    const float* __restrict__ enter_logp,   // [B, J]
    const float* __restrict__ exit_logp,    // [B, J]
    const float* __restrict__ final_logp,   // [B, J]
    const float* __restrict__ skip_logp,    // [B, J]; read only when SKIP
    const int* __restrict__ n_frames,       // [B]
    int J,
    const float* __restrict__ alphas,   // [B, T, J] from fb_forward_kernel
    const float* __restrict__ loglik,   // [B]
    float* __restrict__ log_gamma) {    // [B, T, J]
  extern __shared__ float eb_buf[];  // [2, J]: emit(t+1) + beta_{t+1}
  __shared__ float red_max[32], red_sum[32];
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const size_t g = (size_t)b * J;
  const float* llb = ll + (size_t)b * T * P;
  const float* ab = alphas + (size_t)b * T * J;
  float* lg = log_gamma + (size_t)b * T * J;
  const int nf = max(min(n_frames[b], T), 0);

  for (size_t i = (size_t)nf * J + tid; i < (size_t)T * J; i += nth) lg[i] = NEG_INF;
  if (nf == 0) return;  // the same for every thread of the block
  const float llk = loglik[b];

  int eid[SPT];
  float sl[SPT], an[SPT], el[SPT], xl[SPT], beta[SPT], em[SPT];
  const float* llt = llb + (size_t)(nf - 1) * P;
  const float* abt = ab + (size_t)(nf - 1) * J;
  float* lgt = lg + (size_t)(nf - 1) * J;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int j = tid + k * nth;
    if (j < J) {
      eid[k] = emit_id[g + j];
      if (eid[k] < 0 || eid[k] >= P) __trap();
      sl[k] = self_logp[g + j];
      an[k] = j + 1 < J ? adv_logp[g + j + 1] : NEG_INF;  // the (j -> j+1) advance
      el[k] = enter_logp[g + j];
      xl[k] = exit_logp[g + j];
      beta[k] = final_logp[g + j];
      em[k] = llt[eid[k]] * scale;  // emissions of frame nf-1, used at t = nf-2
      lgt[j] = (abt[j] + beta[k]) - llk;
    } else {
      eid[k] = 0;
      sl[k] = an[k] = el[k] = xl[k] = beta[k] = em[k] = NEG_INF;
    }
  }

  int buf = 0;
  for (int t = nf - 2; t >= 0; --t) {
    float* ebs = eb_buf + buf * J;
    abt = ab + (size_t)t * J;
    lgt = lg + (size_t)t * J;
    float eb[SPT], x[SPT], a_t[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      eb[k] = em[k] + beta[k];
      x[k] = j < J ? el[k] + eb[k] : -INFINITY;
      if (j < J) {
        ebs[j] = eb[k];
        a_t[k] = abt[j];
        // emissions of frame t, used by the next step (t-1)
        if (t > 0) em[k] = __ldg(llb + (size_t)t * P + eid[k]) * scale;
      }
    }
    const float enter_lse = block_logsumexp<SPT>(x, red_max, red_sum);  // also publishes ebs
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      if (j >= J) continue;
      const float stay = sl[k] + eb[k];
      const float adv = j + 1 < J ? an[k] + ebs[j + 1] : NEG_INF;
      const float ext = xl[k] + enter_lse;
      beta[k] = logaddexp(logaddexp(stay, adv), ext);
      if (SKIP)
        beta[k] = logaddexp(beta[k],
                            j + 2 < J ? __ldg(skip_logp + g + j + 2) + ebs[j + 2] : NEG_INF);
      lgt[j] = (a_t[k] + beta[k]) - llk;
    }
    buf ^= 1;
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Launch {
  int threads, spt;
  size_t smem;
};

// 512 threads keep two blocks on an SM (registers permitting); wider graphs
// take 1024. Small graphs take one thread per state, rounded up to a warp.
Launch launch_shape(int J) {
  int threads = J <= MAX_SPT * 512 ? 512 : 1024;
  const int j32 = (J + 31) / 32 * 32;
  if (j32 < threads) threads = j32;
  return Launch{threads, (J + threads - 1) / threads, 2 * (size_t)J * sizeof(float)};
}

}  // namespace

extern "C" {

// K3f for B utterances. ll [B, T, P] float32; the graph arrays [B, J]
// (emit_id int32, the rest float32), skip_logp [B, J] float32 for a graph
// with CTC skip transitions or NULL; n_frames [B] int32. Writes alphas
// [B, T, J] on frames 0 .. max(n_frames[b], 1) - 1 (the rest is left as it
// was: fb_backward reads no other row) and loglik [B]. J may be at most
// MAX_SPT * 1024 (cudaErrorInvalidValue otherwise); an emit_id outside
// [0, P) stops the kernel with a trap.
int fb_forward(const void* ll, int B, int T, int P, float scale, const void* emit_id,
               const void* self_logp, const void* adv_logp, const void* enter_logp,
               const void* exit_logp, const void* init_logp, const void* final_logp,
               const void* skip_logp, const void* n_frames, int J, void* alphas, void* loglik,
               void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (J <= 0 || J > MAX_SPT * 1024) return cudaErrorInvalidValue;
  const Launch L = launch_shape(J);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define MOGASR_FWD(N, SKIP)                                                                  \
  e = set_smem((const void*)fb_forward_kernel<N, SKIP>, L.smem);                             \
  if (e != cudaSuccess) return e;                                                            \
  fb_forward_kernel<N, SKIP><<<B, L.threads, L.smem, st>>>(                                  \
      static_cast<const float*>(ll), T, P, scale, static_cast<const int*>(emit_id),          \
      static_cast<const float*>(self_logp), static_cast<const float*>(adv_logp),             \
      static_cast<const float*>(enter_logp), static_cast<const float*>(exit_logp),           \
      static_cast<const float*>(init_logp), static_cast<const float*>(final_logp),           \
      static_cast<const float*>(skip_logp), static_cast<const int*>(n_frames), J,            \
      static_cast<float*>(alphas), static_cast<float*>(loglik))
#define MOGASR_CASE(N)                 \
  case N:                              \
    if (skip_logp != nullptr) {        \
      MOGASR_FWD(N, true);             \
    } else {                           \
      MOGASR_FWD(N, false);            \
    }                                  \
    break;
  switch (L.spt) {
    MOGASR_CASE(1) MOGASR_CASE(2) MOGASR_CASE(3) MOGASR_CASE(4)
    MOGASR_CASE(5) MOGASR_CASE(6) MOGASR_CASE(7) MOGASR_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef MOGASR_CASE
#undef MOGASR_FWD
  return cudaGetLastError();
}

// K3b for B utterances, after fb_forward on the same stream. Same graph
// arrays (less init_logp; skip_logp as given to fb_forward), the alphas and
// loglik fb_forward wrote. Writes log_gamma [B, T, J]: alpha + beta - loglik
// on frames below n_frames[b], NEG_INF on the rest.
int fb_backward(const void* ll, int B, int T, int P, float scale, const void* emit_id,
                const void* self_logp, const void* adv_logp, const void* enter_logp,
                const void* exit_logp, const void* final_logp, const void* skip_logp,
                const void* n_frames, int J, const void* alphas, const void* loglik,
                void* log_gamma, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (J <= 0 || J > MAX_SPT * 1024) return cudaErrorInvalidValue;
  const Launch L = launch_shape(J);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define MOGASR_BWD(N, SKIP)                                                                  \
  e = set_smem((const void*)fb_backward_kernel<N, SKIP>, L.smem);                            \
  if (e != cudaSuccess) return e;                                                            \
  fb_backward_kernel<N, SKIP><<<B, L.threads, L.smem, st>>>(                                 \
      static_cast<const float*>(ll), T, P, scale, static_cast<const int*>(emit_id),          \
      static_cast<const float*>(self_logp), static_cast<const float*>(adv_logp),             \
      static_cast<const float*>(enter_logp), static_cast<const float*>(exit_logp),           \
      static_cast<const float*>(final_logp), static_cast<const float*>(skip_logp),           \
      static_cast<const int*>(n_frames), J, static_cast<const float*>(alphas),               \
      static_cast<const float*>(loglik), static_cast<float*>(log_gamma))
#define MOGASR_CASE(N)                 \
  case N:                              \
    if (skip_logp != nullptr) {        \
      MOGASR_BWD(N, true);             \
    } else {                           \
      MOGASR_BWD(N, false);            \
    }                                  \
    break;
  switch (L.spt) {
    MOGASR_CASE(1) MOGASR_CASE(2) MOGASR_CASE(3) MOGASR_CASE(4)
    MOGASR_CASE(5) MOGASR_CASE(6) MOGASR_CASE(7) MOGASR_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef MOGASR_CASE
#undef MOGASR_BWD
  return cudaGetLastError();
}

const char* forward_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Forward-backward (the Baum-Welch E-step) over chain+loop graphs for Hopper
// (sm_90a): kernel K3f, the forward pass, kernel K3b, the backward pass, and
// the small combine kernel that turns their alphas and betas into log_gamma.
//
// Replaces mogasr/decoder/fb_pallas.py::_fwd_kernel and ::_bwd_kernel
// (forward_backward_pallas), the log-semiring twins of the Viterbi kernel.
// They compute what mogasr_torch/decoder/forward_backward.py computes, to a
// float tolerance (the logsumexp over states sums in another order):
// alpha per frame, the data log-likelihood lse(alpha_last + final_logp), and
// the state log-posteriors log_gamma = (alpha + beta) - loglik, NEG_INF on
// frames at or past n_frames.
//
// What bounds them: latency, not arithmetic or bytes. Bytes are ~20 MB for
// a 32 x 550-frame training batch of 192-state align graphs (the emissions
// the graphs need, alphas and betas out, log_gamma out of the combine), ~6 us
// at 3.35 TB/s. But frame t needs frame t-1 (t+1 in K3b) of the whole graph:
// a serial chain of T frames per utterance. The earlier design (one block,
// one state a thread, for every row) paced each frame by two serial
// latencies of about a third of the frame each (a split with clock64 stamps
// on the H100, PERF.md): the random read of the frame's emissions from
// ll [B, T, P], and a block-wide logsumexp with two barriers. This design
// takes both off the chain and runs the two chains at once:
//
// - Emissions off the chain. A state's emission is still gathered in the
//   kernel, ll[b, t, emit_id[b, j]] * scale, but ahead of its use: the chain
//   arm keeps the next PD frames of its states in a register ring, the block
//   arm the next frame (at 4 states a thread), so no frame waits on memory.
// - Forward and backward side by side. K3b computes betas without the
//   alphas, as _bwd_kernel does, into a scratch [B, T, J];
//   fb_forward_backward launches K3f and K3b on two streams, and the
//   combine kernel writes log_gamma = (alpha + beta) - loglik (alphas are
//   stored in log_gamma's buffer and overwritten in place) once both have
//   finished. One C call forks and joins the streams with events, so the
//   host's work per call stays small beside the kernels'.
// - A chain arm without the per-frame logsumexp. Each block checks once,
//   on the device, whether its row has a loop arc: any enter_logp or
//   exit_logp above NEG_INF / 2. Align graphs (monophone, CD, the dummy
//   rows' silence graphs) have none: every enter and exit log-prob is
//   NEG_INF = -1e30. Then exit_lse <= max(alpha) - 1e30, the enter term
//   exit_lse + enter_logp is about -2e30, and logaddexp(a, -2e30) =
//   a + log1pf(expf(-|a + 2e30|)) is exactly a for every state whose value
//   is above NEG_INF / 2 (expf gives 0); the same holds for K3b's exit
//   term. A state below NEG_INF / 2 (a padding state) may differ by a
//   rounding of -1e30-sized sums, and it stays below NEG_INF / 2 either way
//   (no live value comes from it: logaddexp(live, dead) is exactly live).
//   So such a row drops the logsumexp and the enter (exit) logaddexp, and
//   with them every barrier but one per frame; everything else keeps the
//   plain version's order of operations, per state logaddexp(stay, adv),
//   then the skip term, then + emission. tests/test_torch_forward_backward.py
//   holds a copy of the plain passes without the loop term bitwise to the
//   plain version on such graphs.
// - The chain arm's frame is elementwise work plus the j-1 (j-2 with skip)
//   neighbour in K3f and j+1 (j+2) in K3b. A row of J <= CHAIN_MAX_J states
//   lives in the registers of nw = ceil(J / CHAIN_WARP_STATES) warps (at
//   most 8), CSPL contiguous states a lane (CSPL even, at most 8); a lane
//   fetches its neighbours with a shuffle, and a warp's edge states cross to
//   the next warp through shared memory behind one named barrier of the nw
//   warps per frame. The frame is bound by the latency of its logaddexp
//   chain (accurate expf and log1pf), so more warps with fewer states each
//   run faster, down to 2 states a lane (measured on the H100, PERF.md):
//   J = 192, the widest training batch, runs on 3 warps. The block's other
//   warps only wait.
// - Every other row takes the block arm, SPT states a thread with a barrier
//   per frame for the neighbours: with a loop arc (the decode word loop,
//   MMI's denominator, random graphs) the general arm, the earlier arithmetic
//   with its logsumexp; without one, on graphs wider than the chain arm
//   takes, the same frame without the logsumexp and the enter (exit) term.
//   The graph arrays live in shared memory, so a thread holds only its
//   states' values and emissions in registers, and each launch shape has
//   its own __launch_bounds__: no instantiation spills (ptxas -v, PERF.md).
//
// CTC skip transitions (mogasr/decoder/forward_backward.py; fb_pallas has no
// such arm) are a template arm of both kernels: one more term per state,
// lse'd last as in the plain version -- alpha[j-2] + skip_logp[j] in K3f,
// skip_logp[j+2] + emit(t+1, j+2) + beta_{t+1}[j+2] in K3b (NEG_INF past the
// ends).
//
// Arithmetic: logaddexp is max + log1p(exp(-|a - b|)), jnp.logaddexp's and
// torch.logaddexp's form; the logsumexp is max-shifted, as fb_pallas's
// _lse_lanes. NEG_INF is -1e30, finite, so sums reach -2e30 and never NaN;
// accurate expf/log1pf/logf (no fast math) keep exp(x - m) exactly 1 and 0
// where the reference has them. The file is built with -fmad=false so each
// product and sum round alone, as in the plain version.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <mutex>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_J = 8192;
// Rows without a loop arc and at most CHAIN_MAX_J states run the chain arm,
// on one warp per CHAIN_WARP_STATES states, at most CHAIN_MAX_WARPS warps and
// 8 states a lane (the choice measured on the H100: PERF.md).
constexpr int CHAIN_MAX_J = 1024;
constexpr int CHAIN_WARP_STATES = 64;
constexpr int CHAIN_MAX_WARPS = 8;
constexpr int PD = 8;  // frames of emissions in flight in the chain arm
constexpr unsigned FULL = 0xffffffffu;
static_assert(CHAIN_MAX_J <= CHAIN_MAX_WARPS * 32 * 8, "the chain arm holds at most 8 states a lane");

enum : int { ARM_CHAIN = 0, ARM_BLOCK = 1, ARM_GENERAL = 2 };

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
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  if (lane == 0) red_max[warp] = m;
  __syncthreads();
  m = red_max[0];
  for (int w = 1; w < n_warps; ++w) m = fmaxf(m, red_max[w]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < SPT; ++k) s += expf(x[k] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) red_sum[warp] = s;
  __syncthreads();
  s = red_sum[0];
  for (int w = 1; w < n_warps; ++w) s += red_sum[w];
  return m + logf(s);
}

// Barrier 1 over the chain arm's nw warps; nothing on one warp.
__device__ __forceinline__ void chain_sync(int nw) {
  if (nw > 1) asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");
}

// The same logsumexp over the chain arm's nw warps (red_* as above).
template <int N>
__device__ __forceinline__ float chain_logsumexp(const float (&x)[N], int nw, float* red_max,
                                                 float* red_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) m = fmaxf(m, x[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  if (nw > 1) {
    if (lane == 0) red_max[warp] = m;
    chain_sync(nw);
    m = red_max[0];
    for (int w = 1; w < nw; ++w) m = fmaxf(m, red_max[w]);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) s += expf(x[k] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (nw > 1) {
    if (lane == 0) red_sum[warp] = s;
    chain_sync(nw);
    s = red_sum[0];
    for (int w = 1; w < nw; ++w) s += red_sum[w];
  }
  return m + logf(s);
}

// Whether row g of the graphs has a loop arc: an enter or exit log-prob
// above NEG_INF / 2. Every thread of the block gets the answer.
__device__ __forceinline__ bool row_has_loop(const float* __restrict__ enter_logp,
                                             const float* __restrict__ exit_logp, size_t g,
                                             int J) {
  int any = 0;
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    any |= (enter_logp[g + j] > NEG_INF / 2) | (exit_logp[g + j] > NEG_INF / 2);
  return __syncthreads_or(any) != 0;
}

// The emission of state j in frame t: ll[b, t, emit_id[b, j]], unscaled.
// The rows of ll are read by the kernels and nothing writes them meanwhile.
__device__ __forceinline__ float emission(const float* __restrict__ llb, int P, int t, int eid) {
  return __ldg(llb + (size_t)t * P + eid);
}

// emit_id[g + j], checked: an id outside [0, P) stops the kernel rather
// than read outside ll's row.
__device__ __forceinline__ int checked_emit_id(const int* __restrict__ emit_id, size_t g, int j,
                                               int P) {
  const int e = emit_id[g + j];
  if (e < 0 || e >= P) __trap();
  return e;
}

// K3f. One block per utterance. MAXT and SPT set the block arm (blockDim.x
// <= MAXT threads, SPT states each); CSPL > 0 compiles the chain arm with
// CSPL states per lane on the first chain_warps warps.
template <int MAXT, int SPT, int CSPL, bool SKIP>
__global__ void __launch_bounds__(MAXT, 1) fb_forward_kernel(
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
    int J, int chain_warps,
    float* __restrict__ alphas,   // [B, T, J]: rows 0 .. max(n_frames, 1) - 1
    float* __restrict__ loglik,   // [B]
    int* __restrict__ arm) {      // [B]
  // block arm [7, J]: alpha x2, self, adv, enter, exit, emit_id; chain arm
  // [2, CHAIN_MAX_WARPS, 2]
  extern __shared__ float smem[];
  __shared__ float red_max[32], red_sum[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t g = (size_t)b * J;
  const float* llb = ll + (size_t)b * T * P;
  float* ab = alphas + (size_t)b * T * J;
  const int nf = min(n_frames[b], T);
  const bool loops = row_has_loop(enter_logp, exit_logp, g, J);
  float lse = 0.f;

  if (CSPL > 0 && !loops) {
    // ---- the chain arm
    constexpr int C = CSPL > 0 ? CSPL : 2;
    const int nw = chain_warps, w = tid >> 5, lane = tid & 31;
    if (w < nw) {
      float* xch = smem;  // [frame parity][warp][2]: a warp's last two alphas
      const int j0 = (w * 32 + lane) * C;
      int eid[C];
      float a[C], sl[C], al[C], sk[C], ring[PD][C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int j = j0 + k;
        const bool v = j < J;
        eid[k] = v ? checked_emit_id(emit_id, g, j, P) : 0;
        sl[k] = v ? self_logp[g + j] : NEG_INF;
        al[k] = v ? adv_logp[g + j] : NEG_INF;
        sk[k] = (SKIP && v) ? skip_logp[g + j] : NEG_INF;
        a[k] = v ? init_logp[g + j] + emission(llb, P, 0, eid[k]) * scale : NEG_INF;
        if (v) ab[j] = a[k];  // frame 0 is always written, as in the reference
      }
#pragma unroll
      for (int u = 0; u < PD; ++u) {
#pragma unroll
        for (int k = 0; k < C; ++k) ring[u][k] = emission(llb, P, min(1 + u, T - 1), eid[k]);
      }
      if (lane == 31) {
        xch[w * 2 + 0] = a[C - 2];
        xch[w * 2 + 1] = a[C - 1];
      }
      chain_sync(nw);
      for (int t0 = 1; t0 < nf; t0 += PD) {
#pragma unroll
        for (int u = 0; u < PD; ++u) {
          const int t = t0 + u;
          if (t >= nf) break;
          // alpha_{t-1} of the lane below: states j0-1 and j0-2
          float p1 = __shfl_up_sync(FULL, a[C - 1], 1);
          float p2 = __shfl_up_sync(FULL, a[C - 2], 1);
          if (lane == 0 && w > 0) {
            const float* x = xch + (((t - 1) & 1) * CHAIN_MAX_WARPS + w - 1) * 2;
            p2 = x[0];
            p1 = x[1];
          }
          float na[C];
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const int j = j0 + k;
            const float prev1 = k >= 1 ? a[k - 1] : p1;
            const float stay = a[k] + sl[k];
            const float adv = j > 0 ? prev1 + al[k] : NEG_INF;
            float v = logaddexp(stay, adv);
            if (SKIP) {
              const float prev2 = k >= 2 ? a[k - 2] : (k == 1 ? p1 : p2);
              v = logaddexp(v, j > 1 ? prev2 + sk[k] : NEG_INF);
            }
            na[k] = v + ring[u][k] * scale;
          }
          float* abt = ab + (size_t)t * J;
          const int tn = min(t + PD, T - 1);
#pragma unroll
          for (int k = 0; k < C; ++k) {
            a[k] = na[k];
            if (j0 + k < J) abt[j0 + k] = na[k];
            ring[u][k] = emission(llb, P, tn, eid[k]);
          }
          if (nw > 1) {
            if (lane == 31) {
              xch[((t & 1) * CHAIN_MAX_WARPS + w) * 2 + 0] = a[C - 2];
              xch[((t & 1) * CHAIN_MAX_WARPS + w) * 2 + 1] = a[C - 1];
            }
            chain_sync(nw);
          }
        }
      }
      float x[C];
#pragma unroll
      for (int k = 0; k < C; ++k) x[k] = j0 + k < J ? a[k] + final_logp[g + j0 + k] : -INFINITY;
      lse = chain_logsumexp<C>(x, nw, red_max, red_sum);
    }
  } else {
    // ---- the block arm: the general frame with a loop arc, without one
    // the same frame less the logsumexp and the enter term
    const int nth = blockDim.x;
    float* cur = smem;
    float* nxt = smem + J;
    float* sl = smem + 2 * J;
    float* al = smem + 3 * J;
    float* el = smem + 4 * J;
    float* xl = smem + 5 * J;
    int* eid = reinterpret_cast<int*>(smem + 6 * J);
    // the next frame's emissions are read during this one; at 8 states a
    // thread (1024 threads, 64 registers) a frame's own are read at its top
    constexpr bool PREFETCH = SPT <= 4;
    float emn[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      emn[k] = 0.f;
      if (j < J) {
        eid[j] = checked_emit_id(emit_id, g, j, P);
        sl[j] = self_logp[g + j];
        al[j] = adv_logp[g + j];
        el[j] = enter_logp[g + j];
        xl[j] = exit_logp[g + j];
        const float a0 = init_logp[g + j] + emission(llb, P, 0, eid[j]) * scale;
        cur[j] = a0;
        ab[j] = a0;
        if (PREFETCH) emn[k] = emission(llb, P, min(1, T - 1), eid[j]);
      }
    }
    __syncthreads();
    for (int t = 1; t < nf; ++t) {
      float e[SPT];  // unscaled
      const int tn = PREFETCH ? min(t + 1, T - 1) : t;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const int j = tid + k * nth;
        e[k] = emn[k];
        if (j < J) (PREFETCH ? emn[k] : e[k]) = emission(llb, P, tn, eid[j]);
      }
      float exit_lse = NEG_INF;
      if (loops) {
        float x[SPT];
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const int j = tid + k * nth;
          x[k] = j < J ? cur[j] + xl[j] : -INFINITY;
        }
        exit_lse = block_logsumexp<SPT>(x, red_max, red_sum);
      }
      float* abt = ab + (size_t)t * J;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const int j = tid + k * nth;
        if (j >= J) continue;
        const float stay = cur[j] + sl[j];
        const float adv = j > 0 ? cur[j - 1] + al[j] : NEG_INF;
        float a = logaddexp(stay, adv);
        if (loops) a = logaddexp(a, exit_lse + el[j]);
        if (SKIP) a = logaddexp(a, j > 1 ? cur[j - 2] + __ldg(skip_logp + g + j) : NEG_INF);
        a += e[k] * scale;
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
    lse = block_logsumexp<SPT>(x, red_max, red_sum);
  }
  if (tid == 0) {
    loglik[b] = lse;
    arm[b] = CSPL > 0 && !loops ? ARM_CHAIN : (loops ? ARM_GENERAL : ARM_BLOCK);
  }
}

// K3b: betas, without the alphas. Same block shapes and arms as K3f.
template <int MAXT, int SPT, int CSPL, bool SKIP>
__global__ void __launch_bounds__(MAXT, 1) fb_backward_kernel(
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
    int J, int chain_warps,
    float* __restrict__ betas,  // [B, T, J]: rows 0 .. n_frames - 1
    int* __restrict__ arm) {    // [B]
  // block arm [7, J]: emit + beta x2, self, adv, enter, exit, emit_id; chain
  // arm [2, CHAIN_MAX_WARPS, 2]
  extern __shared__ float smem[];
  __shared__ float red_max[32], red_sum[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t g = (size_t)b * J;
  const float* llb = ll + (size_t)b * T * P;
  float* bb = betas + (size_t)b * T * J;
  const int nf = max(min(n_frames[b], T), 0);
  const bool loops = row_has_loop(enter_logp, exit_logp, g, J);
  if (tid == 0) arm[b] = CSPL > 0 && !loops ? ARM_CHAIN : (loops ? ARM_GENERAL : ARM_BLOCK);
  if (nf == 0) return;  // the same for every thread of the block

  if (CSPL > 0 && !loops) {
    // ---- the chain arm
    constexpr int C = CSPL > 0 ? CSPL : 2;
    const int nw = chain_warps, w = tid >> 5, lane = tid & 31;
    if (w >= nw) return;
    float* xch = smem;  // [step parity][warp][2]: a warp's first two emit + beta
    const int j0 = (w * 32 + lane) * C;
    int eid[C];
    float beta[C], sl[C], an[C], sk[C], ring[PD][C];
    float* bt = bb + (size_t)(nf - 1) * J;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      const bool v = j < J;
      eid[k] = v ? checked_emit_id(emit_id, g, j, P) : 0;
      sl[k] = v ? self_logp[g + j] : NEG_INF;
      an[k] = j + 1 < J ? adv_logp[g + j + 1] : NEG_INF;  // the (j -> j+1) advance
      sk[k] = (SKIP && j + 2 < J) ? skip_logp[g + j + 2] : NEG_INF;  // the (j -> j+2) skip
      beta[k] = v ? final_logp[g + j] : NEG_INF;
      if (v) bt[j] = beta[k];
    }
    // step s (t = nf - 2 - s) reads the emissions of frame t + 1 = nf - 1 - s
#pragma unroll
    for (int u = 0; u < PD; ++u) {
#pragma unroll
      for (int k = 0; k < C; ++k) ring[u][k] = emission(llb, P, max(nf - 1 - u, 0), eid[k]);
    }
    for (int s0 = 0; s0 < nf - 1; s0 += PD) {
#pragma unroll
      for (int u = 0; u < PD; ++u) {
        const int s = s0 + u, t = nf - 2 - s;
        if (t < 0) break;
        float eb[C];  // emit(t+1, j) + beta_{t+1}[j]
#pragma unroll
        for (int k = 0; k < C; ++k) eb[k] = ring[u][k] * scale + beta[k];
        // emit + beta of the lane above: states j0+C and j0+C+1
        float n1 = __shfl_down_sync(FULL, eb[0], 1);
        float n2 = __shfl_down_sync(FULL, eb[1], 1);
        if (nw > 1) {
          float* x = xch + ((s & 1) * CHAIN_MAX_WARPS + w) * 2;
          if (lane == 0) {
            x[0] = eb[0];
            x[1] = eb[1];
          }
          chain_sync(nw);
          if (lane == 31 && w + 1 < nw) {
            n1 = x[2];
            n2 = x[3];
          }
        }
        float* bt_ = bb + (size_t)t * J;
        const int tn = max(nf - 1 - s - PD, 0);
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int j = j0 + k;
          const float next1 = k + 1 < C ? eb[k + 1] : n1;
          const float next2 = k + 2 < C ? eb[k + 2] : (k + 2 == C ? n1 : n2);
          const float stay = sl[k] + eb[k];
          const float adv = j + 1 < J ? an[k] + next1 : NEG_INF;
          float v = logaddexp(stay, adv);
          if (SKIP) v = logaddexp(v, j + 2 < J ? sk[k] + next2 : NEG_INF);
          beta[k] = v;
          if (j < J) bt_[j] = v;
          ring[u][k] = emission(llb, P, tn, eid[k]);
        }
      }
    }
  } else {
    // ---- the block arm
    const int nth = blockDim.x;
    float* sl = smem + 2 * J;
    float* an = smem + 3 * J;
    float* el = smem + 4 * J;
    float* xl = smem + 5 * J;
    int* eid = reinterpret_cast<int*>(smem + 6 * J);
    float beta[SPT], emn[SPT];
    float* bt = bb + (size_t)(nf - 1) * J;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      beta[k] = NEG_INF;
      emn[k] = 0.f;
      if (j < J) {
        eid[j] = checked_emit_id(emit_id, g, j, P);
        sl[j] = self_logp[g + j];
        an[j] = j + 1 < J ? adv_logp[g + j + 1] : NEG_INF;  // the (j -> j+1) advance
        el[j] = enter_logp[g + j];
        xl[j] = exit_logp[g + j];
        beta[k] = final_logp[g + j];
        bt[j] = beta[k];
        emn[k] = emission(llb, P, nf - 1, eid[j]);  // frame nf-1, used at t = nf-2
      }
    }
    // a thread reads its own states' graph values until the first step's barrier
    int buf = 0;
    for (int t = nf - 2; t >= 0; --t) {
      float* ebs = smem + buf * J;  // emit(t+1) + beta_{t+1}
      float eb[SPT], x[SPT];
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const int j = tid + k * nth;
        eb[k] = emn[k] * scale + beta[k];
        if (j < J) {
          ebs[j] = eb[k];
          emn[k] = emission(llb, P, t, eid[j]);  // frame t, used by the next step (t-1)
        }
        x[k] = j < J ? el[j] + eb[k] : -INFINITY;
      }
      float enter_lse = NEG_INF;
      if (loops) {
        enter_lse = block_logsumexp<SPT>(x, red_max, red_sum);  // also publishes ebs
      } else {
        __syncthreads();
      }
      float* bt_ = bb + (size_t)t * J;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const int j = tid + k * nth;
        if (j >= J) continue;
        const float stay = sl[j] + eb[k];
        const float adv = j + 1 < J ? an[j] + ebs[j + 1] : NEG_INF;
        float v = logaddexp(stay, adv);
        if (loops) v = logaddexp(v, xl[j] + enter_lse);
        if (SKIP) v = logaddexp(v, j + 2 < J ? __ldg(skip_logp + g + j + 2) + ebs[j + 2] : NEG_INF);
        beta[k] = v;
        bt_[j] = v;
      }
      buf ^= 1;
    }
  }
}

// log_gamma = (alpha + beta) - loglik on frames below n_frames, NEG_INF on
// the rest; alphas arrive in log_gamma's buffer. One (b, t) row per step.
__global__ void __launch_bounds__(128) fb_combine_kernel(int B, int T, int J,
                                                         const int* __restrict__ n_frames,
                                                         const float* __restrict__ betas,
                                                         const float* __restrict__ loglik,
                                                         float* __restrict__ log_gamma) {
  for (size_t r = blockIdx.x; r < (size_t)B * T; r += gridDim.x) {
    const int b = (int)(r / T), t = (int)(r % T);
    float* lg = log_gamma + r * J;
    if (t < n_frames[b]) {
      const float* bt = betas + r * J;
      const float llk = loglik[b];
      for (int j = threadIdx.x; j < J; j += blockDim.x) lg[j] = (lg[j] + bt[j]) - llk;
    } else {
      for (int j = threadIdx.x; j < J; j += blockDim.x) lg[j] = NEG_INF;
    }
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Launch {
  int threads, spt, cspl, chain_warps;
  size_t smem;
};

// J <= CHAIN_MAX_J: the chain arm on ceil(J / CHAIN_WARP_STATES) warps (at
// least enough for 8 states a lane, at most CHAIN_MAX_WARPS), CSPL states a
// lane rounded up to even, and a block arm of 4 states a thread. Wider
// graphs: the block arm only, 4 states a thread up to 1024 threads, then 8.
Launch launch_shape(int J) {
  Launch L;
  L.smem = 7 * (size_t)J * sizeof(float);
  if (J <= CHAIN_MAX_J) {
    L.chain_warps = std::min(CHAIN_MAX_WARPS, std::max((J + CHAIN_WARP_STATES - 1) / CHAIN_WARP_STATES,
                                                       (J + 255) / 256));
    const int per_lane = (J + 32 * L.chain_warps - 1) / (32 * L.chain_warps);
    L.cspl = std::max(2, (per_lane + 1) / 2 * 2);
    L.spt = 4;
    L.threads = std::max((J + 4 * 32 - 1) / (4 * 32) * 32, 32 * L.chain_warps);
    L.smem = std::max(L.smem, 2 * CHAIN_MAX_WARPS * 2 * sizeof(float));
  } else {
    L.chain_warps = 0;
    L.cspl = 0;
    L.spt = J <= 4 * 1024 ? 4 : 8;
    L.threads = (J + L.spt * 32 - 1) / (L.spt * 32) * 32;
  }
  return L;
}

// Calls LAUNCH(MAXT, SPT, CSPL) for the instantiation of launch shape L.
#define MOGASR_DISPATCH(L, LAUNCH)                    \
  switch ((L).cspl) {                                 \
    case 2: LAUNCH(256, 4, 2); break;                 \
    case 4: LAUNCH(256, 4, 4); break;                 \
    case 6: LAUNCH(256, 4, 6); break;                 \
    case 8: LAUNCH(256, 4, 8); break;                 \
    case 0:                                           \
      if ((L).spt == 4) {                             \
        LAUNCH(1024, 4, 0);                           \
      } else {                                        \
        LAUNCH(1024, 8, 0);                           \
      }                                               \
      break;                                          \
    default: return cudaErrorInvalidValue;            \
  }

// Two events per device for the fork and join of the two streams, made on
// first use (an event is recorded again by every call; a wait takes the
// record made before it).
cudaError_t fork_join_events(cudaEvent_t* fork, cudaEvent_t* join) {
  constexpr int MAX_DEVICES = 64;
  static cudaEvent_t events[MAX_DEVICES][2];
  static std::mutex lock;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  for (int k = 0; k < 2; ++k) {
    if (events[dev][k] == nullptr) {
      e = cudaEventCreateWithFlags(&events[dev][k], cudaEventDisableTiming);
      if (e != cudaSuccess) return e;
    }
  }
  *fork = events[dev][0];
  *join = events[dev][1];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The forward-backward of B utterances on the current device: K3f on
// `stream`, K3b on `side_stream` at the same time (it waits for the work
// queued on `stream` before the call), then, on `stream` once both are done,
// the combine. ll [B, T, P] float32; the graph arrays [B, J] (emit_id int32,
// the rest float32), skip_logp [B, J] float32 for a graph with CTC skip
// transitions or NULL; n_frames [B] int32. Writes log_gamma [B, T, J]:
// (alpha + beta) - loglik on frames below n_frames[b], NEG_INF on the rest;
// loglik [B]; arms [2, B], the arm each row took in K3f and in K3b (0 chain,
// 1 block arm without a loop arc, 2 general arm); betas [B, T, J] is scratch.
// J may be at most MAX_J (cudaErrorInvalidValue otherwise); an emit_id
// outside [0, P) stops the kernels with a trap.
int fb_forward_backward(const void* ll, int B, int T, int P, float scale, const void* emit_id,
                        const void* self_logp, const void* adv_logp, const void* enter_logp,
                        const void* exit_logp, const void* init_logp, const void* final_logp,
                        const void* skip_logp, const void* n_frames, int J, void* log_gamma,
                        void* betas, void* loglik, void* arms, void* stream, void* side_stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (J <= 0 || J > MAX_J) return cudaErrorInvalidValue;
  const Launch L = launch_shape(J);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStream_t side = static_cast<cudaStream_t>(side_stream);
  cudaEvent_t fork, join;
  cudaError_t e = fork_join_events(&fork, &join);
  if (e != cudaSuccess) return e;
  if ((e = cudaEventRecord(fork, st)) != cudaSuccess) return e;
  if ((e = cudaStreamWaitEvent(side, fork, 0)) != cudaSuccess) return e;
  int* arm = static_cast<int*>(arms);
#define MOGASR_FWD_SKIP(MAXT, SPT, CSPL, SKIP)                                               \
  e = set_smem((const void*)fb_forward_kernel<MAXT, SPT, CSPL, SKIP>, L.smem);               \
  if (e != cudaSuccess) return e;                                                            \
  fb_forward_kernel<MAXT, SPT, CSPL, SKIP><<<B, L.threads, L.smem, st>>>(                    \
      static_cast<const float*>(ll), T, P, scale, static_cast<const int*>(emit_id),          \
      static_cast<const float*>(self_logp), static_cast<const float*>(adv_logp),             \
      static_cast<const float*>(enter_logp), static_cast<const float*>(exit_logp),           \
      static_cast<const float*>(init_logp), static_cast<const float*>(final_logp),           \
      static_cast<const float*>(skip_logp), static_cast<const int*>(n_frames), J,            \
      L.chain_warps, static_cast<float*>(log_gamma), static_cast<float*>(loglik), arm)
#define MOGASR_BWD_SKIP(MAXT, SPT, CSPL, SKIP)                                               \
  e = set_smem((const void*)fb_backward_kernel<MAXT, SPT, CSPL, SKIP>, L.smem);              \
  if (e != cudaSuccess) return e;                                                            \
  fb_backward_kernel<MAXT, SPT, CSPL, SKIP><<<B, L.threads, L.smem, side>>>(                 \
      static_cast<const float*>(ll), T, P, scale, static_cast<const int*>(emit_id),          \
      static_cast<const float*>(self_logp), static_cast<const float*>(adv_logp),             \
      static_cast<const float*>(enter_logp), static_cast<const float*>(exit_logp),           \
      static_cast<const float*>(final_logp), static_cast<const float*>(skip_logp),           \
      static_cast<const int*>(n_frames), J, L.chain_warps, static_cast<float*>(betas),       \
      arm + B)
#define MOGASR_PAIR(MAXT, SPT, CSPL)             \
  if (skip_logp != nullptr) {                    \
    MOGASR_FWD_SKIP(MAXT, SPT, CSPL, true);      \
    if ((e = cudaGetLastError()) != cudaSuccess) \
      return e;                                  \
    MOGASR_BWD_SKIP(MAXT, SPT, CSPL, true);      \
  } else {                                       \
    MOGASR_FWD_SKIP(MAXT, SPT, CSPL, false);     \
    if ((e = cudaGetLastError()) != cudaSuccess) \
      return e;                                  \
    MOGASR_BWD_SKIP(MAXT, SPT, CSPL, false);     \
  }
  MOGASR_DISPATCH(L, MOGASR_PAIR)
#undef MOGASR_PAIR
#undef MOGASR_BWD_SKIP
#undef MOGASR_FWD_SKIP
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = cudaEventRecord(join, side)) != cudaSuccess) return e;
  if ((e = cudaStreamWaitEvent(st, join, 0)) != cudaSuccess) return e;
  const long long rows = (long long)B * T;
  const int grid = (int)(rows < 132 * 16 ? rows : 132 * 16);
  fb_combine_kernel<<<grid, 128, 0, st>>>(B, T, J, static_cast<const int*>(n_frames),
                                          static_cast<const float*>(betas),
                                          static_cast<const float*>(loglik),
                                          static_cast<float*>(log_gamma));
  return cudaGetLastError();
}

const char* forward_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Viterbi decode over chain+loop graphs for Hopper (sm_90a): forward pass and
// backtrace.
//
// Replaces mogasr/decoder/viterbi_pallas.py::_vit_kernel and the reverse-scan
// backtrace of viterbi_pallas (the bitwise twin of mogasr/decoder/viterbi.py).
// The contract is the same: bitwise equality with the plain recursion
// (mogasr_torch/decoder/viterbi.py) -- same path, same entered flags, same
// score. Every float operation below is the one the plain version performs,
// in its order, rounded on its own: __fadd_rn / __fmul_rn, and the file is
// built with -fmad=false, so no product and sum fuse into an FMA.
//
// What bounds it: latency, not arithmetic or bytes. Each frame does a few
// adds and compares per state plus one block-wide max, over J = 3048 states
// and T = 600 frames per utterance, and frame t needs frame t-1 complete.
// So one block owns one utterance and loops over frames inside the kernel
// (blocks run in no order, so nothing carries between them): ceil(J/blockDim)
// states per thread with their graph log-probs in registers, delta
// double-buffered in shared memory so the j-1 neighbour reads the old row,
// and a shuffle-then-shared-memory reduce for the exit max and its
// first-index argmax. Emissions are gathered in the kernel from
// ll[b, t, emit_id[b, j]] (the reference materialises [B, T, J] first: 1.9 GB
// per 256-utterance batch); each frame's gather is issued before the reduce so
// its latency hides behind it. Frames past n_frames[b] are skipped: delta is
// frozen there and the backtrace starts at the last valid frame.
//
// Backpointers are uint8 codes (0 stay, 1 advance, 2 enter, 3 skip) in
// [B, T, J] (row 0 unused) and the exit argmax is int32 [B, T]; both are
// internal. The backtrace is a second kernel, one thread per utterance.
// Without a backtrace (path == NULL) neither is stored nor allocated: only
// the score.
//
// Beam pruning (mogasr/decoder/viterbi.py:92-94) is a template arm: each
// frame, after the emission add, one more block-wide max over the row's J
// states gives thresh = max - beam, and every state below it becomes NEG_INF.
// Max is exact and thresh is one rounded subtraction, so the arm stays
// bitwise equal to the plain version; the beam-off arm is the code without it.
//
// CTC skip transitions (mogasr/decoder/viterbi.py:80-86; the Pallas kernel
// has no such arm) are a template arm too: one more predecessor per state,
// delta[j-2] + skip_logp[j] (NEG_INF for j < 2, as the plain version pads),
// which takes the state with code 3 when it beats stay, advance and enter,
// before stay's exact-tie rule. skip_logp is read through the read-only cache
// each frame rather than held in registers, so the arm adds no register
// pressure; graphs without skips run the code without it.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_SPT = 8;  // states per thread

struct ArgMax {
  float v;
  int i;
};

// The larger value; the smaller index on a tie (first-index argmax).
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// Block-wide argmax. red_v / red_i hold 33 slots: one per warp and one to
// broadcast the result.
__device__ ArgMax block_argmax(ArgMax x, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const ArgMax o{__shfl_down_sync(0xffffffffu, x.v, off),
                   __shfl_down_sync(0xffffffffu, x.i, off)};
    x = better(x, o);
  }
  if (lane == 0) {
    red_v[warp] = x.v;
    red_i[warp] = x.i;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    x = lane < n_warps ? ArgMax{red_v[lane], red_i[lane]} : ArgMax{-INFINITY, INT_MAX};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const ArgMax o{__shfl_down_sync(0xffffffffu, x.v, off),
                     __shfl_down_sync(0xffffffffu, x.i, off)};
      x = better(x, o);
    }
    if (lane == 0) {
      red_v[32] = x.v;
      red_i[32] = x.i;
    }
  }
  __syncthreads();
  return ArgMax{red_v[32], red_i[32]};
}

// Block-wide max; red holds 33 slots, as in block_argmax.
__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, off));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

template <int SPT, bool BEAM, bool SKIP>
__global__ void __launch_bounds__(1024, 1) viterbi_forward_kernel(
    const float* __restrict__ ll,  // [B, T, P]
    int T, int P, float scale, float beam,
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
    uint8_t* __restrict__ bp,     // [B, T, J], or NULL: no backtrace
    int* __restrict__ exit_arg,   // [B, T], or NULL with bp
    float* __restrict__ score,    // [B]
    int* __restrict__ j_final) {  // [B]
  extern __shared__ float delta_buf[];  // [2, J]
  __shared__ float red_v[33];
  __shared__ int red_i[33];
  __shared__ float red_m[33];
  const bool store = bp != nullptr;
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const size_t g = (size_t)b * J;
  const float* llb = ll + (size_t)b * T * P;
  const int nf = min(n_frames[b], T);

  int eid[SPT];
  float sl[SPT], al[SPT], el[SPT], xl[SPT];
  float* cur = delta_buf;
  float* nxt = delta_buf + J;
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
      cur[j] = __fadd_rn(init_logp[g + j], __fmul_rn(llb[eid[k]], scale));
    } else {
      eid[k] = 0;
      sl[k] = al[k] = el[k] = xl[k] = NEG_INF;
    }
  }
  __syncthreads();

  for (int t = 1; t < nf; ++t) {
    const float* llt = llb + (size_t)t * P;
    float em[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      em[k] = j < J ? __fmul_rn(__ldg(llt + eid[k]), scale) : 0.f;
    }

    ArgMax ex{-INFINITY, INT_MAX};
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      if (j < J) ex = better(ex, ArgMax{__fadd_rn(cur[j], xl[k]), j});
    }
    ex = block_argmax(ex, red_v, red_i);

    uint8_t* bpt = store ? bp + ((size_t)b * T + t) * J : nullptr;
    float nv[SPT];
    float row_max = -INFINITY;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      if (j >= J) continue;
      const float stay = __fadd_rn(cur[j], sl[k]);
      const float adv = j > 0 ? __fadd_rn(cur[j - 1], al[k]) : NEG_INF;
      const float ent = __fadd_rn(ex.v, el[k]);
      float best = fmaxf(fmaxf(stay, adv), ent);
      uint8_t code = best == ent ? 2 : (best == adv ? 1 : 0);
      if (SKIP) {
        const float skp = j > 1 ? __fadd_rn(cur[j - 2], __ldg(skip_logp + g + j)) : NEG_INF;
        if (skp > best) {
          code = 3;
          best = skp;
        }
      }
      if (best == stay) code = 0;
      nv[k] = __fadd_rn(best, em[k]);
      if (BEAM) {
        row_max = fmaxf(row_max, nv[k]);
      } else {
        nxt[j] = nv[k];
      }
      if (store) bpt[j] = code;
    }
    if (BEAM) {
      const float thresh = __fsub_rn(block_max(row_max, red_m), beam);
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const int j = tid + k * nth;
        if (j < J) nxt[j] = nv[k] >= thresh ? nv[k] : NEG_INF;
      }
    }
    if (store && tid == 0) exit_arg[(size_t)b * T + t] = ex.i;
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  ArgMax fin{-INFINITY, INT_MAX};
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int j = tid + k * nth;
    if (j < J) fin = better(fin, ArgMax{__fadd_rn(cur[j], final_logp[g + j]), j});
  }
  fin = block_argmax(fin, red_v, red_i);
  if (tid == 0) {
    score[b] = fin.v;
    j_final[b] = fin.i;
  }
}

__global__ void viterbi_backtrace_kernel(
    const uint8_t* __restrict__ bp, const int* __restrict__ exit_arg,
    const int* __restrict__ j_final, const int* __restrict__ n_frames,
    int B, int T, int J,
    int* __restrict__ path,          // [B, T]
    uint8_t* __restrict__ entered) { // [B, T] (torch.bool storage)
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int nf = max(min(n_frames[b], T), 0);
  int* pb = path + (size_t)b * T;
  uint8_t* eb = entered + (size_t)b * T;
  for (int t = nf; t < T; ++t) {
    pb[t] = -1;
    eb[t] = 0;
  }
  if (nf == 0) return;
  int j = j_final[b];
  for (int t = nf - 1; t >= 1; --t) {
    pb[t] = j;
    const uint8_t code = bp[((size_t)b * T + t) * J + j];
    eb[t] = code == 2;
    j = code == 0 ? j : (code == 1 ? j - 1 : (code == 3 ? j - 2 : exit_arg[(size_t)b * T + t]));
  }
  pb[0] = j;
  eb[0] = 1;
}

struct ForwardArgs {
  const float* ll;
  int T, P;
  float scale, beam;
  const int* emit_id;
  const float *self_logp, *adv_logp, *enter_logp, *exit_logp, *init_logp, *final_logp,
      *skip_logp;
  const int* n_frames;
  int J;
  uint8_t* bp;
  int* exit_arg;
  float* score;
  int* j_final;
};

template <int SPT, bool BEAM, bool SKIP>
cudaError_t launch_forward(int threads, size_t smem, int B, cudaStream_t stream,
                           const ForwardArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(viterbi_forward_kernel<SPT, BEAM, SKIP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  viterbi_forward_kernel<SPT, BEAM, SKIP><<<B, threads, smem, stream>>>(
      a.ll, a.T, a.P, a.scale, a.beam, a.emit_id, a.self_logp, a.adv_logp, a.enter_logp,
      a.exit_logp, a.init_logp, a.final_logp, a.skip_logp, a.n_frames, a.J, a.bp, a.exit_arg,
      a.score, a.j_final);
  return cudaGetLastError();
}

// The arm for beam > 0 and for a graph with skip transitions.
template <int SPT>
cudaError_t launch_arm(int threads, size_t smem, int B, cudaStream_t stream,
                       const ForwardArgs& a) {
  const bool beam = a.beam > 0.f, skip = a.skip_logp != nullptr;
  if (beam)
    return skip ? launch_forward<SPT, true, true>(threads, smem, B, stream, a)
                : launch_forward<SPT, true, false>(threads, smem, B, stream, a);
  return skip ? launch_forward<SPT, false, true>(threads, smem, B, stream, a)
              : launch_forward<SPT, false, false>(threads, smem, B, stream, a);
}

}  // namespace

extern "C" {

// Forward pass plus backtrace for B utterances. ll [B, T, P] float32; the
// seven graph arrays [B, J] (emit_id int32, the rest float32), and
// skip_logp [B, J] float32 for a graph with CTC skip transitions or NULL;
// n_frames [B] int32. Scratch: bp uint8 [B, T, J], exit_arg int32 [B, T],
// j_final int32 [B]. Outputs: path int32 [B, T], entered uint8/bool [B, T],
// score float32 [B]. beam > 0 prunes each frame to [max - beam, max]; 0 is
// exact. With path == NULL there is no backtrace: bp, exit_arg and entered may be NULL,
// and only score is written. J may be at most MAX_SPT * 1024
// (cudaErrorInvalidValue otherwise); an emit_id outside [0, P) stops the
// kernel with a trap, as an out-of-range index stops torch.gather on the
// device.
int viterbi_decode(const void* ll, int B, int T, int P, float scale, float beam,
                   const void* emit_id,
                   const void* self_logp, const void* adv_logp, const void* enter_logp,
                   const void* exit_logp, const void* init_logp, const void* final_logp,
                   const void* skip_logp, const void* n_frames, int J, void* bp,
                   void* exit_arg, void* j_final,
                   void* path, void* entered, void* score, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (J <= 0 || J > MAX_SPT * 1024) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 512 threads keep two blocks on an SM (registers permitting); wider graphs
  // take 1024. Small graphs take one thread per state.
  int threads = J <= MAX_SPT * 512 ? 512 : 1024;
  const int j32 = (J + 31) / 32 * 32;
  if (j32 < threads) threads = j32;
  const int spt = (J + threads - 1) / threads;
  const size_t smem = 2 * (size_t)J * sizeof(float);
  const bool backtrace = path != nullptr;
  const ForwardArgs a{static_cast<const float*>(ll), T, P, scale, beam,
                      static_cast<const int*>(emit_id),
                      static_cast<const float*>(self_logp), static_cast<const float*>(adv_logp),
                      static_cast<const float*>(enter_logp), static_cast<const float*>(exit_logp),
                      static_cast<const float*>(init_logp), static_cast<const float*>(final_logp),
                      static_cast<const float*>(skip_logp), static_cast<const int*>(n_frames), J,
                      backtrace ? static_cast<uint8_t*>(bp) : nullptr,
                      backtrace ? static_cast<int*>(exit_arg) : nullptr,
                      static_cast<float*>(score), static_cast<int*>(j_final)};
  cudaError_t e;
  switch (spt) {
    case 1: e = launch_arm<1>(threads, smem, B, st, a); break;
    case 2: e = launch_arm<2>(threads, smem, B, st, a); break;
    case 3: e = launch_arm<3>(threads, smem, B, st, a); break;
    case 4: e = launch_arm<4>(threads, smem, B, st, a); break;
    case 5: e = launch_arm<5>(threads, smem, B, st, a); break;
    case 6: e = launch_arm<6>(threads, smem, B, st, a); break;
    case 7: e = launch_arm<7>(threads, smem, B, st, a); break;
    case 8: e = launch_arm<8>(threads, smem, B, st, a); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || !backtrace) return e;
  viterbi_backtrace_kernel<<<(B + 127) / 128, 128, 0, st>>>(
      a.bp, a.exit_arg, a.j_final, a.n_frames, B, T, J, static_cast<int*>(path),
      static_cast<uint8_t*>(entered));
  return cudaGetLastError();
}

const char* viterbi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

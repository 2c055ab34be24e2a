// Viterbi decode over chain+loop graphs for Hopper (sm_90a): the forward pass
// and the backtrace, in one kernel.
//
// Replaces mogasr/decoder/viterbi_pallas.py::_vit_kernel and the reverse-scan
// backtrace of viterbi_pallas (the bitwise twin of mogasr/decoder/viterbi.py).
// The contract is the same: bitwise equality with the plain recursion
// (mogasr_torch/decoder/viterbi.py) -- same path, same entered flags, same
// score. Every float operation below is the one the plain version performs,
// in its order, rounded on its own: __fadd_rn / __fmul_rn, and the file is
// built with -fmad=false, so no product and sum fuse into an FMA.
//
// What bounds it: latency, not arithmetic or bytes. Frame t needs frame t-1
// of the whole graph, so one block owns one utterance and loops over its
// frames (blocks run in no order, so nothing carries between them). The
// earlier design (one thread per state, every row alike) paced each frame by
// the random read of its emissions from ll [B, T, P], a block-wide exit
// argmax over all J states with two barriers, and an end-of-frame barrier,
// and then read the uint8 backpointers [B, T, J] back with one thread per
// utterance, T dependent loads in a second kernel (a split on the H100,
// PERF.md: on the decode batch the emission wait ~27% of the forward, the
// argmax ~13%, the backpointer stores ~18%, the backtrace kernel a third of
// K2). This design takes each off the chain:
//
// - Emissions ahead of their frame. A state's emission is still gathered in
//   the kernel, ll[b, t, emit_id[b, j]] * scale (the reference materialises
//   [B, T, J] first), but frames ahead of its use: the chain arm keeps the
//   next PD frames of its states in a register ring, the word-loop arm the
//   next frame.
// - A chain arm for rows without a loop arc. Each block checks once, on the
//   device, whether its row has any enter_logp or exit_logp above NEG_INF /
//   2. Align graphs (monophone, CD, a batch's dummy rows' silence graphs)
//   have none: every enter and exit log-prob is NEG_INF = -1e30, and padding
//   states are NEG_INF throughout. Then the enter candidate exit_max +
//   enter_logp is about -2e30 and never beats stay on a real state (finite,
//   or -1e30 rounded), and padding states come after the real ones and feed
//   none of them, so such a row drops the exit argmax and the enter term:
//   every real state's value and code is the plain version's, and no
//   backtrace reads a padding state. tests/test_torch_viterbi.py holds a copy
//   of the plain recursion without those terms bitwise to the plain version
//   on such graphs. A row of J <= CHAIN_MAX_J states lives in the registers
//   of nw = ceil(J / 32) warps (at most 8), 32-state groups dealt to the
//   warps in turn (group g = k * nw + w holds states 32 g .. 32 g + 31 in
//   lane order); a lane takes its j-1 (and j-2) neighbour by shuffle, and a
//   group's lane 0 (and 1) from the previous group's last two states in
//   shared memory, behind one named barrier of the nw warps per frame.
// - A compact exit set for rows with exit arcs (the decode word loop: 301 of
//   3048 states), and one barrier a frame. Only states whose exit_logp is
//   above NEG_INF offer a candidate for the next frame's exit argmax, and
//   they offer it as they write their new delta: each thread keeps its best,
//   each warp reduces them into a slot, and after the frame's barrier every
//   warp reduces the slots itself. A non-exit state's candidate cur[j] +
//   exit_logp rounds to -1e30 or below (|cur| is far below 1e30's half ulp,
//   3.8e22), so when the compact maximum is above -1e30 it is the full
//   first-index argmax; otherwise (the first frames, a row with nothing live
//   at an exit) the frame takes the full block-wide argmax. A frame then has
//   one barrier instead of three. All rows of a decode batch run at once,
//   so this arm is bound by the instructions it issues per state: its frame
//   has no guard and no branch per state (the arrays are padded).
// - Backpointer codes in 2 bits (0 stay, 1 advance, 2 enter, 3 skip), as
//   two bit planes per 32-state group made by warp ballots: [B, T,
//   ceil(J / 32)] uint2, a quarter of the uint8 codes' bytes. The backtrace
//   runs in the same kernel once the row's forward is done, on one warp: a
//   round loads, for the next BT_FRAMES frames, the groups the path can reach
//   without an enter (it moves back at most 2 states a frame) and their
//   exit argmax, then resolves those frames from registers by shuffles; an
//   enter ends the round. So T dependent loads become about T / 16.
//
// Frames past n_frames[b] are skipped: delta is frozen there and the
// backtrace starts at the last valid frame. Without a backtrace (path ==
// NULL) no code is stored: only the score.
//
// The chunk arm (viterbi_chunk) is the step of mogasr/decoder/online.py's
// _chunk_step, the online decoder's: the same forward over one chunk of Tc
// frames of a batch of streams, from the carried delta [B, J] of a row that
// has started (its first valid frame initializes from init_logp as frame 0
// does here), and back into it; started [B] switches on at a row's first
// valid frame; a row past its n_valid (n_valid == 0 included) keeps its delta
// bit for bit. Its codes and exit argmax go into a per-stream buffer on the
// card at each row's own frame offset (frame0[b]; rows t_cap frames apart:
// a batch of sessions at ragged lengths, a reused row restarting at 0), which
// stays there: 2-bit planes are a quarter of the reference's uint8
// backpointers, which went to the host every chunk. viterbi_backtrace is the
// backtrace alone, on that buffer, from the argmax of delta (a partial) or of
// delta + final_logp (the end of the stream): only the path comes back. The
// arms and the frame are the decoder's own, so the chunk arm is bitwise the
// plain chunk step, and a stream's finalize the offline decode of its frames.
//
// Beam pruning (mogasr/decoder/viterbi.py:92-94) is a template arm: each
// frame, after the emission add, a max over the row's J states gives thresh
// = max - beam, and every state below it becomes NEG_INF (in the chain arm
// a max over its warps, with one more barrier). Max is exact and thresh is
// one rounded subtraction, so the arm stays bitwise equal to the plain
// version; the beam-off arm is the code without it.
//
// CTC skip transitions (mogasr/decoder/viterbi.py:80-86; the Pallas kernel
// has no such arm) are a template arm too: one more predecessor per state,
// delta[j-2] + skip_logp[j] (NEG_INF for j < 2, as the plain version pads),
// which takes the state with code 3 when it beats stay, advance and enter,
// before stay's exact-tie rule.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SPT = 8;  // word-loop (block) arm: states per thread
// Rows without a loop arc and at most CHAIN_MAX_J states run the chain arm on
// one warp per 32 states, at most CHAIN_MAX_WARPS, 1-4 states a lane (one a
// lane ran fastest at J = 192 on the H100: 0.071 ms against 0.115 at two and
// 0.161 at three, PERF.md).
constexpr int CHAIN_MAX_J = 1024, CHAIN_MAX_WARPS = 8, CHAIN_MAX_C = 4;
constexpr int BT_FRAMES = 16;   // backtrace: frames resolved per round of loads (two lanes each)

enum : int { ARM_CHAIN = 0, ARM_LOOP = 1, ARM_BLOCK = 2 };

struct ArgMax {
  float v;
  int i;
};

// The larger value; the smaller index on a tie (first-index argmax).
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// Warp-wide argmax and max, every lane getting the result (better is
// associative and commutative).
__device__ __forceinline__ ArgMax warp_argmax(ArgMax x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = better(x, ArgMax{__shfl_xor_sync(FULL, x.v, off), __shfl_xor_sync(FULL, x.i, off)});
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// An int key of a float (not NaN) in its order, -0 as +0, and back: a
// warp's max and its first index take one redux.sync each.
__device__ __forceinline__ int order_key(float v) {
  const int k = __float_as_int(v == 0.f ? 0.f : v);
  return k >= 0 ? k : k ^ 0x7fffffff;
}
__device__ __forceinline__ float key_value(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

// The warp's largest key and the smallest index among its lanes holding it,
// in every lane.
__device__ __forceinline__ void warp_best(int& key, int& idx) {
  const int mk = __reduce_max_sync(FULL, key);
  idx = (int)__reduce_min_sync(FULL, key == mk ? (unsigned)idx : 0xffffffffu);
  key = mk;
}

// Block-wide argmax and max. red_v / red_i / red hold 33 slots: one per warp
// and one to broadcast the result. Two barriers.
__device__ ArgMax block_argmax(ArgMax x, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_argmax(x);
  if (lane == 0) {
    red_v[warp] = x.v;
    red_i[warp] = x.i;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    x = warp_argmax(lane < n_warps ? ArgMax{red_v[lane], red_i[lane]} : ArgMax{-INFINITY, INT_MAX});
    if (lane == 0) {
      red_v[32] = x.v;
      red_i[32] = x.i;
    }
  }
  __syncthreads();
  return ArgMax{red_v[32], red_i[32]};
}
__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_max(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

// A 4-byte copy from global to shared memory that holds no register while
// in flight (cp.async), its commit and the wait for all but the newest N
// groups of the calling thread.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier 1 over the chain arm's nw warps; a warp barrier on one warp.
__device__ __forceinline__ void chain_sync(int nw) {
  if (nw > 1)
    asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");
  else
    __syncwarp();
}

// Whether row g of the graphs has a loop arc: an enter or exit log-prob
// above NEG_INF / 2. Every thread of the block gets the answer.
__device__ __forceinline__ bool row_has_loop(const float* __restrict__ enter_logp,
                                             const float* __restrict__ exit_logp, size_t g, int J) {
  int any = 0;
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    any |= (enter_logp[g + j] > NEG_INF / 2) | (exit_logp[g + j] > NEG_INF / 2);
  return __syncthreads_or(any) != 0;
}

// emit_id[g + j], checked: an id outside [0, P) stops the kernel rather than
// read outside ll's row.
__device__ __forceinline__ int checked_emit_id(const int* __restrict__ emit_id, size_t g, int j, int P) {
  const int e = emit_id[g + j];
  if (e < 0 || e >= P) __trap();
  return e;
}

struct Args {
  const float* ll;  // [B, T, P]
  int T, P;
  float scale, beam;
  const int* emit_id;  // [B, J], and the log-probs [B, J]
  const float *self_logp, *adv_logp, *enter_logp, *exit_logp, *init_logp, *final_logp;
  const float* skip_logp;  // [B, J]; read only by the SKIP arms
  const int* n_frames;     // [B] (the chunk arm: n_valid)
  int J, chain_warps;
  uint2* bp;         // [B, t_cap, ceil(J / 32)] code bit planes, or NULL: no backtrace
  int* exit_arg;     // [B, t_cap], or NULL with bp
  int* path;         // [B, T], or NULL with bp (and in the chunk arm)
  uint8_t* entered;  // [B, T] (torch.bool storage), or NULL with bp
  int* pdfs;         // [B, T]: emit_id of the path's state, -1 past n_frames; or NULL
  float* score;      // [B]
  int* arm;          // [B]: the arm each row took
  int t_cap;         // frames between rows of bp and exit_arg: T, or a stream buffer's capacity
  const int* frame0;  // the chunk arm: [B], the frame of row b's bp and exit_arg that its frame 0 of ll is
                     // stored at; NULL offline (0)
  float* delta_io;   // the chunk arm: [B, J] carried delta, read and written; NULL offline
  uint8_t* started_io;  // the chunk arm: [B] (torch.bool storage), read and written
};

// The chain arm: a row without a loop arc, J <= CHAIN_MAX_J, on the block's
// first nw warps, C states a lane (group k * nw + w, lane order). Writes the
// score and the final state.
template <int C, bool BEAM, bool SKIP, bool CHUNK>
__device__ __forceinline__ void chain_arm(const Args& a, int b, int nf, int t_first, const float* din, uint2* bpb,
                                          float* red_v, int* red_i, int* j_final) {
  constexpr int PD = C <= 2 ? 8 : 4;  // frames of emissions in flight
  __shared__ float xch[2][CHAIN_MAX_WARPS * CHAIN_MAX_C][2];  // [frame parity][group]: its lanes 30, 31
  __shared__ float red_b[2][CHAIN_MAX_WARPS];                 // [frame parity][warp]: the beam's max
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, nw = a.chain_warps;
  if (w >= nw) return;
  const int J = a.J, T = a.T, P = a.P, G = (J + 31) >> 5;
  const float scale = a.scale;
  const size_t g0 = (size_t)b * J;
  const float* llb = a.ll + (size_t)b * T * P;

  int eid[C];
  float d[C], sl[C], al[C], sk[C], ring[PD][C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = 32 * (k * nw + w) + lane;
    const bool v = j < J;
    eid[k] = v ? checked_emit_id(a.emit_id, g0, j, P) : 0;
    sl[k] = v ? a.self_logp[g0 + j] : NEG_INF;
    al[k] = v ? a.adv_logp[g0 + j] : NEG_INF;
    sk[k] = (SKIP && v) ? a.skip_logp[g0 + j] : NEG_INF;
    d[k] = !v ? NEG_INF : (din != nullptr ? din[j] : __fadd_rn(a.init_logp[g0 + j], __fmul_rn(llb[eid[k]], scale)));
  }
#pragma unroll
  for (int u = 0; u < PD; ++u) {
#pragma unroll
    for (int k = 0; k < C; ++k) ring[u][k] = __ldg(llb + (size_t)min(t_first + u, T - 1) * P + eid[k]);
  }
  const auto publish = [&](int t) {  // a group's last two states, for the next group's lanes 0 and 1
    if (lane >= 30) {
#pragma unroll
      for (int k = 0; k < C; ++k) xch[t & 1][k * nw + w][lane - 30] = d[k];
    }
  };
  publish(t_first - 1);
  chain_sync(nw);

  for (int t0 = t_first; t0 < nf; t0 += PD) {
#pragma unroll
    for (int u = 0; u < PD; ++u) {
      const int t = t0 + u;
      if (t >= nf) break;
      const float(*xp)[2] = xch[(t - 1) & 1];
      float nd[C];
      uint2 codes = make_uint2(0u, 0u);  // lane k < C: group k's bit planes
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int gi = k * nw + w, j = 32 * gi + lane;
        float p1 = __shfl_up_sync(FULL, d[k], 1);
        float p2 = SKIP ? __shfl_up_sync(FULL, d[k], 2) : 0.f;
        if (lane == 0) p1 = gi > 0 ? xp[gi - 1][1] : NEG_INF;
        if (SKIP && lane < 2) p2 = gi > 0 ? xp[gi - 1][lane] : NEG_INF;
        const float stay = __fadd_rn(d[k], sl[k]);
        const float adv = j > 0 ? __fadd_rn(p1, al[k]) : NEG_INF;
        float best = fmaxf(stay, adv);
        int code = best == adv ? 1 : 0;
        if (SKIP) {
          const float skp = j > 1 ? __fadd_rn(p2, sk[k]) : NEG_INF;
          if (skp > best) {
            code = 3;
            best = skp;
          }
        }
        if (best == stay) code = 0;
        nd[k] = __fadd_rn(best, __fmul_rn(ring[u][k], scale));
        const bool v = j < J;
        const unsigned lo = __ballot_sync(FULL, v && (code & 1)), hi = __ballot_sync(FULL, v && (code & 2));
        if (lane == k) codes = make_uint2(lo, hi);
      }
      if (BEAM) {
        float m = -INFINITY;
#pragma unroll
        for (int k = 0; k < C; ++k)
          if (32 * (k * nw + w) + lane < J) m = fmaxf(m, nd[k]);
        m = warp_max(m);
        if (nw > 1) {
          if (lane == 0) red_b[t & 1][w] = m;
          chain_sync(nw);
          m = red_b[t & 1][0];
          for (int i = 1; i < nw; ++i) m = fmaxf(m, red_b[t & 1][i]);
        }
        const float thresh = __fsub_rn(m, a.beam);
#pragma unroll
        for (int k = 0; k < C; ++k) nd[k] = nd[k] >= thresh ? nd[k] : NEG_INF;
      }
#pragma unroll
      for (int k = 0; k < C; ++k) d[k] = nd[k];
      if (bpb != nullptr && lane < C && lane * nw + w < G) bpb[(size_t)t * G + lane * nw + w] = codes;
      publish(t);
      const int tn = min(t + PD, T - 1);
#pragma unroll
      for (int k = 0; k < C; ++k) ring[u][k] = __ldg(llb + (size_t)tn * P + eid[k]);
      chain_sync(nw);
    }
  }

  if constexpr (CHUNK) {  // delta back for the next chunk
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = 32 * (k * nw + w) + lane;
      if (j < J) a.delta_io[g0 + j] = d[k];
    }
    return;
  }
  ArgMax fin{-INFINITY, INT_MAX};
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = 32 * (k * nw + w) + lane;
    if (j < J) fin = better(fin, ArgMax{__fadd_rn(d[k], a.final_logp[g0 + j]), j});
  }
  fin = warp_argmax(fin);
  if (nw > 1) {
    if (lane == 0) {
      red_v[w] = fin.v;
      red_i[w] = fin.i;
    }
    chain_sync(nw);
    fin = ArgMax{red_v[0], red_i[0]};
    for (int i = 1; i < nw; ++i) fin = better(fin, ArgMax{red_v[i], red_i[i]});
  }
  if (tid == 0) {
    a.score[b] = fin.v;
    *j_final = fin.i;
  }
}

// The word-loop arm: a row with a loop arc (the decode word loop, random
// graphs), or one without too wide for the chain arm (loops false: no exit
// argmax, no enter term); SPT states a thread, state j on thread j % nth.
// All 256 rows of a decode batch run at once, so the arm is bound by the
// instructions it issues per state and frame (a split on the H100, PERF.md),
// and its frame has no per-state guard or branch:
// - delta is double-buffered in shared memory, padded to SPT * nth states
//   behind two NEG_INF sentinels (adv_logp of state 0 and skip_logp of
//   states 0 and 1 held as 0, so those predecessors give exactly NEG_INF, as
//   the plain version pads), with enter_logp and emit_id beside it;
// - the next two frames' emissions wait in a ring that cp.async fills (held
//   in registers across the barrier they spilled, and a spill of a register
//   whose load was in flight stalled the frame);
// - the next frame's exit argmax rides this frame's one barrier: each
//   thread keeps the first of its exit states (exit_logp above NEG_INF; the
//   others count as -inf) with the largest new delta + exit_logp, each warp
//   reduces that into a slot (redux.sync), and after the barrier every warp
//   reduces the slots. When that maximum is not above NEG_INF, no non-exit
//   state can lose to it by rounding, so the frame takes the full
//   block-wide argmax instead;
// - NTH > 0 is the block's width, known to the compiler so each state's
//   offsets fold into its instructions (a width read at run time took a
//   register per state and array, and those spilled).
// Writes the score and the final state.
template <int SPT, int NTH, bool BEAM, bool SKIP, bool CHUNK>
__device__ __forceinline__ void loop_arm(const Args& a, int b, int nf, int t_first, const float* din, bool loops,
                                         uint2* bpb, float* smem, float* red_v, int* red_i, float* red_m,
                                         int* j_final) {
  __shared__ int slot_k[2][32], slot_i[2][32];  // [frame parity][warp]: its best exit offer (key, state)
  const int tid = threadIdx.x, nth = NTH > 0 ? NTH : blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = nth >> 5;
  const int J = a.J, T = a.T, P = a.P, G = (J + 31) >> 5, JP = SPT * nth + 2;
  const float scale = a.scale;
  const size_t g0 = (size_t)b * J;
  const float* llb = a.ll + (size_t)b * T * P;
  float* cur = smem + 2;  // [-2, SPT * nth): the sentinels, the states, the padding
  float* nxt = smem + JP + 2;
  float* el = smem + 2 * JP;
  int* eid = reinterpret_cast<int*>(smem + 2 * JP + SPT * nth);
  float* ring = smem + 2 * JP + 2 * SPT * nth;  // [3, SPT * nth]: frame t's emissions, unscaled, at t % 3
  const int none = order_key(-INFINITY);
  const auto fetch = [&](int t) {  // this thread's emissions of frame t into the ring, as one group
    if (t < nf) {
      const float* llt = llb + (size_t)t * P;
      float* r = ring + (t % 3) * SPT * nth;
#pragma unroll
      for (int k = 0; k < SPT; ++k) copy_async(r + tid + k * nth, llt + eid[tid + k * nth]);
    }
    copy_commit();
  };

  // self_logp: at 8 states a thread read through the read-only cache each
  // frame (held, it spilled; shared memory is full at J = 8192)
  constexpr bool SL_REG = SPT < 8;
  float sl[SL_REG ? SPT : 1], al[SPT], xl[SPT];  // xl: -inf off the exit set
  if (tid < 2) cur[tid - 2] = nxt[tid - 2] = NEG_INF;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int j = tid + k * nth;
    const bool v = j < J;
    const int e = v ? checked_emit_id(a.emit_id, g0, j, P) : 0;
    if (SL_REG) sl[SL_REG ? k : 0] = v ? a.self_logp[g0 + j] : NEG_INF;
    al[k] = j == 0 ? 0.f : (v ? a.adv_logp[g0 + j] : NEG_INF);
    const float x = v ? a.exit_logp[g0 + j] : NEG_INF;
    xl[k] = loops && x > NEG_INF ? x : -INFINITY;
    eid[j] = e;
    el[j] = v ? a.enter_logp[g0 + j] : NEG_INF;
    cur[j] = !v ? NEG_INF : (din != nullptr ? din[j] : __fadd_rn(a.init_logp[g0 + j], __fmul_rn(llb[e], scale)));
  }
  fetch(t_first);
  fetch(t_first + 1);
  // the first of a thread's exit states with the largest delta + exit_logp,
  // then the warp's into its slot
  float bv = -INFINITY;
  int bi = INT_MAX;
  const auto post = [&](int parity) {
    int key = order_key(bv);
    warp_best(key, bi);
    if (lane == 0) {
      slot_k[parity][warp] = key;
      slot_i[parity][warp] = bi;
    }
    bv = -INFINITY;
    bi = INT_MAX;
  };
  if (loops) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const float c = __fadd_rn(cur[tid + k * nth], xl[k]);
      if (c > bv) {
        bv = c;
        bi = tid + k * nth;
      }
    }
    post((t_first - 1) & 1);  // read by frame t_first
  }
  __syncthreads();

  for (int t = t_first; t < nf; ++t) {
    copy_wait<1>();  // frame t's group is in (frame t + 1's may still be on its way)
    const float* em = ring + (t % 3) * SPT * nth;
    ArgMax ex{-INFINITY, INT_MAX};
    if (loops) {
      const int p = (t - 1) & 1;
      int k2 = lane < n_warps ? slot_k[p][lane] : none, i2 = lane < n_warps ? slot_i[p][lane] : INT_MAX;
      warp_best(k2, i2);
      ex = ArgMax{key_value(k2), i2};
      if (!(ex.v > NEG_INF)) {  // no exit state above NEG_INF: the full argmax (the same in every warp)
        ArgMax x{-INFINITY, INT_MAX};
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const int j = tid + k * nth;
          if (j < J) x = better(x, ArgMax{__fadd_rn(cur[j], __ldg(a.exit_logp + g0 + j)), j});
        }
        ex = block_argmax(x, red_v, red_i);
      }
    }

    float row_max = -INFINITY;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      const float slk = SL_REG ? sl[SL_REG ? k : 0] : (j < J ? __ldg(a.self_logp + g0 + j) : NEG_INF);
      const float stay = __fadd_rn(cur[j], slk);
      const float adv = __fadd_rn(cur[j - 1], al[k]);
      float best;
      int code;
      if (loops) {
        const float ent = __fadd_rn(ex.v, el[j]);
        best = fmaxf(fmaxf(stay, adv), ent);
        code = best == ent ? 2 : (best == adv ? 1 : 0);
      } else {
        best = fmaxf(stay, adv);
        code = best == adv ? 1 : 0;
      }
      if (SKIP) {  // skip_logp through the read-only cache; as 0 for j < 2 (the sentinels give NEG_INF)
        const float skp = __fadd_rn(cur[j - 2], j < 2 ? 0.f : (j < J ? __ldg(a.skip_logp + g0 + j) : NEG_INF));
        if (skp > best) {
          code = 3;
          best = skp;
        }
      }
      if (best == stay) code = 0;
      const float nv = __fadd_rn(best, __fmul_rn(em[j], scale));
      nxt[j] = nv;
      if (BEAM) {
        if (j < J) row_max = fmaxf(row_max, nv);
      } else {
        const float c = __fadd_rn(nv, xl[k]);
        if (c > bv) {
          bv = c;
          bi = j;
        }
      }
      if (bpb != nullptr) {
        const bool v = j < J;
        const unsigned lo = __ballot_sync(FULL, v && (code & 1)), hi = __ballot_sync(FULL, v && (code & 2));
        const int j0 = k * nth + warp * 32;  // the warp's 32-state group
        if (lane == 0 && j0 < J) bpb[(size_t)t * G + (j0 >> 5)] = make_uint2(lo, hi);
      }
    }
    if (BEAM) {
      const float thresh = __fsub_rn(block_max(row_max, red_m), a.beam);
#pragma unroll
      for (int k = 0; k < SPT; ++k) {  // each thread rereads only the states it wrote
        const int j = tid + k * nth;
        const float d = nxt[j] >= thresh ? nxt[j] : NEG_INF;
        nxt[j] = d;
        const float c = __fadd_rn(d, xl[k]);
        if (c > bv) {
          bv = c;
          bi = j;
        }
      }
    }
    if (loops) post(t & 1);
    fetch(t + 2);  // into the slot frame t - 1 used
    if (bpb != nullptr && loops && tid == 0)
      a.exit_arg[(CHUNK ? (size_t)b * a.t_cap + a.frame0[b] : (size_t)b * T) + t] = ex.i;
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if constexpr (CHUNK) {  // delta back for the next chunk
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int j = tid + k * nth;
      if (j < J) a.delta_io[g0 + j] = cur[j];
    }
    return;
  }
  ArgMax fin{-INFINITY, INT_MAX};
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int j = tid + k * nth;
    if (j < J) fin = better(fin, ArgMax{__fadd_rn(cur[j], a.final_logp[g0 + j]), j});
  }
  fin = block_argmax(fin, red_v, red_i);
  if (tid == 0) {
    a.score[b] = fin.v;
    *j_final = fin.i;
  }
}

// The backtrace of row b on one warp, from state j_final at frame nf - 1, over
// the row's codes bpb and exit argmax xb, into path, entered (and pdfs) rows
// of t_out frames.
// A round takes frames t, t-1, ..., t-15: lanes 2d and 2d+1 load frame t-d's
// bit planes of the two 32-state groups that hold [j - 2d, j] (stay, advance
// and skip move back at most 2 states a frame), lane d its exit argmax; the
// frames then resolve from registers by shuffles, and an enter (code 2, to
// the exit argmax) ends the round. The codes were stored by this block, so
// they are read through L2 (ld.global.cg), not the read-only cache. With
// pdfs, each frame's pdf (its state's emit_id) is written beside its state.
__device__ __forceinline__ void backtrace(const Args& a, int b, int nf, int j_final, const uint2* bpb, const int* xb,
                                          int t_out) {
  const int lane = threadIdx.x & 31, G = (a.J + 31) >> 5;
  int* pb = a.path + (size_t)b * t_out;
  uint8_t* eb = a.entered + (size_t)b * t_out;
  int* db = a.pdfs != nullptr ? a.pdfs + (size_t)b * t_out : nullptr;
  const int* ids = a.pdfs != nullptr ? a.emit_id + (size_t)b * a.J : nullptr;
  for (int t = nf + lane; t < t_out; t += 32) {
    pb[t] = -1;
    eb[t] = 0;
    if (db != nullptr) db[t] = -1;
  }
  if (nf == 0) return;
  int j = j_final, t = nf - 1;
  while (t >= 1) {
    const int d = lane >> 1, j0 = j;
    uint2 planes = make_uint2(0u, 0u);
    if (t - d >= 1) planes = __ldcg(bpb + (size_t)(t - d) * G + ((lane & 1) ? j0 >> 5 : max(j0 - 2 * d, 0) >> 5));
    const int ea = (lane < BT_FRAMES && t - lane >= 1) ? __ldcg(xb + t - lane) : 0;
    int my_j = 0, my_e = 0, steps = 0;
    for (int s = 0; s < BT_FRAMES && t - s >= 1; ++s) {
      if (lane == s) my_j = j;
      const int src = 2 * s + ((j >> 5) == (j0 >> 5) ? 1 : 0);
      const unsigned lo = __shfl_sync(FULL, planes.x, src), hi = __shfl_sync(FULL, planes.y, src);
      const int code = ((lo >> (j & 31)) & 1) | (((hi >> (j & 31)) & 1) << 1);
      if (lane == s) my_e = code == 2;
      steps = s + 1;
      if (code == 2) {
        j = __shfl_sync(FULL, ea, s);
        break;
      }
      j -= code == 1 ? 1 : (code == 3 ? 2 : 0);
    }
    if (lane < steps) {
      pb[t - lane] = my_j;
      eb[t - lane] = (uint8_t)my_e;
      if (db != nullptr) db[t - lane] = __ldg(ids + my_j);
    }
    t -= steps;
  }
  if (lane == 0) {
    pb[0] = j;
    eb[0] = 1;
    if (db != nullptr) db[0] = __ldg(ids + j);
  }
}

// One block per utterance. SPT: the word-loop arm's states per thread; C > 0
// compiles the chain arm with C states a lane. Graphs of more than
// CHAIN_MAX_J states (C = 0) run NTH = 512 threads, two blocks an SM (a
// decode batch's 256 rows in one wave on 132 SMs), or 1024: 64 registers a
// thread; narrower ones at most 512 threads (NTH 0: the launch's), with up
// to 128.
template <int SPT, int C, int NTH, bool BEAM, bool SKIP, bool CHUNK>
__global__ void __launch_bounds__(C > 0 ? 512 : 1024, 1) viterbi_kernel(const Args a) {
  extern __shared__ float smem[];  // the word-loop arm's delta, enter_logp, emit_id and emission ring
  __shared__ float red_v[33], red_m[33];
  __shared__ int red_i[33], j_final;
  const int b = blockIdx.x;
  const int nf = max(min(a.n_frames[b], a.T), 0);
  // the chunk arm: a row that has started (or has no frame in this chunk)
  // goes on from its carried delta at frame 0; one that starts here
  // initializes at frame 0 and steps from frame 1, as the offline decode
  const bool from_delta = CHUNK && (a.started_io[b] != 0 || nf == 0);
  const int t_first = from_delta ? 0 : 1;
  const bool loops = row_has_loop(a.enter_logp, a.exit_logp, (size_t)b * a.J, a.J);  // a barrier: started is read
  const size_t bp_row = CHUNK ? (size_t)b * a.t_cap + a.frame0[b] : (size_t)b * a.T;  // the row's frame 0 in bp
  uint2* bpb = a.bp != nullptr ? a.bp + bp_row * ((a.J + 31) >> 5) : nullptr;
  const float* din = from_delta ? a.delta_io + (size_t)b * a.J : nullptr;
  const bool chain = C > 0 && !loops;
  if (threadIdx.x == 0) a.arm[b] = chain ? ARM_CHAIN : (loops ? ARM_LOOP : ARM_BLOCK);
  if constexpr (C > 0) {
    if (chain) chain_arm<C, BEAM, SKIP, CHUNK>(a, b, nf, t_first, din, bpb, red_v, red_i, &j_final);
  }
  if (!chain) loop_arm<SPT, NTH, BEAM, SKIP, CHUNK>(a, b, nf, t_first, din, loops, bpb, smem, red_v, red_i, red_m,
                                                    &j_final);
  if constexpr (CHUNK) {
    if (threadIdx.x == 0 && nf > 0) a.started_io[b] = 1;
    return;
  }
  if (a.path != nullptr) {
    __syncthreads();  // every code of the row is stored
    if (threadIdx.x < 32) backtrace(a, b, nf, j_final, bpb, a.exit_arg + (size_t)b * a.T, a.T);
  }
}

// The backtrace alone, one block per row: the first-index argmax of delta
// (final_logp NULL: a partial result) or of delta + final_logp (the end of
// the stream) gives the score and the last state, then one warp walks the
// row's stored codes from its frame n_frames[b] - 1.
__global__ void __launch_bounds__(256) backtrace_kernel(const Args a, const float* delta, int t_out) {
  __shared__ float red_v[33];
  __shared__ int red_i[33];
  const int b = blockIdx.x, J = a.J;
  const size_t g0 = (size_t)b * J;
  ArgMax x{-INFINITY, INT_MAX};
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    x = better(x, ArgMax{a.final_logp != nullptr ? __fadd_rn(delta[g0 + j], a.final_logp[g0 + j]) : delta[g0 + j], j});
  const ArgMax fin = block_argmax(x, red_v, red_i);
  if (threadIdx.x == 0) a.score[b] = fin.v;
  const int nf = max(min(a.n_frames[b], t_out), 0);
  if (threadIdx.x < 32)
    backtrace(a, b, nf, fin.i, a.bp + (size_t)b * a.t_cap * ((J + 31) >> 5), a.exit_arg + (size_t)b * a.t_cap, t_out);
}

template <int SPT, int C, int NTH, bool CHUNK>
cudaError_t launch_arms(int threads, size_t smem, int B, cudaStream_t stream, const Args& a) {
  const bool beam = a.beam > 0.f, skip = a.skip_logp != nullptr;
  const auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<B, threads, smem, stream>>>(a);
    return cudaGetLastError();
  };
  if (beam)
    return skip ? go(viterbi_kernel<SPT, C, NTH, true, true, CHUNK>)
                : go(viterbi_kernel<SPT, C, NTH, true, false, CHUNK>);
  return skip ? go(viterbi_kernel<SPT, C, NTH, false, true, CHUNK>)
              : go(viterbi_kernel<SPT, C, NTH, false, false, CHUNK>);
}

// The decode's kernels, or the chunk arm's (delta_io set): a template arm, so
// the decode's compile as they did without it.
template <int SPT, int C, int NTH = 0>
cudaError_t launch(int threads, size_t smem, int B, cudaStream_t stream, const Args& a) {
  return a.delta_io != nullptr ? launch_arms<SPT, C, NTH, true>(threads, smem, B, stream, a)
                               : launch_arms<SPT, C, NTH, false>(threads, smem, B, stream, a);
}

// The launch configuration of a batch of B rows of J states, and the launch:
// the word-loop arm's states per thread and block width, the chain arm's
// warps and states per lane.
cudaError_t dispatch(Args a, int B, cudaStream_t st) {
  const int J = a.J;
  if (J <= 0 || J > MAX_SPT * 1024) return cudaErrorInvalidValue;
  // 512 threads keep two blocks on an SM; wider graphs take 1024. Small
  // graphs take one thread per state. The chain arm runs on the first
  // chain_warps warps.
  int threads = J <= MAX_SPT * 512 ? 512 : 1024;
  const int j32 = (J + 31) / 32 * 32;
  if (j32 < threads) threads = j32;
  const int spt = (J + threads - 1) / threads;
  int c = 0;
  a.chain_warps = 0;
  if (J <= CHAIN_MAX_J) {
    a.chain_warps = std::min(CHAIN_MAX_WARPS, (J + 31) / 32);
    c = (J + 32 * a.chain_warps - 1) / (32 * a.chain_warps);
  }
  // the word-loop arm: delta [2, spt * threads + 2], enter_logp, emit_id [spt * threads], emissions [3, spt * threads]
  const size_t smem = (7 * (size_t)spt * threads + 4) * sizeof(float);
  // J <= CHAIN_MAX_J: spt 1 (J <= 512) with c 1 or 2, or spt 2 with c 3 or 4
  // (eight warps); wider graphs: c 0
  if (spt == 1 && c == 1) return launch<1, 1>(threads, smem, B, st, a);
  if (spt == 1 && c == 2) return launch<1, 2>(threads, smem, B, st, a);
  if (spt == 2 && c == 3) return launch<2, 3>(threads, smem, B, st, a);
  if (spt == 2 && c == 4) return launch<2, 4>(threads, smem, B, st, a);
  if (c != 0) return cudaErrorInvalidValue;
  if (threads == 512) {  // CHAIN_MAX_J < J <= 4096
    switch (spt) {
      case 3: return launch<3, 0, 512>(threads, smem, B, st, a);
      case 4: return launch<4, 0, 512>(threads, smem, B, st, a);
      case 5: return launch<5, 0, 512>(threads, smem, B, st, a);
      case 6: return launch<6, 0, 512>(threads, smem, B, st, a);
      case 7: return launch<7, 0, 512>(threads, smem, B, st, a);
      case 8: return launch<8, 0, 512>(threads, smem, B, st, a);
    }
  } else {  // 4096 < J <= 8192
    switch (spt) {
      case 5: return launch<5, 0, 1024>(threads, smem, B, st, a);
      case 6: return launch<6, 0, 1024>(threads, smem, B, st, a);
      case 7: return launch<7, 0, 1024>(threads, smem, B, st, a);
      case 8: return launch<8, 0, 1024>(threads, smem, B, st, a);
    }
  }
  return cudaErrorInvalidValue;
}

Args graph_args(const void* ll, int T, int P, float scale, float beam, const void* emit_id, const void* self_logp,
                const void* adv_logp, const void* enter_logp, const void* exit_logp, const void* init_logp,
                const void* final_logp, const void* skip_logp, const void* n_frames, int J) {
  Args a{};
  a.ll = static_cast<const float*>(ll);
  a.T = T;
  a.P = P;
  a.scale = scale;
  a.beam = beam;
  a.emit_id = static_cast<const int*>(emit_id);
  a.self_logp = static_cast<const float*>(self_logp);
  a.adv_logp = static_cast<const float*>(adv_logp);
  a.enter_logp = static_cast<const float*>(enter_logp);
  a.exit_logp = static_cast<const float*>(exit_logp);
  a.init_logp = static_cast<const float*>(init_logp);
  a.final_logp = static_cast<const float*>(final_logp);
  a.skip_logp = static_cast<const float*>(skip_logp);
  a.n_frames = static_cast<const int*>(n_frames);
  a.J = J;
  a.t_cap = T;
  return a;
}

}  // namespace

extern "C" {

// Forward pass plus backtrace for B utterances. ll [B, T, P] float32; the
// seven graph arrays [B, J] (emit_id int32, the rest float32), and skip_logp
// [B, J] float32 for a graph with CTC skip transitions or NULL; n_frames [B]
// int32. Scratch: bp [B, T, ceil(J / 32)] uint2 (two int32 each), exit_arg
// int32 [B, T]. Outputs: path int32 [B, T], entered uint8/bool [B, T], pdfs
// int32 [B, T] or NULL (the path's pdfs, -1 past n_frames), score float32
// [B], arm int32 [B] (0 chain, 1 word loop, 2 block without a loop arc).
// beam > 0 prunes each frame to [max - beam, max]; 0 is exact. With path ==
// NULL there is no backtrace: bp, exit_arg, entered and pdfs may be NULL,
// and only score and arm are written. J may be at most MAX_SPT * 1024 = 8192
// (cudaErrorInvalidValue otherwise); an emit_id outside [0, P) stops the
// kernel with a trap, as an out-of-range index stops torch.gather on the
// device.
int viterbi_decode(const void* ll, int B, int T, int P, float scale, float beam, const void* emit_id,
                   const void* self_logp, const void* adv_logp, const void* enter_logp, const void* exit_logp,
                   const void* init_logp, const void* final_logp, const void* skip_logp, const void* n_frames,
                   int J, void* bp, void* exit_arg, void* path, void* entered, void* pdfs, void* score,
                   void* arm, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  Args a = graph_args(ll, T, P, scale, beam, emit_id, self_logp, adv_logp, enter_logp, exit_logp, init_logp,
                      final_logp, skip_logp, n_frames, J);
  if (path != nullptr) {
    a.bp = static_cast<uint2*>(bp);
    a.exit_arg = static_cast<int*>(exit_arg);
    a.path = static_cast<int*>(path);
    a.entered = static_cast<uint8_t*>(entered);
    a.pdfs = static_cast<int*>(pdfs);
  }
  a.score = static_cast<float*>(score);
  a.arm = static_cast<int*>(arm);
  return dispatch(a, B, static_cast<cudaStream_t>(stream));
}

// The online decoder's chunk step for B streams: ll [B, Tc, P] float32 (this
// chunk's scores), the graph arrays as viterbi_decode's, n_valid [B] int32
// (valid frames of the chunk, a prefix), delta [B, J] float32 and started
// [B] uint8/bool carried in and out (in place). Each frame's code planes go
// to bp [B, t_cap, ceil(J / 32)] uint2 and the exit argmax of a word-loop
// row to exit_arg [B, t_cap] int32, at frames frame0[b] .. frame0[b] +
// n_valid[b] - 1 of row b (frame0 [B] int32 on the device: each stream's
// own offset); frames past n_valid are not written, nor is the frame a row
// starts at (the backtrace never reads its code). The caller keeps every
// frame0[b] + n_valid[b] within [0, t_cap]: it holds both on the host, and
// reading them back here would cost a synchronisation. arm [B] as
// viterbi_decode's.
int viterbi_chunk(const void* ll, int B, int Tc, int P, float scale, float beam, const void* emit_id,
                  const void* self_logp, const void* adv_logp, const void* enter_logp, const void* exit_logp,
                  const void* init_logp, const void* final_logp, const void* skip_logp, const void* n_valid, int J,
                  void* delta, void* started, void* bp, void* exit_arg, const void* frame0, int t_cap, void* arm,
                  void* stream) {
  if (B <= 0 || Tc <= 0) return cudaSuccess;
  if (frame0 == nullptr || t_cap <= 0) return cudaErrorInvalidValue;
  Args a = graph_args(ll, Tc, P, scale, beam, emit_id, self_logp, adv_logp, enter_logp, exit_logp, init_logp,
                      final_logp, skip_logp, n_valid, J);
  a.bp = static_cast<uint2*>(bp);
  a.exit_arg = static_cast<int*>(exit_arg);
  a.t_cap = t_cap;
  a.frame0 = static_cast<const int*>(frame0);
  a.delta_io = static_cast<float*>(delta);
  a.started_io = static_cast<uint8_t*>(started);
  a.arm = static_cast<int*>(arm);
  return dispatch(a, B, static_cast<cudaStream_t>(stream));
}

// The backtrace alone, over viterbi_chunk's buffers: for each of B streams
// the first-index argmax of delta [B, J] (final_logp NULL) or of delta +
// final_logp [B, J], its value into score [B] float32, then the path from
// frame n_frames[b] - 1 (int32 [B], the stream's frames so far) back to 0
// over bp [B, t_cap, ceil(J / 32)] and exit_arg [B, t_cap], into path int32
// and entered uint8/bool [B, t_out] (-1 and 0 past n_frames).
int viterbi_backtrace(int B, int J, const void* delta, const void* final_logp, const void* n_frames, const void* bp,
                      const void* exit_arg, int t_cap, int t_out, void* path, void* entered, void* score,
                      void* stream) {
  if (B <= 0) return cudaSuccess;
  if (J <= 0 || t_out < 0 || t_out > t_cap) return cudaErrorInvalidValue;
  Args a{};
  a.J = J;
  a.final_logp = static_cast<const float*>(final_logp);
  a.n_frames = static_cast<const int*>(n_frames);
  a.bp = static_cast<uint2*>(const_cast<void*>(bp));
  a.exit_arg = static_cast<int*>(const_cast<void*>(exit_arg));
  a.t_cap = t_cap;
  a.path = static_cast<int*>(path);
  a.entered = static_cast<uint8_t*>(entered);
  a.score = static_cast<float*>(score);
  backtrace_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, static_cast<const float*>(delta), t_out);
  return cudaGetLastError();
}

const char* viterbi_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"

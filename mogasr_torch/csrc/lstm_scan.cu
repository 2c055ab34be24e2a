// The recurrence of one LSTM layer for Hopper (sm_90a): one persistent launch
// of thread-block clusters per block of up to 64 batch rows.
//
// Replaces mogasr/am/lstm_pallas.py::_lstm_scan_kernel (driven by
// lstm_layer_pallas). Given the prefused input projection xg [B, T, 4H]
// (x @ W_in + bias, computed outside), the recurrent weight W_rec [H, 4H]
// (gate blocks i, f, g, o: flax's OptimizedLSTMCell order) and n_frames [B],
// it runs, from zero carries, for t = 0 .. T-1:
//
//     gates = xg[:, t] + h @ W_rec                 (float32 accumulation)
//     i, f, o = sigmoid(gates_i, gates_f, gates_o); g = tanh(gates_g)
//     c' = f * c + i * g;  h' = o * tanh(c')
//     (c, h) = t < n_frames ? (c', h') : (c, h);  out[:, t] = h
//
// so each row's carries freeze at its n_frames and a row with n_frames = 0
// outputs zeros. In bfloat16 mode W_rec and h are rounded to bf16 before
// the product, which runs on the tensor cores (wgmma, float32 accumulation);
// the tensor cores truncate their float32 sums, so this arm is not the
// plain version's float32 rounding but stays within K4_ATOL["bfloat16"] of
// it. The gates and the carries stay float32. The float32 arm runs float32
// FMA on the CUDA cores: a truncating sum would bias h the same way frame
// after frame.
//
// What bounds it. Per layer the work is 2 * H * 4H operations per valid
// frame (37.8 GFLOP for the 18,004 valid frames of the hybrid path's widest
// batch at H = 512: 0.56 ms at 67 TFLOP/s in float32) over the valid frames'
// xg and all of out (0.12 ms at 3.35 TB/s); but it is a chain of dependent
// frames, each needing h_{t-1} of its rows from every unit. Per frame the
// cost is the exchange of h across the card, a barrier and a short product
// (PERF.md has the measured split of the earlier design). The design cuts
// each:
//
//   - Live rows only. The wrapper orders the rows by n_frames, longest first
//     (perm; xg and out are read and written through it, never copied). Row
//     block rb of a launch takes rows rb, rb + NRB, ... of the order, so the
//     rows it has live at a frame are a prefix of it, thinning out as the
//     batch's do; it runs to its own longest row, and a frame works only its
//     live rows (in 8-row groups, and in the float32 product 2-row steps). After the
//     loop each row's frozen h fills its frames from n_frames to T.
//   - CTA (row block rb, unit block ub) owns 16 rows and U = 16 units (8 for
//     float32 past H = 512), the four gate columns of each; its slice of
//     W_rec stays in shared memory for all frames (128 KiB in float32 at
//     H = 512). Rows are independent, so the row blocks never wait for each
//     other: a frame's exchange and barrier span the CTAs of one row block
//     (32 at H = 512), and each needs 16 rows of h (32 KiB), not all 64.
//   - h_{t-1} reaches the CTAs of a row block by cluster (16 CTAs, or 8, 4,
//     2: the largest whose whole grid the card holds at once): h is written
//     to a double-buffered global buffer, in NK column chunks of 8-row
//     pieces laid out as the shared-memory image the product reads, and
//     each chunk is fetched from L2 once per cluster, by one CTA of it, with
//     a bulk copy multicast to all (cp.async.bulk ... .multicast::cluster).
//     Each chunk completes an mbarrier of its own, so the float32 product
//     starts on chunk 0 while the rest are in flight.
//   - The sync per frame: after a CTA barrier one thread per CTA adds to the
//     row block's counter in global memory (release), waits for the count of
//     all the row block's CTAs (acquire), fences the async proxy and issues
//     its share of the copies. Every CTA must be resident: the launch raises
//     cudaErrorCooperativeLaunchTooLarge unless cudaOccupancyMaxActiveClusters
//     admits the whole grid. A wait that outlasts a few seconds traps.
//   - The product: float32, register tiles of 8 rows (2, 4 or 6 while no
//     more of them are live) x 8 gate columns per lane, 16 lanes splitting k, a
//     reduce-scatter by shuffles (F32_V);
//     bfloat16, one warpgroup issuing wgmma m64n16k16 of the transposed
//     product (M = the 4U = 64 gate columns, A = the W_rec slice; N = the 16
//     rows, B = h; K = H), both in wgmma's no-swizzle K-major image, then a
//     shuffle gives each thread all four gates of its unit. Either way every
//     thread then owns a unit of one or two rows and their carries.
//
// The carry arm (h0 != NULL) is the step of mogasr/am/neural.py's
// LstmAmStream, flax's nn.RNN with initial_carry and return_carry: the
// recurrence starts from the carries (h0, c0) [B, H] of each row (through
// perm, as xg and out), so frame 0 has a product too, with h0's image sent
// around the row block by one more exchange before it; and each row's
// carries at its n_frames go to (h_out, c_out), those of a row with no frame
// copied through unchanged. The carries stay float32; in bf16 h is rounded
// for the product only.
//
// No fast math: expf and tanhf are the accurate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gmm_tc.cuh"  // smem_addr, mbar_init, mbar_expect_tx, make_desc

namespace {

using gmm_tc::make_desc;
using gmm_tc::mbar_expect_tx;
using gmm_tc::mbar_init;
using gmm_tc::smem_addr;

constexpr int NK = 4;           // column chunks of h, one mbarrier each
constexpr int RBLK = 16;        // rows per CTA: a row block
constexpr int MAX_RB = 4;       // row blocks per launch: 64 rows
constexpr int MAX_CTAS = 128;   // CTAs per launch at most
constexpr int TC_U = 16;        // bf16: units per CTA, M = 4 TC_U = 64 gate columns
constexpr int BAR_BYTES = 128;  // shared memory before the h image: the mbarriers
constexpr int CTR_STRIDE = 32;  // counters 128 bytes apart
constexpr size_t SMEM_LIMIT = 232448;
constexpr long long PATIENCE = 1ll << 33;  // cycles (~4 s) before a wait traps

struct Args {
  const float* xg;      // [B, T, 4H]
  const void* w;        // [H, 4H] float32 or bf16
  const int* perm;      // this launch's rows, longest first: original row indices
  const int* nfs;       // their n_frames, non-increasing
  float* out;           // [B, T, H]
  char* hbuf;           // per row block two frame buffers of the h image
  unsigned* counters;   // per row block a frame counter, zero, CTR_STRIDE apart
  size_t hstride;       // bytes between frame buffers
  int T, H, KC, NUB, n_rows, b0;  // NUB: CTAs (unit blocks) per row block
  const float* h0;      // [B, H] initial carries, or NULL: zero, no carry out
  const float* c0;      // [B, H]
  float* h_out;         // [B, H] the carries at each row's n_frames
  float* c_out;         // [B, H]
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > PATIENCE) __trap();
  }
}

// One bulk copy global -> the same shared offset in every CTA of the cluster,
// completing `bytes` on each one's mbarrier at that offset.
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask) : "memory");
}

// d (+)= A[64, 16] . B[16, 16]^T, bf16 operands, float32 accumulators.
__device__ __forceinline__ void wgmma_m64n16(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_acc(float (&d)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Element (m, k) of a no-swizzle K-major image with K columns: 8 x 8 core
// matrices, adjacent along K 128 bytes apart, 8-row groups 16 * K bytes apart.
__device__ __forceinline__ int image_at(int m, int k, int K) {
  return (((m >> 3) * (K >> 3) + (k >> 3)) << 6) + ((m & 7) << 3) + (k & 7);
}

// The h image of a row block (global frame buffer and shared memory alike):
// NK chunks of 16 rows x KC columns; each 8-row piece of a chunk is
// contiguous. float32: row-major with a row stride of KC + 4 floats (rows 16
// bytes apart in the banks); bf16: wgmma's image of [16, KC].
template <bool BF16> struct HImage {
  int KC;
  __device__ int row_bytes() const { return BF16 ? KC * 2 : (KC + 4) * 4; }
  __device__ int piece_bytes() const { return 8 * row_bytes(); }
  __device__ int chunk_bytes() const { return RBLK * row_bytes(); }
  // element offset of h[m, k]
  __device__ int at(int m, int k) const {
    const int kc = k / KC, kk = k - kc * KC;
    return BF16 ? kc * RBLK * KC + image_at(m, kk, KC) : (kc * RBLK + m) * (KC + 4) + kk;
  }
};

// The bf16 arm's A image, the W_rec slice: row m is gate 2 (m & 1) +
// ((m >> 3) & 1) of unit 4 (m >> 4) + (m & 7) / 2, so that wgmma's fragment
// gives lanes L and L ^ 4 the four gates of one unit.
__device__ __forceinline__ int tc_unit(int m) { return 4 * (m >> 4) + (m & 7) / 2; }
__device__ __forceinline__ int tc_gate(int m) { return 2 * (m & 1) + ((m >> 3) & 1); }

// float32 product: items of 8 rows x 8 gate columns (a unit pair, unit-major
// columns 4 v + gate), one per 16 lanes; the lanes split k into 4-wide quads
// (lane kg takes quads kg, kg + 16, ...), each lane's partial sums an 8 x 8
// register tile fed by float4 shared-memory loads (1 byte loaded per FMA,
// where a float4 load per 4 FMAs bound the earlier product by shared
// memory), only its first 2, 4 or 6 rows while no more of them are live. A
// reduce-scatter over the 16 lanes (4 rounds of shuffles, each halving the
// values a lane keeps) leaves lane l the four gates of row l / 2, unit
// l % 2 of the item.
constexpr int F32_V = 64;

// One round of the reduce-scatter: the lane with bit m keeps the upper HALF
// of its first 2 HALF values, its partner (lane ^ m) the lower, each adding
// the other's copy of the half it keeps.
template <int HALF>
__device__ __forceinline__ void reduce_round(float (&v)[F32_V], int m, int lane) {
  const bool upper = lane & m;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? v[j] : v[j + HALF], keep = upper ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// One chunk's product for the first ROWS rows of an item: v[8 i + col] +=
// h[i, k] w[col, k] over the lane's quads of the chunk.
template <int ROWS>
__device__ __forceinline__ void f32_chunk(float (&v)[F32_V], const float* hq, const float* wq, int Q, int hstr,
                                          int wstr, int lane16) {
  for (int q = lane16; q < Q; q += 16) {
    float4 wv[8];
#pragma unroll
    for (int col = 0; col < 8; ++col) wv[col] = *reinterpret_cast<const float4*>(wq + col * wstr + 4 * q);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float4 hv = *reinterpret_cast<const float4*>(hq + i * hstr + 4 * q);
#pragma unroll
      for (int col = 0; col < 8; ++col) {
        float& x = v[8 * i + col];
        x = fmaf(hv.x, wv[col].x, x);
        x = fmaf(hv.y, wv[col].y, x);
        x = fmaf(hv.z, wv[col].z, x);
        x = fmaf(hv.w, wv[col].w, x);
      }
    }
  }
}

// Threads of the worker warps (the product and the gates), then one warp
// whose first thread runs the frame counter and issues the copies.
template <bool BF16, int U> constexpr int WORKERS = BF16 ? 128 : 16 * U;

template <bool BF16, int U, int STEPS>
__global__ void __launch_bounds__(WORKERS<BF16, U> + 32, 1) lstm_scan_kernel(const Args a) {
  constexpr int N = 4 * U, R = BF16 ? 2 : 1;  // R: rows per thread
  constexpr int PRODUCER = WORKERS<BF16, U>;
  using Elem = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const HImage<BF16> img{a.KC};
  Elem* hs = reinterpret_cast<Elem*>(smem + BAR_BYTES);
  Elem* ws = reinterpret_cast<Elem*>(smem + BAR_BYTES + NK * img.chunk_bytes());
  const int H = a.H, T = a.T, KC = a.KC, HP = NK * KC;
  const size_t H4 = 4 * (size_t)H;
  const int tid = threadIdx.x, lane = tid % 32;
  // Row block rb takes every NRB-th row of the launch's order from rb on, so
  // the blocks' lengths decay alike; its own rows stay longest first.
  const int NRB = gridDim.x / a.NUB, rb = blockIdx.x / a.NUB, u0 = (blockIdx.x % a.NUB) * U;
  const int rows = max(0, min(RBLK, (a.n_rows - rb + NRB - 1) / NRB));  // this row block's rows
  const unsigned rank = cluster_rank(), cs = cluster_size();
  char* hbuf = a.hbuf + (size_t)rb * 2 * a.hstride;
  unsigned* counter = a.counters + rb * CTR_STRIDE;

  // W_rec's slice: bf16 the A image (tc_unit, tc_gate), float32 row-major
  // [N gate columns (n = 4 unit + gate), HP].
  for (int i = tid; i < N * HP; i += blockDim.x) {
    const int n = i / HP, k = i % HP;
    const int ul = BF16 ? tc_unit(n) : n / 4, g = BF16 ? tc_gate(n) : n % 4, u = u0 + ul;
    const bool in = k < H && u < H;
    const size_t at = (size_t)k * H4 + (size_t)g * H + u;
    if constexpr (BF16)
      ws[image_at(n, k, HP)] = in ? static_cast<const __nv_bfloat16*>(a.w)[at] : __float2bfloat16(0.f);
    else
      ws[i] = in ? static_cast<const float*>(a.w)[at] : 0.f;
  }
  if (BF16) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  if (tid == 0) {
    for (int kc = 0; kc < NK; ++kc) mbar_init(&bars[kc], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's mbarriers exist before any copy reaches them

  // This thread's unit and rows (within the row block). bf16: lanes L and
  // L ^ 4 hold one unit's gates for rows 2q, 2q + 1 and 8 + 2q, 9 + 2q
  // (q = lane % 4); they keep the first pair and the second. float32: item
  // (row group rg, unit pair up), lane l16 keeps row 8 rg + l16 / 2 of unit
  // 2 up + l16 % 2.
  const int l16 = lane % 16, item = tid / 16, rg = item / (U / 2), up = item % (U / 2);
  const bool odd = (lane >> 2) & 1;
  int row[R];
  int ul;
  if constexpr (BF16) {
    ul = 4 * (tid / 32) + (lane / 4) / 2;
    row[0] = (odd ? 8 : 0) + 2 * (lane % 4);
    row[1] = row[0] + 1;
  } else {
    ul = 2 * up + (l16 & 1);
    row[0] = 8 * rg + (l16 >> 1);
  }
  const int u = u0 + ul;
  const bool mine = tid < PRODUCER && u < H;
  int orig[R], nf[R], h_at[R];
  float c[R], h[R], xv[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = row[r] < rows;
    orig[r] = in ? a.perm[row[r] * NRB + rb] : 0;
    nf[r] = in ? min(max(a.nfs[row[r] * NRB + rb], 0), T) : 0;
    h_at[r] = img.at(row[r], u);  // where h[row, u] goes in the h image
    const size_t at = (size_t)orig[r] * H + u;
    c[r] = a.h0 != nullptr && mine && in ? a.c0[at] : 0.f;
    h[r] = a.h0 != nullptr && mine && in ? a.h0[at] : 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xv[r][g] = mine && nf[r] > 0 ? a.xg[(size_t)orig[r] * T * H4 + g * (size_t)H + u] : 0.f;
  }
  const int t_end = rows > 0 ? min(max(a.nfs[rb], 0), T) : 0;  // the row block's longest row
  // The row block's rows live at frame t, counted down from m, which are
  // at least as many.
  auto live_after = [&](int t, int m) {
    while (m > 0 && a.nfs[(m - 1) * NRB + rb] <= t) --m;
    return m;
  };

  // After a CTA barrier (this CTA's h written to its frame buffer src, and
  // its reads of the previous h done), the producer thread adds to the row
  // block's counter (release), waits for all its CTAs' count (acquire),
  // fences the async proxy and issues its share of the copies of the first
  // n_live rows' h image to the cluster.
  auto exchange = [&](const char* src, unsigned target, int n_live) {
    __syncthreads();
    if (tid == PRODUCER) {  // no writes of its own to wait for before the proxy fence
      // the release orders the CTA's h writes, acquired through the CTA
      // barrier, before the count; once every CTA of the row block has
      // counted, none reads its copy of the previous h any more
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" :: "l"(counter) : "memory");
      const long long t0 = clock64();
      for (;;) {
        unsigned v;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
        if (v >= target) break;
        if (clock64() - t0 > PATIENCE) __trap();
      }
      asm volatile("fence.proxy.async;\n" ::: "memory");  // the generic writes of h, before the bulk reads
      // the live rows' 8-row groups of a chunk are contiguous: each chunk
      // goes as `parts` copies of whole groups, spread over the cluster
      const int groups = (n_live + 7) / 8, parts = min(max((int)cs / NK, 1), groups);
      const uint32_t piece = img.piece_bytes();
      for (int kc = 0; kc < NK; ++kc) mbar_expect_tx(&bars[kc], groups * piece);
      const uint16_t mask = (uint16_t)((1u << cs) - 1);
      for (int p = (int)rank; p < NK * parts; p += (int)cs) {
        const int kc = p / parts, g0 = groups * (p % parts) / parts, g1 = groups * (p % parts + 1) / parts;
        const int off = kc * img.chunk_bytes() + g0 * piece;
        bulk_multicast(reinterpret_cast<char*>(hs) + off, src + off, (g1 - g0) * piece, &bars[kc], mask);
      }
    }
    __syncwarp();
  };

  int n = live_after(0, rows);
  // the carry arm: h0 of the rows live at frame 0 is h_{-1}, in frame buffer 1
  const int ph = a.h0 != nullptr ? 1 : 0;
  if (ph && t_end > 0) {
    Elem* hprev = reinterpret_cast<Elem*>(hbuf + a.hstride);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!mine || row[r] >= n) continue;
      if constexpr (BF16)
        hprev[h_at[r]] = __float2bfloat16_rn(h[r]);
      else
        __stcg(hprev + h_at[r], h[r]);
    }
    exchange(hbuf + a.hstride, a.NUB, n);
  }
  for (int t = 0; t < t_end; ++t) {
    const bool more = t + 1 < t_end;
    const int n_next = more ? live_after(t + 1, n) : 0;
    float acc[R][4] = {};
    if ((t > 0 || ph) && tid < PRODUCER) {  // without carries h_{-1} = 0: frame 0 has no product
      const uint32_t parity = (t - 1 + ph) & 1;
      if constexpr (BF16) {
        for (int kc = 0; kc < NK; ++kc) mbar_wait(&bars[kc], parity);
        float d[8] = {};
        const uint32_t sw = smem_addr(ws), sh = smem_addr(hs);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kc = 0; kc < NK; ++kc)
#pragma unroll
          for (int s = 0; s < STEPS; ++s)
            wgmma_m64n16(d, make_desc(sw + 256u * (kc * STEPS + s), 128, 16 * HP),
                         make_desc(sh + kc * img.chunk_bytes() + 256u * s, 128, 16 * KC), kc > 0 || s > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(d);
        // d[4 a + 2 hh + e] is gate 2 (lane / 4 % 2) + hh of unit ul for row
        // 8 a + 2 (lane % 4) + e: the even lane of the pair keeps rows a = 0
        // and gets gates 2, 3 from the odd one, which keeps a = 1.
        float recv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) recv[k] = __shfl_xor_sync(0xffffffffu, odd ? d[k] : d[4 + k], 4);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[e][0] = odd ? recv[e] : d[e];
          acc[e][1] = odd ? recv[2 + e] : d[2 + e];
          acc[e][2] = odd ? d[4 + e] : recv[e];
          acc[e][3] = odd ? d[6 + e] : recv[2 + e];
        }
      } else if (8 * rg < n) {  // the whole warp's rows: skipped when none is live
        float v[F32_V] = {};  // v[8 i + col]: row 8 rg + i, gate column 8 up + col
        const int live = n - 8 * rg;  // the item's live rows
        for (int kc = 0; kc < NK; ++kc) {
          mbar_wait(&bars[kc], parity);
          const float* hq = hs + (kc * RBLK + 8 * rg) * (KC + 4);
          const float* wq = ws + (8 * up) * HP + kc * KC;
          switch ((min(live, 8) + 1) / 2) {  // the live rows, rounded up to even
            case 1: f32_chunk<2>(v, hq, wq, KC / 4, KC + 4, HP, l16); break;
            case 2: f32_chunk<4>(v, hq, wq, KC / 4, KC + 4, HP, l16); break;
            case 3: f32_chunk<6>(v, hq, wq, KC / 4, KC + 4, HP, l16); break;
            default: f32_chunk<8>(v, hq, wq, KC / 4, KC + 4, HP, l16);
          }
        }
        reduce_round<32>(v, 8, l16);
        reduce_round<16>(v, 4, l16);
        reduce_round<8>(v, 2, l16);
        reduce_round<4>(v, 1, l16);
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[0][g] = v[g];
      }
    }
    // the gates, the carries, h_t into the next frame's image and out
    Elem* hnext = reinterpret_cast<Elem*>(hbuf + (size_t)(t & 1) * a.hstride);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!mine || row[r] >= n) continue;
      const float gi = sigmoid(xv[r][0] + acc[r][0]), gf = sigmoid(xv[r][1] + acc[r][1]);
      const float gg = tanhf(xv[r][2] + acc[r][2]), go = sigmoid(xv[r][3] + acc[r][3]);
      c[r] = gf * c[r] + gi * gg;
      h[r] = go * tanhf(c[r]);
      a.out[((size_t)orig[r] * T + t) * H + u] = h[r];
      if (more && t + 1 < nf[r]) {
        if constexpr (BF16)
          hnext[h_at[r]] = __float2bfloat16_rn(h[r]);
        else
          __stcg(hnext + h_at[r], h[r]);
        const size_t at = ((size_t)orig[r] * T + t + 1) * H4 + u;  // the next frame's inputs, before the wait
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[r][g] = a.xg[at + g * (size_t)H];
      }
    }
    if (!more) break;
    // h_t of this CTA is written and its threads are done reading h_{t-1}
    exchange(hbuf + (size_t)(t & 1) * a.hstride, a.NUB * (unsigned)(t + 1 + ph), n_next);
    n = n_next;
  }
  // frames n_frames .. T-1 of each row repeat its frozen h (h0, or zeros,
  // for none); the carry arm writes each row's carries, a row without
  // frames its h0 and c0
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!mine || row[r] >= rows) continue;
    float* o = a.out + (size_t)orig[r] * T * H + u;
    for (int t = nf[r]; t < T; ++t) o[(size_t)t * H] = h[r];
    if (a.h_out != nullptr) {
      a.h_out[(size_t)orig[r] * H + u] = h[r];
      a.c_out[(size_t)orig[r] * H + u] = c[r];
    }
  }
  cluster_sync();  // no CTA leaves while its cluster may still address it
}

using KernelFn = void (*)(const Args);

// bf16: STEPS k-steps of 16 per chunk.
KernelFn bf16_kernel(int steps) {
  switch (steps) {
    case 1: return lstm_scan_kernel<true, TC_U, 1>;
    case 2: return lstm_scan_kernel<true, TC_U, 2>;
    case 4: return lstm_scan_kernel<true, TC_U, 4>;
    case 8: return lstm_scan_kernel<true, TC_U, 8>;
    case 16: return lstm_scan_kernel<true, TC_U, 16>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// xg [B, T, 4H] float32, w [H, 4H] (dtype: 0 = float32, 1 = bfloat16),
// perm [B] int32 (rows by n_frames, longest first), nfs [B] int32 (their
// n_frames, non-increasing; taken as clamped to [0, T]), out [B, T, H]
// float32; ws a zero-filled scratch of
// ws_bytes: per row block two frame buffers of the h image (at most
// 2 * 64 * (2H + 144) floats in all) and CTR_STRIDE uints of counter per 16
// rows (and 4 more). Launches on `stream`, in blocks of at most 64 rows of
// the order, one launch each. info[0] += the launches; info[1], info[2],
// info[3] = the cluster size, the CTAs and the rows of a launch.
//
// h0, c0 [B, H] float32 (or NULL: zero carries, and no carry out): the
// carries each row starts from; h_out, c_out [B, H] float32 (with h0): its
// carries at n_frames.
int lstm_scan(const void* xg, const void* w, const void* perm, const void* nfs, void* out,
              void* ws, long long ws_bytes, int B, int T, int H, int dtype, const void* h0, const void* c0,
              void* h_out, void* c_out, void* stream, int* info) {
  if (B <= 0 || T <= 0 || H <= 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  const int U = bf16 || H <= 512 ? 16 : 8;
  const int quarter = (H + NK - 1) / NK;
  int KC = (quarter + 3) / 4 * 4, steps = 0;
  if (bf16) {
    for (steps = 1; 16 * steps < quarter;) steps *= 2;
    KC = 16 * steps;
  }
  const int HP = NK * KC;
  const size_t row_bytes = bf16 ? KC * 2 : (KC + 4) * 4;
  const size_t hstride = NK * RBLK * row_bytes;
  const size_t smem = BAR_BYTES + hstride + (size_t)HP * 4 * U * (bf16 ? 2 : 4);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const KernelFn kernel = bf16 ? bf16_kernel(steps)
                               : U == 16 ? lstm_scan_kernel<false, 16, 0> : lstm_scan_kernel<false, 8, 0>;
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3((bf16 ? 128 : 16 * U) + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // The most row blocks per launch, then the largest cluster, whose whole
  // grid is resident at once.
  const int units = (H + U - 1) / U, want_rb = (B + RBLK - 1) / RBLK;
  int cs = 0, NUB = 0, NRB = 0;
  for (int nrb = want_rb < MAX_RB ? want_rb : MAX_RB; nrb >= 1 && cs == 0; --nrb) {
    for (int c = 16; c >= 2; c /= 2) {
      const int nub = (units + c - 1) / c * c;
      if (nub * nrb > MAX_CTAS && nrb > 1) continue;
      attr[0].val.clusterDim.x = c;
      cfg.gridDim = dim3(nub * nrb);
      int n_fit = 0;
      e = cudaOccupancyMaxActiveClusters(&n_fit, (const void*)kernel, &cfg);
      if (e != cudaSuccess) {
        cudaGetLastError();  // a cluster size the card refuses: try the next
        continue;
      }
      if ((long long)n_fit * c >= (long long)nub * nrb) {
        cs = c;
        NUB = nub;
        NRB = nrb;
        break;
      }
    }
  }
  if (cs == 0) return cudaErrorCooperativeLaunchTooLarge;
  attr[0].val.clusterDim.x = cs;
  cfg.gridDim = dim3(NUB * NRB);
  const int rows = RBLK * NRB, n_launches = (B + rows - 1) / rows;
  if ((size_t)ws_bytes < 2 * hstride * NRB + (size_t)n_launches * NRB * CTR_STRIDE * sizeof(unsigned))
    return cudaErrorInvalidValue;

  char* hbuf = static_cast<char*>(ws);
  unsigned* counters = reinterpret_cast<unsigned*>(hbuf + 2 * hstride * NRB);
  for (int l = 0; l < n_launches; ++l) {
    const int b0 = l * rows;
    Args args{static_cast<const float*>(xg), w, static_cast<const int*>(perm) + b0,
              static_cast<const int*>(nfs) + b0, static_cast<float*>(out),
              hbuf, counters + (size_t)l * NRB * CTR_STRIDE, hstride, T, H, KC, NUB,
              B - b0 < rows ? B - b0 : rows, b0, static_cast<const float*>(h0), static_cast<const float*>(c0),
              static_cast<float*>(h_out), static_cast<float*>(c_out)};
    void* params[] = {&args};
    e = cudaLaunchKernelExC(&cfg, (const void*)kernel, params);
    if (e != cudaSuccess) return e;
    ++info[0];
  }
  info[1] = cs;
  info[2] = NUB * NRB;
  info[3] = rows;
  return cudaGetLastError();
}

const char* lstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

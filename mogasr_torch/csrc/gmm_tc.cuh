// The shared core of the fused diagonal-GMM scorer for Hopper (sm_90a): K1
// (csrc/gmm_score.cu), K1w (csrc/gmm_wide.cu) and K5 (the int8 entry point
// in csrc/gmm_score.cu) are this one kernel.
//
// Replaces the arithmetic of mogasr/am/gmm_pallas.py::_gmm_kernel (:154),
// ::_gmm_kernel_wide (:107) and ::_gmm_kernel_int8 (:48). For every frame n
// and state s
//
//     out[n, s] = fold_k ( x2[n, :] . ab[k, :, s] + c[k, s] )
//
// with x2 = [x*x, x] (R = 2D columns), ab the natural parameters, c the
// Gaussian constant and fold the max (mode "max") or an online logsumexp
// (mode "sum"). Only out [N, S] float32 is written: [N, S*K] never exists.
// The int8 route (K5, sum mode only) takes x2 and ab quantized symmetrically
// (qx [N, Rp] per frame row with scale sx [N], qab per (component, state)
// column with scale sab [K, S]) and dequantizes each int32 product in the
// plain version's order, each op rounded alone:
//
//     score = (float(qx[n, :] . qab[k, :, s]) * sx[n]) * sab[k, s] + c[k, s]
//
// What bounds it on an H100 SXM (decode batch N = 153,600, S = 1168, K = 16,
// R = 78): the products, 2*N*S*K*R = 0.45 TFLOP: 0.45 ms for bf16 products
// at 989 TFLOP/s, 2.7 ms were they three TF32 products at 495 TFLOP/s, 6.7 ms
// as float32 FMA on the CUDA cores at 67 TFLOP/s; in sum mode the N*S*K =
// 2.9e9 exps of the logsumexp at the SFU rate (16 per SM and clock, ~0.7
// ms); the output, N*S*4 bytes, 0.21 ms at 3.35 TB/s.
//
// What the design does about it:
// - One block owns TM = 128 frames x TS = 64 states and walks the K
//   components in an inner loop. Each component is, per consumer warpgroup,
//   a [64, Rp] x [Rp, 64] product into float32 registers, then the epilogue
//   in registers: + c[k, s] in float32 (kept out of the product: a bf16 c
//   would keep 8 bits of it), then the running max or the online logsumexp.
// - The R = 2D rows are cut into n_chunks(D) equal chunks of RC rows, RC a
//   multiple of 16 and at most 128 (one chunk of 80 at D = 39; two of 128 at
//   D = 120, fbank with deltas), the padding rows zero; Rp = n_chunks * RC.
//   A product is one step per chunk, accumulated in the same registers, so
//   any D runs: the kernel is templated on RC, and on whether there is one
//   chunk. The frame tile holds all chunks when they fit in shared memory
//   beside two stages (D up to 144 in float32, about 390 in bf16); otherwise
//   each warpgroup restages its one chunk of x2 from x before each step.
// - bf16 arms: on the tensor cores, wgmma m64n64k16 bf16 with float32
//   accumulation, Rp/16 steps; a bf16 x bf16 product is exact in float32.
// - int8 (K5): on the tensor cores, wgmma m64n64k32 s8 x s8 with int32
//   accumulation, chunks of a multiple of 32 rows (one chunk of 96 at D =
//   39), Rp/32 steps; the zero rows add nothing, so every int32 sum is exact
//   in any order. The wrapper quantizes x2 (PyTorch, bitwise the plain
//   version's) into qx [N, Rp]; each warpgroup stages its 64 rows of qx into
//   the K-major image with 16-byte copies. The products are exact, so the
//   kernel differs from the plain int8 scorer only in the logsumexp's order.
//   Two consumer warpgroups of 64 frames take turns to issue their products
//   (ping-pong, two named barriers): while one runs its epilogue, the
//   other's wgmma runs.
// - float32 arms: float32 FMA on the CUDA cores, each thread an 8-frame x
//   4-state register tile fed by 16-byte shared-memory loads, summed over r
//   in order. 3xTF32 wgmma (hi = rna_tf32(v), lo = rna_tf32(v - hi), lo.hi +
//   hi.lo + hi.hi) was built and measured on the card first: the tensor
//   cores' float32 accumulation truncates, and the bias it leaves in the
//   scores (up to 6e-4 of loglik, the same sign for a state across frames)
//   moved the Baum-Welch occupancies by 2.5e-4 to 4.0e-4 of their largest
//   entry against the limit of 1e-4 (PERF.md), so the training scorer stays
//   in true float32 rounding.
// - The frame tile (A) is staged by the consumers (once per block when it is
//   resident): x [N, D] float32, each warpgroup's 64 rows one contiguous read
//   with several loads in flight (its 4*D-byte row stride is no TMA stride);
//   x2 formed in float32, and in bf16 rounded to nearest even as torch's .to,
//   so the operands are bitwise the plain version's.
// - The component panels (B) stream through a ring of shared-memory stages,
//   one [64, RC] chunk per stage. One thread of a producer warpgroup fills a
//   stage with one bulk copy of the TMA unit (cp.async.bulk) and an mbarrier
//   signals its arrival; a second mbarrier per stage tells the producer that
//   both consumers are done with it. kernel_params (am/gmm_cuda.py) lays
//   every chunk out in device memory as the shared-memory image its route
//   reads, so one contiguous copy fills a stage and needs no tensor map. The
//   producer gives its registers to the consumers (setmaxnreg).
// - bf16 image of a chunk, for wgmma (A and B alike, K-major, no swizzle):
//   8-row groups of 16-byte column chunks, each 8 x 16-byte core matrix
//   contiguous, element (m, r) at ((m/8 * RC/8 + r/8) * 8 + m%8) * 8 + r%8.
//   Core matrices adjacent along R are 128 bytes apart (the descriptor's
//   leading byte offset), 8-row groups 16*RC bytes (its stride byte offset),
//   and a 16-deep k-step advances 256 bytes. int8 image, for wgmma s8 (both
//   operands K-major, as 8-bit wgmma requires): the same with 16 int8 to a
//   core-matrix row, element (m, r) at ((m/8 * RC/16 + r/16) * 8 + m%8) * 16
//   + r%16, core matrices 128 bytes apart along R, 8-row groups 8*RC bytes,
//   a 32-deep k-step 256 bytes. float32 image, for FMA:
//   R-major, the panel chunk [RC, 64] as the reference's ab_t tile, A
//   [RC, 128 + 4].
//
// K1 and K1w differ only in where a component's panel lies (the chunked or
// the wide layout) and, in sum mode, in the fold: K1 folds every component
// online, K1w folds each chunk of kc components online and merges it into
// the running (m, s) at the chunk's end, the reference's merge
// (gmm_pallas.py:143-147). In max mode the two compute the same scores in
// the same order, so K1w is bitwise K1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace gmm_tc {

constexpr int TM = 128;                   // frames per block: two warpgroups of 64
constexpr int TS = 64;                    // states per block: the wgmma n-width
constexpr int RC_MAX = 128;               // chunk rows: at most this
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int MAX_STAGES = 4;
constexpr size_t SMEM_LIMIT = 232448;     // 227 KB, the most a block may have
constexpr int BAR_TURN = 1;               // named barriers 1, 2: warpgroup w's turn
constexpr int BAR_STAGE_A = 3;            // named barriers 3, 4: warpgroup w's A tile
constexpr int XS = TM + 4;                // float32 A: padded row stride

// bf16 and int8 run on the tensor cores, float32 on the CUDA cores.
template <typename T> constexpr bool IS_I8 = std::is_same<T, int8_t>::value;
template <typename T> constexpr bool ON_TC = std::is_same<T, __nv_bfloat16>::value || IS_I8<T>;
// Chunk rows are a multiple of the wgmma depth: 16 bf16, 32 int8 (float32
// follows bf16).
template <typename T> constexpr int R_ALIGN = IS_I8<T> ? 32 : 16;

// The R = 2D rows in n_chunks(D) chunks of chunk_rows(D) rows each.
template <typename T> int n_chunks(int D) {
  constexpr int A = R_ALIGN<T>;
  return ((2 * D + A - 1) / A + RC_MAX / A - 1) / (RC_MAX / A);
}
template <typename T> int chunk_rows(int D) {
  constexpr int A = R_ALIGN<T>;
  const int units = (2 * D + A - 1) / A, n = n_chunks<T>(D);
  return (units + n - 1) / n * A;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, the bulk copy, named barriers, setmaxnreg

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma (the bf16 route)

// Matrix descriptor of a no-swizzle K-major tile: start address, leading byte
// offset (between core matrices along K) and stride byte offset (between
// 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= A[64, 16] . B[16, 64]; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64, 32] . B[32, 64], int8 x int8 -> int32; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep the compiler from moving reads of the accumulators across the wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- the two routes' tiles

// One chunk of RC rows: of A, [TM, RC] (bf16 or int8 image) or [RC, XS]
// (float32); of a panel, [64, RC].
template <typename T, int RC> struct Tile {
  static constexpr int A_ELEMS = ON_TC<T> ? TM * RC : RC * XS, P_ELEMS = TS * RC;
  static constexpr size_t A_BYTES = (size_t)A_ELEMS * sizeof(T), P_BYTES = P_ELEMS * sizeof(T);
  static constexpr size_t BAR_BYTES = 2 * MAX_STAGES * sizeof(uint64_t);
};

// The shared-memory plan of a launch: A's chunks (all n_ch, or the one a
// step needs), a ring of stages, the mbarriers.
struct Plan {
  int a_chunks, stages;
  size_t smem;
};
template <typename T, int RC> Plan plan(int n_ch) {
  using L = Tile<T, RC>;
  const int a_chunks = n_ch * L::A_BYTES + 2 * L::P_BYTES + L::BAR_BYTES <= SMEM_LIMIT ? n_ch : 1;
  const size_t a_bytes = a_chunks * L::A_BYTES;
  const int stages = std::min<size_t>(MAX_STAGES, (SMEM_LIMIT - a_bytes - L::BAR_BYTES) / L::P_BYTES);
  return {a_chunks, stages, a_bytes + stages * L::P_BYTES + L::BAR_BYTES};
}

// Which output element a thread's register i holds, within its warpgroup's
// 64 x 64 tile: wgmma's accumulator fragment (rows 16 (warp % 4) + lane / 4
// + 8 ((i / 2) % 2), columns 8 (i / 4) + 2 (lane % 4) + i % 2, 16 distinct),
// or the FMA route's 8 x 4 tile (rows 8 (t / 16) + i / 4, columns 4 (t % 16)
// + i % 4, 4 distinct). col_slot(i) indexes the thread's NC distinct columns.
template <typename T> struct Frag;
template <> struct Frag<__nv_bfloat16> {
  static constexpr int NC = 16;
  __device__ static int row(int t, int i) { return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2); }
  __device__ static int col_of_slot(int t, int q) { return 8 * (q / 2) + 2 * (t % 4) + q % 2; }
  __device__ static constexpr int col_slot(int i) { return (i / 4) * 2 + i % 2; }
};
template <> struct Frag<int8_t> : Frag<__nv_bfloat16> {};  // int32 accumulators: the same fragment
template <> struct Frag<float> {
  static constexpr int NC = 4;
  __device__ static int row(int t, int i) { return 8 * (t / 16) + i / 4; }
  __device__ static int col_of_slot(int t, int q) { return 4 * (t % 16) + q; }
  __device__ static constexpr int col_slot(int i) { return i % 4; }
};

// Warpgroup wg's rows of A chunk slot `slot`.
template <int RC> __device__ __forceinline__ __nv_bfloat16* a_rows(__nv_bfloat16* a, int slot, int wg) {
  return a + (size_t)(2 * slot + wg) * 64 * RC;
}
template <int RC> __device__ __forceinline__ int8_t* a_rows(int8_t* a, int slot, int wg) {
  return a + (size_t)(2 * slot + wg) * 64 * RC;
}
template <int RC> __device__ __forceinline__ float* a_rows(float* a, int slot, int wg) {
  return a + (size_t)slot * RC * XS + 64 * wg;
}
// Stage x2[m, r] = v, r within the chunk, of a warpgroup's A rows.
template <int RC>
__device__ __forceinline__ void store_a(__nv_bfloat16* a, int m, int r, float v) {
  a[(((m >> 3) * (RC / 8) + r / 8) * 8 + (m & 7)) * 8 + r % 8] = __float2bfloat16_rn(v);
}
template <int RC>
__device__ __forceinline__ void store_a(float* a, int m, int r, float v) {
  a[r * XS + m] = v;
}

// One chunk's product for a warpgroup, complete on return: acc = A[64, RC] .
// panel[RC, 64], added to acc unless `first`; `issued` runs once the tensor
// cores have it. bf16: one unrolled chain of wgmma into the same accumulators
// (a loop that ptxas cannot unroll makes it fence, and so serialise, every
// step).
template <int RC, typename Issued>
__device__ __forceinline__ void product(float (&acc)[32], const __nv_bfloat16* a_rows, const __nv_bfloat16* panel,
                                        bool first, Issued issued) {
  constexpr uint32_t SBO = 8u * RC * sizeof(__nv_bfloat16);
  const uint32_t a = smem_addr(a_rows), b = smem_addr(panel);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int t = 0; t < RC / 16; ++t)
    wgmma(acc, make_desc(a + 256u * t, 128, SBO), make_desc(b + 256u * t, 128, SBO), t > 0 || !first);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  issued();
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}
// int8: the same chain of wgmma s8, 32 rows a step, into int32 accumulators.
template <int RC, typename Issued>
__device__ __forceinline__ void product(int (&acc)[32], const int8_t* a_rows, const int8_t* panel, bool first,
                                        Issued issued) {
  constexpr uint32_t SBO = 8u * RC;
  const uint32_t a = smem_addr(a_rows), b = smem_addr(panel);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int t = 0; t < RC / 32; ++t)
    wgmma(acc, make_desc(a + 256u * t, 128, SBO), make_desc(b + 256u * t, 128, SBO), t > 0 || !first);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  issued();
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}
// float32: each score an fmaf chain over the rows in order from 0 (the zero
// rows add exact zeros), chunk after chunk, the same for K1 and K1w.
template <int RC, typename Issued>
__device__ __forceinline__ void product(float (&acc)[32], const float* a_rows, const float* panel, bool first,
                                        Issued issued) {
  const int t = threadIdx.x % 128;
  const float* ap = a_rows + 8 * (t / 16);
  const float* bp = panel + 4 * (t % 16);
  issued();
  if (first) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }
#pragma unroll 4
  for (int r = 0; r < RC; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(ap + r * XS);
    const float4 a1 = *reinterpret_cast<const float4*>(ap + r * XS + 4);
    const float4 b = *reinterpret_cast<const float4*>(bp + r * TS);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = fmaf(av[i / 4], bv[i % 4], acc[i]);
  }
}

__device__ __forceinline__ float exp_(float v) { return exp2f(v * 1.4426950408889634f); }

// 2^v on the special-function unit alone (ex2.approx.ftz: relative error
// ~2^-22, results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// (m, s) <- online logsumexp of (m, s) and v, one exp: for m = -inf, s = 1.
// FAST (K5) takes the exp as ex2_ftz, whose error is far below the int8
// scorer's tolerance of the plain version.
template <bool FAST = false>
__device__ __forceinline__ void lse_push(float& m, float& s, float v) {
  const float d = v - m;
  const float e = FAST ? ex2_ftz(-fabsf(d) * 1.4426950408889634f) : exp_(-fabsf(d));
  s = d > 0.f ? fmaf(s, e, 1.f) : s + e;
  m = fmaxf(m, v);
}


// ---- the kernel
//
// x [N, D] float32 (int8: qx [N, Rp], the quantized x2 zero-padded to Rp =
// n_ch * RC columns, with sx [N]); panels: K1 and K5 (WIDE false) panel (k,
// j) at k * n_st + j; K1w (WIDE true) the wide layout, panel (q, j, kk) at (q
// * n_st + j) * kc + kk for component k = q * kc + kk; each panel n_ch chunks
// of 64 * RC elements. c [K, S] (and int8: sab [K, S]) and out [N, S] float32.

// Registers: bf16 max mode runs two blocks per SM, every other arm one. The
// producer warpgroup gives its registers to the consumers (setmaxnreg): 40
// and 232 each at one block per SM, 24 and 104 at two.
template <typename T, bool MAX> struct Regs {
  static constexpr int BLOCKS = (MAX && ON_TC<T>) ? 2 : 1;
  static constexpr int PRODUCER = BLOCKS == 2 ? 24 : 40;
  static constexpr int CONSUMER = BLOCKS == 2 ? 104 : 232;
  static_assert(PRODUCER * 128 + CONSUMER * CONSUMERS <= 65536 / BLOCKS, "register file");
};

// The ring's position: stage st in its pass of parity ph.
struct Ring {
  int st = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int n_stages) {
    if (++st == n_stages) {
      st = 0;
      ph ^= 1;
    }
  }
};

// The producer: one thread streams the panel chunks, component by component
// and chunk by chunk, into the ring, each into a stage once both consumers
// have released its previous chunk.
template <typename T, bool WIDE, int RC>
__device__ __forceinline__ void produce(const T* panels, T* stages, uint64_t* full, uint64_t* empty, int K,
                                        int kc, int n_ch, int n_stages) {
  using L = Tile<T, RC>;
  const int j = blockIdx.y, n_st = gridDim.y;
  Ring ring;
  for (int k = 0, i = 0; k < K; ++k) {
    const size_t p = WIDE ? ((size_t)(k / kc) * n_st + j) * kc + k % kc : (size_t)k * n_st + j;
    for (int ch = 0; ch < n_ch; ++ch, ++i, ring.next(n_stages)) {
      if (i >= n_stages) mbar_wait(&empty[ring.st], ring.ph ^ 1);
      mbar_expect_tx(&full[ring.st], L::P_BYTES);
      bulk_copy(stages + (size_t)ring.st * L::P_ELEMS, panels + (p * n_ch + ch) * L::P_ELEMS, L::P_BYTES,
                &full[ring.st]);
    }
  }
}

// Stage chunks c0 .. c1 - 1 of a warpgroup's A rows into slots 0 .. c1 - c0:
// x2 = [x*x, x, 0...] of frames n0 .. n0 + 63. Those 64 rows of x are 64 * D
// contiguous floats, read with several loads in flight; rows past N are zero.
// ONE: the rows are one chunk, stored with no test.
template <typename T, int RC, bool ONE>
__device__ __forceinline__ void stage_a(const float* x, T* a_tile, int wg, int n0, int N, int D, int c0, int c1) {
  const int t_wg = threadIdx.x % 128, r0 = c0 * RC, r1 = c1 * RC;
  const float* xw = x + (size_t)n0 * D;
  const int valid = max(0, min(64, N - n0)) * D;
  const auto put = [&](int m, int r, float v) {
    if (ONE)
      store_a<RC>(a_rows<RC>(a_tile, 0, wg), m, r, v);
    else if (r >= r0 && r < r1)
      store_a<RC>(a_rows<RC>(a_tile, (r - r0) / RC, wg), m, (r - r0) % RC, v);
  };
#pragma unroll 4
  for (int i = t_wg; i < 64 * D; i += 128) {
    const int m = i / D, d = i - m * D;
    const float xv = i < valid ? __ldg(xw + i) : 0.f;
    put(m, d, __fmul_rn(xv, xv));
    put(m, D + d, xv);
  }
  const int z0 = max(r0, 2 * D), nz = r1 - z0;  // the zero rows of the product
  for (int i = t_wg; i < 64 * nz; i += 128) {
    const int m = i / nz;
    put(m, z0 + i - m * nz, 0.f);
  }
  if (ON_TC<T>) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  named_sync(BAR_STAGE_A + wg, 128);
}

// The same for int8: frames n0 .. n0 + 63 of qx [N, Rp], chunks c0 .. c1 - 1,
// copied 16 bytes (one core-matrix row) at a time into the K-major image;
// rows past N are zero.
template <int RC>
__device__ __forceinline__ void stage_a(const int8_t* qx, int8_t* a_tile, int wg, int n0, int N, int Rp, int c0,
                                        int c1) {
  constexpr int Q = RC / 16;  // 16-byte pieces of a row in a chunk
  const int t_wg = threadIdx.x % 128, per_row = (c1 - c0) * Q;
  for (int i = t_wg; i < 64 * per_row; i += 128) {
    const int m = i / per_row, q = i - m * per_row;
    int4 v = make_int4(0, 0, 0, 0);
    if (n0 + m < N) v = __ldg(reinterpret_cast<const int4*>(qx + (size_t)(n0 + m) * Rp + c0 * RC) + q);
    int8_t* a = a_rows<RC>(a_tile, q / Q, wg);
    *reinterpret_cast<int4*>(a + (((m >> 3) * Q + q % Q) * 8 + (m & 7)) * 16) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  named_sync(BAR_STAGE_A + wg, 128);
}

// A consumer warpgroup: frames n0 .. n0 + 63 of the block against its states.
template <typename T, bool MAX, bool WIDE, int RC, bool ONE>
__device__ __forceinline__ void consume(const void* x, const float* sx, const float* sab, const float* c,
                                        float* out, T* a_tile, T* stages, uint64_t* full, uint64_t* empty, int N,
                                        int D, int S, int K, int kc, int n_ch, bool resident, int n_stages) {
  using L = Tile<T, RC>;
  using F = Frag<T>;
  using Acc = typename std::conditional<IS_I8<T>, int, float>::type;
  const int tid = threadIdx.x, wg = tid / 128, t_wg = tid % 128, lane = tid % 32;
  const int n0 = blockIdx.x * TM + 64 * wg, s0 = blockIdx.y * TS;
  const auto stage = [&](int c0, int c1) {
    if constexpr (IS_I8<T>)
      stage_a<RC>(static_cast<const int8_t*>(x), a_tile, wg, n0, N, n_ch * RC, c0, c1);
    else
      stage_a<T, RC, ONE>(static_cast<const float*>(x), a_tile, wg, n0, N, D, c0, c1);
  };
  if (resident) stage(0, n_ch);

  // acc, run_m, run_s: element i is (F::row(t_wg, i), F::col_of_slot(t_wg,
  // F::col_slot(i))); cm, cs: K1w sum mode's chunk (m, s); sxv: int8's row
  // scales of the thread's two rows (i / 2 % 2)
  Acc acc[32];
  float run_m[32], run_s[32], cm[32], cs[32], sxv[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0;
    run_m[i] = -INFINITY;
    run_s[i] = 0.f;
  }
  if (IS_I8<T>) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + F::row(t_wg, 2 * h);
      sxv[h] = n < N ? __ldg(sx + n) : 0.f;
    }
  }

  Ring ring;
  if (ON_TC<T> && wg == 1) named_arrive(BAR_TURN, 256);  // warpgroup 0 issues first
  for (int k = 0; k < K; ++k) {
    float cv[F::NC], sv[F::NC];
#pragma unroll
    for (int q = 0; q < F::NC; ++q) {
      const int s = s0 + F::col_of_slot(t_wg, q);
      cv[q] = s < S ? __ldg(c + (size_t)k * S + s) : 0.f;
      if (IS_I8<T>) sv[q] = s < S ? __ldg(sab + (size_t)k * S + s) : 0.f;
    }
    for (int ch = 0; ch < n_ch; ++ch, ring.next(n_stages)) {
      if (!resident) {  // restage: every thread is done with the last chunk
        named_sync(BAR_STAGE_A + wg, 128);
        stage(ch, ch + 1);
      }
      mbar_wait(&full[ring.st], ring.ph);
      if (ON_TC<T>) named_sync(BAR_TURN + wg, 256);  // my turn to issue
      const bool last = k == K - 1 && ch == n_ch - 1;
      product<RC>(acc, a_rows<RC>(a_tile, resident ? ch : 0, wg), stages + (size_t)ring.st * L::P_ELEMS, ch == 0,
                  [&] {
                    if (ON_TC<T> && !(wg == 1 && last)) named_arrive(BAR_TURN + 1 - wg, 256);  // the other's turn
                  });
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[ring.st]);
    }

    const int kk = WIDE ? k % kc : 0;
    const bool chunk_end = WIDE && (kk == kc - 1 || k == K - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (IS_I8<T>) {  // the plain int8 scorer's order, each op rounded alone
        const float v = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), sxv[(i / 2) % 2]), sv[F::col_slot(i)]), cv[F::col_slot(i)]);
        lse_push<true>(run_m[i], run_s[i], v);
        continue;
      }
      const float v = acc[i] + cv[F::col_slot(i)];
      if (MAX) {
        run_m[i] = fmaxf(run_m[i], v);
      } else if (!WIDE) {
        lse_push(run_m[i], run_s[i], v);
      } else {
        if (kk == 0) {
          cm[i] = v;
          cs[i] = 1.f;
        } else {
          lse_push(cm[i], cs[i], v);
        }
        if (chunk_end) {  // merge the chunk into the running (m, s)
          const float m_new = fmaxf(run_m[i], cm[i]);
          run_s[i] = run_s[i] * exp_(run_m[i] - m_new) + cs[i] * exp_(cm[i] - m_new);
          run_m[i] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = n0 + F::row(t_wg, i), s = s0 + F::col_of_slot(t_wg, F::col_slot(i));
    if (n < N && s < S) out[(size_t)n * S + s] = MAX ? run_m[i] : run_m[i] + logf(run_s[i]);
  }
}

// ONE: the rows are one chunk (D <= 64), which the compiler then folds; the
// step loop's bookkeeping and the staging's chunk test slowed the bf16 arms,
// whose epilogue is lean, where it could not.
template <typename T, bool MAX, bool WIDE, int RC, bool ONE>
__global__ void __launch_bounds__(THREADS, (Regs<T, MAX>::BLOCKS)) gmm_tc_kernel(
    const void* __restrict__ x, const float* __restrict__ sx, const T* __restrict__ panels,
    const float* __restrict__ sab, const float* __restrict__ c, float* __restrict__ out, int N, int D, int S,
    int K, int kc, int n_ch_, int a_chunks, int n_stages) {
  using L = Tile<T, RC>;
  const int n_ch = ONE ? 1 : n_ch_;
  extern __shared__ __align__(128) unsigned char smem[];
  T* a_tile = reinterpret_cast<T*>(smem);
  T* stages = a_tile + (size_t)a_chunks * L::A_ELEMS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a_chunks * L::A_BYTES + n_stages * L::P_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one branch per role to the end, as setmaxnreg needs
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<Regs<T, MAX>::PRODUCER>();
    if (threadIdx.x == CONSUMERS) produce<T, WIDE, RC>(panels, stages, full, empty, K, kc, n_ch, n_stages);
  } else {
    setmaxnreg_inc<Regs<T, MAX>::CONSUMER>();
    consume<T, MAX, WIDE, RC, ONE>(x, sx, sab, c, out, a_tile, stages, full, empty, N, D, S, K, kc, n_ch,
                                   ONE || a_chunks == n_ch, n_stages);
  }
}

// The kernel's operands: x (float32 x, or int8 qx), and int8's sx and sab.
struct Operands {
  const void* x;
  const float* sx;
  const void* panels;
  const float *sab, *c;
  float* out;
};

template <typename T, bool MAX, bool WIDE, int RC, bool ONE>
cudaError_t launch(const Operands& o, int N, int D, int S, int K, int kc, cudaStream_t stream) {
  const int n_ch = n_chunks<T>(D);
  const Plan pl = plan<T, RC>(n_ch);
  const dim3 grid((N + TM - 1) / TM, (S + TS - 1) / TS);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(gmm_tc_kernel<T, MAX, WIDE, RC, ONE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  gmm_tc_kernel<T, MAX, WIDE, RC, ONE><<<grid, THREADS, pl.smem, stream>>>(
      o.x, o.sx, static_cast<const T*>(o.panels), o.sab, o.c, o.out, N, D, S, K, kc, n_ch, pl.a_chunks,
      pl.stages);
  return cudaGetLastError();
}

// Several chunks make RC at least 80 (chunk_rows), so only those are built;
// int8 takes the multiples of 32.
template <typename T, bool MAX, bool WIDE, int RC>
cudaError_t launch_rc(const Operands& o, int N, int D, int S, int K, int kc, cudaStream_t stream) {
  if constexpr (RC % R_ALIGN<T> != 0) {
    return cudaErrorInvalidValue;
  } else {
    if (n_chunks<T>(D) == 1) return launch<T, MAX, WIDE, RC, true>(o, N, D, S, K, kc, stream);
    if constexpr (RC >= 80) return launch<T, MAX, WIDE, RC, false>(o, N, D, S, K, kc, stream);
    return cudaErrorInvalidValue;
  }
}

// Launch on `stream`; cudaErrorInvalidValue for arguments the kernel does not
// take: D, K or kc below 1.
template <typename T, bool MAX, bool WIDE>
cudaError_t launch(const Operands& o, int N, int D, int S, int K, int kc, cudaStream_t stream) {
  if (N <= 0 || S <= 0) return cudaSuccess;
  if (K <= 0 || D <= 0 || (WIDE && kc <= 0)) return cudaErrorInvalidValue;
  switch (chunk_rows<T>(D)) {
#define GMM_TC_RC(rc) \
  case rc: return launch_rc<T, MAX, WIDE, rc>(o, N, D, S, K, kc, stream);
    GMM_TC_RC(16) GMM_TC_RC(32) GMM_TC_RC(48) GMM_TC_RC(64)
    GMM_TC_RC(80) GMM_TC_RC(96) GMM_TC_RC(112) GMM_TC_RC(128)
#undef GMM_TC_RC
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; mode: 0 = sum, 1 = max.
template <bool WIDE>
cudaError_t dispatch(const void* x, const void* panels, const void* c, void* out, int N, int D, int S, int K,
                     int kc, int dtype, int mode, void* stream) {
  const Operands o{x, nullptr, panels, nullptr, static_cast<const float*>(c), static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && mode == 0) return launch<float, false, WIDE>(o, N, D, S, K, kc, st);
  if (dtype == 0 && mode == 1) return launch<float, true, WIDE>(o, N, D, S, K, kc, st);
  if (dtype == 1 && mode == 0) return launch<__nv_bfloat16, false, WIDE>(o, N, D, S, K, kc, st);
  if (dtype == 1 && mode == 1) return launch<__nv_bfloat16, true, WIDE>(o, N, D, S, K, kc, st);
  return cudaErrorInvalidValue;
}

// K5: qx [N, Rp] int8 (Rp = n_chunks * chunk_rows of int8), sx [N], panels
// int8, sab and c [K, S]; sum mode.
inline cudaError_t dispatch_int8(const void* qx, const void* sx, const void* panels, const void* sab,
                                 const void* c, void* out, int N, int D, int S, int K, void* stream) {
  const Operands o{qx, static_cast<const float*>(sx), panels, static_cast<const float*>(sab),
                   static_cast<const float*>(c), static_cast<float*>(out)};
  return launch<int8_t, false, false>(o, N, D, S, K, 0, static_cast<cudaStream_t>(stream));
}

}  // namespace gmm_tc

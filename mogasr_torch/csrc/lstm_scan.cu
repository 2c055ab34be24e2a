// The recurrence of one LSTM layer for Hopper (sm_90a): one persistent,
// cooperatively launched kernel per layer.
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
// the product (every bf16 x bf16 product is exact in float32) and the sum,
// the gates and the carries stay float32, as in the TPU kernel.
//
// What bounds it. Per layer the work is 2 * B * T * H * 4H operations
// (80.5 GFLOP at B = 64, T = 600, H = 512: 1.2 ms at the card's 67 TFLOP/s
// in float32) over ~400 MB of xg and out (0.12 ms at 3.35 TB/s); but it is
// a chain of T dependent steps, and each step needs all of h_{t-1}. The TPU
// kernel kept W_rec (4 MiB in float32 at H = 512) resident in one core's
// VMEM; no SM holds that. The design:
//
//   - the hidden units are split across CTAs: CTA g owns units
//     [g*U, (g+1)*U) and all four gate columns of each; its [H, U, 4] slice
//     of W_rec is staged in shared memory once and stays there for all T
//     frames (32 KiB at U = 4, H = 512). Each item, one unit for R batch
//     rows, is worked by KS threads that split the sum over k (so a CTA
//     runs up to 8 warps even for a small batch, and each thread's serial
//     chain of FMAs is KS times shorter); the first of them adds the partial
//     sums, does the gate math and keeps the item's c and h carries in
//     registers for the whole recurrence, and loads the next frame's xg
//     behind the grid barrier;
//   - h_{t-1} is exchanged through a double-buffered global buffer
//     [2, B, HP] (L2-resident). Each CTA copies all its rows of it into
//     shared memory with cp.async.cg (through L2 only, so no stale L1 line
//     is read), in NK column chunks, and starts the product on a chunk while
//     the later ones are in flight (a loop of plain loads waits on L2
//     latency once per load); W is read from shared memory as float4, the
//     four gates of a (k, unit) at once. In bf16 mode the buffer holds
//     h rounded to bf16, the carry itself stays float32;
//   - after each frame the whole grid synchronises (cooperative_groups
//     grid.sync(), so the launch is cudaLaunchCooperativeKernel and every CTA
//     must be resident at once: the grid is sized from the occupancy query).
//     A batch of more than MAX_ROWS rows (or more than shared memory holds)
//     runs as several such launches, one per block of rows, from the one
//     entry point.
//
// The per-frame grid barrier and the re-read of h_{t-1} by every CTA put a
// serial floor under the kernel that the bound above does not count. The
// product runs on the CUDA cores in float32 FMA; tensor cores (wgmma) and
// cluster multicast of h are later work. No fast math: expf and tanhf are
// the accurate ones.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 2;              // batch rows per thread
constexpr int MAX_THREADS = 256;  // threads per CTA: one (row slot, unit) item each
constexpr int MAX_ROWS = 64;      // batch rows per launch, all of their h staged at once
constexpr int NK = 4;             // column chunks of h, copied as separate cp.async groups

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float load_w(const void* w, size_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  return static_cast<const float*>(w)[i];
}

// 16-byte global -> shared copy through L2 only (cp.async.cg): never a stale L1 line.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most n of this thread's copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS) lstm_scan_kernel(
    const float* __restrict__ xg,  // [B, T, 4H]
    const void* __restrict__ w,    // [H, 4H] float32 or bf16
    const int* __restrict__ nf,    // [B]
    float* __restrict__ out,       // [B, T, H]
    float* hbuf,                   // two [B, HP] halves, hstride floats apart; lanes >= H zero
    size_t hstride, int B, int T, int H, int U, int KS) {
  extern __shared__ float4 smem[];
  const int HP = (H + 3) / 4 * 4;  // h row stride in hbuf: 16-byte copies
  const int HS = HP + 4;           // h row stride in shared memory: rows 16 B apart in the banks
  const int Q = HP / 4;
  const size_t H4 = 4 * (size_t)H;
  const int S = (B + R - 1) / R;  // row slots: slot s holds rows s, s + S, ...
  const int items = S * U;        // (row slot, unit) pairs of this CTA
  float4* ws = smem;                                            // [HP][U]: the 4 gate weights of (k, unit)
  float* hs = reinterpret_cast<float*>(smem + (size_t)HP * U);  // [B][HS]
  float* red = hs + (size_t)B * HS;                             // [KS - 1][items][R * 4] partial sums
  const int tid = threadIdx.x, nt = blockDim.x;
  const int u0 = blockIdx.x * U;
  cg::grid_group grid = cg::this_grid();

  for (int i = tid; i < HP * U; i += nt) {
    const int k = i / U, u = u0 + i % U;
    const bool in = k < H && u < H;
    const size_t at = (size_t)k * H4 + u;
    ws[i] = make_float4(in ? load_w<BF16>(w, at) : 0.f, in ? load_w<BF16>(w, at + H) : 0.f,
                        in ? load_w<BF16>(w, at + 2 * (size_t)H) : 0.f,
                        in ? load_w<BF16>(w, at + 3 * (size_t)H) : 0.f);
  }

  // This thread's item: unit u = u0 + ul for the rows of slot s; the KS
  // threads of an item split the sum over k (group kg takes every KS-th
  // float4 column) and group 0 adds the others' partial sums, does the gate
  // math and keeps the item's carries in registers.
  const int kg = tid / items, item = tid % items;
  const int ul = item % U, s = item / U, u = u0 + ul;
  const bool mine = kg < KS && u < H;
  const bool owner = mine && kg == 0;
  bool live[R];
  int n_valid[R];
  const float4* hrow[R];
  float c[R], h[R], xv[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = s + r * S;
    live[r] = mine && row < B;
    n_valid[r] = live[r] ? nf[row] : 0;
    hrow[r] = reinterpret_cast<const float4*>(hs + min(row, B - 1) * HS);
    c[r] = h[r] = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) xv[r][g] = owner && live[r] ? xg[(size_t)row * T * H4 + g * (size_t)H + u] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const float* src = hbuf + (size_t)(t & 1) * hstride;
    float* dst = hbuf + (size_t)((t + 1) & 1) * hstride;
    float acc[R][4] = {};
    if (t > 0) {  // h_0 = 0: frame 0 has no product
      for (int kc = 0; kc < NK; ++kc) {
        const int q0 = Q * kc / NK, nq = Q * (kc + 1) / NK - q0;
        if (nq > 0) {
          const int dr = nt / nq, dq = nt % nq;
          for (int r = tid / nq, q = tid % nq; r < B;) {
            cp_async16(hs + r * HS + 4 * (q0 + q), src + (size_t)r * HP + 4 * (q0 + q));
            r += dr;
            q += dq;
            if (q >= nq) { q -= nq; ++r; }
          }
        }
        cp_async_commit();
      }
      for (int kc = 0; kc < NK; ++kc) {
        const int q1 = Q * (kc + 1) / NK;
        cp_async_wait(NK - 1 - kc);  // this thread's copies of chunk kc have landed
        __syncthreads();             // and everyone's
        if (!mine) continue;
#pragma unroll 4
        for (int q = Q * kc / NK + kg; q < q1; q += KS) {
          const float4 w0 = ws[(4 * q + 0) * U + ul], w1 = ws[(4 * q + 1) * U + ul];
          const float4 w2 = ws[(4 * q + 2) * U + ul], w3 = ws[(4 * q + 3) * U + ul];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 hv = hrow[r][q];
            acc[r][0] = fmaf(hv.x, w0.x, acc[r][0]);
            acc[r][1] = fmaf(hv.x, w0.y, acc[r][1]);
            acc[r][2] = fmaf(hv.x, w0.z, acc[r][2]);
            acc[r][3] = fmaf(hv.x, w0.w, acc[r][3]);
            acc[r][0] = fmaf(hv.y, w1.x, acc[r][0]);
            acc[r][1] = fmaf(hv.y, w1.y, acc[r][1]);
            acc[r][2] = fmaf(hv.y, w1.z, acc[r][2]);
            acc[r][3] = fmaf(hv.y, w1.w, acc[r][3]);
            acc[r][0] = fmaf(hv.z, w2.x, acc[r][0]);
            acc[r][1] = fmaf(hv.z, w2.y, acc[r][1]);
            acc[r][2] = fmaf(hv.z, w2.z, acc[r][2]);
            acc[r][3] = fmaf(hv.z, w2.w, acc[r][3]);
            acc[r][0] = fmaf(hv.w, w3.x, acc[r][0]);
            acc[r][1] = fmaf(hv.w, w3.y, acc[r][1]);
            acc[r][2] = fmaf(hv.w, w3.z, acc[r][2]);
            acc[r][3] = fmaf(hv.w, w3.w, acc[r][3]);
          }
        }
      }
      if (KS > 1) {
        if (mine && kg > 0) {
          float* p = red + ((size_t)(kg - 1) * items + item) * (R * 4);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int g = 0; g < 4; ++g) p[r * 4 + g] = acc[r][g];
        }
        __syncthreads();
        if (owner) {
          for (int j = 1; j < KS; ++j) {
            const float* p = red + ((size_t)(j - 1) * items + item) * (R * 4);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int g = 0; g < 4; ++g) acc[r][g] += p[r * 4 + g];
          }
        }
      }
    }
    if (owner) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        const int row = s + r * S;
        if (t < n_valid[r]) {
          const float gi = sigmoid(xv[r][0] + acc[r][0]), gf = sigmoid(xv[r][1] + acc[r][1]);
          const float gg = tanhf(xv[r][2] + acc[r][2]), go = sigmoid(xv[r][3] + acc[r][3]);
          c[r] = gf * c[r] + gi * gg;
          h[r] = go * tanhf(c[r]);
        }
        // the next frame's product reads h rounded to bf16 in bf16 mode; the
        // carry and the output keep float32
        __stcg(dst + (size_t)row * HP + u, BF16 ? round_bf16(h[r]) : h[r]);
        out[((size_t)row * T + t) * H + u] = h[r];
        if (t + 1 < T) {  // the next frame's inputs load behind the barrier
          const size_t at = ((size_t)row * T + t + 1) * H4 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[r][g] = xg[at + g * (size_t)H];
        }
      }
    }
    grid.sync();  // h_t is complete in dst before any CTA reads it
  }
}

// Launch the recurrence over rows [0, B) in blocks of at most `rows` rows,
// each one cooperative launch of G CTAs; n_launched counts them.
template <bool BF16>
cudaError_t launch(const float* xg, const void* w, const int* nf, float* out, float* hbuf,
                   int B, int T, int H, cudaStream_t stream, int* n_launched) {
  int dev = 0, sms = 0, max_smem = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const int HP = (H + 3) / 4 * 4;
  // The fewest units per CTA (the most CTAs) whose grid is co-resident.
  for (int U = (H + sms - 1) / sms; U <= H && U <= MAX_THREADS; ++U) {
    const int G = (H + U - 1) / U;
    const size_t w_bytes = (size_t)HP * U * sizeof(float4);
    int rows = B < MAX_ROWS ? B : MAX_ROWS;
    if (rows > R * (MAX_THREADS / U)) rows = R * (MAX_THREADS / U);
    int items = 0, KS = 1;
    size_t smem = 0;
    for (;; rows = (rows + 1) / 2) {
      items = (rows + R - 1) / R * U;
      KS = MAX_THREADS / items;                 // threads per item, splitting the sum over k
      if (KS > HP / 32) KS = HP / 32 > 1 ? HP / 32 : 1;  // at least 8 float4 columns per thread
      smem = w_bytes + (size_t)rows * (HP + 4) * sizeof(float) + (size_t)(KS - 1) * items * R * 4 * sizeof(float);
      if (smem <= (size_t)max_smem || rows == 1) break;
    }
    if (smem > (size_t)max_smem) break;
    const int threads = (items * KS + 31) / 32 * 32;
    e = cudaFuncSetAttribute(lstm_scan_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_scan_kernel<BF16>, threads, smem);
    if (e != cudaSuccess) return e;
    if ((long long)per_sm * sms < G) continue;
    const size_t hstride = (size_t)B * HP;
    for (int b0 = 0; b0 < B; b0 += rows) {
      const float* x_b = xg + (size_t)b0 * T * 4 * H;
      const int* nf_b = nf + b0;
      float* out_b = out + (size_t)b0 * T * H;
      float* h_b = hbuf + (size_t)b0 * HP;
      int n = B - b0 < rows ? B - b0 : rows;
      void* args[] = {(void*)&x_b, (void*)&w, (void*)&nf_b, (void*)&out_b, (void*)&h_b,
                      (void*)&hstride, (void*)&n, (void*)&T, (void*)&H, (void*)&U, (void*)&KS};
      e = cudaLaunchCooperativeKernel((const void*)lstm_scan_kernel<BF16>, dim3(G), dim3(threads), args,
                                      smem, stream);
      if (e != cudaSuccess) return e;
      ++*n_launched;
    }
    return cudaGetLastError();
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

extern "C" {

// xg [B, T, 4H] float32, w [H, 4H] (dtype: 0 = float32, 1 = bfloat16),
// n_frames [B] int32, out [B, T, H] float32; scratch hbuf [2, B, HP]
// float32, zero-filled, HP = H rounded up to a multiple of 4. All
// contiguous, on the current device; launches on ``stream`` and adds the
// number of cooperative launches to *n_launched (one per block of rows).
int lstm_scan(const void* xg, const void* w, const void* n_frames, void* out, void* hbuf,
              int B, int T, int H, int dtype, void* stream, int* n_launched) {
  if (B <= 0 || T <= 0 || H <= 0) return cudaSuccess;
  const float* x = static_cast<const float*>(xg);
  const int* nf = static_cast<const int*>(n_frames);
  float* o = static_cast<float*>(out);
  float* hb = static_cast<float*>(hbuf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<false>(x, w, nf, o, hb, B, T, H, st, n_launched);
  if (dtype == 1) return launch<true>(x, w, nf, o, hb, B, T, H, st, n_launched);
  return cudaErrorInvalidValue;
}

const char* lstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

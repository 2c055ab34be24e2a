// int8 diagonal-GMM log-likelihood scoring for Hopper (sm_90a), CUDA cores.
//
// Replaces mogasr/am/gmm_pallas.py::_gmm_kernel_int8 (the int8 arm of the
// Pallas TPU scorer). It computes, for every frame n and state s,
//
//     out[n, s] = logsumexp_k ( (float(acc[n, k, s]) * sx[n]) * sab[k, s] + c[k, s] )
//     acc[n, k, s] = sum_r qx[n, r] * qab[k, r, s]          (int32)
//
// where qx [N, R] is x2 = [x^2, x] quantized to int8 per frame row with scale
// sx [N], qab [K, R, S] the component-major natural parameters quantized per
// (component, state) column with scale sab [K, S], and c [K, S] the float32
// Gaussian constants. Quantization is plain PyTorch before the launch, as in
// the reference (XLA work outside its kernel); mode is sum only.
//
// What bounds it: at the decode path's N = 256 * 600 the products are 2 * N *
// R * S * K = 4.5e11 int8 operations (0.23 ms at the H100's 1,979 TOP/s) and
// the [N, S] float32 output alone is 0.72 GB (0.21 ms at 3.35 TB/s); the
// float epilogue (dequantize, fold) is 6 operations per (n, k, s) on the CUDA
// cores. This first version keeps K1's shape: a 64 x 64 output tile per
// block, 4 x 4 outputs per thread, the frame tile staged once in shared
// memory and each component's panel in turn, both packed four int8 values of
// consecutive r to a 32-bit word (R padded to a multiple of 4 with zeros), so
// each product step is one __dp4a with an int32 accumulator. The epilogue
// dequantizes in the plain version's order, each op rounded alone
// (__fmul_rn / __fadd_rn: no FMA contraction), and folds the components into
// an online logsumexp in registers, so the [N, S*K] scores never exist.
// mma.sync / wgmma s8 with TMA is later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TM = 64;        // frames per block
constexpr int TS = 64;        // states per block
constexpr int XS = TM + 4;    // padded row stride (words) of the transposed frame tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// Four int8 values at p[0], p[stride], p[2 stride], p[3 stride] (zero for
// r >= R), packed little-endian into one word: byte b holds row r0 + b.
__device__ __forceinline__ int pack4(const int8_t* p, size_t stride, int r0, int R) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t v = r0 + b < R ? (uint8_t)p[b * stride] : 0u;
    w |= v << (8 * b);
  }
  return (int)w;
}

__global__ void __launch_bounds__(THREADS) gmm_int8_kernel(
    const int8_t* __restrict__ qx,    // [N, R]
    const float* __restrict__ sx,     // [N]
    const int8_t* __restrict__ qab,   // [K, R, S]
    const float* __restrict__ sab,    // [K, S]
    const float* __restrict__ c,      // [K, S]
    float* __restrict__ out,          // [N, S]
    int N, int R, int S, int K) {
  extern __shared__ int smem_w[];
  const int R4 = (R + 3) / 4;
  int* xs = smem_w;             // [R4][XS]: xs[w * XS + m] = qx[n0 + m, 4w .. 4w+3]
  int* ps = smem_w + R4 * XS;   // [R4][TS]: one component's packed panel
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TM, s0 = blockIdx.y * TS;

  // Stage the frame tile once; rows past N are zero and never written out.
  for (int i = tid; i < TM * R4; i += THREADS) {
    const int m = i / R4, w = i % R4;
    const int n = n0 + m;
    xs[w * XS + m] = n < N ? pack4(qx + (size_t)n * R + 4 * w, 1, 4 * w, R) : 0;
  }
  float sxv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    sxv[i] = n < N ? sx[n] : 0.f;
  }

  float run_m[4][4], run_s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run_m[i][j] = -INFINITY;
      run_s[i][j] = 0.f;
    }

  for (int k = 0; k < K; ++k) {
    __syncthreads();  // the previous panel has been consumed
    const int8_t* qk = qab + (size_t)k * R * S;
    for (int i = tid; i < R4 * TS; i += THREADS) {
      const int w = i / TS, s = i % TS;
      const int sg = s0 + s;
      ps[w * TS + s] = sg < S ? pack4(qk + (size_t)(4 * w) * S + sg, S, 4 * w, R) : 0;
    }
    __syncthreads();

    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int w = 0; w < R4; ++w) {
      const int4 a = *reinterpret_cast<const int4*>(&xs[w * XS + ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&ps[w * TS + tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }

    float sv[4], cv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx * 4 + j;
      sv[j] = s < S ? sab[(size_t)k * S + s] : 0.f;
      cv[j] = s < S ? c[(size_t)k * S + s] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // exact: |acc| <= R * 127^2 < 2^24
        const float v = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sxv[i]), sv[j]), cv[j]);
        if (v > run_m[i][j]) {  // online logsumexp
          run_s[i][j] = run_s[i][j] * expf(run_m[i][j] - v) + 1.f;
          run_m[i][j] = v;
        } else {
          run_s[i][j] += expf(v - run_m[i][j]);
        }
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx * 4 + j;
      if (s < S) out[(size_t)n * S + s] = run_m[i][j] + logf(run_s[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// qx int8 [N, R], sx float32 [N], qab int8 [K, R, S], sab and c float32
// [K, S], out float32 [N, S]; all contiguous, on the current device.
int gmm_int8(const void* qx, const void* sx, const void* qab, const void* sab,
             const void* c, void* out, int N, int R, int S, int K, void* stream) {
  if (N <= 0 || S <= 0) return cudaSuccess;
  const int R4 = (R + 3) / 4;
  const size_t smem = (size_t)R4 * (XS + TS) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + TM - 1) / TM, (S + TS - 1) / TS);
  gmm_int8_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
      static_cast<const int8_t*>(qab), static_cast<const float*>(sab),
      static_cast<const float*>(c), static_cast<float*>(out), N, R, S, K);
  return cudaGetLastError();
}

const char* gmm_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

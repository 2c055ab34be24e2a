// Wide-layout diagonal-GMM log-likelihood scoring for Hopper (sm_90a), CUDA
// cores.
//
// Replaces mogasr/am/gmm_pallas.py::_gmm_kernel_wide (the wide-layout arm of
// the Pallas TPU scorer). Same function as K1 (csrc/gmm_score.cu):
//
//     out[n, s] = fold_k ( x2[n, :] . ab[k, :, s] + c[k, s] )
//
// but over the reference's wide layout: the natural parameters come as
// abw [n_kc, R, n_st * kc * TSW], where for component chunk q and state tile
// j the kc component panels [R, TSW] sit side by side, kk-major, in one
// contiguous [R, kc * TSW] panel (gmm_pallas.py:300-304, with this kernel's
// TSW). Per (frame tile, state tile, component chunk) a block stages that
// whole panel in shared memory with 16-byte loads and takes one
// [TM, R] x [R, kc * TSW] product, read as kc column slices of TSW.
//
// Fold: max mode takes the running max over the slices, exactly as K1 does,
// and each score is accumulated over r in K1's order (fmaf from r = 0, then +
// c in float32), so in max mode K1w is bitwise equal to K1. Sum mode folds a
// chunk into a chunk-local (max, sum) online in registers, then merges it into
// the running (m, s) once per chunk, the reference's merge; it agrees with the
// plain version within K1's tolerance.
//
// What bounds it: arithmetic (2 * R * S * K operations per frame, as K1), and
// on this card shared memory: at kc = 16 the f32 panel is 78 x 512 x 4 =
// 160 KB, so TSW is 32 (not K1's 64) and bf16 panels stay bf16 in shared
// memory (80 KB), widened to float32 when read; one block of 256 threads per
// SM in f32. A cp.async / TMA ring over the chunks and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TM = 128;       // frames per block
constexpr int TSW = 32;       // states per block (the layout's tile width)
constexpr int XS = TM + 4;    // padded row stride of the transposed frame tile
constexpr int THREADS = 256;  // 32 x 8 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

template <typename T, bool MAX>
__global__ void __launch_bounds__(THREADS) gmm_wide_kernel(
    const T* __restrict__ x2,     // [N, R]
    const T* __restrict__ abw,    // [n_kc, R, n_st * kc * TSW]
    const float* __restrict__ c,  // [K, S]
    float* __restrict__ out,      // [N, S]
    int N, int R, int S, int K, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);      // [R][XS]
  T* ps = reinterpret_cast<T*>(xs + (size_t)R * XS);   // [R][kc * TSW]
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int n0 = blockIdx.x * TM, j = blockIdx.y, s0 = j * TSW;
  const int n_st = gridDim.y, n_kc = (K + kc - 1) / kc;
  const int pw = kc * TSW;                 // panel width
  const size_t row_w = (size_t)n_st * pw;  // abw row width

  for (int i = tid; i < TM * R; i += THREADS) {
    const int m = i / R, r = i % R;
    const int n = n0 + m;
    xs[r * XS + m] = n < N ? to_f32(x2[(size_t)n * R + r]) : 0.f;
  }

  float run_m[4][4], run_s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      run_m[i][jj] = -INFINITY;
      run_s[i][jj] = 0.f;
    }

  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  const int per_row = pw / V;
  for (int q = 0; q < n_kc; ++q) {
    __syncthreads();  // the previous panel has been consumed
    const T* src = abw + (size_t)q * R * row_w + (size_t)j * pw;
    for (int i = tid; i < R * per_row; i += THREADS) {
      const int r = i / per_row, v = i % per_row;
      reinterpret_cast<uint4*>(ps + (size_t)r * pw)[v] =
          __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * row_w) + v);
    }
    __syncthreads();

    float cm[4][4], cs[4][4];  // the chunk's (max, sum), sum mode
    const int kk_end = min(kc, K - q * kc);
    for (int kk = 0; kk < kk_end; ++kk) {
      const int k = q * kc + kk;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
      const T* pk = ps + kk * TSW + tx * 4;
      for (int r = 0; r < R; ++r) {
        float av[4], bv[4];
        load4(&xs[r * XS + ty * 4], av);
        load4(pk + (size_t)r * pw, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
      float cv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int s = s0 + tx * 4 + jj;
        cv[jj] = s < S ? c[(size_t)k * S + s] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float v = acc[i][jj] + cv[jj];
          if (MAX) {
            run_m[i][jj] = fmaxf(run_m[i][jj], v);
          } else if (kk == 0) {
            cm[i][jj] = v;
            cs[i][jj] = 1.f;
          } else if (v > cm[i][jj]) {
            cs[i][jj] = cs[i][jj] * expf(cm[i][jj] - v) + 1.f;
            cm[i][jj] = v;
          } else {
            cs[i][jj] += expf(v - cm[i][jj]);
          }
        }
    }
    if (!MAX) {  // merge the chunk into the running (m, s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float m_new = fmaxf(run_m[i][jj], cm[i][jj]);
          run_s[i][jj] = run_s[i][jj] * expf(run_m[i][jj] - m_new) + cs[i][jj] * expf(cm[i][jj] - m_new);
          run_m[i][jj] = m_new;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int s = s0 + tx * 4 + jj;
      if (s < S) out[(size_t)n * S + s] = MAX ? run_m[i][jj] : run_m[i][jj] + logf(run_s[i][jj]);
    }
  }
}

template <typename T, bool MAX>
cudaError_t launch(const void* x2, const void* abw, const float* c, float* out,
                   int N, int R, int S, int K, int kc, cudaStream_t stream) {
  const size_t smem = (size_t)R * XS * sizeof(float) + (size_t)R * kc * TSW * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_wide_kernel<T, MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + TM - 1) / TM, (S + TSW - 1) / TSW);
  gmm_wide_kernel<T, MAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x2), static_cast<const T*>(abw), c, out, N, R, S, K, kc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile width of the wide layout this kernel reads.
int gmm_wide_tile_s() { return TSW; }

// dtype: 0 = float32, 1 = bfloat16 (x2 and abw); mode: 0 = sum, 1 = max.
// x2 [N, R]; abw [ceil(K / kc), R, ceil(S / TSW) * kc * TSW], padded with
// zeros; c [K, S] and out [N, S] float32. All contiguous, on the current
// device. A panel too large for shared memory fails the launch.
int gmm_wide(const void* x2, const void* abw, const void* c, void* out,
             int N, int R, int S, int K, int kc, int dtype, int mode, void* stream) {
  if (N <= 0 || S <= 0) return cudaSuccess;
  if (kc <= 0 || K <= 0) return cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && mode == 0) return launch<float, false>(x2, abw, cf, of, N, R, S, K, kc, st);
  if (dtype == 0 && mode == 1) return launch<float, true>(x2, abw, cf, of, N, R, S, K, kc, st);
  if (dtype == 1 && mode == 0) return launch<__nv_bfloat16, false>(x2, abw, cf, of, N, R, S, K, kc, st);
  if (dtype == 1 && mode == 1) return launch<__nv_bfloat16, true>(x2, abw, cf, of, N, R, S, K, kc, st);
  return cudaErrorInvalidValue;
}

const char* gmm_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

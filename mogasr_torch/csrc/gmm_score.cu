// Fused diagonal-GMM log-likelihood scoring for Hopper (sm_90a), CUDA cores.
//
// Replaces mogasr/am/gmm_pallas.py::_gmm_kernel (the chunked-layout Pallas
// TPU kernel). It computes, for every frame n and state s,
//
//     out[n, s] = fold_k ( x2[n, :] . ab[k, :, s] + c[k, s] )
//
// where x2 = [x^2, x] (R = 2D columns), ab holds the natural parameters
// component-major ([K, R, S]) and fold is max (mode "max") or an online
// logsumexp (mode "sum"). Only out [N, S] float32 is written: the
// [N, S*K] score tensor (11 GB at N = 256*600 frames, S = 1168, K = 16)
// never exists, since each component's scores are folded into a running
// max, or a running (m, s) pair, held in registers.
//
// What bounds it: arithmetic. Each frame costs 2*R*S*K = 2*78*1168*16
// ~= 2.9 MFLOP, ~0.45 TFLOP per 256 x 600 batch, and each x2 row is reused
// across S*K = 18,688 columns, so the inputs (N*R + K*R*S values) are tiny
// next to the work. This first version runs on the CUDA cores in true fp32
// FMA (no TF32): a TM x TS output tile per block, the frame tile [TM, R]
// staged once in shared memory, each component's [R, TS] panel staged in
// turn, 4 x 4 outputs per thread. bf16 inputs are widened to float32 when
// staged, so bf16 x bf16 products are exact and accumulate in float32; c is
// added in float32 in the epilogue. A wgmma / TMA pipeline is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int TM = 64;        // frames per block
constexpr int TS = 64;        // states per block
constexpr int XS = TM + 4;    // padded row stride of the transposed frame tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool MAX>
__global__ void __launch_bounds__(THREADS) gmm_score_kernel(
    const T* __restrict__ x2,     // [N, R]
    const T* __restrict__ ab,     // [K, R, S]
    const float* __restrict__ c,  // [K, S]
    float* __restrict__ out,      // [N, S]
    int N, int R, int S, int K) {
  extern __shared__ float smem[];
  float* xs = smem;           // [R][XS]: xs[r * XS + m] = x2[n0 + m, r]
  float* ps = smem + R * XS;  // [R][TS]: one component's panel
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TM, s0 = blockIdx.y * TS;

  // Stage the frame tile once; rows past N are zero and never written out.
  for (int i = tid; i < TM * R; i += THREADS) {
    const int m = i / R, r = i % R;
    const int n = n0 + m;
    xs[r * XS + m] = n < N ? to_f32(x2[(size_t)n * R + r]) : 0.f;
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
    const T* abk = ab + (size_t)k * R * S;
    for (int i = tid; i < R * TS; i += THREADS) {
      const int r = i / TS, s = i % TS;
      const int sg = s0 + s;
      ps[r * TS + s] = sg < S ? to_f32(abk[(size_t)r * S + sg]) : 0.f;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r * XS + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ps[r * TS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }

    float cv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx * 4 + j;
      cv[j] = s < S ? c[(size_t)k * S + s] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = acc[i][j] + cv[j];
        if (MAX) {
          run_m[i][j] = fmaxf(run_m[i][j], v);
        } else if (v > run_m[i][j]) {  // online logsumexp
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
      if (s < S) out[(size_t)n * S + s] = MAX ? run_m[i][j] : run_m[i][j] + logf(run_s[i][j]);
    }
  }
}

template <typename T, bool MAX>
cudaError_t launch(const void* x2, const void* ab, const float* c, float* out,
                   int N, int R, int S, int K, cudaStream_t stream) {
  const size_t smem = (size_t)R * (XS + TS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_score_kernel<T, MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + TM - 1) / TM, (S + TS - 1) / TS);
  gmm_score_kernel<T, MAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x2), static_cast<const T*>(ab), c, out, N, R, S, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x2 and ab); mode: 0 = sum, 1 = max.
// c and out are float32. All arrays are contiguous, on the current device.
int gmm_score(const void* x2, const void* ab, const void* c, void* out,
              int N, int R, int S, int K, int dtype, int mode, void* stream) {
  if (N <= 0 || S <= 0) return cudaSuccess;
  const float* cf = static_cast<const float*>(c);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && mode == 0) return launch<float, false>(x2, ab, cf, of, N, R, S, K, st);
  if (dtype == 0 && mode == 1) return launch<float, true>(x2, ab, cf, of, N, R, S, K, st);
  if (dtype == 1 && mode == 0) return launch<__nv_bfloat16, false>(x2, ab, cf, of, N, R, S, K, st);
  if (dtype == 1 && mode == 1) return launch<__nv_bfloat16, true>(x2, ab, cf, of, N, R, S, K, st);
  return cudaErrorInvalidValue;
}

const char* gmm_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

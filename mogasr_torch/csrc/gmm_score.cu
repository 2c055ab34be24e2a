// K1: fused diagonal-GMM log-likelihood scoring on Hopper's tensor cores
// (sm_90a), the chunked layout.
//
// Replaces mogasr/am/gmm_pallas.py::_gmm_kernel (:154, pallas_call :326): for
// every frame n and state s, out[n, s] = fold_k (x2[n, :] . ab[k, :, s] +
// c[k, s]), fold max or online logsumexp, float32 or bfloat16 operands.
//
// What bounds it on an H100 SXM, on the decode batch (N = 256 x 600, S =
// 1168, K = 16, D = 39; 2 * N * S * K * 2D = 0.45 TFLOP of products): the
// bf16 arms' products at 989 TFLOP/s on the tensor cores, 0.45 ms; the
// float32 arms' products as float32 FMA at 67 TFLOP/s on the CUDA cores,
// 6.68 ms; in sum mode also the N * S * K exps at the SFU rate (16 per SM
// and clock), ~0.7 ms. csrc/gmm_tc.cuh says why float32 stays on FMA.
//
// What the design does (csrc/gmm_tc.cuh, shared with K1w): a 128-frame x
// 64-state output tile per block, the K components in an inner loop, each a
// product into registers (bf16 wgmma, or float32 FMA) folded in registers
// with c added in float32; the frame tile staged in the kernel from x, the
// component panels streamed through a shared-memory ring by TMA bulk copies,
// two consumer warpgroups (in ping-pong on wgmma). Here component k's panel
// for state tile j is panel k * ceil(S / 64) + j of the chunked layout that
// am/gmm_cuda.py::kernel_params builds from ab_t [K, 2D, S].

#include "gmm_tc.cuh"

extern "C" {

// The state-tile width of the panels this kernel reads.
int gmm_score_tile_s() { return gmm_tc::TS; }

// x [N, D] float32; panels [K * ceil(S / 64), 64 * Rp] in the compute dtype
// (Rp = 2D in n_chunks(D) chunks of chunk_rows(D) rows, csrc/gmm_tc.cuh);
// c [K, S] and out [N, S] float32. dtype: 0 = float32, 1 = bfloat16; mode:
// 0 = sum, 1 = max. All contiguous, on the current device.
int gmm_score(const void* x, const void* panels, const void* c, void* out,
              int N, int D, int S, int K, int dtype, int mode, void* stream) {
  return gmm_tc::dispatch<false>(x, panels, c, out, N, D, S, K, 0, dtype, mode, stream);
}

const char* gmm_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

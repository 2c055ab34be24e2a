// K1 and K5: fused diagonal-GMM log-likelihood scoring on Hopper's tensor
// cores (sm_90a), the chunked layout.
//
// K1 replaces mogasr/am/gmm_pallas.py::_gmm_kernel (:154, pallas_call :326):
// for every frame n and state s, out[n, s] = fold_k (x2[n, :] . ab[k, :, s] +
// c[k, s]), fold max or online logsumexp, float32 or bfloat16 operands. K5
// (gmm_int8 below) replaces ::_gmm_kernel_int8 (:48, pallas_call :320): the
// same in sum mode on int8 operands, int8 x int8 -> int32 on wgmma s8,
// dequantized by the per-frame and per-(component, state) scales.
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
// am/gmm_cuda.py::kernel_params builds from ab_t [K, 2D, S] (for K5 from the
// quantized qab, as its int8 image).
//
// What bounds K5 on the decode batch: its N * S * K = 2.9e9 exps at the SFU
// rate, ~0.69 ms; its int8 products (0.45 TOP) take 0.23 ms at 1,979 TOP/s,
// its output 0.21 ms at 3.35 TB/s. The earlier K5 (CUDA-core __dp4a, each
// block re-packing every component's panel from qab [K, R, S]) spent a
// third of its time packing and a third in the dp4a loop (PERF.md); here
// the panels arrive packed through the core's TMA ring and the products run
// on the tensor cores, so the float epilogue is what is left.

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

// K5. qx [N, Rp] int8: x2 quantized per row, zero-padded to Rp =
// gmm_int8_padded_rows(D) columns; sx [N] float32; panels [K * ceil(S / 64),
// 64 * Rp] int8, the int8 image of qab; sab, c [K, S] and out [N, S]
// float32. Sum mode. All contiguous, on the current device.
int gmm_int8(const void* qx, const void* sx, const void* panels, const void* sab, const void* c, void* out,
             int N, int D, int S, int K, void* stream) {
  return gmm_tc::dispatch_int8(qx, sx, panels, sab, c, out, N, D, S, K, stream);
}

// Rp of K5's operands: the 2D rows in chunks of a multiple of 32.
int gmm_int8_padded_rows(int D) {
  return D > 0 ? gmm_tc::n_chunks<int8_t>(D) * gmm_tc::chunk_rows<int8_t>(D) : 0;
}

const char* gmm_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

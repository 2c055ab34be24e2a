// K1w: fused diagonal-GMM log-likelihood scoring on Hopper's tensor cores
// (sm_90a), the wide layout.
//
// Replaces mogasr/am/gmm_pallas.py::_gmm_kernel_wide (:107, pallas_call
// :305): the function of K1 (csrc/gmm_score.cu) over the reference's wide
// layout, where for component chunk q and state tile j the kc component
// panels sit side by side, kk-major, in one contiguous panel
// (gmm_pallas.py:300-304).
//
// What bounds it on an H100 SXM: as K1, the products (bf16 at 989 TFLOP/s on
// the tensor cores, 0.45 ms on the decode batch; float32 FMA at 67 TFLOP/s on
// the CUDA cores, 6.68 ms) and in sum mode the N * S * K exps at the SFU
// rate.
//
// What the design does: it runs K1's kernel (csrc/gmm_tc.cuh) on the same
// frame tile, with the same step order, the same 64-wide products and the
// same epilogue. kernel_params cuts the chunk's [2D, kc * 64] wide panel into
// kc 64-state slices, each laid out as its shared-memory image, and they
// stream through the ring one slice per stage (a whole float32 chunk at kc =
// 16, 320 KB at D = 39, would not fit in shared memory). In max mode K1w is
// therefore bitwise K1; in sum mode it folds each chunk online and merges it
// into the running (m, s) once per chunk, the reference's fold, within K1's
// tolerance of the plain version.

#include "gmm_tc.cuh"

extern "C" {

// The tile width of the wide layout this kernel reads.
int gmm_wide_tile_s() { return gmm_tc::TS; }

// x [N, D] float32; panels [ceil(K / kc) * ceil(S / 64) * kc, 64 * Rp] in the
// compute dtype (the wide layout's slices, zero-padded; Rp as K1's); c [K, S]
// and out [N, S] float32. dtype: 0 = float32, 1 = bfloat16; mode: 0 = sum,
// 1 = max. All contiguous, on the current device.
int gmm_wide(const void* x, const void* panels, const void* c, void* out,
             int N, int D, int S, int K, int kc, int dtype, int mode, void* stream) {
  return gmm_tc::dispatch<true>(x, panels, c, out, N, D, S, K, kc, dtype, mode, stream);
}

const char* gmm_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

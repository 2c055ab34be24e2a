"""Fused GMM scorer: the port of mogasr/am/gmm_pallas.py on three CUDA kernels.

- K1, ``csrc/gmm_score.cu`` (``_gmm_kernel``): the chunked layout, float32 or
  bfloat16 operands, sum or max mode;
- K1w, ``csrc/gmm_wide.cu`` (``_gmm_kernel_wide``): the same function over
  the wide layout (``layout="wide"``), float32 or bfloat16;
- K5, the ``gmm_int8`` entry point of ``csrc/gmm_score.cu``
  (``_gmm_kernel_int8``): int8 operands (``compute_dtype="int8"``), sum mode
  only.

``gmm_loglik_fused`` mirrors ``gmm_loglik_pallas``: a CUDA tensor runs a
kernel, a CPU tensor runs the plain version ``am.gmm.gmm_loglik`` (layout and
kc only arrange the same function); any other device raises. ``LAUNCHES``,
``WIDE_LAUNCHES`` and ``INT8_LAUNCHES`` count the launches of K1, K1w and K5
(none for N = 0). A caller that scores many batches with one GMM converts it
to the kernel's layout once, with :func:`kernel_params`, and passes it in.

K1, K1w and K5 run one kernel (``csrc/gmm_tc.cuh``): bf16 and int8 products
on the tensor cores, float32 FMA on the CUDA cores. They read the model as
panels: for each component and 64-state tile a [64, Rp] slice, its 2D rows
cut into equal chunks of at most 128 (zero rows past 2D), each chunk laid out
as the shared-memory image its route reads (:func:`kernel_panels`).
``kernel_params`` derives them from the reference's chunked layout
(``am.gmm.component_major``), its wide layout (:func:`wide_layout`) or the
quantized chunked layout (``am.gmm.int8_params``). K5's frames are quantized
here, as ``am.gmm.quantize_int8`` does, into rows zero-padded to Rp. The
kernels have no backward: on the card a call with grad mode on and frames
or a GMM that require grad raises (``_cuda.refuse_grad``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch

from mogasr_torch import _cuda
from mogasr_torch.am.gmm import (
    COMPUTE_DTYPES,
    GmmSet,
    check_scoring_args,
    gmm_loglik,
    component_major,
    int8_params,
    quadratic_features,
    quantize_int8,
)

LAUNCHES = 0
WIDE_LAUNCHES = 0
INT8_LAUNCHES = 0

LAYOUTS = ("chunked", "wide")
WIDE_TS = 64  # the state tile of K1's panels and of the wide layout: TS in csrc/gmm_tc.cuh
# panel chunk rows: a multiple of the wgmma depth (16 bf16, and float32
# alike; 32 int8), at most 128 (R_ALIGN and RC_MAX in csrc/gmm_tc.cuh)
R_ALIGN, INT8_R_ALIGN, RC_MAX = 16, 32, 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gmm_score": [_P] * 4 + [_I] * 6 + [_P], "gmm_score_tile_s": [],
               "gmm_int8": [_P] * 6 + [_I] * 4 + [_P], "gmm_int8_padded_rows": [_I]}
_WIDE_SIGNATURES = {"gmm_wide": [_P] * 4 + [_I] * 7 + [_P], "gmm_wide_tile_s": []}


class KernelParams(NamedTuple):
    """A GmmSet as K1 reads it: c_t [K, S] float32 and panels, the
    component-major ab_t [K, 2D, S] in the compute dtype through
    :func:`kernel_panels`."""

    c_t: torch.Tensor
    panels: torch.Tensor


class WideParams(NamedTuple):
    """A GmmSet as K1w reads it: c_t [K, S] float32, the component chunk kc,
    and panels, the wide layout of ab_t (:func:`wide_layout`) in the compute
    dtype through :func:`kernel_panels`."""

    c_t: torch.Tensor
    kc: int
    panels: torch.Tensor


class Int8Params(NamedTuple):
    """A GmmSet quantized for K5 (``am.gmm.int8_params``): panels, qab [K,
    2D, S] int8 through :func:`kernel_panels` (the int8 image); sab [K, S]
    float32 scales; c_t [K, S] float32."""

    panels: torch.Tensor
    sab: torch.Tensor
    c_t: torch.Tensor


Params = Union[KernelParams, WideParams, Int8Params]


def default_kc(compute_dtype: str, mode: str, n_components: int) -> int:
    """The reference's component chunk (gmm_pallas.py:386-388): 8 for the
    bf16 sum path, 16 otherwise, at most K."""
    kc = 8 if (mode == "sum" and compute_dtype == "bfloat16") else 16
    return min(kc, n_components)


def wide_layout(ab_t: torch.Tensor, kc: int, ts: int = WIDE_TS) -> torch.Tensor:
    """[K, R, S] component-major -> [n_kc, R, n_st * kc * ts]: components
    zero-padded to a multiple of kc, states to a multiple of ts, then state
    tile j's kc component panels side by side, kk-major (gmm_pallas.py:300-304)."""
    K, R, S = ab_t.shape
    k_pad, s_pad = -(-K // kc) * kc, -(-S // ts) * ts
    n_kc, n_st = k_pad // kc, s_pad // ts
    abp = torch.zeros((k_pad, R, s_pad), dtype=ab_t.dtype, device=ab_t.device)
    abp[:K, :, :S] = ab_t
    return abp.reshape(n_kc, kc, R, n_st, ts).permute(0, 2, 3, 1, 4).reshape(n_kc, R, n_st * kc * ts)


def row_chunks(d: int, align: int = R_ALIGN) -> tuple:
    """(n, rc): the panels' 2D rows in n equal chunks of rc rows, rc a
    multiple of ``align`` (R_ALIGN, or INT8_R_ALIGN for int8) and at most
    RC_MAX (n_chunks and chunk_rows in csrc/gmm_tc.cuh)."""
    units = -(-2 * d // align)
    n = -(-units // (RC_MAX // align))
    return n, -(-units // n) * align


def padded_rows(d: int, align: int = R_ALIGN) -> int:
    """Rp, the panels' row count: n * rc of :func:`row_chunks`."""
    n, rc = row_chunks(d, align)
    return n * rc


def _align(dtype: torch.dtype) -> int:
    return INT8_R_ALIGN if dtype == torch.int8 else R_ALIGN


def kernel_panels(ab: torch.Tensor) -> torch.Tensor:
    """The panels K1, K1w and K5 read, from the reference's chunked layout ab_t
    [K, R, S] or its wide layout [n_kc, R, n_st * kc * WIDE_TS]: its [R,
    WIDE_TS] slices along the last dimension (zero-padded to a multiple of
    WIDE_TS), then along the first, each with its rows zero-padded to Rp and
    each chunk of rc rows (:func:`row_chunks`) in the shared-memory image its
    route reads (csrc/gmm_tc.cuh): float32 (FMA) as it is, [rc, 64]; bf16
    and int8 (wgmma) K-major in 8-row groups of 16-byte column chunks (8
    bf16 or 16 int8), each 8-row x 16-byte core matrix contiguous; int8
    chunks a multiple of 32 rows. Panel k * n_st + j of ab_t is component
    k's state tile j; panel (q * n_st + j) * kc + kk of the wide layout is
    component q * kc + kk's."""
    lead, R, S = ab.shape
    align = _align(ab.dtype)
    n_st, rp, (_n, rc) = -(-S // WIDE_TS), padded_rows(R // 2, align), row_chunks(R // 2, align)
    tiles = torch.zeros((lead, n_st, rp, WIDE_TS), dtype=ab.dtype, device=ab.device)
    abp = torch.zeros((lead, R, n_st * WIDE_TS), dtype=ab.dtype, device=ab.device)
    abp[..., :S] = ab
    tiles[:, :, :R] = abp.reshape(lead, R, n_st, WIDE_TS).permute(0, 2, 1, 3)
    if ab.dtype != torch.float32:
        per_row = 16 // ab.element_size()  # elements of a 16-byte core-matrix row
        tiles = tiles.reshape(-1, rc // per_row, per_row, WIDE_TS // 8, 8).permute(0, 3, 1, 4, 2)
    return tiles.reshape(lead * n_st, rp * WIDE_TS).contiguous()


def kernel_params(gmm: GmmSet, compute_dtype: str = "float32", layout: str = "chunked",
                  kc: Optional[int] = None, mode: str = "sum") -> Params:
    """The GMM in the layout of the kernel that ``compute_dtype`` and
    ``layout`` pick (``mode`` only sets the default kc of the wide layout)."""
    _check_layout(compute_dtype, layout)
    K = gmm.n_components
    if compute_dtype == "int8":
        qab, sab, c_t = int8_params(gmm)
        return Int8Params(kernel_panels(qab), sab, c_t)
    ab_t, c_t = component_major(gmm)
    ab_t, c_t = ab_t.to(COMPUTE_DTYPES[compute_dtype]), c_t.contiguous()
    if layout == "wide":
        kc = default_kc(compute_dtype, mode, K) if kc is None else kc
        if not 1 <= kc <= K:
            raise ValueError(f"kc must be in [1, {K}], got {kc}")
        return WideParams(c_t, kc, kernel_panels(wide_layout(ab_t, kc)))
    return KernelParams(c_t, kernel_panels(ab_t))


def _check_layout(compute_dtype: str, layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "wide" and compute_dtype == "int8":
        raise ValueError("layout='wide' applies to float32 and bfloat16 only")


def _check_params(params, x: torch.Tensor, expect) -> None:
    for name, shape, dtype in expect:
        p = getattr(params, name)
        if p.device != x.device or p.dtype != dtype or tuple(p.shape) != shape or not p.is_contiguous():
            raise ValueError(f"params.{name} must be contiguous {dtype} {list(shape)} on {x.device}, "
                             f"got {p.dtype} {list(p.shape)} on {p.device}")


def gmm_loglik_fused(
    x: torch.Tensor,
    gmm: GmmSet,
    compute_dtype: str = "float32",
    mode: str = "sum",
    params: Optional[Params] = None,
    layout: str = "chunked",
    kc: Optional[int] = None,
) -> torch.Tensor:
    """score(features) -> loglik: [N, D] x GmmSet -> [N, S] float32.

    compute_dtype "float32" is true fp32; "bfloat16" rounds the GEMM operands
    to bf16 and accumulates in float32; "int8" (sum mode only) quantizes them
    as ``am.gmm.gmm_loglik`` does and runs K5 (exact int32 products). mode
    "sum" is the exact mixture loglik, "max" the best-component approximation. layout "wide"
    (float32 and bfloat16) runs K1w over components in chunks of ``kc``
    (default :func:`default_kc`). ``params`` is ``kernel_params(gmm,
    compute_dtype, layout, kc, mode)``, made here when not given.
    """
    global LAUNCHES, WIDE_LAUNCHES, INT8_LAUNCHES
    check_scoring_args(compute_dtype, mode)
    _check_layout(compute_dtype, layout)
    S, K, D = gmm.means.shape
    if kc is not None and not 1 <= kc <= K:
        raise ValueError(f"kc must be in [1, {K}], got {kc}")
    if x.device.type == "cpu":
        return gmm_loglik(x, gmm, mode=mode, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gmm_loglik_fused: unsupported device {x.device}")
    _cuda.refuse_grad("K1/K1w/K5 (gmm_cuda.gmm_loglik_fused)", "score with am.gmm.gmm_loglik (the plain "
                      "scorer) under autograd, or run the kernels under torch.no_grad()", x, *gmm)
    if x.dim() != 2 or x.shape[1] != gmm.feat_dim:
        raise ValueError(f"x must be [N, {gmm.feat_dim}], got {tuple(x.shape)}")
    if params is None:
        params = kernel_params(gmm, compute_dtype, layout, kc, mode)
    N = x.shape[0]
    out = torch.empty((N, S), dtype=torch.float32, device=x.device)
    f32 = torch.float32

    n_st = -(-S // WIDE_TS)
    if compute_dtype == "int8":
        if not isinstance(params, Int8Params):
            raise ValueError("compute_dtype='int8' needs Int8Params (kernel_params(gmm, 'int8'))")
        rp = padded_rows(D, INT8_R_ALIGN)
        _check_params(params, x, (("panels", (K * n_st, WIDE_TS * rp), torch.int8), ("sab", (K, S), f32),
                                  ("c_t", (K, S), f32)))
        lib = _cuda.load("gmm_score", _SIGNATURES)
        if lib.gmm_int8_padded_rows(D) != rp:
            raise RuntimeError(f"csrc/gmm_tc.cuh pads int8 rows to {lib.gmm_int8_padded_rows(D)}, not {rp}")
        # zero columns leave each row's scale and the int32 sums as they are
        x2 = torch.nn.functional.pad(quadratic_features(x.to(f32)), (0, rp - 2 * D))
        qx, sx = quantize_int8(x2, dim=1)
        with torch.cuda.device(x.device):
            err = lib.gmm_int8(qx.data_ptr(), sx.data_ptr(), params.panels.data_ptr(), params.sab.data_ptr(),
                               params.c_t.data_ptr(), out.data_ptr(), N, D, S, K,
                               torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, "gmm_score", err, "gmm_int8 launch")
        INT8_LAUNCHES += int(N > 0)  # the entry point returns at once on no rows
        return out

    dt = COMPUTE_DTYPES[compute_dtype]
    xf = x.to(f32).contiguous()
    dcode, mcode = 0 if dt == f32 else 1, 0 if mode == "sum" else 1
    panel = WIDE_TS * padded_rows(D)
    if layout == "wide":
        if not isinstance(params, WideParams) or (kc is not None and params.kc != kc):
            raise ValueError(f"layout='wide' needs WideParams with kc={kc} "
                             "(kernel_params(gmm, compute_dtype, 'wide', kc))")
        n_panels, name, args = -(-K // params.kc) * n_st * params.kc, "gmm_wide", (K, params.kc)
    else:
        if not isinstance(params, KernelParams):
            raise ValueError("layout='chunked' needs KernelParams (kernel_params(gmm, compute_dtype))")
        n_panels, name, args = K * n_st, "gmm_score", (K,)
    _check_params(params, x, (("panels", (n_panels, panel), dt), ("c_t", (K, S), f32)))
    lib = _cuda.load(name, _WIDE_SIGNATURES if layout == "wide" else _SIGNATURES)
    if getattr(lib, f"{name}_tile_s")() != WIDE_TS:
        raise RuntimeError(f"csrc/{name}.cu tiles states by {getattr(lib, f'{name}_tile_s')()}, not {WIDE_TS}")
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(xf.data_ptr(), params.panels.data_ptr(), params.c_t.data_ptr(), out.data_ptr(),
                                 N, D, S, *args, dcode, mcode, torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, name, err, f"{name} launch")
    if layout == "wide":
        WIDE_LAUNCHES += int(N > 0)  # the entry points return at once on no rows
    else:
        LAUNCHES += int(N > 0)
    return out


def gmm_loglik_batched(feats: torch.Tensor, gmm: GmmSet, **kwargs) -> torch.Tensor:
    """Batched scorer over padded utterance batches: [B, T, D] -> [B, T, S]."""
    B, T, D = feats.shape
    return gmm_loglik_fused(feats.reshape(B * T, D), gmm, **kwargs).reshape(B, T, -1)

"""Fused GMM scorer: the port of mogasr/am/gmm_pallas.py on three CUDA kernels.

- K1, ``csrc/gmm_score.cu`` (``_gmm_kernel``): the chunked layout, float32 or
  bfloat16 operands, sum or max mode;
- K1w, ``csrc/gmm_wide.cu`` (``_gmm_kernel_wide``): the same function over
  the wide layout (``layout="wide"``), float32 or bfloat16;
- K5, ``csrc/gmm_int8.cu`` (``_gmm_kernel_int8``): int8 operands
  (``compute_dtype="int8"``), sum mode only.

``gmm_loglik_fused`` mirrors ``gmm_loglik_pallas``: a CUDA tensor runs a
kernel, a CPU tensor runs the plain version ``am.gmm.gmm_loglik`` (layout and
kc only arrange the same function); any other device raises. ``LAUNCHES``,
``WIDE_LAUNCHES`` and ``INT8_LAUNCHES`` count the launches of K1, K1w and K5
(none for N = 0). A caller that scores many batches with one GMM converts it
to the kernel's layout once, with :func:`kernel_params`, and passes it in.
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
    int8_params,
    natural_params,
    quadratic_features,
    quantize_int8,
)

LAUNCHES = 0
WIDE_LAUNCHES = 0
INT8_LAUNCHES = 0

LAYOUTS = ("chunked", "wide")
WIDE_TS = 32  # the wide layout's state-tile width: TSW in csrc/gmm_wide.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gmm_score": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}
_WIDE_SIGNATURES = {"gmm_wide": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], "gmm_wide_tile_s": []}
_INT8_SIGNATURES = {"gmm_int8": [_P] * 6 + [_I] * 4 + [_P]}


class KernelParams(NamedTuple):
    """A GmmSet in K1's component-major layout, contiguous.

    ab_t: [K, 2D, S] in the compute dtype; c_t: [K, S] float32.
    """

    ab_t: torch.Tensor
    c_t: torch.Tensor


class WideParams(NamedTuple):
    """A GmmSet in K1w's wide layout: ab_wide [ceil(K/kc), 2D,
    ceil(S/WIDE_TS) * kc * WIDE_TS] in the compute dtype (zero-padded),
    c_t [K, S] float32, and the component chunk kc."""

    ab_wide: torch.Tensor
    c_t: torch.Tensor
    kc: int


class Int8Params(NamedTuple):
    """A GmmSet quantized for K5 (``am.gmm.int8_params``): qab [K, 2D, S]
    int8, sab [K, S] float32 scales, c_t [K, S] float32."""

    qab: torch.Tensor
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


def kernel_params(gmm: GmmSet, compute_dtype: str = "float32", layout: str = "chunked",
                  kc: Optional[int] = None, mode: str = "sum") -> Params:
    """The GMM in the layout of the kernel that ``compute_dtype`` and
    ``layout`` pick (``mode`` only sets the default kc of the wide layout)."""
    _check_layout(compute_dtype, layout)
    S, K, D = gmm.means.shape
    if compute_dtype == "int8":
        return Int8Params(*int8_params(gmm))
    nat = natural_params(gmm)
    ab_t = nat.ab.reshape(2 * D, S, K).permute(2, 0, 1).to(COMPUTE_DTYPES[compute_dtype])
    c_t = nat.c.reshape(S, K).T.contiguous()
    if layout == "wide":
        kc = default_kc(compute_dtype, mode, K) if kc is None else kc
        if not 1 <= kc <= K:
            raise ValueError(f"kc must be in [1, {K}], got {kc}")
        return WideParams(wide_layout(ab_t, kc).contiguous(), c_t, kc)
    return KernelParams(ab_t.contiguous(), c_t)


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
    as ``am.gmm.gmm_loglik`` does and runs K5. mode "sum" is the exact
    mixture loglik, "max" the best-component approximation. layout "wide"
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
    if x.dim() != 2 or x.shape[1] != gmm.feat_dim:
        raise ValueError(f"x must be [N, {gmm.feat_dim}], got {tuple(x.shape)}")
    if params is None:
        params = kernel_params(gmm, compute_dtype, layout, kc, mode)
    N = x.shape[0]
    out = torch.empty((N, S), dtype=torch.float32, device=x.device)
    x2 = quadratic_features(x.to(torch.float32))
    f32 = torch.float32

    if compute_dtype == "int8":
        if not isinstance(params, Int8Params):
            raise ValueError("compute_dtype='int8' needs Int8Params (kernel_params(gmm, 'int8'))")
        _check_params(params, x, (("qab", (K, 2 * D, S), torch.int8), ("sab", (K, S), f32),
                                  ("c_t", (K, S), f32)))
        qx, sx = quantize_int8(x2, dim=1)
        lib = _cuda.load("gmm_int8", _INT8_SIGNATURES)
        with torch.cuda.device(x.device):
            err = lib.gmm_int8(qx.contiguous().data_ptr(), sx.contiguous().data_ptr(),
                               params.qab.data_ptr(), params.sab.data_ptr(), params.c_t.data_ptr(),
                               out.data_ptr(), N, 2 * D, S, K, torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, "gmm_int8", err, "gmm_int8 launch")
        INT8_LAUNCHES += int(N > 0)  # the entry point returns at once on no rows
        return out

    dt = COMPUTE_DTYPES[compute_dtype]
    x2 = x2.to(dt).contiguous()
    dcode, mcode = 0 if dt == f32 else 1, 0 if mode == "sum" else 1
    if layout == "wide":
        if not isinstance(params, WideParams) or (kc is not None and params.kc != kc):
            raise ValueError(f"layout='wide' needs WideParams with kc={kc} "
                             "(kernel_params(gmm, compute_dtype, 'wide', kc))")
        n_kc, n_st = -(-K // params.kc), -(-S // WIDE_TS)
        _check_params(params, x, (("ab_wide", (n_kc, 2 * D, n_st * params.kc * WIDE_TS), dt),
                                  ("c_t", (K, S), f32)))
        lib = _cuda.load("gmm_wide", _WIDE_SIGNATURES)
        if lib.gmm_wide_tile_s() != WIDE_TS:
            raise RuntimeError(f"csrc/gmm_wide.cu tiles states by {lib.gmm_wide_tile_s()}, not {WIDE_TS}")
        with torch.cuda.device(x.device):
            err = lib.gmm_wide(x2.data_ptr(), params.ab_wide.data_ptr(), params.c_t.data_ptr(),
                               out.data_ptr(), N, 2 * D, S, K, params.kc, dcode, mcode,
                               torch.cuda.current_stream().cuda_stream)
        _cuda.check(lib, "gmm_wide", err, "gmm_wide launch")
        WIDE_LAUNCHES += int(N > 0)
        return out

    if not isinstance(params, KernelParams):
        raise ValueError("layout='chunked' needs KernelParams (kernel_params(gmm, compute_dtype))")
    _check_params(params, x, (("ab_t", (K, 2 * D, S), dt), ("c_t", (K, S), f32)))
    lib = _cuda.load("gmm_score", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.gmm_score(x2.data_ptr(), params.ab_t.data_ptr(), params.c_t.data_ptr(), out.data_ptr(),
                            N, 2 * D, S, K, dcode, mcode, torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, "gmm_score", err, "gmm_score launch")
    LAUNCHES += int(N > 0)
    return out


def gmm_loglik_batched(feats: torch.Tensor, gmm: GmmSet, **kwargs) -> torch.Tensor:
    """Batched scorer over padded utterance batches: [B, T, D] -> [B, T, S]."""
    B, T, D = feats.shape
    return gmm_loglik_fused(feats.reshape(B * T, D), gmm, **kwargs).reshape(B, T, -1)

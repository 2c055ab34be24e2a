"""Fused GMM scorer: the port of mogasr/am/gmm_pallas.py on the CUDA kernel
``csrc/gmm_score.cu`` (kernel K1).

``gmm_loglik_fused`` mirrors ``gmm_loglik_pallas``: a CUDA tensor runs the
kernel, a CPU tensor runs the plain version ``am.gmm.gmm_loglik``; any other
device raises. ``LAUNCHES`` counts kernel launches (none for N = 0). A
caller that scores many batches with one GMM converts it to the kernel's
layout once, with :func:`kernel_params`, and passes the result in.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from mogasr_torch import _cuda
from mogasr_torch.am.gmm import (
    COMPUTE_DTYPES,
    GmmSet,
    check_scoring_args,
    gmm_loglik,
    natural_params,
    quadratic_features,
)

LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gmm_score": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}


class KernelParams(NamedTuple):
    """A GmmSet in the kernel's component-major layout, contiguous.

    ab_t: [K, 2D, S] in the compute dtype; c_t: [K, S] float32.
    """

    ab_t: torch.Tensor
    c_t: torch.Tensor


def kernel_params(gmm: GmmSet, compute_dtype: str = "float32") -> KernelParams:
    S, K, D = gmm.means.shape
    nat = natural_params(gmm)
    ab_t = nat.ab.reshape(2 * D, S, K).permute(2, 0, 1)
    return KernelParams(
        ab_t.to(COMPUTE_DTYPES[compute_dtype]).contiguous(),
        nat.c.reshape(S, K).T.contiguous(),
    )


def gmm_loglik_fused(
    x: torch.Tensor,
    gmm: GmmSet,
    compute_dtype: str = "float32",
    mode: str = "sum",
    params: Optional[KernelParams] = None,
) -> torch.Tensor:
    """score(features) -> loglik: [N, D] x GmmSet -> [N, S] float32.

    compute_dtype "float32" is true fp32; "bfloat16" rounds the GEMM operands
    to bf16 and accumulates in float32. mode "sum" is the exact mixture
    loglik, "max" the best-component approximation. ``params`` is
    ``kernel_params(gmm, compute_dtype)``, made here when not given.
    """
    global LAUNCHES
    check_scoring_args(compute_dtype, mode)
    if x.device.type == "cpu":
        return gmm_loglik(x, gmm, mode=mode, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gmm_loglik_fused: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != gmm.feat_dim:
        raise ValueError(f"x must be [N, {gmm.feat_dim}], got {tuple(x.shape)}")
    S, K, D = gmm.means.shape
    dt = COMPUTE_DTYPES[compute_dtype]
    if params is None:
        params = kernel_params(gmm, compute_dtype)
    ab_t, c_t = params
    for name, p, dtype, shape in (("ab_t", ab_t, dt, (K, 2 * D, S)),
                                  ("c_t", c_t, torch.float32, (K, S))):
        if p.device != x.device or p.dtype != dtype or tuple(p.shape) != shape or not p.is_contiguous():
            raise ValueError(f"params.{name} must be contiguous {dtype} {list(shape)} on {x.device}, "
                             f"got {p.dtype} {list(p.shape)} on {p.device}")
    x2 = quadratic_features(x.to(torch.float32)).to(dt).contiguous()
    N = x.shape[0]
    out = torch.empty((N, S), dtype=torch.float32, device=x.device)
    lib = _cuda.load("gmm_score", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gmm_score(
            x2.data_ptr(), ab_t.data_ptr(), c_t.data_ptr(), out.data_ptr(),
            N, 2 * D, S, K, 0 if dt == torch.float32 else 1,
            0 if mode == "sum" else 1, stream,
        )
    _cuda.check(lib, "gmm_score", err, "gmm_score launch")
    LAUNCHES += int(N > 0)  # the entry point returns at once on no rows
    return out


def gmm_loglik_batched(feats: torch.Tensor, gmm: GmmSet, **kwargs) -> torch.Tensor:
    """Batched scorer over padded utterance batches: [B, T, D] -> [B, T, S]."""
    B, T, D = feats.shape
    return gmm_loglik_fused(feats.reshape(B * T, D), gmm, **kwargs).reshape(B, T, -1)

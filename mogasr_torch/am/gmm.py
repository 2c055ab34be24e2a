"""Diagonal-covariance GMM acoustic model in PyTorch: the port of mogasr/am/gmm.py.

Scoring in GEMM form, as in the reference:

    loglik[n, s] = fold_k( c[s,k] + x_n . b[s,k] + x_n^2 . a[s,k] )

with a = -0.5/var, b = mean/var, c = log w - 0.5 (D log 2pi + sum log var +
sum mean^2/var), and fold = logsumexp (``mode="sum"``) or max (``mode="max"``,
the best-component Viterbi approximation). :func:`gmm_loglik` is the plain
version of the CUDA kernels in ``gmm_cuda`` (chunked over states so the
[N, S*K] score tensor is never whole); the kernels are held against it.

``compute_dtype="int8"`` is the reference's int8 arm (mogasr/am/gmm_pallas.py
:234-244, kernel ``_gmm_kernel_int8``): x2 quantized symmetrically per frame
row, each (component, state) column of ab over its 2D rows, c kept float32;
sum mode only.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mogasr_torch.config import GmmConfig

LOG_2PI = math.log(2.0 * math.pi)

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
MODES = ("sum", "max")
STATE_CHUNK = 128  # states per GEMM in the plain scorer: [N, 128*K] scores at a time


class GmmSet(NamedTuple):
    """Per-state GMM parameters as float32 tensors.

    weights: [S, K] mixture weights (sum to 1 over K)
    means:   [S, K, D]
    vars:    [S, K, D] diagonal covariances
    """

    weights: torch.Tensor
    means: torch.Tensor
    vars: torch.Tensor

    @property
    def n_states(self) -> int:
        return self.weights.shape[0]

    @property
    def n_components(self) -> int:
        return self.weights.shape[1]

    @property
    def feat_dim(self) -> int:
        return self.means.shape[-1]


def gmm_from_numpy(weights, means, vars, device: torch.device) -> GmmSet:
    """A GmmSet on ``device`` from numpy-convertible parameters, e.g. the
    reference's ``np.asarray(jax_gmm.means)`` or a bundle's ``gmm.npz``."""

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return GmmSet(f32(weights), f32(means), f32(vars))


def init_gmm(
    cfg: GmmConfig,
    generator: Optional[torch.Generator] = None,
    data_mean: Optional[np.ndarray] = None,
    data_var: Optional[np.ndarray] = None,
    n_states: Optional[int] = None,
    n_components: Optional[int] = None,
    device: torch.device = torch.device("cuda"),
) -> GmmSet:
    """Random init around the data statistics (or a standard normal): equal
    weights, the data variance, means at mean + 0.5 * std * N(0, 1) drawn
    from ``generator`` on the CPU. The reference draws from a JAX key, so the
    two agree in distribution, not in values."""
    S = n_states if n_states is not None else cfg.n_states
    K = n_components if n_components is not None else cfg.n_components
    D = cfg.feat_dim
    mu0 = torch.zeros(D) if data_mean is None else torch.as_tensor(np.asarray(data_mean, np.float32))
    var0 = torch.ones(D) if data_var is None else torch.as_tensor(np.asarray(data_var, np.float32))
    means = mu0 + torch.randn((S, K, D), generator=generator) * torch.sqrt(var0) * 0.5
    return GmmSet(torch.full((S, K), 1.0 / K, device=device), means.to(device),
                  var0.expand(S, K, D).contiguous().to(device))


class NaturalParams(NamedTuple):
    """GEMM-ready natural parameters. ab: [2D, S*K] (a on top, b below); c: [S*K]."""

    ab: torch.Tensor
    c: torch.Tensor
    n_states: int
    n_components: int


def natural_params(gmm: GmmSet, var_floor: float = 1e-3) -> NaturalParams:
    S, K, D = gmm.means.shape
    v = torch.clamp(gmm.vars, min=var_floor)
    a = -0.5 / v
    b = gmm.means / v
    c = torch.log(torch.clamp(gmm.weights, min=1e-30)) - 0.5 * (
        D * LOG_2PI + torch.log(v).sum(-1) + (gmm.means**2 / v).sum(-1)
    )
    ab = torch.cat(
        [a.permute(2, 0, 1).reshape(D, S * K), b.permute(2, 0, 1).reshape(D, S * K)],
        dim=0,
    )
    return NaturalParams(ab=ab, c=c.reshape(S * K), n_states=S, n_components=K)


def quadratic_features(x: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N, 2D] with x^2 on the left to match NaturalParams.ab."""
    return torch.cat([x * x, x], dim=-1)


def check_scoring_args(compute_dtype: str, mode: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {compute_dtype!r}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "max" and compute_dtype == "int8":
        raise NotImplementedError("mode='max' supports float32/bfloat16 only")


def quantize_int8(a: torch.Tensor, dim: int):
    """Symmetric int8 quantization of float32 ``a`` over ``dim``, as
    gmm_pallas.py:239-240,243-244: scale = max(max |a|, 1e-10) / 127 and
    q = clip(round(a / scale), -127, 127), rounding half to even. Returns
    (q int8, scale float32 with ``dim`` dropped); a ~= q * scale."""
    amax = torch.clamp(a.abs().amax(dim=dim, keepdim=True), min=1e-10)
    # a true division on every device: CUDA divides by a Python scalar as a
    # multiplication by its reciprocal, which rounds differently
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(dim)


def component_major(gmm: GmmSet):
    """(ab_t [K, 2D, S], c_t [K, S]) float32: the natural parameters
    component-major, ab_t[k, r, s] = ab[r, s*K + k] and c_t[k, s] = c[s*K +
    k], the reference's transposed_natural_params (gmm_pallas.py)."""
    S, K, D = gmm.means.shape
    nat = natural_params(gmm)
    return nat.ab.reshape(2 * D, S, K).permute(2, 0, 1), nat.c.reshape(S, K).T


def int8_params(gmm: GmmSet):
    """The int8 model: (qab [K, 2D, S] int8, sab [K, S] f32, c_t [K, S] f32),
    each (component, state) column of the component-major ab quantized over
    its 2D rows; 4x smaller than the float32 ab."""
    ab_t, c_t = component_major(gmm)
    qab, sab = quantize_int8(ab_t, dim=1)
    return qab.contiguous(), sab.contiguous(), c_t.contiguous()


def gmm_loglik(
    x: torch.Tensor,
    gmm: GmmSet,
    mode: str = "sum",
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Plain scorer: [N, D] -> [N, S] float32, chunked over states.

    compute_dtype="bfloat16" rounds the GEMM operands (x2 and ab) to bf16
    and multiplies them in float32; the Gaussian constant c stays float32
    and is added after the product. That is exactly what the CUDA kernel
    computes, so the two agree up to float32 summation order.

    compute_dtype="int8" (sum mode only) quantizes x2 per frame row and ab
    per (component, state) column (:func:`quantize_int8`), forms the integer
    products as a float32 matmul of int8-valued tensors (exact: every partial
    sum is an integer below 2D * 127**2 = 1,258,062 < 2**24) and dequantizes
    them in the reference's order (gmm_pallas.py:65-66), ``(acc * sx) * sab
    + c``, each op rounded alone, as the int8 kernel does.
    """
    check_scoring_args(compute_dtype, mode)
    S, K, D = gmm.means.shape
    x2 = quadratic_features(x.to(torch.float32))
    if compute_dtype == "int8":
        return _gmm_loglik_int8(x2, gmm)
    nat = natural_params(gmm)
    ab = nat.ab.reshape(2 * D, S, K)
    c = nat.c.reshape(S, K)
    if compute_dtype == "bfloat16":
        x2 = x2.to(torch.bfloat16).to(torch.float32)
        ab = ab.to(torch.bfloat16).to(torch.float32)
    out = []
    for s0 in range(0, S, STATE_CHUNK):
        s1 = min(s0 + STATE_CHUNK, S)
        ab_c = ab[:, s0:s1].reshape(2 * D, (s1 - s0) * K)
        scores = (x2 @ ab_c).reshape(-1, s1 - s0, K) + c[None, s0:s1]
        if mode == "max":
            out.append(scores.amax(dim=-1))
        else:
            out.append(torch.logsumexp(scores, dim=-1))
    return torch.cat(out, dim=1)


def _gmm_loglik_int8(x2: torch.Tensor, gmm: GmmSet) -> torch.Tensor:
    S, K, D = gmm.means.shape
    qx, sx = quantize_int8(x2, dim=1)
    qab, sab, c_t = int8_params(gmm)
    qx, sx = qx.to(torch.float32), sx[:, None, None]
    out = []
    for s0 in range(0, S, STATE_CHUNK):
        s1 = min(s0 + STATE_CHUNK, S)
        q = qab[:, :, s0:s1].to(torch.float32).permute(1, 0, 2).reshape(2 * D, K * (s1 - s0))
        acc = (qx @ q).reshape(-1, K, s1 - s0)
        scores = (acc * sx) * sab[None, :, s0:s1] + c_t[None, :, s0:s1]
        out.append(torch.logsumexp(scores, dim=1))
    return torch.cat(out, dim=1)

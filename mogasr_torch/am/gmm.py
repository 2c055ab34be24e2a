"""Diagonal-covariance GMM acoustic model in PyTorch: the port of mogasr/am/gmm.py.

Scoring in GEMM form, as in the reference:

    loglik[n, s] = fold_k( c[s,k] + x_n . b[s,k] + x_n^2 . a[s,k] )

with a = -0.5/var, b = mean/var, c = log w - 0.5 (D log 2pi + sum log var +
sum mean^2/var), and fold = logsumexp (``mode="sum"``) or max (``mode="max"``,
the best-component Viterbi approximation). :func:`gmm_loglik` is the plain
version of the CUDA kernel in ``gmm_cuda`` (chunked over states so the
[N, S*K] score tensor is never whole); the kernel is held against it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
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
    """
    check_scoring_args(compute_dtype, mode)
    S, K, D = gmm.means.shape
    nat = natural_params(gmm)
    x2 = quadratic_features(x.to(torch.float32))
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

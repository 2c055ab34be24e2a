"""Semi-tied covariance / MLLT in PyTorch: the port of mogasr/am/stc.py.

Model: Sigma_m = A^{-1} diag(sigma_m^2) A^{-T}, i.e. score in the
transformed space y = A x against means A mu_m and per-component diagonal
variances. Estimation alternates (on the host, float64 numpy, the
reference's code with its three-operand einsums written as stacked
products on BLAS, where numpy runs the einsums as C loops over every term;
the sums' order moves the results by ~1e-14):

  1. variances:  sigma_m,i^2 = (A W_m A^T)_{ii}
  2. rows of A:  a_i = c_i G_i^{-1} * sqrt(beta / (c_i G_i^{-1} c_i^T)),
                 G_i = sum_m (occ_m / sigma_m,i^2) W_m

The [S, K, D, D] within-component scatters accumulate on the device of the
features. The reference's einsum "ns,nk,nkd,nke->skde" would build
[N, K, D, D] for a batch (1.8 GB on a 32 x 550 training batch at K = 16,
D = 40); here each chunk of frames, sorted by state, forms its own
gamma (x - mu)(x - mu)^T and one segment sum adds it into its run of states
(``am.aligned.state_sums``, under ``CHUNK_BYTES``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mogasr_torch.am.aligned import component_posteriors, gather_bytes, state_sums
from mogasr_torch.am.gmm import GmmSet


class StcStats(NamedTuple):
    """Per-(state, component) occupancy and within scatter."""

    occ: torch.Tensor      # [S, K]
    scatter: torch.Tensor  # [S, K, D, D]  sum_t gamma (x - mu)(x - mu)^T


def add_stc_stats(a: StcStats, b: StcStats) -> StcStats:
    return StcStats(a.occ + b.occ, a.scatter + b.scatter)


def accumulate_stc_stats(
    gmm: GmmSet,
    feats: torch.Tensor,   # [N, D]
    labels: torch.Tensor,  # [N] aligned pdf ids, -1 = padding
) -> StcStats:
    S, K, D = gmm.means.shape
    labels = labels.to(feats.device)

    def per_frame(idx):
        x = feats[idx]
        gamma, mu, _var = component_posteriors(gmm, x, labels[idx])
        d = x[:, None, :] - mu                                          # [n, K, D]
        outer = gamma[:, :, None, None] * d[:, :, :, None] * d[:, :, None, :]
        return torch.cat([gamma, outer.reshape(-1, K * D * D)], dim=1)

    # per frame: the gathered operands and the [K, D, D] products, twice
    sums = state_sums(per_frame, labels, S, K + K * D * D, gather_bytes(gmm) + 8 * K * D * D)
    return StcStats(sums[:, :K].contiguous(), sums[:, K:].reshape(S, K, D, D))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _diag_aw_at(A: np.ndarray, Wn: np.ndarray) -> np.ndarray:
    """[M, D]: diag(A W_m A^T) per component, the reference's einsum
    "id,mde,ie->mi" as one product (numpy runs that einsum as a C loop over
    all M * D^3 terms)."""
    D = A.shape[0]
    return Wn.reshape(-1, D * D) @ np.einsum("id,ie->dei", A, A).reshape(D * D, D)


def solve_stc(
    gmm: GmmSet,
    stats: StcStats,
    n_iters: int = 10,
    var_floor: float = 1e-4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Alternating MLLT solve -> (A [D, D], vars [S, K, D] in y-space)."""
    S, K, D = gmm.means.shape
    occ = np.asarray(_np(stats.occ), np.float64).reshape(-1)              # [M]
    W = np.asarray(_np(stats.scatter), np.float64).reshape(-1, D, D)
    keep = occ > 1e-6
    occ_k, W_k = occ[keep], W[keep]
    # normalize scatters to per-frame covariances
    Wn = W_k / np.maximum(occ_k, 1e-10)[:, None, None]
    beta = occ_k.sum()
    A = np.eye(D)
    for _ in range(n_iters):
        # 1. diagonal variances in the transformed space
        var = np.maximum(_diag_aw_at(A, Wn), var_floor)  # [M, D]
        # 2. exact per-row updates given the others; every row's
        # G_i = sum_m (occ_m / var_m,i) W_m from one product (the variances
        # stay fixed through the sweep)
        Gs = np.tensordot(occ_k[:, None] / var, Wn, axes=(0, 0))  # [D, D, D]
        for i in range(D):
            Gi = np.linalg.inv(Gs[i] + 1e-8 * np.eye(D))
            cof = np.linalg.det(A) * np.linalg.inv(A).T[i]
            denom = float(cof @ Gi @ cof)
            if denom <= 0:
                continue
            A[i] = cof @ Gi * np.sqrt(beta / denom)
    var = np.maximum(_diag_aw_at(A, Wn), var_floor)
    vars_full = np.tile(np.mean(var, axis=0), (occ.shape[0], 1))
    vars_full[keep] = var
    return A.astype(np.float32), vars_full.reshape(S, K, D).astype(np.float32)


def stc_aux_loglik(A: np.ndarray, gmm: GmmSet, stats: StcStats, vars_y: np.ndarray) -> float:
    """Mean per-frame auxiliary log-likelihood (incl. log|det A|): the
    monotonicity check for the alternating solve."""
    S, K, D = gmm.means.shape
    occ = np.asarray(_np(stats.occ), np.float64).reshape(-1)
    W = np.asarray(_np(stats.scatter), np.float64).reshape(-1, D, D)
    keep = occ > 1e-6
    occ_k = occ[keep]
    Wn = W[keep] / np.maximum(occ_k, 1e-10)[:, None, None]
    var = np.maximum(np.asarray(vars_y, np.float64).reshape(-1, D)[keep], 1e-10)
    beta = occ_k.sum()
    _sign, logdet = np.linalg.slogdet(np.asarray(A, np.float64))
    diag = _diag_aw_at(np.asarray(A, np.float64), Wn)
    q = beta * logdet - 0.5 * float(
        np.sum(occ_k[:, None] * (np.log(2 * np.pi * var) + diag / var))
    )
    return q / max(beta, 1e-10)


def apply_stc(gmm: GmmSet, A: np.ndarray, vars_y: np.ndarray) -> GmmSet:
    """GmmSet scoring in the transformed space: means A mu, variances vars_y.
    Pair with features y = A x (fmllr.apply_fmllr with zero bias)."""
    At = torch.as_tensor(np.array(A, np.float32), device=gmm.means.device)
    new_means = torch.einsum("skd,ed->ske", gmm.means, At)
    return GmmSet(gmm.weights, new_means,
                  torch.as_tensor(np.array(vars_y, np.float32), device=gmm.vars.device))


def stc_feature_transform(A: np.ndarray) -> np.ndarray:
    """[D, D+1] transform for fmllr.apply_fmllr (zero bias)."""
    D = A.shape[0]
    return np.concatenate([A, np.zeros((D, 1), A.dtype)], axis=1).astype(np.float32)


def estimate_stc(
    gmm: GmmSet,
    feats_list,   # iterable of ([N_i, D] feats, [N_i] labels)
    n_iters: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulate scatter stats over batches and run the alternating solve."""
    stats = None
    for feats, labels in feats_list:
        s = accumulate_stc_stats(gmm, feats, labels)
        stats = s if stats is None else add_stc_stats(stats, s)
    return solve_stc(gmm, stats, n_iters=n_iters)

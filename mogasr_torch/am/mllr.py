"""MLLR speaker adaptation (model-space mean transform) in PyTorch: the port
of mogasr/am/mllr.py.

Adapts the GMM means with an affine transform mu' = A mu + b (mean-only
MLLR); each transform row has a closed form

    w_i = G_i^{-1} k_i,
    k_i[e]    = sum_m  sigma_{m,i}^{-2} (sum_t gamma_m x_{t,i}) xi_{m,e}
    G_i[e,f]  = sum_m  occ_m sigma_{m,i}^{-2} xi_{m,e} xi_{m,f}

with xi_m = [mu_m; 1]. The per-(state, component) occupancies and first
moments accumulate on the device of the features, summed per state with the
sorted segment sums of ``am.aligned.state_sums`` (the reference's one-hot
einsums; the same bits on every run) in frame chunks; the [D, D+1] solves
(global, and per regression class with a back-off to the global transform)
run on the host in float64 numpy, the reference's code but for one sum
written as a product (``_solve_rows``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mogasr_torch.am.aligned import component_posteriors, gather_bytes, state_sums
from mogasr_torch.am.gmm import GmmSet


class MllrStats(NamedTuple):
    """Per-(state, component) sufficient statistics."""

    occ: torch.Tensor    # [S, K]    sum_t gamma
    xsum: torch.Tensor   # [S, K, D] sum_t gamma * x_t


def add_mllr_stats(a: MllrStats, b: MllrStats) -> MllrStats:
    return MllrStats(a.occ + b.occ, a.xsum + b.xsum)


def accumulate_mllr_stats(
    gmm: GmmSet,
    feats: torch.Tensor,   # [N, D]
    labels: torch.Tensor,  # [N] aligned pdf ids, -1 = padding
) -> MllrStats:
    S, K, D = gmm.means.shape
    labels = labels.to(feats.device)

    def per_frame(idx):
        x = feats[idx]
        gamma, _mu, _var = component_posteriors(gmm, x, labels[idx])
        return torch.cat([gamma, (gamma[:, :, None] * x[:, None, :]).reshape(-1, K * D)], dim=1)

    sums = state_sums(per_frame, labels, S, K + K * D, gather_bytes(gmm))
    return MllrStats(sums[:, :K].contiguous(), sums[:, K:].reshape(S, K, D))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _solve_rows(
    occ: np.ndarray, xsum: np.ndarray, means: np.ndarray, var: np.ndarray,
    min_occ: float,
) -> Optional[np.ndarray]:
    """Row-wise closed-form solve over flat [M]-indexed Gaussian stats.
    Returns W [D, D+1], or None when occupancy is too small to estimate."""
    D = means.shape[1]
    if occ.sum() < max(min_occ, D + 1):
        return None
    keep = occ > 1e-8
    occ, xsum, means, var = occ[keep], xsum[keep], means[keep], var[keep]
    xi = np.concatenate([means, np.ones((means.shape[0], 1))], axis=1)  # [M, D+1]
    inv_var = 1.0 / var                                                  # [M, D]
    # k[d] = sum_m inv_var[m,d] * xsum[m,d] * xi[m]   -> [D, D+1]
    k = np.einsum("md,me->de", inv_var * xsum, xi)
    # G[d] = sum_m occ[m] inv_var[m,d] xi[m] xi[m]^T  -> [D, D+1, D+1], the
    # reference's einsum "md,me,mf->def" as one stacked product: numpy runs
    # that three-operand einsum as a C loop over all M * D * (D+1)^2 terms,
    # the product runs on BLAS; the sums' order moves G by ~1e-14 of its
    # largest entry
    G = ((occ[:, None] * inv_var).T[:, None, :] * xi.T[None, :, :]) @ xi
    W = np.empty((D, D + 1))
    for i in range(D):
        W[i] = np.linalg.solve(G[i] + 1e-6 * np.eye(D + 1), k[i])
    return W.astype(np.float32)


def _flat_stats(gmm: GmmSet, stats: MllrStats):
    occ = np.asarray(_np(stats.occ), np.float64).reshape(-1)                  # [M]
    xsum = np.asarray(_np(stats.xsum), np.float64).reshape(occ.shape[0], -1)  # [M, D]
    means = np.asarray(_np(gmm.means), np.float64).reshape(occ.shape[0], -1)
    var = np.maximum(np.asarray(_np(gmm.vars), np.float64).reshape(occ.shape[0], -1), 1e-8)
    return occ, xsum, means, var


def solve_mllr(gmm: GmmSet, stats: MllrStats, min_occ: float = 1.0) -> np.ndarray:
    """Closed-form GLOBAL mean-MLLR solve -> W = [A | b], shape [D, D+1].

    Components with negligible occupancy contribute nothing; if the total
    occupancy is too small to estimate D*(D+1) parameters, returns identity.
    """
    occ, xsum, means, var = _flat_stats(gmm, stats)
    D = means.shape[1]
    W = _solve_rows(occ, xsum, means, var, min_occ)
    if W is None:
        return np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1).astype(np.float32)
    return W


def speech_sil_classes(topo) -> np.ndarray:
    """[n_pdfs] regression classes: 0 = silence pdfs, 1 = speech pdfs."""
    classes = np.ones(topo.n_pdfs, np.int32)
    classes[: topo.sil_states] = 0
    return classes


def solve_mllr_classes(
    gmm: GmmSet,
    stats: MllrStats,
    classes: np.ndarray,     # [S] regression class per pdf state
    min_occ: float = 1.0,
) -> np.ndarray:
    """Per-regression-class mean-MLLR -> W [n_classes, D, D+1]; a class with
    too little occupancy backs off to the GLOBAL transform (or identity when
    even the global one is unestimable)."""
    occ, xsum, means, var = _flat_stats(gmm, stats)
    S, K = _np(stats.occ).shape
    D = means.shape[1]
    member = np.repeat(np.asarray(classes, np.int32), K)  # [S*K]
    n_classes = int(classes.max()) + 1
    W_global = solve_mllr(gmm, stats, min_occ=min_occ)
    out = np.empty((n_classes, D, D + 1), np.float32)
    for c in range(n_classes):
        m = member == c
        W = _solve_rows(occ[m], xsum[m], means[m], var[m], min_occ)
        out[c] = W_global if W is None else W
    return out


def apply_mllr_classes(gmm: GmmSet, Ws: np.ndarray, classes: np.ndarray) -> GmmSet:
    """Adapted means with one transform per regression class."""
    Wt = torch.as_tensor(np.array(Ws, np.float32), device=gmm.means.device)   # [C, D, D+1]
    cls = torch.as_tensor(np.array(classes, np.int64), device=gmm.means.device)  # [S]
    A = Wt[cls, :, :-1]                                 # [S, D, D]
    b = Wt[cls, :, -1]                                  # [S, D]
    new_means = torch.einsum("skd,sed->ske", gmm.means, A) + b[:, None, :]
    return gmm._replace(means=new_means)


def apply_mllr(gmm: GmmSet, W: np.ndarray) -> GmmSet:
    """Return a GmmSet with adapted means mu' = A mu + b (vars untouched)."""
    Wt = torch.as_tensor(np.array(W, np.float32), device=gmm.means.device)
    new_means = torch.einsum("skd,ed->ske", gmm.means, Wt[:, :-1]) + Wt[:, -1]
    return gmm._replace(means=new_means)


def estimate_mllr(
    gmm: GmmSet,
    feats_list,   # iterable of ([N_i, D] feats, [N_i] labels) per batch
    min_occ: float = 1.0,
) -> np.ndarray:
    """Accumulate stats over batches (one speaker/session) and solve."""
    stats = None
    for feats, labels in feats_list:
        s = accumulate_mllr_stats(gmm, feats, labels)
        stats = s if stats is None else add_mllr_stats(stats, s)
    return solve_mllr(gmm, stats, min_occ=min_occ)

"""fMLLR / CMLLR speaker adaptation in PyTorch: the port of mogasr/am/fmllr.py.

Estimates an affine feature transform x' = A x + b per speaker/session that
maximizes the GMM likelihood (with the log|A| Jacobian term). The statistics
accumulate on the device of the features (the aligned state's component
posteriors, then two products over frames), in frame chunks under
``am.aligned.CHUNK_BYTES``; the [D, (D+1)^2]-sized solve runs on the host in
float64 numpy with the reference's row-wise cofactor iteration:

    w_i = G_i^{-1} (k_i + alpha * p_i),
    alpha from the quadratic  alpha^2 (p G^-1 p) + alpha (p G^-1 k) - beta = 0,

where p_i is the extended cofactor row of A. ``solve_fmllr`` and
``_aux_objective`` are the reference's code on numpy copies of the
statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mogasr_torch.am.aligned import component_posteriors, frame_chunks, gather_bytes
from mogasr_torch.am.gmm import GmmSet


class FmllrStats(NamedTuple):
    """Sufficient statistics (tensors, or numpy arrays on the host).

    k_stat: [D, D+1]        sum_t sum_k gamma (mu/var) xi^T
    g_stat: [D, D+1, D+1]   per-row sum_t (sum_k gamma/var_i) xi xi^T
    beta:   []              total posterior mass (frame count)
    """

    k_stat: torch.Tensor
    g_stat: torch.Tensor
    beta: torch.Tensor


def add_fmllr_stats(a: FmllrStats, b: FmllrStats) -> FmllrStats:
    return FmllrStats(a.k_stat + b.k_stat, a.g_stat + b.g_stat, a.beta + b.beta)


def accumulate_fmllr_stats(
    gmm: GmmSet,
    feats: torch.Tensor,   # [N, D]
    labels: torch.Tensor,  # [N] aligned pdf ids, -1 = padding
) -> FmllrStats:
    _S, _K, D = gmm.means.shape
    labels = labels.to(feats.device)
    k_stat = torch.zeros((D, D + 1), dtype=torch.float32, device=feats.device)
    g_stat = torch.zeros((D, (D + 1) ** 2), dtype=torch.float32, device=feats.device)
    beta = torch.zeros((), dtype=torch.float32, device=feats.device)
    for a, b in frame_chunks(feats.shape[0], gather_bytes(gmm) + 8 * (D + 1) ** 2):
        x = feats[a:b]
        gamma, mu, var = component_posteriors(gmm, x, labels[a:b])   # [n, K]
        xi = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)        # [n, D+1]
        # k_stat[d, e] = sum_n sum_k gamma * mu/var [n,k,d] * xi[n,e]
        gmv = torch.einsum("nk,nkd->nd", gamma, mu / var)            # [n, D]
        k_stat += gmv.T @ xi
        # g_stat[d] = sum_n (sum_k gamma/var_d) xi xi^T
        gv = torch.einsum("nk,nkd->nd", gamma, 1.0 / var)           # [n, D]
        g_stat += gv.T @ (xi[:, :, None] * xi[:, None, :]).reshape(-1, (D + 1) ** 2)
        beta += gamma.sum()
    return FmllrStats(k_stat, g_stat.reshape(D, D + 1, D + 1), beta)


def host_stats(stats: FmllrStats) -> FmllrStats:
    """The statistics as numpy arrays (the host solve's input)."""
    return FmllrStats(*(t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t) for t in stats))


def _aux_objective(W: np.ndarray, stats) -> float:
    A = W[:, :-1]
    beta = float(stats.beta)
    q = beta * np.log(abs(np.linalg.det(A)) + 1e-300)
    for i in range(W.shape[0]):
        q += float(W[i] @ np.asarray(stats.k_stat)[i])
        q -= 0.5 * float(W[i] @ np.asarray(stats.g_stat)[i] @ W[i])
    return q


def solve_fmllr(stats: FmllrStats, n_sweeps: int = 10) -> np.ndarray:
    """Row-iterative fMLLR solve -> W = [A | b], shape [D, D+1]."""
    stats = host_stats(stats)
    k_stat = np.asarray(stats.k_stat, np.float64)
    g_stat = np.asarray(stats.g_stat, np.float64)
    beta = float(stats.beta)
    D = k_stat.shape[0]
    W = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)  # init: identity

    g_inv = [np.linalg.inv(g_stat[i] + 1e-6 * np.eye(D + 1)) for i in range(D)]
    for _ in range(n_sweeps):
        for i in range(D):
            A = W[:, :-1]
            # extended cofactor row: det(A) * row i of inv(A)^T, bias coord 0
            cof = np.linalg.det(A) * np.linalg.inv(A).T[i]
            p = np.concatenate([cof, [0.0]])
            gp = g_inv[i] @ p
            gk = g_inv[i] @ k_stat[i]
            a_quad = float(p @ gp)
            b_quad = float(p @ gk)
            # alpha^2 a + alpha b - beta = 0, take the root maximizing Q
            disc = b_quad * b_quad + 4 * a_quad * beta
            if a_quad <= 0 or disc < 0:
                continue
            r = np.sqrt(disc)
            cands = [(-b_quad + r) / (2 * a_quad), (-b_quad - r) / (2 * a_quad)]
            best_w, best_q = None, -np.inf
            for alpha in cands:
                w_i = g_inv[i] @ (k_stat[i] + alpha * p)
                W_try = W.copy()
                W_try[i] = w_i
                q = _aux_objective(W_try, stats)
                if q > best_q and np.isfinite(q):
                    best_q, best_w = q, w_i
            if best_w is not None:
                W[i] = best_w
    return W.astype(np.float32)


def apply_fmllr(feats: torch.Tensor, W: np.ndarray) -> torch.Tensor:
    """x' = A x + b over [..., D] features."""
    Wt = torch.as_tensor(np.array(W, np.float32), device=feats.device)
    return feats @ Wt[:, :-1].T + Wt[:, -1]


def estimate_fmllr(
    gmm: GmmSet,
    feats_list,   # iterable of ([N_i, D] feats, [N_i] labels) per batch
    n_sweeps: int = 10,
) -> np.ndarray:
    """Accumulate stats over batches (one speaker/session) and solve."""
    stats = None
    for feats, labels in feats_list:
        s = accumulate_fmllr_stats(gmm, feats, labels)
        stats = s if stats is None else add_fmllr_stats(stats, s)
    return solve_fmllr(stats, n_sweeps=n_sweeps)

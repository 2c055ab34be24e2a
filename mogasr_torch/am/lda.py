"""LDA feature-space transform over spliced frames in PyTorch: the port of
mogasr/am/lda.py.

Splice +-C frames of the static features, estimate a linear discriminant
transform from forced-alignment class labels (pdf ids) and train the GMM in
the projected space (Haeb-Umbach & Ney):

  - within-class scatter  W = T - B   (T total covariance, B between-class)
  - whiten W:  W^{-1/2} via its eigendecomposition (floored)
  - diagonalize the whitened between-class scatter  M = W^{-1/2} B W^{-1/2}
  - keep the top-d eigenvectors:  A = V_d^T W^{-1/2}

The statistics are one pass per batch on the device of the features: per
class occupancies and first moments as sorted segment sums
(``am.aligned.state_sums``, the reference's one-hot einsums) and the global
second moment (one product), both in float64 rounded to float32 once (the
reference's ``Precision.HIGHEST``). ``solve_lda``, ``compose_affine`` and the oracle
``splice_np`` are the reference's numpy code; ``splice_frames`` splices on
the device with clamped edges and zeroed padding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mogasr_torch.am.aligned import state_sums


class LdaStats(NamedTuple):
    """Sufficient statistics for LDA: per-class occupancy and first moments,
    plus the global second moment (additive)."""

    occ: torch.Tensor    # [S] class occupancies
    first: torch.Tensor  # [S, D] per-class feature sums
    outer: torch.Tensor  # [D, D] global sum of x x^T over valid frames


def accumulate_lda_stats(
    feats: torch.Tensor,   # [N, D] (spliced) features
    labels: torch.Tensor,  # [N] aligned class (pdf) ids, -1 = padding
    n_classes: int,
) -> LdaStats:
    D = feats.shape[-1]
    labels = labels.to(feats.device)
    valid = labels >= 0
    xm = torch.where(valid[:, None], feats, torch.zeros_like(feats))

    # Sums of features cancel (positive and negative terms), so a float32 sum
    # sits up to ~5e-5 of an entry from the exact one in any order (the
    # reference's too). Both sums run in float64 and are rounded once: the
    # float32 statistics the reference's Precision.HIGHEST asks for.
    def per_frame(idx):
        x = feats[idx].to(torch.float64)
        return torch.cat([torch.ones_like(x[:, :1]), x], dim=1)

    sums = state_sums(per_frame, labels, n_classes, 1 + D, 8 * D).to(torch.float32)
    outer = (xm.to(torch.float64).T @ xm.to(torch.float64)).to(torch.float32)
    return LdaStats(sums[:, 0].contiguous(), sums[:, 1:].contiguous(), outer)


def add_lda_stats(a: LdaStats, b: LdaStats) -> LdaStats:
    return LdaStats(a.occ + b.occ, a.first + b.first, a.outer + b.outer)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def solve_lda(
    stats: LdaStats,
    out_dim: int,
    within_floor: float = 1e-6,
) -> np.ndarray:
    """Stats -> affine LDA transform [out_dim, D + 1] (bias last column).

    A Sigma_W A^T = I, A Sigma_B A^T diagonal with descending entries, and
    the bias centers the global mean. Eigenvalues of the within scatter are
    floored at within_floor * max(eig).
    """
    occ = np.asarray(_np(stats.occ), np.float64)
    first = np.asarray(_np(stats.first), np.float64)
    outer = np.asarray(_np(stats.outer), np.float64)
    D = first.shape[1]
    if not 0 < out_dim <= D:
        raise ValueError(f"out_dim={out_dim} must be in (0, {D}]")
    n = occ.sum()
    if n <= 0:
        raise ValueError("no occupancy in LDA stats")
    mu_g = first.sum(axis=0) / n
    total = outer / n - np.outer(mu_g, mu_g)
    keep = occ > 0
    mu_c = first[keep] / occ[keep, None]
    d = mu_c - mu_g[None, :]
    between = np.einsum("s,sd,se->de", occ[keep] / n, d, d)
    within = total - between
    within = 0.5 * (within + within.T)
    ew, Uw = np.linalg.eigh(within)
    ew = np.maximum(ew, within_floor * max(ew.max(), within_floor))
    w_m12 = (Uw / np.sqrt(ew)[None, :]) @ Uw.T
    m = w_m12 @ (0.5 * (between + between.T)) @ w_m12
    eb, V = np.linalg.eigh(0.5 * (m + m.T))
    order = np.argsort(eb)[::-1]
    A = (V[:, order[:out_dim]]).T @ w_m12   # [out_dim, D]
    bias = -A @ mu_g
    return np.concatenate([A, bias[:, None]], axis=1).astype(np.float32)


def compose_affine(w2: np.ndarray, w1: np.ndarray) -> np.ndarray:
    """y = A2 (A1 x + b1) + b2 as one [d2, D + 1] affine transform."""
    a2, b2 = np.asarray(w2, np.float64)[:, :-1], np.asarray(w2, np.float64)[:, -1]
    a1, b1 = np.asarray(w1, np.float64)[:, :-1], np.asarray(w1, np.float64)[:, -1]
    return np.concatenate(
        [a2 @ a1, (a2 @ b1 + b2)[:, None]], axis=1
    ).astype(np.float32)


def splice_frames(
    feats: torch.Tensor,     # [B, T, D]
    n_frames: torch.Tensor,  # [B]
    context: int,
) -> torch.Tensor:
    """[B, T, (2*context+1)*D] frame splicing with per-utterance clamped
    edges (offset order -C..+C), padding rows zeroed."""
    B, T, D = feats.shape
    n_frames = n_frames.to(device=feats.device, dtype=torch.int64)
    t = torch.arange(T, device=feats.device)[None, :]
    last = torch.clamp(n_frames - 1, min=0)[:, None]
    cols = []
    for off in range(-context, context + 1):
        idx = torch.minimum(torch.clamp(t + off, min=0), last)              # [B, T]
        cols.append(torch.gather(feats, 1, idx[:, :, None].expand(B, T, D)))
    out = torch.cat(cols, dim=-1)
    mask = (t < n_frames[:, None]).to(out.dtype)
    return out * mask[:, :, None]


def splice_np(feats: np.ndarray, context: int) -> np.ndarray:
    """NumPy oracle for a single unpadded [T, D] utterance."""
    T = feats.shape[0]
    idx = np.arange(T)
    cols = [
        feats[np.clip(idx + off, 0, max(T - 1, 0))]
        for off in range(-context, context + 1)
    ]
    return np.concatenate(cols, axis=-1)

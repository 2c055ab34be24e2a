"""EM training for the GMM acoustic model in PyTorch: the port of mogasr/am/em.py.

The E-step takes component posteriors on frames assigned to states, hard
(``accumulate_stats``: each frame's state from a forced alignment) or soft
(``accumulate_stats_soft``: state posteriors from forward-backward); the
M-step turns the weighted sums into new parameters with variance flooring,
weight flooring and an occupancy guard; mixtures grow by occupancy-gated
splitting. Sums over states are sorted segment sums
(``utils.segment.index_sum``: the same bits on every run, unlike the atomic
``index_add_`` on a CUDA device); the soft E-step's
products are float32 ``torch.matmul`` in true fp32 (TF32 is off
package-wide), the reference's XLA products.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mogasr_torch.am.gmm import LOG_2PI, STATE_CHUNK, GmmSet, natural_params, quadratic_features
from mogasr_torch.utils.segment import index_sum


class GmmStats(NamedTuple):
    """Sufficient statistics for the M-step (float32 tensors)."""

    occ: torch.Tensor       # [S, K] soft occupancy
    sx: torch.Tensor        # [S, K, D] weighted sum of x
    sxx: torch.Tensor       # [S, K, D] weighted sum of x^2
    loglik: torch.Tensor    # [] total data log-likelihood (monotonicity check)
    n_frames: torch.Tensor  # [] frames accumulated


def zero_stats(S: int, K: int, D: int, *, device: torch.device) -> GmmStats:
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return GmmStats(occ=z(S, K), sx=z(S, K, D), sxx=z(S, K, D), loglik=z(), n_frames=z())


def add_stats(a: GmmStats, b: GmmStats) -> GmmStats:
    return GmmStats(*(x + y for x, y in zip(a, b)))


def accumulate_stats(
    gmm: GmmSet,
    feats: torch.Tensor,   # [N, D] frames (flattened batch)
    labels: torch.Tensor,  # [N] assigned pdf/state ids, -1 for padding
) -> GmmStats:
    """E-step: component posteriors on each frame's assigned state -> stats."""
    S, K, D = gmm.means.shape
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)

    mu = gmm.means[safe]                                # [N, K, D]
    var = torch.clamp(gmm.vars[safe], min=1e-8)         # [N, K, D]
    w = torch.clamp(gmm.weights[safe], min=1e-30)       # [N, K]
    x = feats[:, None, :]                               # [N, 1, D]
    ll_k = (
        torch.log(w)
        - 0.5 * (D * LOG_2PI + torch.log(var).sum(-1))
        - 0.5 * ((x - mu) ** 2 / var).sum(-1)
    )                                                   # [N, K]
    frame_ll = torch.logsumexp(ll_k, dim=-1)            # [N]
    gamma = torch.exp(ll_k - frame_ll[:, None])         # [N, K]
    gamma = torch.where(valid[:, None], gamma, torch.zeros_like(gamma))

    # one sorted segment sum over states for all three statistics
    per_frame = torch.cat([gamma, (gamma[:, :, None] * feats[:, None, :]).reshape(-1, K * D),
                           (gamma[:, :, None] * (feats ** 2)[:, None, :]).reshape(-1, K * D)], dim=1)
    sums = index_sum(per_frame, labels, S)              # [S, K + 2KD]; padding frames skipped
    occ = sums[:, :K].contiguous()
    sx = sums[:, K: K + K * D].reshape(S, K, D)
    sxx = sums[:, K + K * D:].reshape(S, K, D)
    total_ll = torch.where(valid, frame_ll, torch.zeros_like(frame_ll)).sum()
    return GmmStats(occ, sx, sxx, total_ll, valid.sum().to(torch.float32))


def accumulate_stats_soft(
    gmm: GmmSet,
    feats: torch.Tensor,     # [N, D] frames (padding rows must carry 0 posterior)
    pdf_post: torch.Tensor,  # [N, S] state (pdf) posteriors, rows may sum to < 1
    state_chunk: int = STATE_CHUNK,
) -> GmmStats:
    """Full Baum-Welch E-step: soft state posteriors x component posteriors.

    occ[s,k] = sum_n w[n,s] * gamma_k(n|s), and the same weights on x and
    x^2. The component posteriors come from the scorer's GEMM form
    (quadratic features x natural parameters), ``state_chunk`` states at a
    time, so the [N, S, K] tensor is never whole.
    """
    S, K, D = gmm.means.shape
    N = feats.shape[0]
    nat = natural_params(gmm)
    x2 = quadratic_features(feats)                      # [N, 2D]
    f2 = feats ** 2
    ab = nat.ab.reshape(2 * D, S, K)
    c = nat.c.reshape(S, K)
    occ, sx, sxx = [], [], []
    for s0 in range(0, S, state_chunk):
        s1 = min(s0 + state_chunk, S)
        C = s1 - s0
        ll = (x2 @ ab[:, s0:s1].reshape(2 * D, C * K)).reshape(N, C, K) + c[None, s0:s1]
        wg = torch.softmax(ll, dim=-1) * pdf_post[:, s0:s1, None]  # [N, C, K]
        occ.append(wg.sum(0))
        wg_t = wg.reshape(N, C * K).T
        sx.append((wg_t @ feats).reshape(C, K, D))
        sxx.append((wg_t @ f2).reshape(C, K, D))
    return GmmStats(
        occ=torch.cat(occ), sx=torch.cat(sx), sxx=torch.cat(sxx),
        loglik=torch.zeros((), dtype=torch.float32, device=feats.device),  # from the forward pass
        n_frames=pdf_post.sum(),
    )


def m_step(
    gmm: GmmSet,
    stats: GmmStats,
    var_floor: float = 1e-3,
    weight_floor: float = 1e-5,
    min_occ: float = 1e-2,
) -> GmmSet:
    """M-step: re-estimate (w, mu, var) from stats.

    Components with occupancy below min_occ keep their old parameters (their
    weight decays toward the floor). Exactly-zero prior weights mark the
    inert slots of an occupancy-gated split: they stay 0 unless their raw
    weight reaches the floor.
    """
    occ = stats.occ                                     # [S, K]
    denom = torch.clamp(occ[:, :, None], min=1e-10)
    mu_new = stats.sx / denom
    var_new = stats.sxx / denom - mu_new ** 2
    keep = occ[:, :, None] < min_occ
    mu = torch.where(keep, gmm.means, mu_new)
    var = torch.where(keep, gmm.vars, torch.clamp(var_new, min=var_floor))
    state_occ = torch.clamp(occ.sum(-1, keepdim=True), min=1e-10)
    raw = occ / state_occ
    w = torch.where(
        gmm.weights > 0.0,
        torch.clamp(raw, min=weight_floor),
        torch.where(raw >= weight_floor, raw, torch.zeros_like(raw)),
    )
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-10)
    return GmmSet(w.to(torch.float32), mu.to(torch.float32), var.to(torch.float32))


def split_components(
    gmm: GmmSet,
    perturb: float = 0.2,
    seed: int = 0,
    state_occ=None,
    min_frames_per_comp: float = 0.0,
) -> GmmSet:
    """Double the number of components by splitting each along its std dev:
    mu +/- perturb * sigma, half the weight each. Deterministic (``seed`` is
    kept for the reference's signature).

    With ``state_occ`` ([S] frame counts from the previous E-step), a state
    is split only if each of its 2K components would still average at least
    ``min_frames_per_comp`` frames. A state that is not split keeps its
    components, and its new slots get weight 0 (inert until a later split).
    """
    del seed
    sigma = torch.sqrt(torch.clamp(gmm.vars, min=1e-8))
    lo = gmm.means - perturb * sigma
    hi = gmm.means + perturb * sigma
    means = torch.cat([gmm.means, hi], dim=1)
    means_split = torch.cat([lo, hi], dim=1)
    variances = torch.cat([gmm.vars, gmm.vars], dim=1)
    weights_split = torch.cat([gmm.weights, gmm.weights], dim=1) * 0.5
    weights_keep = torch.cat([gmm.weights, torch.zeros_like(gmm.weights)], dim=1)
    if state_occ is None or min_frames_per_comp <= 0.0:
        return GmmSet(weights_split, means_split, variances)
    k_new = 2 * gmm.n_components
    occ = torch.as_tensor(state_occ, device=gmm.weights.device)
    do_split = (occ / k_new >= min_frames_per_comp)[:, None]
    weights = torch.where(do_split, weights_split, weights_keep)
    means = torch.where(do_split[:, :, None], means_split, means)
    return GmmSet(weights, means, variances)


def init_from_labels(
    feats: np.ndarray,
    labels: np.ndarray,
    n_states: int,
    var_floor: float = 1e-3,
    *,
    device: torch.device,
) -> GmmSet:
    """Single-component-per-state init from labeled frames (flat start), on
    ``device``. States with no frames fall back to the global mean/var."""
    feats = np.asarray(feats, np.float64)
    labels = np.asarray(labels)
    D = feats.shape[1]
    valid = labels >= 0
    g_mean = feats[valid].mean(0)
    g_var = np.maximum(feats[valid].var(0), var_floor)
    means = np.tile(g_mean, (n_states, 1))
    variances = np.tile(g_var, (n_states, 1))
    for s in range(n_states):
        sel = labels == s
        n = sel.sum()
        if n >= 2:
            means[s] = feats[sel].mean(0)
            variances[s] = np.maximum(feats[sel].var(0), var_floor)
        elif n == 1:
            means[s] = feats[sel][0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return GmmSet(
        weights=torch.ones((n_states, 1), dtype=torch.float32, device=device),
        means=f32(means[:, None, :]),
        vars=f32(variances[:, None, :]),
    )


def uniform_alignment_labels(
    graph_emit_ids: np.ndarray, n_states_used: int, n_frames: int
) -> np.ndarray:
    """Equal-duration flat-start alignment of a linear graph over n_frames."""
    j = np.minimum(
        (np.arange(n_frames) * n_states_used) // max(n_frames, 1), n_states_used - 1
    )
    return graph_emit_ids[j]


def estimate_transitions(
    paths: np.ndarray,        # [B, T] graph-state indices, -1 padding
    pdf_ids: np.ndarray,      # [B, T] pdf per frame, -1 padding
    pdf_to_phone: np.ndarray,  # [n_pdfs]
    n_phones: int,
    prior_count: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-phone self-loop probability from alignment paths.

    Returns (self_prob[n_phones], counts[n_phones]).
    """
    stays = np.zeros(n_phones)
    moves = np.zeros(n_phones)
    B, T = paths.shape
    for b in range(B):
        for t in range(1, T):
            if paths[b, t] < 0:
                break
            ph = pdf_to_phone[pdf_ids[b, t - 1]]
            if paths[b, t] == paths[b, t - 1]:
                stays[ph] += 1
            else:
                moves[ph] += 1
    total = stays + moves + 2 * prior_count
    return (stays + prior_count) / total, total


def m_step_map(
    prior: GmmSet,
    stats: GmmStats,
    tau: float = 10.0,
    var_floor: float = 1e-3,
    adapt_vars: bool = False,
) -> GmmSet:
    """MAP adaptation (Gauvain & Lee): mu_map = (tau * mu0 + sum_x) / (tau + occ).

    Components with little adaptation data stay near the prior; weights and
    variances stay at the prior unless ``adapt_vars`` (then E[x^2] is blended
    the same way and recentred on the new mean).
    """
    occ = stats.occ[:, :, None]                         # [S, K, 1]
    mu = (tau * prior.means + stats.sx) / (tau + occ)
    if adapt_vars:
        ex2 = (tau * (prior.vars + prior.means ** 2) + stats.sxx) / (tau + occ)
        var = torch.clamp(ex2 - mu ** 2, min=var_floor)
    else:
        var = prior.vars
    return GmmSet(prior.weights, mu.to(torch.float32), var.to(torch.float32))

"""State-level Minimum Bayes Risk (sMBR) discriminative training: the port of
mogasr/am/smbr.py.

sMBR maximizes the posterior-expected frame accuracy over the dense
word-loop denominator graph,

    F = sum_u E_{paths ~ p_kappa(path | X_u, G_den)} [ #frames on ref state ],

with frame accuracy a(t, j) = 1[emit_id(j) == ref_pdf(t)] against a forced
alignment. One forward and one backward pass carry an accuracy accumulator
beside the log-domain Baum-Welch recursion:

    ahat(t, j) = E[acc up to t | path(t)=j]   (forward, includes a(t, j))
    bhat(t, j) = E[acc after t | path(t)=j]   (backward)
    w(t, j)    = gamma(t, j) * (ahat + bhat - E[acc])

Positive parts of w feed "numerator" statistics, negative parts
"denominator" statistics, and the update is MMI's extended Baum-Welch
(``mmi.ebw_update``) after I-smoothing with the ML statistics.

The reference leaves the two passes to XLA (a pair of ``lax.scan``); there
is no TPU kernel, so here they are plain PyTorch ops over [B, J] per frame:
on the card about 25 small launches a frame in each direction.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from mogasr_torch import pipeline as pipe
from mogasr_torch.am import em
from mogasr_torch.am.gmm import GmmSet
from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.am.mmi import den_graphs_for, ebw_update
from mogasr_torch.config import DecodeConfig
from mogasr_torch.utils.segment import collapse_columns

NEG_INF = -1e30
# One sMBR iteration: the reference alignment (K1 + K2; the first iteration,
# or every one with realign), graphs and copies, K1 on the denominator
# batch, the two accuracy-carrying passes, the statistics, the EBW update.
SMBR_STAGES = ("align", "host", "scoring", "smbr", "stats", "m_step")


class SmbrQuantities(NamedTuple):
    weights_pdf: torch.Tensor   # [B, T, P] signed sMBR weights per pdf
    expected_acc: torch.Tensor  # [B] posterior-expected #correct frames
    loglik: torch.Tensor        # [B] denominator log-likelihood


def _safe_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, min=-80.0))


def smbr_quantities(
    emit_ll: torch.Tensor,            # [B, T, P]
    graphs: Dict[str, torch.Tensor],  # batched denominator graphs (word loop)
    ref_pdf: torch.Tensor,            # [B, T] reference pdf ids (-1 padding)
    n_frames: torch.Tensor,           # [B]
    acoustic_scale: float,
    n_pdfs: int,
) -> SmbrQuantities:
    """sMBR weights per pdf, expected accuracy and log-likelihood per
    utterance, in the dtype of ``emit_ll``."""
    B, T, _ = emit_ll.shape
    dev, dt = emit_ll.device, emit_ll.dtype
    emit_id = graphs["emit_id"].to(device=dev, dtype=torch.int64)
    self_logp, adv_logp, enter_logp, exit_logp, init_logp, final_logp = (
        graphs[k].to(device=dev, dtype=dt)
        for k in ("self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp"))
    J = emit_id.shape[1]
    n_frames = n_frames.to(dev)
    ref_pdf = ref_pdf.to(dev)
    emit_graph = torch.gather(emit_ll * acoustic_scale, 2, emit_id[:, None, :].expand(B, T, J))  # [B, T, J]
    neg1 = torch.full((B, 1), NEG_INF, dtype=dt, device=dev)
    zero1 = torch.zeros((B, 1), dtype=dt, device=dev)

    def acc_at(t):  # frame-state accuracy against the reference alignment
        return (emit_id == ref_pdf[:, t, None]).to(dt)

    # ---------------- forward: (alpha, ahat) ----------------
    alpha = init_logp + emit_graph[:, 0]
    ahat = acc_at(0)
    alphas, ahats = [alpha], [ahat]
    for t in range(1, T):
        emit_t = emit_graph[:, t]
        exit_sc = alpha + exit_logp
        exit_lse = torch.logsumexp(exit_sc, dim=1)                   # [B]
        u = _safe_exp(exit_sc - exit_lse[:, None])                   # [B, J]
        acc_via_loop = (u * ahat).sum(1)                             # [B]
        stay = alpha + self_logp
        adv = torch.cat([neg1, alpha[:, :-1] + adv_logp[:, 1:]], dim=1)
        ent = exit_lse[:, None] + enter_logp
        new_alpha = torch.logaddexp(torch.logaddexp(stay, adv), ent) + emit_t
        # predecessor responsibilities (the emission cancels in all three)
        base = new_alpha - emit_t
        w_stay = _safe_exp(stay - base)
        w_adv = _safe_exp(adv - base)
        w_ent = _safe_exp(ent - base)
        new_ahat = (w_stay * ahat + w_adv * torch.cat([zero1, ahat[:, :-1]], dim=1)
                    + w_ent * acc_via_loop[:, None] + acc_at(t))
        active = (t < n_frames)[:, None]
        alphas.append(torch.where(active, new_alpha, torch.full_like(new_alpha, NEG_INF)))
        ahats.append(torch.where(active, new_ahat, torch.zeros_like(new_ahat)))
        alpha = torch.where(active, new_alpha, alpha)
        ahat = torch.where(active, new_ahat, ahat)

    final_sc = alpha + final_logp
    loglik = torch.logsumexp(final_sc, dim=1)                        # [B]
    expected_acc = (_safe_exp(final_sc - loglik[:, None]) * ahat).sum(1)

    # ---------------- backward: (beta, bhat) ----------------
    beta, bhat = final_logp, torch.zeros((B, J), dtype=dt, device=dev)
    betas, bhats = [beta], [bhat]
    for t in range(T - 2, -1, -1):  # frame t+1's quantities give frame t's
        eb = emit_graph[:, t + 1] + beta
        g = bhat + acc_at(t + 1)                                     # acc from t+1 on
        enter_sc = enter_logp + eb
        enter_lse = torch.logsumexp(enter_sc, dim=1)                 # [B]
        q = _safe_exp(enter_sc - enter_lse[:, None])
        acc_via_loop = (q * g).sum(1)                                # [B]
        stay = self_logp + eb
        adv = torch.cat([adv_logp[:, 1:] + eb[:, 1:], neg1], dim=1)
        ext = exit_logp + enter_lse[:, None]
        new_beta = torch.logaddexp(torch.logaddexp(stay, adv), ext)
        v_stay = _safe_exp(stay - new_beta)
        v_adv = _safe_exp(adv - new_beta)
        v_ext = _safe_exp(ext - new_beta)
        new_bhat = v_stay * g + v_adv * torch.cat([g[:, 1:], zero1], dim=1) + v_ext * acc_via_loop[:, None]
        active = (t + 1 < n_frames)[:, None]
        beta = torch.where(active, new_beta, beta)
        bhat = torch.where(active, new_bhat, bhat)
        betas.append(beta)
        bhats.append(bhat)
    betas.reverse()
    bhats.reverse()

    log_gamma = torch.stack(alphas, 1) + torch.stack(betas, 1) - loglik[:, None, None]  # [B, T, J]
    mask = (torch.arange(T, device=dev)[None, :] < n_frames[:, None])[:, :, None]
    gamma = torch.where(mask, _safe_exp(log_gamma), torch.zeros_like(log_gamma))
    w_state = gamma * (torch.stack(ahats, 1) + torch.stack(bhats, 1) - expected_acc[:, None, None])
    # collapse graph states -> pdf ids, in state order (utils.segment)
    w_pdf = collapse_columns(w_state, emit_id, n_pdfs)
    return SmbrQuantities(w_pdf, expected_acc, loglik)


@dataclasses.dataclass
class SmbrResult:
    """Unpacks like a (gmm, history) pair; ``seconds``/``stage_seconds``:
    each iteration's wall time and its split over ``SMBR_STAGES``."""

    gmm: GmmSet
    history: List[float]  # expected frame accuracy per iteration
    seconds: List[float] = dataclasses.field(default_factory=list)
    stage_seconds: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def __iter__(self):
        return iter((self.gmm, self.history))


def train_smbr(
    batches,                 # Sequence[pipeline.FeatBatch]
    lexicon,
    topo,
    gmm: GmmSet,
    n_iters: int = 4,
    acoustic_scale: float = 0.1,
    e_const: float = 2.0,
    i_smooth_tau: float = 20.0,
    den_graph=None,
    realign: bool = False,   # re-derive reference alignments each iteration
    logger=None,
) -> SmbrResult:
    """sMBR training loop on top of an ML-trained GMM (mirrors train_mmi).

    Reference state sequences come from forced alignment (``align_batch``:
    K1, K2) with the initial model, or each iteration's with ``realign``.
    Positive sMBR weights accumulate as numerator statistics, negative as
    denominator statistics. ``i_smooth_tau``: I-smoothing, each Gaussian's
    numerator statistics blended with tau frames' worth of its ML statistics
    (without it EBW overshoots after the first iteration).
    """
    if den_graph is None:
        den_graph = pipe.word_decode_graph(lexicon, topo, DecodeConfig(acoustic_scale=acoustic_scale))
    S, K, D = gmm.means.shape
    dev = batches[0].feats.device
    den_cache: Dict[int, Dict[str, torch.Tensor]] = {}
    result = SmbrResult(gmm, [])

    def align_all(model, clock):
        params = kernel_params(model, "float32")
        with clock("align"):
            return [pipe.align_batch(fb, model, lexicon, topo, params=params)[1] for fb in batches]

    ref_labels = None
    for it in range(n_iters):
        clock = pipe.StageClock(dev, SMBR_STAGES)
        start = time.perf_counter()
        if ref_labels is None or realign:
            ref_labels = align_all(gmm, clock)
        num_stats = em.zero_stats(S, K, D, device=dev)
        den_stats = em.zero_stats(S, K, D, device=dev)
        ml_stats = em.zero_stats(S, K, D, device=dev)
        acc_total = torch.zeros((), dtype=torch.float64, device=dev)
        n_frames_total = torch.zeros((), dtype=torch.int64, device=dev)
        with clock("host"):
            params = kernel_params(gmm, "float32")
        for fb, ref in zip(batches, ref_labels):
            with clock("scoring"):
                scores = pipe.score_batch(fb.feats, gmm, params=params)
            Bp = scores.shape[0]
            with clock("host"):
                den_graphs = den_graphs_for(den_graph, den_cache, Bp, dev)
            with clock("smbr"):
                q = smbr_quantities(scores, den_graphs, ref, fb.n_frames, acoustic_scale, S)
            with clock("stats"):
                w = q.weights_pdf.reshape(-1, S)
                feats_flat = fb.feats.reshape(-1, D)
                num_stats = em.add_stats(num_stats, em.accumulate_stats_soft(gmm, feats_flat, w.clamp(min=0.0)))
                den_stats = em.add_stats(den_stats, em.accumulate_stats_soft(gmm, feats_flat, (-w).clamp(min=0.0)))
                if i_smooth_tau > 0:
                    ml_stats = em.add_stats(ml_stats, em.accumulate_stats(gmm, feats_flat, ref.reshape(-1)))
                valid = torch.arange(Bp, device=dev) < fb.size
                acc_total += torch.where(valid, q.expected_acc, torch.zeros_like(q.expected_acc)).sum().double()
                n_frames_total += fb.n_frames[: fb.size].sum()
        result.history.append(float(acc_total) / max(float(n_frames_total), 1.0))
        if logger is not None:
            logger.log({"stage": "train_smbr", "iter": it, "expected_frame_acc": result.history[-1]})
        with clock("m_step"):
            if i_smooth_tau > 0:
                # I-smoothing: num <- num + (tau / occ_ml) * ml per Gaussian (host float64)
                occ_ml = ml_stats.occ.cpu().numpy().astype(np.float64)
                scale = np.where(occ_ml > 1e-6, i_smooth_tau / np.maximum(occ_ml, 1e-6), 0.0)

                def smoothed(a, b):
                    return a + torch.as_tensor(b.astype(np.float32), device=dev)

                num_stats = num_stats._replace(
                    occ=smoothed(num_stats.occ, scale * occ_ml),
                    sx=smoothed(num_stats.sx, scale[:, :, None] * ml_stats.sx.cpu().numpy()),
                    sxx=smoothed(num_stats.sxx, scale[:, :, None] * ml_stats.sxx.cpu().numpy()),
                )
            gmm = ebw_update(gmm, num_stats, den_stats, e_const=e_const)
        result.seconds.append(time.perf_counter() - start)
        result.stage_seconds.append(clock.seconds)
    result.gmm = gmm
    return result

"""MMI discriminative training for the GMM acoustic model (extended
Baum-Welch): the port of mogasr/am/mmi.py.

Maximum Mutual Information per utterance u with acoustic scale k:

    F = sum_u  log p_k(X_u | G_num(u)) - log p_k(X_u | G_den)

G_num(u) is the utterance's forced-alignment graph and G_den the shared
word-loop decode graph: a dense denominator, evaluated exactly by one
forward-backward over the loop graph per batch (lattice-free MMI's design
point). On the card each batch is scored by K1 (float32, sum mode), the
numerator runs K3f/K3b's chain arm over the align graphs, the denominator
their general arm over the word loop (its rows have loop arcs); the
posteriors become statistics through ``state_posteriors_to_pdf`` and
``em.accumulate_stats_soft``.

Parameter update (``ebw_update``, host float64 numpy as in the reference):
extended Baum-Welch with per-Gaussian smoothing constants D, doubled until
every variance is positive,

    mu'  = (sx_num - sx_den + D mu) / (occ_num - occ_den + D)
    var' = (sxx_num - sxx_den + D (var + mu^2)) / (occ_num - occ_den + D) - mu'^2

with the mixture weights fixed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mogasr_torch import pipeline as pipe
from mogasr_torch.am import em
from mogasr_torch.am.gmm import GmmSet
from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.config import DecodeConfig
from mogasr_torch.decoder import fb_cuda
from mogasr_torch.decoder import forward_backward as fbd
from mogasr_torch.decoder import viterbi as vit


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def ebw_update(
    gmm: GmmSet,
    num: em.GmmStats,
    den: em.GmmStats,
    e_const: float = 2.0,
    var_floor: float = 1e-3,
    min_occ: float = 1e-2,
) -> GmmSet:
    """Extended Baum-Welch M-step (means + variances, weights fixed).

    Per-Gaussian D starts at E * occ_den and doubles until the implied
    variance is positive everywhere. Gaussians with (almost) no numerator
    occupancy keep their parameters. Computed in float64 on the host; the new
    means and variances go back to the GMM's device in float32.
    """
    occ_n, occ_d = _host64(num.occ), _host64(den.occ)
    sx_n, sx_d = _host64(num.sx), _host64(den.sx)
    sxx_n, sxx_d = _host64(num.sxx), _host64(den.sxx)
    mu0, var0 = _host64(gmm.means), _host64(gmm.vars)

    D = np.maximum(e_const * occ_d, 1.0)  # [S, K]
    for _ in range(32):
        denom = (occ_n - occ_d)[:, :, None] + D[:, :, None]
        mu = (sx_n - sx_d + D[:, :, None] * mu0) / denom
        var = (sxx_n - sxx_d + D[:, :, None] * (var0 + mu0**2)) / denom - mu**2
        bad = (denom.min(-1) <= 0) | (var.min(-1) <= var_floor * 0.5)
        if not bad.any():
            break
        D = np.where(bad, D * 2.0, D)
    var = np.maximum(var, var_floor)

    keep = (occ_n < min_occ)[:, :, None]
    mu = np.where(keep, mu0, mu)
    var = np.where(keep, var0, var)
    dev = gmm.means.device
    return GmmSet(
        gmm.weights,
        torch.as_tensor(mu.astype(np.float32), device=dev),
        torch.as_tensor(var.astype(np.float32), device=dev),
    )


def fb_stats(
    gmm: GmmSet,
    feats_flat: torch.Tensor,         # [B*T, D]
    scores: torch.Tensor,             # [B, T, P] pdf log-likelihoods
    graphs: Dict[str, torch.Tensor],  # graphs_to_torch(batch_graphs(...))
    n_frames: torch.Tensor,
    acoustic_scale: float,
    use_kernels: bool = True,
    clock: Optional[pipe.StageClock] = None,
) -> Tuple[em.GmmStats, fbd.FBResult]:
    """Forward-backward over ``graphs`` at ``acoustic_scale`` (K3f/K3b on the
    card, the plain version on the CPU or with ``use_kernels=False``) ->
    (soft statistics of the pdf posteriors, the FBResult). Everything runs
    in the dtype of ``scores``, ``feats_flat`` and the GMM: float64 inputs
    with ``use_kernels=False`` give the float64 reference."""
    S = gmm.means.shape[0]
    fb = fb_cuda.forward_backward if use_kernels else fbd.forward_backward
    with pipe._stage(clock, "align"):
        res = fb(scores, graphs, n_frames, acoustic_scale=acoustic_scale)
    with pipe._stage(clock, "stats"):
        post = fbd.state_posteriors_to_pdf(res.log_gamma, graphs["emit_id"], S)
        return em.accumulate_stats_soft(gmm, feats_flat, post.reshape(-1, S)), res


def den_graphs_for(den_graph, cache: Dict[int, Dict[str, torch.Tensor]], rows: int, device: torch.device):
    """The denominator graph stacked for a batch of ``rows``, built once per
    row count (the reference rebuilds the same arrays for every batch)."""
    if rows not in cache:
        cache[rows] = pipe.decode_graphs(den_graph, rows, device)[1]
    return cache[rows]


@dataclasses.dataclass
class MmiResult:
    """Unpacks like a (gmm, history) pair; ``seconds``/``stage_seconds``:
    each iteration's wall time and its split over ``pipeline.TRAIN_STAGES``
    ("align" is both forward-backward passes, "m_step" the EBW update)."""

    gmm: GmmSet
    history: List[float]  # MMI criterion (mean per frame) per iteration
    seconds: List[float] = dataclasses.field(default_factory=list)
    stage_seconds: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def __iter__(self):
        return iter((self.gmm, self.history))


def train_mmi(
    batches,                 # Sequence[pipeline.FeatBatch]
    lexicon,
    topo,
    gmm: GmmSet,
    n_iters: int = 4,
    acoustic_scale: float = 0.1,
    e_const: float = 2.0,
    den_graph=None,          # override the denominator graph (default: word loop)
    logger=None,
) -> MmiResult:
    """MMI training loop on top of an ML-trained GMM.

    acoustic_scale: the usual MMI kappa (~0.1) flattening the acoustic model
    against the (implicit unigram) LM of the denominator loop graph.
    """
    if den_graph is None:
        den_graph = pipe.word_decode_graph(lexicon, topo, DecodeConfig(acoustic_scale=acoustic_scale))
    S, K, D = gmm.means.shape
    dev = batches[0].feats.device
    den_cache: Dict[int, Dict[str, torch.Tensor]] = {}
    result = MmiResult(gmm, [])
    for it in range(n_iters):
        clock = pipe.StageClock(dev, pipe.TRAIN_STAGES)
        start = time.perf_counter()
        num_stats = em.zero_stats(S, K, D, device=dev)
        den_stats = em.zero_stats(S, K, D, device=dev)
        crit = torch.zeros((), dtype=torch.float64, device=dev)
        n_frames_total = torch.zeros((), dtype=torch.int64, device=dev)
        with clock("host"):
            params = kernel_params(gmm, "float32")
        for fb in batches:
            with clock("scoring"):
                scores = pipe.score_batch(fb.feats, gmm, params=params)
            Bp = scores.shape[0]
            with clock("host"):
                num_graphs = vit.graphs_to_torch(pipe.build_align_graphs(fb.words, lexicon, topo), dev)
                den_graphs = den_graphs_for(den_graph, den_cache, Bp, dev)
            feats_flat = fb.feats.reshape(-1, D)
            s_num, r_num = fb_stats(gmm, feats_flat, scores, num_graphs, fb.n_frames, acoustic_scale, clock=clock)
            s_den, r_den = fb_stats(gmm, feats_flat, scores, den_graphs, fb.n_frames, acoustic_scale, clock=clock)
            with clock("stats"):
                num_stats = em.add_stats(num_stats, s_num)
                den_stats = em.add_stats(den_stats, s_den)
                valid = torch.arange(Bp, device=dev) < fb.size
                diff = r_num.loglik - r_den.loglik
                crit += torch.where(valid, diff, torch.zeros_like(diff)).sum().double()
                n_frames_total += fb.n_frames[: fb.size].sum()
        result.history.append(float(crit) / max(float(n_frames_total), 1.0))
        if logger is not None:
            logger.log({"stage": "train_mmi", "iter": it, "mmi_per_frame": result.history[-1]})
        with clock("m_step"):
            gmm = ebw_update(gmm, num_stats, den_stats, e_const=e_const)
        result.seconds.append(time.perf_counter() - start)
        result.stage_seconds.append(clock.seconds)
    result.gmm = gmm
    return result

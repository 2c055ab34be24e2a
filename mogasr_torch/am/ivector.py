"""i-vectors in PyTorch (UBM + total-variability subspace): the port of
mogasr/am/ivector.py.

A diagonal UBM (one unlabeled GmmSet state, trained by the port's EM,
``am.em``) summarizes each utterance into zeroth/first-order Baum-Welch
statistics; a low-rank total-variability matrix T models the per-utterance
supervector offset M(u) = m + T w(u), w ~ N(0, I); the MAP point estimate
of w(u) is the i-vector.

On the device of the features: the UBM responsibilities and per-utterance
statistics (rows in chunks under ``am.aligned.CHUNK_BYTES``), the E-step's
batched [R, R] Cholesky factor and solves (``torch.linalg.cholesky``,
``torch.cholesky_solve``) and the M-step's accumulators. The per-component
[R, R] solves of the M-step run on the host in float64 numpy, as in the
reference. ``extractor_from_numpy`` builds an ``IvectorExtractor`` from
numpy arrays (e.g. the reference's), and ``save_extractor`` /
``load_extractor`` keep one in the port's checkpoint format
(``utils.checkpoint``) under the reference CLI's keys, ``ubm`` and ``t``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mogasr_torch.am.aligned import frame_chunks
from mogasr_torch.am.gmm import LOG_2PI, GmmSet, gmm_from_numpy


class BwStats(NamedTuple):
    """Per-utterance Baum-Welch stats against the UBM."""

    n: torch.Tensor  # [..., K] zeroth order (occupancies)
    f: torch.Tensor  # [..., K, D] first order, CENTERED on the UBM means


def _ubm_log_resp(feats: torch.Tensor, ubm: GmmSet) -> torch.Tensor:
    """[..., D] -> [..., K] per-component log responsibilities (normalized)."""
    w = torch.clamp(ubm.weights[0], min=1e-30)
    mu = ubm.means[0]
    var = torch.clamp(ubm.vars[0], min=1e-8)
    x = feats[..., None, :]
    ll = (
        torch.log(w)
        - 0.5 * (feats.shape[-1] * LOG_2PI + torch.log(var).sum(-1))
        - 0.5 * ((x - mu) ** 2 / var).sum(-1)
    )
    return ll - torch.logsumexp(ll, dim=-1, keepdim=True)


def accumulate_bw_stats(
    feats: torch.Tensor,     # [B, T, D]
    n_frames: torch.Tensor,  # [B]
    ubm: GmmSet,             # S == 1
) -> BwStats:
    """Batched per-utterance zeroth/first-order UBM stats (padding masked)."""
    B, T, D = feats.shape
    K = ubm.n_components
    n_frames = n_frames.to(feats.device)
    mask = (torch.arange(T, device=feats.device)[None, :] < n_frames[:, None]).to(feats.dtype)
    ns, fs = [], []
    for a, b in frame_chunks(B, 4 * T * K * D * 4):
        x = feats[a:b]
        gamma = torch.exp(_ubm_log_resp(x, ubm)) * mask[a:b, :, None]          # [b, T, K]
        n = gamma.sum(1)                                                       # [b, K]
        ns.append(n)
        fs.append(torch.einsum("btk,btd->bkd", gamma, x) - n[:, :, None] * ubm.means[0])
    return BwStats(torch.cat(ns), torch.cat(fs))


def _estep(
    t_mat: torch.Tensor,    # [K, D, R]
    inv_var: torch.Tensor,  # [K, D]
    stats: BwStats,         # n [U, K], f [U, K, D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior moments of w per utterance: E[w] [U, R], E[ww'] [U, R, R]."""
    R = t_mat.shape[-1]
    tsig = t_mat * inv_var[:, :, None]                   # [K, D, R] = Sigma^-1 T
    gram = torch.einsum("kdr,kds->krs", tsig, t_mat)     # [K, R, R]
    eye = torch.eye(R, dtype=t_mat.dtype, device=t_mat.device)
    prec = eye + torch.einsum("uk,krs->urs", stats.n, gram)
    rhs = torch.einsum("kdr,ukd->ur", tsig, stats.f)
    chol = torch.linalg.cholesky(prec)
    mean = torch.cholesky_solve(rhs[:, :, None], chol)[:, :, 0]
    cov = torch.cholesky_solve(eye.expand_as(prec).contiguous(), chol)
    return mean, cov + mean[:, :, None] * mean[:, None, :]


def _mstep_accumulators(stats: BwStats, w_mean: torch.Tensor, w_sq: torch.Tensor):
    """A_k = sum_u n_uk E[ww'] [K, R, R];  C = sum_u f_u E[w]' [K, D, R]."""
    a = torch.einsum("uk,urs->krs", stats.n, w_sq)
    c = torch.einsum("ukd,ur->kdr", stats.f, w_mean)
    return a, c


def _flatten_stats(stats_list: Sequence[BwStats]) -> BwStats:
    n = torch.cat([s.n.reshape(-1, s.n.shape[-1]) for s in stats_list])
    f = torch.cat([s.f.reshape(-1, *s.f.shape[-2:]) for s in stats_list])
    return BwStats(n, f)


def train_total_variability(
    stats_list: Sequence[BwStats],   # batched stats (any leading shape)
    ubm: GmmSet,
    rank: int,
    n_iters: int = 10,
    seed: int = 0,
) -> np.ndarray:
    """EM for the total-variability matrix T [K, D, rank]."""
    K, D = ubm.means.shape[1], ubm.means.shape[2]
    dev = ubm.means.device
    rng = np.random.default_rng(seed)
    t_mat = torch.as_tensor((0.1 * rng.standard_normal((K, D, rank))).astype(np.float32), device=dev)
    inv_var = 1.0 / torch.clamp(ubm.vars[0], min=1e-8)
    flat = _flatten_stats(stats_list)
    for _ in range(n_iters):
        w_mean, w_sq = _estep(t_mat, inv_var, flat)
        a, c = _mstep_accumulators(flat, w_mean, w_sq)
        a_np = a.cpu().numpy().astype(np.float64)
        c_np = c.cpu().numpy().astype(np.float64)
        t_new = np.empty((K, D, rank))
        eye = 1e-6 * np.eye(rank)
        for k in range(K):
            t_new[k] = np.linalg.solve(a_np[k] + eye, c_np[k].T).T
        t_mat = torch.as_tensor(t_new.astype(np.float32), device=dev)
    return t_mat.cpu().numpy()


def extract_ivectors(
    stats: BwStats,       # n [U, K], f [U, K, D]
    ubm: GmmSet,
    t_mat: np.ndarray,    # [K, D, R]
) -> np.ndarray:
    """MAP point estimates E[w | utt] -> [U, R] i-vectors."""
    inv_var = 1.0 / torch.clamp(ubm.vars[0], min=1e-8)
    w_mean, _ = _estep(torch.as_tensor(np.array(t_mat, np.float32), device=ubm.means.device), inv_var, stats)
    return w_mean.cpu().numpy()


def extract_ivectors_batches(
    batches,              # Sequence[FeatBatch-like]
    ubm: GmmSet,
    t_mat: np.ndarray,
    stats_list: Optional[Sequence[BwStats]] = None,
) -> dict:
    """{utt_id: ivector} over featurized batches (rows past fb.size are
    padding and are not paired with an id)."""
    out = {}
    for i, fb in enumerate(batches):
        s = stats_list[i] if stats_list is not None else accumulate_bw_stats(fb.feats, fb.n_frames, ubm)
        vecs = extract_ivectors(s, ubm, t_mat)
        for b, uid in enumerate(fb.utt_ids):
            out[uid] = vecs[b]
    return out


def tv_aux_loglik(stats: BwStats, ubm: GmmSet, t_mat: np.ndarray) -> float:
    """Mean per-utterance EM auxiliary objective (up to stats-only consts):
    E_q[log p(F | w)] - KL(q(w) || N(0, I))."""
    t_t = torch.as_tensor(np.array(t_mat, np.float32), device=ubm.means.device)
    inv_var = 1.0 / torch.clamp(ubm.vars[0], min=1e-8)
    w_mean, w_sq = _estep(t_t, inv_var, stats)
    R = t_t.shape[-1]
    tsig = t_t * inv_var[:, :, None]
    gram = torch.einsum("kdr,kds->krs", tsig, t_t)
    quad = -0.5 * (torch.einsum("uk,krs->urs", stats.n, gram) * w_sq).sum((1, 2))
    lin = torch.einsum("kdr,ukd,ur->u", tsig, stats.f, w_mean)
    cov = w_sq - w_mean[:, :, None] * w_mean[:, None, :]
    sign, logdet = torch.linalg.slogdet(cov)
    kl = 0.5 * (torch.diagonal(w_sq, dim1=1, dim2=2).sum(-1) - R - sign * logdet)
    return float((quad + lin - kl).mean())


def train_ubm(
    batches,              # Sequence[FeatBatch-like] with .feats [B,T,D], .n_frames
    n_components: int,
    n_iters: int = 8,
    seed: int = 0,
    var_floor: float = 1e-3,
) -> GmmSet:
    """Diagonal UBM as a single-state GmmSet via the port's EM: all valid
    frames labeled 0, the reference's split-and-refit schedule. Each E-step
    runs over the frames in chunks under ``am.aligned.CHUNK_BYTES`` (the reference's one
    call over the corpus would gather [N, K, D] at once), the chunks' sums
    added in order."""
    from mogasr_torch.am import em

    dev = batches[0].feats.device
    frames = []
    for fb in batches:
        T = fb.feats.shape[1]
        mask = torch.arange(T, device=fb.feats.device)[None, :] < fb.n_frames.to(fb.feats.device)[:, None]
        frames.append(fb.feats[mask])
    x = torch.cat(frames).to(torch.float32)
    y = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    gmm = em.init_from_labels(x.cpu().numpy(), y.cpu().numpy(), 1, device=dev)
    it = 0
    while True:
        stats = None
        D = x.shape[1]
        for a, b in frame_chunks(x.shape[0], 8 * n_components * D * 4):
            s = em.accumulate_stats(gmm, x[a:b], y[a:b])
            stats = s if stats is None else em.add_stats(stats, s)
        gmm = em.m_step(gmm, stats, var_floor=var_floor)
        it += 1
        if it >= n_iters and gmm.n_components >= n_components:
            break
        if it % 2 == 0 and gmm.n_components < n_components:
            gmm = em.split_components(gmm, seed=seed + it)
            if gmm.n_components > n_components:
                gmm = GmmSet(gmm.weights[:, :n_components], gmm.means[:, :n_components],
                             gmm.vars[:, :n_components])
    return gmm


def length_normalize(ivecs: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Project i-vectors to the unit sphere (standard before cosine/PLDA)."""
    return ivecs / np.maximum(np.linalg.norm(ivecs, axis=-1, keepdims=True), eps)


def cosine_score(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[M, R] x [N, R] -> [M, N] cosine similarity matrix."""
    an = length_normalize(np.atleast_2d(a))
    bn = length_normalize(np.atleast_2d(b))
    return an @ bn.T


class IvectorExtractor(NamedTuple):
    """Trained i-vector front end: diagonal UBM + total-variability matrix."""

    ubm: GmmSet
    t_mat: np.ndarray   # [K, D, R]

    @property
    def rank(self) -> int:
        return int(self.t_mat.shape[-1])


def extractor_from_numpy(weights, means, vars, t_mat, device: torch.device) -> IvectorExtractor:
    """An IvectorExtractor on ``device`` from numpy-convertible UBM
    parameters ([1, K], [1, K, D], [1, K, D]) and T [K, D, R]."""
    return IvectorExtractor(gmm_from_numpy(weights, means, vars, device), np.asarray(t_mat, np.float32))


def save_extractor(path: str, extractor: IvectorExtractor, step: int = 0) -> str:
    """Write the extractor in the port's checkpoint format: {"ubm": GmmSet
    fields, "t": T}, the reference CLI's keys."""
    from mogasr_torch.utils.checkpoint import save_checkpoint

    return save_checkpoint(path, {"ubm": extractor.ubm._asdict(), "t": np.asarray(extractor.t_mat)}, step=step)


def load_extractor(path: str, device: torch.device) -> IvectorExtractor:
    """Read ``save_extractor``'s checkpoint (its latest step) onto ``device``."""
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    raw = restore_checkpoint(path)
    return extractor_from_numpy(raw["ubm"]["weights"], raw["ubm"]["means"], raw["ubm"]["vars"], raw["t"], device)


def train_ivector_extractor(
    batches,
    n_components: int = 64,
    rank: int = 16,
    ubm_iters: int = 8,
    tv_iters: int = 8,
    seed: int = 0,
) -> IvectorExtractor:
    """UBM + total-variability training on featurized batches."""
    ubm = train_ubm(batches, n_components, n_iters=ubm_iters, seed=seed)
    stats = [accumulate_bw_stats(fb.feats, fb.n_frames, ubm) for fb in batches]
    t_mat = train_total_variability(stats, ubm, rank, n_iters=tv_iters, seed=seed)
    return IvectorExtractor(ubm, t_mat)


def utterance_ivectors(extractor: IvectorExtractor, feats, n_frames, length_norm: bool = True) -> np.ndarray:
    """[B, R] per-utterance i-vectors (rows past the real count give zero
    stats -> zero vectors; callers mask by batch.size)."""
    stats = accumulate_bw_stats(feats, n_frames, extractor.ubm)
    vecs = extract_ivectors(stats, extractor.ubm, extractor.t_mat)
    return length_normalize(vecs) if length_norm else vecs

"""Confusion networks (word sausages), exact arc posteriors, and
minimum-Bayes-risk decoding over word lattices (host side).

The port's copy of mogasr/decoder/confusion.py, its imports pointed at mogasr_torch.

Completes the lattice toolchain (mogasr_torch.decoder.lattice): the device
LM-Viterbi pass materializes the lattice, this module turns it into

- **exact arc posteriors** under any n-gram LM: forward-backward over
  (frame-boundary, LM-context) lattice states. Invariant (tested): every
  frame is covered by exactly one arc per path, so the posteriors of arcs
  crossing any frame sum to 1.
- **confusion networks** (Mangu et al. 2000 style): arcs -> intra-word
  clusters (same word, overlapping spans) -> time-ordered confusion slots
  with per-word posteriors and an implicit epsilon (skip) probability.
- **consensus decoding**: argmax word per slot — minimizes expected WORD
  errors under the CN approximation of the posterior (vs. Viterbi's
  sentence-error criterion).
- **N-best MBR decoding** (Goel & Byrne 2000): pick the candidate with
  the lowest posterior-expected edit distance to the other candidates.

Host-side by design (same rationale as lattice.py): lattices are KBs and
these are data-dependent dict/graph algorithms; all FLOPs already happened
on device in the first pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mogasr_torch.decoder.lattice import Arc, Lattice, lattice_nbest
from mogasr_torch.eval.wer import edit_counts
from mogasr_torch.lm.ngram import lm_stepper

NEG_INF = -1e30


def _lse(a: float, b: float) -> float:
    if a <= NEG_INF / 2:
        return b
    if b <= NEG_INF / 2:
        return a
    return float(np.logaddexp(a, b))


def lattice_arc_posteriors(
    lat: Lattice, lm
) -> Tuple[List[Arc], np.ndarray, float]:
    """Exact arc posteriors under ``lm`` via lattice forward-backward.

    Returns (arcs, posterior[len(arcs)] in linear domain, total log-prob Z).
    States are (frame boundary, LM context); the LM context subsumes all
    path history the LM can see, so the sums are exact for the lattice.
    """
    idx = {t: i for i, t in enumerate(lm.tokens)}
    start_fn, step_fn, final_fn = lm_stepper(lm)
    T = lat.n_frames
    by_end = lat.arcs_by_end

    # forward
    alpha: List[Dict[tuple, float]] = [dict() for _ in range(T + 1)]
    alpha[0][start_fn()] = 0.0
    for t in range(T):
        for arc in by_end[t]:
            src = alpha[arc.start]
            if not src:
                continue
            w = idx[arc.word]
            dst = alpha[t + 1]
            for ctx, a in src.items():
                lp, nctx = step_fn(ctx, w)
                dst[nctx] = _lse(dst.get(nctx, NEG_INF), a + arc.score + lp)

    z = NEG_INF
    for ctx, a in alpha[T].items():
        z = _lse(z, a + final_fn(ctx))
    if z <= NEG_INF / 2:
        return list(lat.arcs), np.zeros(len(lat.arcs)), z

    # backward: beta[pos][ctx] = log-sum of completions from (pos, ctx)
    beta: List[Dict[tuple, float]] = [dict() for _ in range(T + 1)]
    for ctx in alpha[T]:
        beta[T][ctx] = final_fn(ctx)
    for t in range(T - 1, -1, -1):
        for arc in by_end[t]:
            w = idx[arc.word]
            src = beta[t + 1]
            dst = beta[arc.start]
            for ctx in alpha[arc.start]:
                lp, nctx = step_fn(ctx, w)
                nb = src.get(nctx)
                if nb is None:
                    continue
                dst[ctx] = _lse(dst.get(ctx, NEG_INF), arc.score + lp + nb)

    arcs = list(lat.arcs)
    post = np.zeros(len(arcs))
    for i, arc in enumerate(arcs):
        w = idx[arc.word]
        acc = NEG_INF
        for ctx, a in alpha[arc.start].items():
            lp, nctx = step_fn(ctx, w)
            nb = beta[arc.end + 1].get(nctx)
            if nb is None:
                continue
            acc = _lse(acc, a + arc.score + lp + nb)
        post[i] = math.exp(min(acc - z, 0.0)) if acc > NEG_INF / 2 else 0.0
    return arcs, post, z


@dataclasses.dataclass
class Slot:
    """One confusion slot: competing words with posteriors (+ implicit eps)."""

    start: int
    end: int
    words: Dict[str, float]  # word -> posterior

    @property
    def eps(self) -> float:
        return max(0.0, 1.0 - sum(self.words.values()))

    def best(self) -> Tuple[str, float]:
        return max(self.words.items(), key=lambda kv: kv[1])


@dataclasses.dataclass
class _Cluster:
    word: str
    start: int
    end: int
    posterior: float
    mean_t: float  # posterior-weighted mean midpoint


def confusion_network(
    lat: Lattice,
    lm,
    drop_tokens: Tuple[str, ...] = ("<sil>", "sil"),
    min_posterior: float = 1e-3,
) -> List[Slot]:
    """Cluster lattice arcs into a time-ordered confusion network.

    Two stages (Mangu-style, simplified): (1) intra-word — union same-word
    arcs with overlapping spans; (2) inter-word — walk clusters in weighted
    -mean-time order, merging a cluster into the current slot while their
    time spans overlap and the slot does not already hold that word with
    disjoint support. Silence/dropped arcs contribute to epsilon mass by
    omission.
    """
    arcs, post, _z = lattice_arc_posteriors(lat, lm)
    keep = [
        (a, float(p))
        for a, p in zip(arcs, post)
        if p >= min_posterior and a.word not in drop_tokens
    ]
    if not keep:
        return []

    # --- intra-word clustering (union-find over overlapping same-word arcs)
    parent = list(range(len(keep)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, (ai, _) in enumerate(keep):
        for j in range(i + 1, len(keep)):
            aj, _ = keep[j]
            if ai.word == aj.word and ai.start <= aj.end and aj.start <= ai.end:
                parent[find(i)] = find(j)

    groups: Dict[int, List[int]] = {}
    for i in range(len(keep)):
        groups.setdefault(find(i), []).append(i)
    clusters: List[_Cluster] = []
    for members in groups.values():
        p_tot = sum(keep[i][1] for i in members)
        mean_t = (
            sum(keep[i][1] * 0.5 * (keep[i][0].start + keep[i][0].end) for i in members)
            / max(p_tot, 1e-12)
        )
        clusters.append(
            _Cluster(
                word=keep[members[0]][0].word,
                start=min(keep[i][0].start for i in members),
                end=max(keep[i][0].end for i in members),
                posterior=p_tot,
                mean_t=mean_t,
            )
        )
    clusters.sort(key=lambda c: c.mean_t)

    # --- inter-word clustering into slots
    slots: List[Slot] = []
    cur: Optional[Slot] = None
    for c in clusters:
        overlaps = cur is not None and c.start <= cur.end and c.mean_t <= cur.end
        if overlaps and c.word not in cur.words:
            cur.words[c.word] = cur.words.get(c.word, 0.0) + c.posterior
            cur.start = min(cur.start, c.start)
            cur.end = max(cur.end, c.end)
        else:
            cur = Slot(start=c.start, end=c.end, words={c.word: c.posterior})
            slots.append(cur)
    return slots


def consensus_decode(
    slots: Sequence[Slot], eps_margin: float = 0.0
) -> Tuple[List[str], List[float]]:
    """CN consensus: per slot, emit the argmax word unless epsilon wins.

    Returns (words, per-word posterior confidences) — the CN-MBR hypothesis
    minimizing expected word errors under the sausage approximation.
    """
    words: List[str] = []
    confs: List[float] = []
    for s in slots:
        w, p = s.best()
        if p > s.eps + eps_margin:
            words.append(w)
            confs.append(p)
    return words, confs


def mbr_nbest_decode(
    lat: Lattice,
    lm,
    n: int = 32,
    drop_tokens: Tuple[str, ...] = ("<sil>", "sil"),
) -> Tuple[List[str], float]:
    """N-best MBR: candidate minimizing posterior-expected edit distance.

    Exact N-best under the LM supplies candidates AND the posterior (softmax
    of path scores restricted to the list). Returns (hyp, expected_errors).
    """
    cands = lattice_nbest(lat, lm, n, drop_tokens=drop_tokens)
    if not cands:
        return [], 0.0
    scores = np.asarray([s for _, s in cands])
    w = np.exp(scores - scores.max())
    w /= w.sum()
    best_i, best_risk = 0, float("inf")
    for i, (hyp_i, _) in enumerate(cands):
        risk = sum(
            w[j] * edit_counts(hyp_j, hyp_i).errors
            for j, (hyp_j, _) in enumerate(cands)
        )
        if risk < best_risk:
            best_i, best_risk = i, float(risk)
    return list(cands[best_i][0]), best_risk

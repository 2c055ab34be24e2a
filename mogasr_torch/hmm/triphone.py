"""Context-dependent (triphone) modeling with data-driven state tying.

BASELINE.json sizes the acoustic model at "256 components x 1k states — a
monophone-to-small-triphone-scale GMM-HMM" (SURVEY.md §0). This module
provides the triphone side: word-internal triphone contexts, occupancy-
weighted k-means tying of (center-phone, hmm-position) context clusters into
tied pdfs, and context-dependent graph expansion that plugs into the same
chain+loop decoder graphs. Silence stays context-independent (standard).

Cross-word contexts back off to silence (word-boundary) context — exact for
corpora with inter-word silence, the standard approximation otherwise.
Unseen triphones back off to their (center, position) monophone-style pdf.

The recipe (pipeline.train_triphone): monophone align -> per-triphone-state
stats -> tie -> init CD GMM from tied stats -> EM with CD realignment.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mogasr_torch.hmm.graph import Graph, NEG_INF
from mogasr_torch.hmm.lexicon import SIL
from mogasr_torch.hmm.topology import Topology

Context = Tuple[int, int, int, int]  # (left, center, right, hmm position k)


@dataclasses.dataclass
class TiedTriphones:
    """Tying table: triphone state -> tied pdf id."""

    topo: Topology                       # monophone base (transitions, sil)
    tying: Dict[Context, int]            # (l, c, r, k) -> pdf
    backoff: Dict[Tuple[int, int], int]  # (c, k) -> pdf (unseen contexts)
    n_pdfs: int

    def pdf_of(self, l: int, c: int, r: int, k: int) -> int:
        sil = self.topo.lexicon.sil_id
        if c == sil:
            return self.topo.phone_pdf_ids(sil)[k]  # sil is CI: pdfs 0..sil_states
        return self.tying.get((l, c, r, k), self.backoff[(c, k)])

    def pdf_to_phone(self) -> np.ndarray:
        out = np.zeros(self.n_pdfs, np.int32)
        sil = self.topo.lexicon.sil_id
        for k in range(self.topo.sil_states):
            out[self.topo.phone_pdf_ids(sil)[k]] = sil
        for (l, c, r, k), pdf in self.tying.items():
            out[pdf] = c
        for (c, k), pdf in self.backoff.items():
            out[pdf] = c
        return out


def contexts_of(phone_ids: Sequence[int], sil_id: int) -> List[Tuple[int, int, int]]:
    """(l, c, r) per position; silence is both CI and a context barrier."""
    out = []
    n = len(phone_ids)
    for i, c in enumerate(phone_ids):
        l = phone_ids[i - 1] if i > 0 else sil_id
        r = phone_ids[i + 1] if i < n - 1 else sil_id
        out.append((l, c, r))
    return out


def _weighted_kmeans(
    means: np.ndarray, weights: np.ndarray, k: int, iters: int = 10, seed: int = 0
) -> np.ndarray:
    """Occupancy-weighted k-means over context mean vectors -> cluster ids."""
    n = means.shape[0]
    k = min(k, n)
    order = np.argsort(-weights)
    centers = means[order[:k]].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((means[:, None, :] - centers[None]) ** 2).sum(-1)  # [n, k]
        assign = d.argmin(1)
        for j in range(k):
            sel = assign == j
            if weights[sel].sum() > 0:
                centers[j] = (means[sel] * weights[sel, None]).sum(0) / weights[sel].sum()
    return assign


def tie_states(
    topo: Topology,
    stats: Dict[Context, Tuple[float, np.ndarray]],  # (l,c,r,k) -> (occ, mean)
    target_pdfs: int,
    min_occ: float = 10.0,
    seed: int = 0,
) -> TiedTriphones:
    """Cluster seen triphone states into <= target_pdfs tied pdfs.

    pdf layout: [sil CI pdfs][per-(c,k) backoff pdfs][tied cluster pdfs].
    The per-(c,k) budget of clusters is allocated proportionally to the
    number of distinct well-observed contexts.
    """
    lex = topo.lexicon
    sil = lex.sil_id
    sps = topo.states_per_phone

    # group stats by (c, k)
    groups: Dict[Tuple[int, int], List[Tuple[Context, float, np.ndarray]]] = {}
    for ctx, (occ, mean) in stats.items():
        l, c, r, k = ctx
        if c == sil:
            continue
        groups.setdefault((c, k), []).append((ctx, occ, mean))

    next_pdf = topo.sil_states
    backoff: Dict[Tuple[int, int], int] = {}
    for c in range(lex.n_phones):
        if c == sil:
            continue
        for k in range(sps):
            backoff[(c, k)] = next_pdf
            next_pdf += 1

    budget = max(target_pdfs - next_pdf, 0)
    # distinct well-observed contexts per group
    eligible = {
        ck: [g for g in lst if g[1] >= min_occ] for ck, lst in groups.items()
    }
    total_elig = sum(len(v) for v in eligible.values())
    tying: Dict[Context, int] = {}
    remaining = budget
    # largest groups first so the budget goes where contexts are plentiful;
    # the per-group share is proportional but the running total respects the
    # target (n_pdfs <= target_pdfs whenever target >= sil + backoff pdfs)
    for ck, lst in sorted(eligible.items(), key=lambda kv: (-len(kv[1]), kv[0])):
        if not lst or remaining <= 0 or total_elig == 0:
            continue
        share = max(int(round(budget * len(lst) / total_elig)), 1)
        share = min(share, len(lst), remaining)
        means = np.stack([m for _, _, m in lst])
        occs = np.asarray([o for _, o, _ in lst])
        assign = _weighted_kmeans(means, occs, share, seed=seed)
        n_clusters = int(assign.max()) + 1
        for (ctx, _o, _m), a in zip(lst, assign):
            tying[ctx] = next_pdf + int(a)
        next_pdf += n_clusters
        remaining -= n_clusters
    return TiedTriphones(topo=topo, tying=tying, backoff=backoff, n_pdfs=next_pdf)


def align_graph_cd(tied: TiedTriphones, phone_ids: Sequence[int]) -> Graph:
    """Forced-alignment chain with context-dependent emit ids."""
    topo = tied.topo
    emit, selfp, advp, chain = [], [], [], []
    ctxs = contexts_of(list(phone_ids), topo.lexicon.sil_id)
    prev_adv = NEG_INF  # adv_logp[j] = SOURCE state's advance prob (see graph.py)
    for ci, (p, (l, c, r)) in enumerate(zip(phone_ids, ctxs)):
        s_logp, a_logp = topo.phone_trans_logps(p)
        for k in range(topo.phone_n_states(p)):
            emit.append(tied.pdf_of(l, c, r, k))
            selfp.append(s_logp)
            advp.append(prev_adv)
            chain.append(ci)
            prev_adv = a_logp
    j = len(emit)
    init = np.full(j, NEG_INF, np.float32)
    init[0] = 0.0
    final = np.full(j, NEG_INF, np.float32)
    final[j - 1] = 0.0
    return Graph(
        emit_id=np.asarray(emit, np.int32),
        self_logp=np.asarray(selfp, np.float32),
        adv_logp=np.asarray(advp, np.float32),
        enter_logp=np.full(j, NEG_INF, np.float32),
        exit_logp=np.full(j, NEG_INF, np.float32),
        init_logp=init,
        final_logp=final,
        chain_id=np.asarray(chain, np.int32),
        labels=[topo.lexicon.phones[p] for p in phone_ids],
    )


def word_loop_graph_cd(
    tied: TiedTriphones,
    insertion_penalty: float = 0.0,
    token_logp: Optional[np.ndarray] = None,
) -> Graph:
    """Word-loop decode graph with word-internal triphones.

    Word-boundary phones take silence as the cross-word context (exact when
    utterances have inter-word silence; standard approximation otherwise).
    """
    topo = tied.topo
    lex = topo.lexicon
    sil = lex.sil_id
    tokens: List[Tuple[str, List[int]]] = [(w, lex.word_phone_ids(w)) for w in lex.words]
    tokens.append(("<sil>", [sil]))
    n_tok = len(tokens)
    if token_logp is None:
        token_logp = np.full(n_tok, -np.log(n_tok), np.float32)

    emit, selfp, advp, enterp, exitp, chain, labels = [], [], [], [], [], [], []
    for ci, (label, pids) in enumerate(tokens):
        labels.append(label)
        ctxs = contexts_of(pids, sil)
        states = []
        for p, (l, c, r) in zip(pids, ctxs):
            s_logp, a_logp = topo.phone_trans_logps(p)
            for k in range(topo.phone_n_states(p)):
                states.append((tied.pdf_of(l, c, r, k), s_logp, a_logp))
        for k, (pdf, s_logp, a_logp) in enumerate(states):
            emit.append(pdf)
            selfp.append(s_logp)
            advp.append(NEG_INF if k == 0 else states[k - 1][2])
            enterp.append(float(token_logp[ci]) - insertion_penalty if k == 0 else NEG_INF)
            exitp.append(a_logp if k == len(states) - 1 else NEG_INF)
            chain.append(ci)
    j = len(emit)
    return Graph(
        emit_id=np.asarray(emit, np.int32),
        self_logp=np.asarray(selfp, np.float32),
        adv_logp=np.asarray(advp, np.float32),
        enter_logp=np.asarray(enterp, np.float32),
        exit_logp=np.asarray(exitp, np.float32),
        init_logp=np.asarray(enterp, np.float32).copy(),
        final_logp=np.asarray(exitp, np.float32).copy(),
        chain_id=np.asarray(chain, np.int32),
        labels=labels,
    )

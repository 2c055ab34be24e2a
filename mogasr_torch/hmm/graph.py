"""Decode/alignment graph construction (host side).

One graph machinery serves both entry points (SURVEY.md §3.3/§3.4):

- **Forced-alignment graph**: the transcript's phone sequence expanded into one
  linear chain of HMM states (must start at state 0, end at the last state).
- **Loop graph** (free decode): a set of linear chains (one per token — phone
  or word), all connected through a single *non-emitting loop state*: every
  chain end exits to the loop, the loop enters every chain start with a token
  prior + insertion penalty. This is classic token-passing; because the only
  cross-chain connectivity is through the loop state, the jitted Viterbi step
  needs just one max-reduce per frame instead of a [J, J] transition matrix.

The graph is a flat struct-of-arrays over states j = 0..J-1; everything the
device needs is dense int32/float32, built once per utterance batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mogasr_torch.hmm.topology import Topology

NEG_INF = np.float32(-1e30)


@dataclasses.dataclass
class Graph:
    """Flat left-to-right-chains + loop-state graph.

    emit_id:    [J] pdf id per state
    self_logp:  [J] self-loop log-prob
    adv_logp:   [J] log-prob of the (j-1 -> j) within-chain transition
                (NEG_INF at chain starts)
    enter_logp: [J] loop-state -> j entry log-prob (NEG_INF unless chain start)
    exit_logp:  [J] j -> loop-state exit log-prob (NEG_INF unless chain end)
    init_logp:  [J] start-of-utterance distribution
    final_logp: [J] end-of-utterance weights
    chain_id:   [J] which token each state belongs to
    labels:     token label per chain (phone or word string)
    skip_logp:  optional [J] log-prob of the (j-2 -> j) within-chain skip
                (CTC optional-blank topology; None for HMM chain graphs)
    """

    emit_id: np.ndarray
    self_logp: np.ndarray
    adv_logp: np.ndarray
    enter_logp: np.ndarray
    exit_logp: np.ndarray
    init_logp: np.ndarray
    final_logp: np.ndarray
    chain_id: np.ndarray
    labels: List[str]
    skip_logp: Optional[np.ndarray] = None

    @property
    def n_states(self) -> int:
        return int(self.emit_id.shape[0])

    def pad_to(self, j_max: int) -> "Graph":
        """Pad state arrays to j_max with inert states (all NEG_INF)."""
        j = self.n_states
        assert j <= j_max
        pad = j_max - j

        def padf(a, fill):
            return np.concatenate([a, np.full(pad, fill, a.dtype)])

        return Graph(
            emit_id=padf(self.emit_id, 0),
            self_logp=padf(self.self_logp, NEG_INF),
            adv_logp=padf(self.adv_logp, NEG_INF),
            enter_logp=padf(self.enter_logp, NEG_INF),
            exit_logp=padf(self.exit_logp, NEG_INF),
            init_logp=padf(self.init_logp, NEG_INF),
            final_logp=padf(self.final_logp, NEG_INF),
            chain_id=padf(self.chain_id, -1),
            labels=self.labels,
            skip_logp=None if self.skip_logp is None else padf(self.skip_logp, NEG_INF),
        )


def align_graph(topo: Topology, phone_ids: Sequence[int]) -> Graph:
    """Linear forced-alignment graph for a transcript phone sequence.

    adv_logp[j] is the weight of the (j-1 -> j) transition, i.e. the SOURCE
    state's advance log-prob — at phone boundaries that is the previous
    phone's advance prob, keeping each state's outgoing mass normalized.
    """
    emit, selfp, advp, chain = [], [], [], []
    prev_adv = NEG_INF  # no predecessor for the very first state
    for ci, p in enumerate(phone_ids):
        s_logp, a_logp = topo.phone_trans_logps(p)
        for k, pdf in enumerate(topo.phone_pdf_ids(p)):
            emit.append(pdf)
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


def loop_graph(
    topo: Topology,
    tokens: Optional[Sequence[Tuple[str, Sequence[int]]]] = None,
    token_logp: Optional[np.ndarray] = None,
    insertion_penalty: float = 0.0,
) -> Graph:
    """Free-decode loop graph.

    tokens: (label, phone id seq) per chain. Default: one chain per phone
    (free phone decode). For word decode pass the lexicon's vocabulary with
    each word's phone sequence; token_logp supplies unigram LM log-probs.
    """
    lex = topo.lexicon
    if tokens is None:
        tokens = [(ph, [pid]) for pid, ph in enumerate(lex.phones)]
    n_tok = len(tokens)
    if token_logp is None:
        token_logp = np.full(n_tok, -np.log(n_tok), np.float32)

    emit, selfp, advp, enterp, exitp, chain = [], [], [], [], [], []
    labels = []
    for ci, (label, pids) in enumerate(tokens):
        labels.append(label)
        states: List[Tuple[int, float, float]] = []  # (pdf, self, adv)
        for p in pids:
            s_logp, a_logp = topo.phone_trans_logps(p)
            for pdf in topo.phone_pdf_ids(p):
                states.append((pdf, s_logp, a_logp))
        for k, (pdf, s_logp, a_logp) in enumerate(states):
            emit.append(pdf)
            selfp.append(s_logp)
            advp.append(NEG_INF if k == 0 else states[k - 1][2])
            enterp.append(
                float(token_logp[ci]) - insertion_penalty if k == 0 else NEG_INF
            )
            exitp.append(a_logp if k == len(states) - 1 else NEG_INF)
            chain.append(ci)
    j = len(emit)
    g = Graph(
        emit_id=np.asarray(emit, np.int32),
        self_logp=np.asarray(selfp, np.float32),
        adv_logp=np.asarray(advp, np.float32),
        enter_logp=np.asarray(enterp, np.float32),
        exit_logp=np.asarray(exitp, np.float32),
        init_logp=np.asarray(enterp, np.float32).copy(),  # start as if from loop
        final_logp=np.asarray(exitp, np.float32).copy(),  # must end a token
        chain_id=np.asarray(chain, np.int32),
        labels=labels,
    )
    return g


def path_words(graph: "Graph", path, entered,
               drop=("<sil>", "sil")) -> list:
    """Collapse ONE stream's decoded (path, entered) into word labels.

    The single source of truth for path->words (serving engines, the serve
    CLI, and online decode all need it; three hand copies drifted before
    this existed). path[t] < 0 terminates; a frame with entered[t] emits
    its chain's label unless it is a silence token."""
    toks = []
    for t in range(len(path)):
        j = int(path[t])
        if j < 0:
            break
        if entered[t]:
            w = graph.labels[graph.chain_id[j]]
            if w not in drop:
                toks.append(w)
    return toks


def batch_graphs(graphs: Sequence[Graph], j_max: Optional[int] = None) -> dict:
    """Stack per-utterance graphs into [B, J_max] device-ready arrays."""
    jm = j_max if j_max is not None else max(g.n_states for g in graphs)
    padded = [g.pad_to(jm) for g in graphs]
    out = {}
    if any(g.skip_logp is not None for g in padded):
        out["skip_logp"] = np.stack([
            g.skip_logp if g.skip_logp is not None
            else np.full(jm, NEG_INF, np.float32)
            for g in padded
        ])
    return {
        **out,
        "emit_id": np.stack([g.emit_id for g in padded]),
        "self_logp": np.stack([g.self_logp for g in padded]),
        "adv_logp": np.stack([g.adv_logp for g in padded]),
        "enter_logp": np.stack([g.enter_logp for g in padded]),
        "exit_logp": np.stack([g.exit_logp for g in padded]),
        "init_logp": np.stack([g.init_logp for g in padded]),
        "final_logp": np.stack([g.final_logp for g in padded]),
        "chain_id": np.stack([g.chain_id for g in padded]),
        "n_states": np.asarray([g.n_states for g in graphs], np.int32),
    }

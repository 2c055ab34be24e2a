"""Contextual biasing: on-the-fly phrase boosting for beam decoding.

The port's copy of mogasr/decoder/biasing.py, its imports pointed at mogasr_torch.

Production ASR must be able to favor a supplied phrase list (contact
names, device commands, rare entities) at DECODE time, without retraining.
This module implements the shallow-fusion boosting recipe as a stateless
``ext_score(prefix, unit)`` callback compatible with the CTC prefix beam
(mogasr_torch.am.ctc.ctc_beam_step / CtcStreamDecoder) offline and streaming:

  score(prefix, u) = weight * [m(prefix + u) - m(prefix)]           (partial)
                   + weight * len(p) * completion_scale             (complete)
                     for every phrase p that prefix + u ends with

where m(x) is the length of the longest suffix of x that is a PROPER
prefix of some phrase. The delta form telescopes: a live partial match
carries cumulative bonus weight * m, which is AUTOMATICALLY retracted when
the match dies (the delta goes negative) — the classic subtractive-cost
trick, with no per-hypothesis decoder state. Completions are credited
permanently (and the transient part retracts by construction), so a
finished phrase keeps exactly weight * len(p) * completion_scale.

Unit inventories are whatever the decoder emits: phone ids
(``biaser_from_words``) or BPE unit ids (``biaser_from_bpe``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple


class ContextBiaser:
    """Trie-free suffix matcher over a phrase list of unit-id sequences."""

    def __init__(
        self,
        phrases: Sequence[Sequence[int]],
        weight: float = 2.0,
        completion_scale: float = 1.0,
    ):
        self.weight = float(weight)
        self.completion_scale = float(completion_scale)
        self.phrases: List[Tuple[int, ...]] = [
            tuple(int(u) for u in p) for p in phrases if len(p) > 0
        ]
        self.proper_prefixes: Set[Tuple[int, ...]] = set()
        self.full: Dict[Tuple[int, ...], int] = {}
        for p in self.phrases:
            self.full[p] = len(p)
            for k in range(1, len(p)):
                self.proper_prefixes.add(p[:k])
        self.max_pref = max((len(p) - 1 for p in self.phrases), default=0)
        self.max_full = max((len(p) for p in self.phrases), default=0)

    def match_len(self, toks: Tuple[int, ...]) -> int:
        """Longest suffix of toks that is a proper prefix of some phrase."""
        L = min(len(toks), self.max_pref)
        for k in range(L, 0, -1):
            if toks[-k:] in self.proper_prefixes:
                return k
        return 0

    def score(self, prefix: Tuple[int, ...], unit: int) -> float:
        """Additive log-score bonus for extending prefix with unit
        (the ext_score signature of ctc_beam_step / CtcStreamDecoder)."""
        ext = tuple(prefix) + (int(unit),)
        s = self.weight * (self.match_len(ext) - self.match_len(tuple(prefix)))
        if self.completion_scale != 0.0:
            L = min(len(ext), self.max_full)
            for k in range(1, L + 1):
                n = self.full.get(ext[-k:])
                if n is not None:
                    s += self.weight * n * self.completion_scale
        return s


def biaser_from_words(
    lexicon,
    phrases: Sequence[Sequence[str]],
    weight: float = 2.0,
    completion_scale: float = 1.0,
) -> ContextBiaser:
    """Word phrases -> phone-id sequences via the lexicon (no silences —
    the boost must match the decoder's raw unit stream)."""
    seqs = [
        lexicon.words_to_phone_ids(list(p), interword_sil=False, edge_sil=False)
        for p in phrases
    ]
    return ContextBiaser(seqs, weight=weight, completion_scale=completion_scale)


def biaser_from_bpe(
    bpe,
    phrases: Sequence[Sequence[str]],
    weight: float = 2.0,
    completion_scale: float = 1.0,
) -> ContextBiaser:
    """Word phrases -> BPE unit-id sequences (open vocabulary)."""
    seqs = [bpe.encode(list(p)) for p in phrases]
    return ContextBiaser(seqs, weight=weight, completion_scale=completion_scale)


def load_phrases(path: str) -> List[List[str]]:
    """One phrase per line, whitespace-separated words; blank lines and
    #-comments skipped."""
    out: List[List[str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append(line.split())
    return out


class CompiledBiaser:
    """ContextBiaser compiled into dense automaton tables for DEVICE beams.

    ``score(prefix, u)`` depends on the prefix only through its longest
    suffix that is a proper prefix of some phrase (the Aho-Corasick state):
    every matching suffix of the prefix has length <= that state's, hence
    IS a suffix of the state string, and every phrase completion of
    prefix+u likewise ends inside state+u. Enumerating the (root + proper
    prefixes) states S therefore yields exact tables

        delta[S, V] = ContextBiaser.score(state, u)   (retraction included)
        next_state[S, V] = state id of (state + u)'s longest match

    so a batched on-device beam carries ONE int per hypothesis and adds one
    row-gather per expansion — same trick as the AED fusion matrix.
    Equality with the callback is pinned by tests/test_unit_fusion.py.
    """

    def __init__(self, biaser: ContextBiaser, n_units: int):
        states: List[Tuple[int, ...]] = [()]
        states.extend(sorted(biaser.proper_prefixes, key=lambda s: (len(s), s)))
        sid = {s: i for i, s in enumerate(states)}
        S, V = len(states), int(n_units)
        import numpy as np

        self.delta = np.zeros((S, V), np.float32)
        self.next_state = np.zeros((S, V), np.int32)
        for s, i in sid.items():
            for u in range(V):
                self.delta[i, u] = biaser.score(s, u)
                ext = s + (u,)
                k = biaser.match_len(ext)
                self.next_state[i, u] = sid[ext[len(ext) - k:]]
        self.n_states = S
        self.n_units = V

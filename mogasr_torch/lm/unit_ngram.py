"""Subword-unit n-gram LM for SHALLOW FUSION in the CTC prefix beam.

The port's copy of mogasr/lm/unit_ngram.py, its imports pointed at mogasr_torch.

The prefix beam (am/ctc.py ctc_beam_step) exposes an ``ext_score(prefix,
unit)`` hook scored exactly once each time a prefix grows by one unit, so
summing conditional unit log-probs telescopes to the LM log-prob of the
whole unit sequence: fused beam scores are acoustic + weight * LM — the
standard shallow-fusion decision rule. A Kneser-Ney bigram over BPE unit
ids is the pragmatic streaming choice: one array lookup per expansion and
no per-hypothesis LM state to carry, so the SAME callback serves offline
decode, cli/stream.py, and the batched serving engine without changing
their exactness story. (A dense unit trigram at V≈300 would be a 27M-entry
table for marginal gain; word-level strength comes from the neural-LM
N-best rescoring pass instead — lm/neural.py.)

No reference file can be cited (SURVEY.md §0: reference is empty);
shallow fusion is the standard e2e-ASR decoding component the capability
spec's CTC/streaming configs presume.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from mogasr_torch.lm.ngram import estimate_bigram_kn


@dataclasses.dataclass
class UnitBigramLm:
    """KN-smoothed bigram over unit ids 0..n_units-1."""

    n_units: int
    pair_logp: np.ndarray  # [V, V]: log P(u' | u)
    init_logp: np.ndarray  # [V]:    log P(u | <s>)


def estimate_unit_bigram(
    unit_seqs: Sequence[Sequence[int]],
    n_units: int,
    discount: float = 0.75,
) -> UnitBigramLm:
    """Interpolated-KN bigram over unit-id sequences (lm/ngram machinery;
    token strings are the ids themselves, so index == unit id)."""
    toks = [str(i) for i in range(n_units)]
    lm = estimate_bigram_kn(
        [[str(int(u)) for u in seq] for seq in unit_seqs], toks,
        discount=discount,
    )
    return UnitBigramLm(
        n_units=n_units,
        pair_logp=lm.pair_logp.astype(np.float32),
        init_logp=lm.init_logp.astype(np.float32),
    )


def unit_seq_logp(lm: UnitBigramLm, seq: Sequence[int]) -> float:
    """LM log-prob of a unit sequence (no EOS term — fusion scores prefixes
    that are still growing, so the telescoped sum must match this)."""
    total = 0.0
    for i, u in enumerate(seq):
        total += float(lm.init_logp[u] if i == 0
                       else lm.pair_logp[seq[i - 1], u])
    return total


def fusion_score(
    lm: UnitBigramLm, weight: float = 1.0
) -> Callable[[Tuple[int, ...], int], float]:
    """ext_score callback for ctc_beam_step / CtcStreamDecoder.

    The weight is baked in (pass ext_weight=1.0) so fusion composes with
    other callbacks — e.g. contextual biasing — by plain summation."""
    pair = lm.pair_logp
    init = lm.init_logp

    def ext(prefix: Tuple[int, ...], unit: int) -> float:
        if not prefix:
            return weight * float(init[unit])
        return weight * float(pair[prefix[-1], unit])

    return ext


def compose_ext_scores(
    fns: Sequence[Optional[Callable[[Tuple[int, ...], int], float]]],
) -> Optional[Callable[[Tuple[int, ...], int], float]]:
    """Sum of the non-None callbacks (None if none remain)."""
    live = [f for f in fns if f is not None]
    if not live:
        return None
    if len(live) == 1:
        return live[0]

    def ext(prefix: Tuple[int, ...], unit: int) -> float:
        return sum(f(prefix, unit) for f in live)

    return ext


def unit_perplexity(lm: UnitBigramLm, unit_seqs: Sequence[Sequence[int]]) -> float:
    """Per-unit perplexity over held-out sequences (no EOS term, matching
    unit_seq_logp / the fusion telescoping)."""
    total, n = 0.0, 0
    for seq in unit_seqs:
        if len(seq) == 0:
            continue
        total += unit_seq_logp(lm, list(seq))
        n += len(seq)
    return float(np.exp(-total / max(n, 1)))


def save_unit_lm(path: str, lm: UnitBigramLm) -> None:
    np.savez(path if path.endswith(".npz") else path + ".npz",
             n_units=np.int32(lm.n_units),
             pair_logp=lm.pair_logp, init_logp=lm.init_logp)


def load_unit_lm(path: str) -> UnitBigramLm:
    with np.load(path) as z:
        return UnitBigramLm(
            n_units=int(z["n_units"]),
            pair_logp=z["pair_logp"],
            init_logp=z["init_logp"],
        )

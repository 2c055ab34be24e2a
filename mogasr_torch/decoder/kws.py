"""Keyword spotting (KWS) over word lattices / confusion networks.

The port's copy of mogasr/decoder/kws.py, its imports pointed at mogasr_torch.

Posterior-based term detection, the standard lattice-KWS architecture:
the device decode pass materializes lattices (decoder.lm_viterbi), the
confusion network supplies per-slot word posteriors (decoder.confusion),
and a term hit is a run of slots whose words spell the term — with
low-confidence (epsilon-dominated) slots skippable between term words.
Score = product of the matched slots' word posteriors.

Single-word terms degenerate to the slot posterior of the word — i.e. the
exact lattice posterior mass of that word at that position under the LM.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from mogasr_torch.decoder.confusion import Slot, confusion_network
from mogasr_torch.decoder.lattice import Lattice


@dataclasses.dataclass(frozen=True)
class KwsHit:
    term: str
    start: int      # first frame of the matched span
    end: int        # last frame (inclusive)
    posterior: float


def search_slots(
    slots: Sequence[Slot],
    term: Sequence[str],
    threshold: float = 0.3,
    eps_skip: float = 0.5,
) -> List[KwsHit]:
    """Find term occurrences in a confusion network.

    A match anchors each term word to a slot containing it; between term
    words, slots whose epsilon mass exceeds ``eps_skip`` may be skipped
    (they most likely contain no word on the best paths). Overlapping
    matches keep the highest-posterior one.
    """
    term = [w.lower() for w in term]
    hits: List[KwsHit] = []
    n = len(slots)
    for i in range(n):
        p = 1.0
        k = 0
        j = i
        last = i
        while j < n and k < len(term):
            pw = slots[j].words.get(term[k], 0.0)
            if pw > 0.0:
                p *= pw
                last = j
                k += 1
                j += 1
            elif k > 0 and slots[j].eps >= eps_skip:
                j += 1  # skippable gap inside the phrase
            else:
                break
        if k == len(term) and p >= threshold:
            hits.append(
                KwsHit(
                    term=" ".join(term),
                    start=slots[i].start,
                    end=slots[last].end,
                    posterior=float(p),
                )
            )
    # resolve overlaps: keep best-scoring hit per overlapping group
    hits.sort(key=lambda h: -h.posterior)
    chosen: List[KwsHit] = []
    for h in hits:
        if all(h.end < c.start or h.start > c.end for c in chosen):
            chosen.append(h)
    chosen.sort(key=lambda h: h.start)
    return chosen


def keyword_search(
    lat: Lattice,
    lm,
    terms: Sequence[Sequence[str]],
    threshold: float = 0.3,
    eps_skip: float = 0.5,
    drop_tokens: Tuple[str, ...] = ("<sil>", "sil"),
) -> List[KwsHit]:
    """Search one lattice for all terms; returns hits sorted by start frame."""
    slots = confusion_network(lat, lm, drop_tokens=drop_tokens)
    out: List[KwsHit] = []
    for term in terms:
        out.extend(search_slots(slots, term, threshold=threshold, eps_skip=eps_skip))
    out.sort(key=lambda h: h.start)
    return out


def keyword_search_batch(
    lats: Sequence[Lattice],
    lm,
    terms: Sequence[Sequence[str]],
    threshold: float = 0.3,
) -> List[List[KwsHit]]:
    return [keyword_search(lat, lm, terms, threshold=threshold) for lat in lats]

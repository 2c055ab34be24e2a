"""Diarization Error Rate (DER) with optimal speaker mapping.

The port's copy of mogasr/eval/diarization.py, its imports pointed at mogasr_torch.

Frame-stepped scoring (default 10 ms) of hypothesis speaker turns against
reference turns: the hypothesis labels are mapped to reference speakers by
maximizing total overlap (Hungarian assignment), then

    DER = (missed speech + false alarm + speaker confusion) / ref speech

— the standard NIST definition, without overlap regions (neither the
synthetic sessions nor the single-label track produce overlapping
speech).  An optional collar around reference boundaries excludes
transition frames from scoring, as in NIST scoring tools.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Segment = Tuple[float, float, object]  # (start_s, end_s, speaker_label)


def _tracks(
    segs: Sequence[Segment], n_steps: int, step_s: float
) -> Tuple[np.ndarray, List[object]]:
    """Segments -> ([n_steps] int track, -1 = no speech; label list)."""
    labels = sorted({s[2] for s in segs}, key=str)
    idx = {l: i for i, l in enumerate(labels)}
    track = np.full(n_steps, -1, np.int64)
    for s, e, lab in segs:
        lo = int(round(s / step_s))
        hi = min(int(round(e / step_s)), n_steps)
        track[lo:hi] = idx[lab]
    return track, labels


def der(
    ref: Sequence[Segment],
    hyp: Sequence[Segment],
    step_s: float = 0.01,
    collar_s: float = 0.0,
) -> Dict[str, float]:
    """-> {"der", "miss", "false_alarm", "confusion", "ref_speech_s"}.

    Rates are fractions of total reference speech time (NIST convention)."""
    from scipy.optimize import linear_sum_assignment

    end = max([e for _s, e, _l in list(ref) + list(hyp)] or [0.0])
    n = int(np.ceil(end / step_s)) + 1
    rt, rlabs = _tracks(ref, n, step_s)
    ht, hlabs = _tracks(hyp, n, step_s)

    scored = np.ones(n, bool)
    if collar_s > 0:
        c = int(round(collar_s / step_s))
        bounds = {int(round(s / step_s)) for s, _e, _l in ref}
        bounds |= {int(round(e / step_s)) for _s, e, _l in ref}
        for b in bounds:
            scored[max(0, b - c) : b + c] = False

    rs = (rt >= 0) & scored
    hs = (ht >= 0) & scored
    ref_speech = float(rs.sum())
    if ref_speech == 0:
        fa = float(hs.sum())
        return {"der": fa, "miss": 0.0, "false_alarm": fa,
                "confusion": 0.0, "ref_speech_s": 0.0}

    # optimal hyp->ref label mapping by total overlap
    overlap = np.zeros((len(rlabs), len(hlabs)))
    both = rs & hs
    for i in range(len(rlabs)):
        for j in range(len(hlabs)):
            overlap[i, j] = float(((rt == i) & (ht == j) & both).sum())
    mapped = np.full(len(hlabs), -1, np.int64)
    if overlap.size:
        ri, hj = linear_sum_assignment(-overlap)
        mapped[hj] = ri

    miss = float((rs & ~hs).sum())
    fa = float((~rs & hs).sum())
    conf = float((both & (mapped[np.maximum(ht, 0)] != rt)).sum())
    return {
        "der": (miss + fa + conf) / ref_speech,
        "miss": miss / ref_speech,
        "false_alarm": fa / ref_speech,
        "confusion": conf / ref_speech,
        "ref_speech_s": ref_speech * step_s,
    }

"""Word-error-rate scoring (host side): the port's copy of mogasr/eval/wer.py.

Levenshtein distance over words, corpus-level WER. Only the pure-Python
dynamic program is kept: the reference's native C++ batch scorer
(mogasr/native) gives the same counts and is not part of the port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class WerCounts:
    substitutions: int = 0
    deletions: int = 0
    insertions: int = 0
    ref_words: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    @property
    def wer(self) -> float:
        return self.errors / max(self.ref_words, 1)

    def __add__(self, other: "WerCounts") -> "WerCounts":
        return WerCounts(
            self.substitutions + other.substitutions,
            self.deletions + other.deletions,
            self.insertions + other.insertions,
            self.ref_words + other.ref_words,
        )


def edit_counts(ref: Sequence[str], hyp: Sequence[str]) -> WerCounts:
    """Levenshtein alignment with (sub, del, ins) breakdown."""
    R, H = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, inss) for ref[:i] vs hyp[:j]
    cost = np.zeros((R + 1, H + 1), np.int32)
    cost[:, 0] = np.arange(R + 1)
    cost[0, :] = np.arange(H + 1)
    op = np.zeros((R + 1, H + 1), np.int8)  # 0=match,1=sub,2=del,3=ins
    op[1:, 0] = 2
    op[0, 1:] = 3
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                cost[i, j] = cost[i - 1, j - 1]
                op[i, j] = 0
            else:
                sub = cost[i - 1, j - 1] + 1
                dele = cost[i - 1, j] + 1
                ins = cost[i, j - 1] + 1
                best = min(sub, dele, ins)
                cost[i, j] = best
                op[i, j] = 1 if best == sub else (2 if best == dele else 3)
    counts = WerCounts(ref_words=R)
    i, j = R, H
    while i > 0 or j > 0:
        o = op[i, j]
        if o == 0 or o == 1:
            counts.substitutions += int(o == 1)
            i, j = i - 1, j - 1
        elif o == 2:
            counts.deletions += 1
            i -= 1
        else:
            counts.insertions += 1
            j -= 1
    return counts


def corpus_wer(
    refs: Sequence[Sequence[str]], hyps: Sequence[Sequence[str]]
) -> Tuple[float, WerCounts]:
    """wer(refs, hyps) -> (corpus WER, aggregated counts)."""
    assert len(refs) == len(hyps), (len(refs), len(hyps))
    per_utt = [edit_counts(list(r), list(h)) for r, h in zip(refs, hyps)]
    total = WerCounts()
    for c in per_utt:
        total = total + c
    return total.wer, total


def per_utt_wer(refs, hyps) -> List[float]:
    return [edit_counts(list(r), list(h)).wer for r, h in zip(refs, hyps)]


def wer_bootstrap_ci(
    refs: Sequence[Sequence[str]],
    hyps: Sequence[Sequence[str]],
    n_boot: int = 1000,
    confidence: float = 0.95,
    seed: int = 0,
) -> Tuple[float, float, float]:
    """Bootstrap confidence interval for corpus WER (Bisani & Ney 2004):
    resample UTTERANCES with replacement, recompute the ratio of summed
    errors to summed reference words per replicate, take the percentile
    interval. Returns (wer, lo, hi). Per-utterance counts are computed once;
    replicates are vectorized sums, so n_boot=1000 costs ~nothing beyond
    the scoring pass itself."""
    assert len(refs) == len(hyps), (len(refs), len(hyps))
    per_utt = [edit_counts(list(r), list(h)) for r, h in zip(refs, hyps)]
    errs = np.asarray([c.errors for c in per_utt], np.float64)
    words = np.asarray([max(c.ref_words, 0) for c in per_utt], np.float64)
    wer = float(errs.sum() / max(words.sum(), 1.0))
    rng = np.random.default_rng(seed)
    n = len(per_utt)
    idx = rng.integers(0, n, size=(n_boot, n))
    boot = errs[idx].sum(axis=1) / np.maximum(words[idx].sum(axis=1), 1.0)
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(boot, [alpha, 1.0 - alpha])
    return wer, float(lo), float(hi)


def align_words(
    ref: Sequence[str], hyp: Sequence[str]
) -> List[Tuple[str, Optional[str], Optional[str]]]:
    """Levenshtein alignment as (op, ref_word, hyp_word) triples, op in
    {"ok", "sub", "del", "ins"} — the per-word view behind sclite-style
    error reports. Same DP/tie-breaking as edit_counts (op counts agree)."""
    R, H = len(ref), len(hyp)
    cost = np.zeros((R + 1, H + 1), np.int32)
    cost[:, 0] = np.arange(R + 1)
    cost[0, :] = np.arange(H + 1)
    op = np.zeros((R + 1, H + 1), np.int8)
    op[1:, 0] = 2
    op[0, 1:] = 3
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                cost[i, j] = cost[i - 1, j - 1]
                op[i, j] = 0
            else:
                sub = cost[i - 1, j - 1] + 1
                dele = cost[i - 1, j] + 1
                ins = cost[i, j - 1] + 1
                best = min(sub, dele, ins)
                cost[i, j] = best
                op[i, j] = 1 if best == sub else (2 if best == dele else 3)
    out: List[Tuple[str, Optional[str], Optional[str]]] = []
    i, j = R, H
    while i > 0 or j > 0:
        o = op[i, j]
        if o == 0:
            out.append(("ok", ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif o == 1:
            out.append(("sub", ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif o == 2:
            out.append(("del", ref[i - 1], None))
            i -= 1
        else:
            out.append(("ins", None, hyp[j - 1]))
            j -= 1
    return out[::-1]


def error_report(
    refs: Sequence[Sequence[str]],
    hyps: Sequence[Sequence[str]],
    ids: Optional[Sequence[str]] = None,
    top_confusions: int = 20,
) -> str:
    """Sclite-flavored text report: per-utterance REF/HYP alignment lines
    (errors upper-cased, deletions as ***) plus corpus totals and the most
    frequent confusion pairs / deleted / inserted words."""
    from collections import Counter

    subs: Counter = Counter()
    dels: Counter = Counter()
    inss: Counter = Counter()
    lines: List[str] = []
    total = WerCounts()
    for k, (r, h) in enumerate(zip(refs, hyps)):
        ali = align_words(list(r), list(h))
        rrow, hrow = [], []
        for o, rw, hw in ali:
            if o == "ok":
                rrow.append(rw)
                hrow.append(hw)
            elif o == "sub":
                w = max(len(rw), len(hw))
                rrow.append(rw.upper().ljust(w))
                hrow.append(hw.upper().ljust(w))
                subs[(rw, hw)] += 1
            elif o == "del":
                rrow.append(rw.upper())
                hrow.append("*" * len(rw))
                dels[rw] += 1
            else:
                rrow.append("*" * len(hw))
                hrow.append(hw.upper())
                inss[hw] += 1
        c = edit_counts(list(r), list(h))
        total = total + c
        uid = ids[k] if ids is not None else f"utt-{k:04d}"
        lines.append(f"id: {uid}  (#err {c.errors}, #ref {c.ref_words})")
        lines.append("REF: " + " ".join(rrow))
        lines.append("HYP: " + " ".join(hrow))
        lines.append("")
    lines.append(
        f"TOTAL wer {total.wer:.4f}  sub {total.substitutions} "
        f"del {total.deletions} ins {total.insertions} "
        f"ref_words {total.ref_words}"
    )
    if subs:
        lines.append("top substitutions:")
        for (rw, hw), n in subs.most_common(top_confusions):
            lines.append(f"  {n:4d}  {rw} -> {hw}")
    if dels:
        lines.append("top deletions:")
        for w, n in dels.most_common(top_confusions):
            lines.append(f"  {n:4d}  {w}")
    if inss:
        lines.append("top insertions:")
        for w, n in inss.most_common(top_confusions):
            lines.append(f"  {n:4d}  {w}")
    return "\n".join(lines) + "\n"

"""ARPA language-model file I/O (the standard n-gram interchange format).

The port's copy of mogasr/lm/arpa.py, its imports pointed at mogasr_torch.

Interop layer for the n-gram LMs: export BigramLm/TrigramLm so external
toolkits (SRILM/KenLM/Kaldi) can consume them, and import ARPA files —
including ones with backoff weights — into the dense closed-vocabulary
tables the decoders use. Conventions:

- ARPA probabilities are log10; internal tables are natural log.
- Export writes EVERY n-gram of the dense model (closed small vocabularies;
  a few thousand lines), so backoff weights are never exercised on
  re-import and round-trips are exact. External models with missing n-grams
  resolve through standard Katz backoff: P(w|a,b) = bow(a,b) * P(w|b) when
  the trigram is absent, recursively down to unigrams.
- ``<s>``/``</s>`` map to the internal BOS/EOS handling (init/final arrays
  for the bigram; sentinel context/event index for the trigram).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mogasr_torch.lm.ngram import BigramLm, TrigramLm

LN10 = math.log(10.0)
BOS, EOS = "<s>", "</s>"
MIN_LOG10 = -99.0  # ARPA convention for "never"


def _to10(ln: float) -> float:
    return max(ln / LN10, MIN_LOG10)


def _toln(l10: float) -> float:
    return l10 * LN10


def write_arpa(path: str, lm) -> None:
    """Write a BigramLm or TrigramLm as an ARPA file (all n-grams explicit)."""
    if isinstance(lm, TrigramLm):
        _write_arpa_trigram(path, lm)
    elif isinstance(lm, BigramLm):
        _write_arpa_bigram(path, lm)
    else:
        raise TypeError(f"cannot export {type(lm).__name__} as ARPA")


def _write_arpa_bigram(path: str, lm: BigramLm) -> None:
    toks = lm.tokens
    C = len(toks)
    lines: List[str] = ["\\data\\", f"ngram 1={C + 2}", f"ngram 2={C * C + 2 * C}", "",
                        "\\1-grams:"]
    # unigram section: <s>/<"never" prob, no backoff needed — every used
    # bigram is listed explicitly below. P(w) = P(w|<s>) keeps round-trips
    # exact for the init distribution.
    lines.append(f"{MIN_LOG10:.6f}\t{BOS}\t0.000000")
    lines.append(f"{_to10(0.0):.6f}\t{EOS}")
    for i, t in enumerate(toks):
        lines.append(f"{_to10(float(lm.init_logp[i])):.6f}\t{t}\t0.000000")
    lines += ["", "\\2-grams:"]
    for i, t in enumerate(toks):
        lines.append(f"{_to10(float(lm.init_logp[i])):.6f}\t{BOS} {t}")
    for i, a in enumerate(toks):
        lines.append(f"{_to10(float(lm.final_logp[i])):.6f}\t{a} {EOS}")
        for j, b in enumerate(toks):
            lines.append(f"{_to10(float(lm.pair_logp[i, j])):.6f}\t{a} {b}")
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _write_arpa_trigram(path: str, lm: TrigramLm) -> None:
    toks = lm.tokens
    C = len(toks)
    B = lm.bos
    lg = lm.logp  # [C+1, C+1, C+1]

    def name(i: int, ctx: bool) -> str:
        return (BOS if ctx else EOS) if i == C else toks[i]

    tri_lines: List[str] = []
    for a in range(C + 1):
        for b in range(C + 1):
            if a != B and b == B:
                continue  # (word, <s>) contexts never occur
            for w in range(C + 1):
                if a == B and b == B and w == C:
                    continue  # "<s> <s> </s>" is meaningless
                tri_lines.append(
                    f"{_to10(float(lg[a, b, w])):.6f}\t"
                    f"{name(a, True)} {name(b, True)} {name(w, False)}"
                )
    # 2-grams: only the (<s>, w) starts matter (all other contexts have
    # explicit trigrams); P(w|<s>) = logp[BOS, BOS, w]
    bi_lines = [
        f"{_to10(float(lg[B, B, w])):.6f}\t{BOS} {name(w, False)}\t0.000000"
        for w in range(C + 1)
    ]
    uni_lines = [f"{MIN_LOG10:.6f}\t{BOS}\t0.000000", f"{_to10(0.0):.6f}\t{EOS}"]
    uni_lines += [f"{_to10(float(lg[B, B, i])):.6f}\t{t}\t0.000000" for i, t in enumerate(toks)]
    lines = ["\\data\\", f"ngram 1={len(uni_lines)}", f"ngram 2={len(bi_lines)}",
             f"ngram 3={len(tri_lines)}", "", "\\1-grams:", *uni_lines, "",
             "\\2-grams:", *bi_lines, "", "\\3-grams:", *tri_lines, "", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _parse_arpa(path: str) -> Dict[int, Dict[Tuple[str, ...], Tuple[float, float]]]:
    """-> {order: {ngram words: (log10 p, log10 backoff)}}"""
    grams: Dict[int, Dict[Tuple[str, ...], Tuple[float, float]]] = {}
    order = 0
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("\\data\\") or line.startswith("ngram "):
                continue
            if line.startswith("\\end\\"):
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                order = int(line[1:].split("-")[0])
                grams[order] = {}
                continue
            if order == 0:
                continue
            parts = line.split()
            p = float(parts[0])
            words = tuple(parts[1 : 1 + order])
            bow = float(parts[1 + order]) if len(parts) > 1 + order else 0.0
            grams[order][words] = (p, bow)
    return grams


def read_arpa_bigram(path: str, tokens: Optional[Sequence[str]] = None) -> BigramLm:
    """ARPA (order >= 2) -> dense BigramLm over `tokens` (default: the ARPA
    vocabulary minus <s>/</s>), resolving missing bigrams via Katz backoff."""
    grams = _parse_arpa(path)
    uni, bi = grams.get(1, {}), grams.get(2, {})
    if tokens is None:
        tokens = sorted(w for (w,) in uni if w not in (BOS, EOS))
    toks = list(tokens)
    C = len(toks)

    def p1(w: str) -> float:
        return uni.get((w,), (MIN_LOG10, 0.0))[0]

    def p2(a: str, b: str) -> float:
        if (a, b) in bi:
            return bi[(a, b)][0]
        bow = uni.get((a,), (MIN_LOG10, 0.0))[1]
        return bow + p1(b)

    pair = np.array([[_toln(p2(a, b)) for b in toks] for a in toks], np.float32)
    init = np.array([_toln(p2(BOS, w)) for w in toks], np.float32)
    final = np.array([_toln(p2(a, EOS)) for a in toks], np.float32)
    return BigramLm(tokens=toks, pair_logp=pair, init_logp=init, final_logp=final)


def read_arpa_trigram(path: str, tokens: Optional[Sequence[str]] = None) -> TrigramLm:
    """ARPA (order >= 3) -> dense TrigramLm, resolving missing n-grams via
    Katz backoff: P(w|a,b) = bow(a,b) + P(w|b); P(w|b) = bow(b) + P(w)."""
    grams = _parse_arpa(path)
    uni, bi, tri = grams.get(1, {}), grams.get(2, {}), grams.get(3, {})
    if tokens is None:
        tokens = sorted(w for (w,) in uni if w not in (BOS, EOS))
    toks = list(tokens)
    C = len(toks)

    def p1(w: str) -> float:
        return uni.get((w,), (MIN_LOG10, 0.0))[0]

    def p2(a: str, b: str) -> float:
        if (a, b) in bi:
            return bi[(a, b)][0]
        return uni.get((a,), (MIN_LOG10, 0.0))[1] + p1(b)

    def p3(a: str, b: str, w: str) -> float:
        if (a, b, w) in tri:
            return tri[(a, b, w)][0]
        bow = bi.get((a, b), (MIN_LOG10, 0.0))[1]
        return bow + p2(b, w)

    names_ctx = toks + [BOS]
    names_evt = toks + [EOS]
    logp = np.empty((C + 1, C + 1, C + 1), np.float32)
    for ai, a in enumerate(names_ctx):
        for bi_, b in enumerate(names_ctx):
            for wi, w in enumerate(names_evt):
                logp[ai, bi_, wi] = _toln(p3(a, b, w))
    return TrigramLm(tokens=toks, logp=logp)

"""Byte-pair-encoding subword units (host-side text processing).

The port's copy of mogasr/data/bpe.py, its imports pointed at mogasr_torch.

Lexicon-free open-vocabulary modeling: instead of phones + a pronunciation
lexicon, CTC/RNN-T targets are BPE units learned from the training
transcripts. Decoding joins units back into words directly — no decode
graph, no lexicon, words never seen in training still decode as long as
their characters/merges are covered.

Standard greedy-merge BPE (Sennrich et al. 2016): words end with the
boundary marker; the N most frequent adjacent-unit pairs become merged
units, applied in training order at encode time.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Sequence, Tuple

BOUNDARY = "▁"  # '▁' marks end-of-word (attached to the final unit)


@dataclasses.dataclass(frozen=True)
class Bpe:
    units: Tuple[str, ...]                 # unit inventory, index = unit id
    merges: Tuple[Tuple[str, str], ...]    # learned merges, in order

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def _lut(self) -> Dict[str, int]:
        lut = getattr(self, "_lut_cache", None)
        if lut is None:
            lut = {u: i for i, u in enumerate(self.units)}
            object.__setattr__(self, "_lut_cache", lut)  # frozen dataclass
        return lut

    def encode_word(self, word: str) -> List[str]:
        """Word -> unit strings (characters merged per the learned merges)."""
        symbols = list(word) + [BOUNDARY]
        # attach the boundary to the final character so every unit sequence
        # ends in a marked unit even with zero merges
        if len(symbols) >= 2:
            symbols = symbols[:-2] + [symbols[-2] + BOUNDARY]
        for a, b in self.merges:
            i = 0
            out: List[str] = []
            while i < len(symbols):
                if i + 1 < len(symbols) and symbols[i] == a and symbols[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out
        return symbols

    def encode(self, words: Sequence[str]) -> List[int]:
        """Word sequence -> unit ids; unknown characters are skipped."""
        ids: List[int] = []
        lut = self._lut
        for w in words:
            for u in self.encode_word(w.lower()):
                if u in lut:
                    ids.append(lut[u])
                # unknown unit: skip (char not in training alphabet)
        return ids

    def decode(self, ids: Sequence[int]) -> List[str]:
        """Unit ids -> word list (split at boundary-marked units)."""
        words: List[str] = []
        cur = ""
        for i in ids:
            u = self.units[int(i)]
            if u.endswith(BOUNDARY):
                cur += u[: -len(BOUNDARY)]
                if cur:
                    words.append(cur)
                cur = ""
            else:
                cur += u
        if cur:
            words.append(cur)  # trailing partial word (no boundary seen)
        return words

    def decode_with_spans(
        self, ids: Sequence[int]
    ) -> List[Tuple[str, int, int]]:
        """Unit ids -> [(word, first_unit_idx, last_unit_idx)]: decode()
        plus the index span of each word's units (for unit-level timing)."""
        spans: List[Tuple[str, int, int]] = []
        cur, first = "", 0
        for i, u_id in enumerate(ids):
            u = self.units[int(u_id)]
            if not cur:
                first = i
            if u.endswith(BOUNDARY):
                cur += u[: -len(BOUNDARY)]
                if cur:
                    spans.append((cur, first, i))
                cur = ""
            else:
                cur += u
        if cur:
            spans.append((cur, first, len(ids) - 1))
        return spans


def save_bpe(bpe: Bpe, path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump({"units": list(bpe.units), "merges": [list(m) for m in bpe.merges]}, f)


def load_bpe(path: str) -> Bpe:
    import json

    with open(path) as f:
        raw = json.load(f)
    return Bpe(
        units=tuple(raw["units"]),
        merges=tuple((a, b) for a, b in raw["merges"]),
    )


def train_bpe(
    transcripts: Sequence[Sequence[str]], n_merges: int = 100
) -> Bpe:
    """Learn BPE merges from word transcripts (lowercased)."""
    word_freq: Counter = Counter(
        w.lower() for words in transcripts for w in words
    )
    # each word as a tuple of symbols; boundary attached to the last char
    def initial(word: str) -> Tuple[str, ...]:
        if not word:
            return ()
        chars = list(word)
        chars[-1] = chars[-1] + BOUNDARY
        return tuple(chars)

    corpus: Dict[Tuple[str, ...], int] = {}
    for w, f in word_freq.items():
        sym = initial(w)
        if sym:
            corpus[sym] = corpus.get(sym, 0) + f

    merges: List[Tuple[str, str]] = []
    for _ in range(n_merges):
        pairs: Counter = Counter()
        for sym, f in corpus.items():
            for a, b in zip(sym, sym[1:]):
                pairs[(a, b)] += f
        if not pairs:
            break
        (a, b), freq = pairs.most_common(1)[0]
        if freq < 2:
            break
        merges.append((a, b))
        new_corpus: Dict[Tuple[str, ...], int] = {}
        for sym, f in corpus.items():
            out: List[str] = []
            i = 0
            while i < len(sym):
                if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            key = tuple(out)
            new_corpus[key] = new_corpus.get(key, 0) + f
        corpus = new_corpus

    units = {u for sym in corpus for u in sym}
    # every merge PRODUCT must be a unit even if all its corpus occurrences
    # merged further (an unseen word's merge replay can stop at any
    # intermediate product), and single characters (+marked forms) survive
    # as the fallback alphabet so unseen words always encode
    units |= {a + b for a, b in merges}
    alphabet = {c for w in word_freq for c in w}
    units |= alphabet | {c + BOUNDARY for c in alphabet}
    return Bpe(units=tuple(sorted(units)), merges=tuple(merges))

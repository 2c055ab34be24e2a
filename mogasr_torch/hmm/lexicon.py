"""Phone set and pronunciation lexicon.

Host-side (SURVEY.md §1 L3: graph building happens on host, device arrays are
handed to the jitted decoder). Supports the bundled synthetic lexicon and
Kaldi/CMUdict-style lexicon text files (``WORD ph1 ph2 ...``) for real
corpora such as LibriSpeech.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SIL = "sil"
EPS = "<eps>"
UNK = "<unk>"


@dataclasses.dataclass(frozen=True)
class Lexicon:
    phones: Tuple[str, ...]              # phone inventory, SIL first
    words: Tuple[str, ...]               # vocabulary, sorted
    prons: Dict[str, Tuple[str, ...]]    # word -> PRIMARY phone sequence
    # word -> all pronunciation variants (primary first). Always populated;
    # single-pron words have a 1-tuple. Graph builders expand one chain per
    # variant when multi_pron decoding is requested.
    variants: Dict[str, Tuple[Tuple[str, ...], ...]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def n_phones(self) -> int:
        return len(self.phones)

    def phone_id(self, p: str) -> int:
        return self.phones.index(p)

    @property
    def sil_id(self) -> int:
        return self.phones.index(SIL)

    def word_phone_ids(self, word: str) -> List[int]:
        idx = {p: i for i, p in enumerate(self.phones)}
        return [idx[p] for p in self.prons[word]]

    def word_variant_phone_ids(self, word: str) -> List[List[int]]:
        """Phone-id sequences for ALL pronunciation variants (primary first)."""
        idx = {p: i for i, p in enumerate(self.phones)}
        variants = self.variants.get(word, (self.prons[word],))
        return [[idx[p] for p in v] for v in variants]

    def words_to_phone_ids(
        self,
        words: Sequence[str],
        interword_sil: bool = True,
        edge_sil: bool = True,
        oov: str = "error",  # error | skip | sil
    ) -> List[int]:
        """Expand a word sequence to phone ids with optional silences.

        oov: out-of-vocabulary handling — raise, drop the word, or model it
        as silence (the monophone-system stand-in for <unk>/<spn>).
        """
        idx = {p: i for i, p in enumerate(self.phones)}
        out: List[int] = [idx[SIL]] if edge_sil else []
        for i, w in enumerate(words):
            if w in self.prons:
                out.extend(idx[p] for p in self.prons[w])
            elif oov == "error":
                raise KeyError(f"word {w!r} not in lexicon (pass oov='skip' or 'sil')")
            elif oov == "sil":
                out.append(idx[SIL])
            # skip: drop silently
            if interword_sil and i < len(words) - 1:
                out.append(idx[SIL])
        if edge_sil:
            out.append(idx[SIL])
        return out


def make_lexicon(prons: Dict[str, Sequence[str]], extra_phones: Iterable[str] = ()) -> Lexicon:
    return make_lexicon_multi({w: (ps,) for w, ps in prons.items()}, extra_phones)


def make_lexicon_multi(
    variants: Dict[str, Sequence[Sequence[str]]], extra_phones: Iterable[str] = ()
) -> Lexicon:
    """Build a lexicon with multiple pronunciations per word (primary first)."""
    phones = {SIL}
    for vs in variants.values():
        for ps in vs:
            phones.update(ps)
    phones.update(extra_phones)
    ordered = (SIL,) + tuple(sorted(phones - {SIL}))
    norm = {w: tuple(tuple(ps) for ps in vs) for w, vs in variants.items()}
    return Lexicon(
        phones=ordered,
        words=tuple(sorted(variants)),
        prons={w: vs[0] for w, vs in norm.items()},
        variants=norm,
    )


def synthetic_lexicon() -> Lexicon:
    from mogasr_torch.data.synthetic import LEXICON

    return make_lexicon(LEXICON)


def load_lexicon(path: str) -> Lexicon:
    """Parse a Kaldi-style lexicon.txt: 'WORD phone phone ...' per line.

    Words are lowercased to match the corpus loaders (LibriSpeech transcripts
    are uppercase, cli.common lowercases them) — a case mismatch would
    silently turn every word OOV.

    Alternate pronunciations — CMUdict-style "WORD(2)" markers or repeated
    WORD lines — are ALL retained as variants (first listed = primary); graph
    builders expand one chain per variant under ``multi_pron`` decoding.
    """
    import re

    variants: Dict[str, List[Tuple[str, ...]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                word = re.sub(r"\(\d+\)$", "", parts[0]).lower()
                pron = tuple(parts[1:])
                vs = variants.setdefault(word, [])
                if pron not in vs:
                    vs.append(pron)
    return make_lexicon_multi(variants)

"""Deterministic synthetic speech corpus for tests, fixtures and benchmarks.

The environment has no LibriSpeech audio and no flac decoder (SURVEY.md §0:
offline box), so tests and the benchmark harness use a synthetic corpus with
*known ground truth*: each utterance is generated from a phone sequence where
every phone has a characteristic two-"formant" spectrum, so forced alignment,
decoding and WER all have verifiable answers. The real LibriSpeech reader
lives in mogasr.data.librispeech and activates when a corpus directory exists.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SIL = "sil"

# A compact phone set with well-separated formant pairs (Hz).
PHONE_FORMANTS: Dict[str, Tuple[float, float]] = {
    "aa": (730, 1090), "iy": (270, 2290), "uw": (300, 870), "eh": (530, 1840),
    "ae": (660, 1720), "ah": (640, 1190), "ao": (570, 840), "ih": (390, 1990),
    "s": (4500, 6200), "sh": (2500, 4000), "f": (5500, 7200), "th": (5100, 6800),
    "m": (250, 1000), "n": (250, 1600), "ng": (250, 2000),
    "k": (1800, 3500), "t": (3000, 5000), "p": (1000, 2200),
    "b": (500, 1500), "d": (2600, 3900), "g": (1500, 2800), "r": (490, 1350),
    "l": (360, 1300), "w": (300, 610), "y": (300, 2200), "z": (3800, 5600),
}

PHONES: List[str] = [SIL] + sorted(PHONE_FORMANTS)

# Small closed vocabulary: word -> phone sequence.
LEXICON: Dict[str, List[str]] = {
    "cat": ["k", "ae", "t"], "dog": ["d", "ao", "g"], "fish": ["f", "ih", "sh"],
    "bird": ["b", "r", "d"], "see": ["s", "iy"], "saw": ["s", "ao"],
    "new": ["n", "uw"], "moon": ["m", "uw", "n"], "sun": ["s", "ah", "n"],
    "rain": ["r", "eh", "n"], "snow": ["s", "n", "uw"], "tree": ["t", "r", "iy"],
    "leaf": ["l", "iy", "f"], "wind": ["w", "ih", "n", "d"],
    "yes": ["y", "eh", "s"], "no": ["n", "uw"], "go": ["g", "uw"],
    "run": ["r", "ah", "n"], "walk": ["w", "ao", "k"], "talk": ["t", "ao", "k"],
    "sing": ["s", "ih", "ng"], "ring": ["r", "ih", "ng"], "king": ["k", "ih", "ng"],
    "thin": ["th", "ih", "n"], "zoo": ["z", "uw"], "tea": ["t", "iy"],
    "day": ["d", "eh"], "may": ["m", "eh"], "way": ["w", "eh"], "bee": ["b", "iy"],
}

WORDS: List[str] = sorted(LEXICON)


@dataclasses.dataclass
class Utterance:
    utt_id: str
    wave: np.ndarray          # float32 [-1, 1]
    sample_rate: int
    words: List[str]
    phones: List[str]         # including surrounding/inter-word sil
    phone_bounds: np.ndarray  # [n_phones + 1] sample boundaries
    speaker: str = "spk00"    # speaker id (v2 corpora; v1 uses the default)


def phone_wave(
    phone: str, n: int, sr: int, rng: np.random.Generator,
    formant_scale: float = 1.0,
) -> np.ndarray:
    """formant_scale simulates a vocal-tract-length change: every phone's
    formant pair is scaled (the VTLN adaptation target)."""
    t = np.arange(n, dtype=np.float64) / sr
    if phone == SIL:
        return (0.001 * rng.standard_normal(n)).astype(np.float64)
    f1, f2 = PHONE_FORMANTS[phone]
    f1, f2 = f1 * formant_scale, f2 * formant_scale
    jitter = 1.0 + 0.02 * rng.standard_normal()
    sig = 0.5 * np.sin(2 * np.pi * f1 * jitter * t + rng.uniform(0, 2 * np.pi))
    sig += 0.3 * np.sin(2 * np.pi * f2 * jitter * t + rng.uniform(0, 2 * np.pi))
    sig += 0.02 * rng.standard_normal(n)
    # short raised-cosine on/off ramps to avoid clicks
    ramp = min(n // 4, 80)
    if ramp > 0:
        env = np.ones(n)
        env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
        env[-ramp:] = env[:ramp][::-1]
        sig *= env
    return sig


def words_to_phones(
    words: Sequence[str],
    interword_sil: bool = True,
    lexicon: Optional[Dict[str, List[str]]] = None,
) -> List[str]:
    lex = LEXICON if lexicon is None else lexicon
    phones = [SIL]
    for i, w in enumerate(words):
        phones.extend(lex[w])
        if interword_sil and i < len(words) - 1:
            phones.append(SIL)
    phones.append(SIL)
    return phones


def synth_utterance(
    utt_id: str,
    words: Sequence[str],
    sr: int = 16000,
    seed: int = 0,
    mean_phone_ms: float = 90.0,
    lexicon: Optional[Dict[str, List[str]]] = None,
    formant_scale: float = 1.0,
) -> Utterance:
    """lexicon overrides the word->phones map (e.g. alternate pronunciations
    for multi-pron decoding tests); formant_scale simulates a different
    vocal tract length (VTLN tests); default is the module LEXICON."""
    rng = np.random.default_rng(seed)
    phones = words_to_phones(words, lexicon=lexicon)
    waves, bounds = [], [0]
    for p in phones:
        dur_ms = mean_phone_ms * (1.6 if p == SIL else 1.0) * rng.uniform(0.7, 1.4)
        n = max(int(sr * dur_ms / 1000.0), 160)
        waves.append(phone_wave(p, n, sr, rng, formant_scale=formant_scale))
        bounds.append(bounds[-1] + n)
    wave = np.concatenate(waves)
    wave = (0.3 * wave / max(np.abs(wave).max(), 1e-6)).astype(np.float32)
    return Utterance(utt_id, wave, sr, list(words), phones, np.array(bounds))


def make_corpus(
    n_utts: int,
    words_per_utt: Tuple[int, int] = (2, 6),
    sr: int = 16000,
    seed: int = 0,
    vocab: Optional[Sequence[str]] = None,
    formant_scale: float = 1.0,
) -> List[Utterance]:
    rng = np.random.default_rng(seed)
    vocab = list(vocab) if vocab is not None else WORDS
    utts = []
    for i in range(n_utts):
        n_words = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
        words = [vocab[int(j)] for j in rng.integers(0, len(vocab), n_words)]
        utts.append(
            synth_utterance(
                f"synth-{i:05d}", words, sr=sr, seed=seed * 100003 + i,
                formant_scale=formant_scale,
            )
        )
    return utts


# ---------------------------------------------------------------------------
# v2 corpus: coarticulated, multi-speaker, noisy — the *discriminative* task.
#
# The v1 synthesis above renders every phone as a context-independent pair of
# stationary sines; on that task monophone GMMs already saturate (round-1
# VERDICT: CD/LM/MMI/adaptation all tied at 1.45% WER).  The v2 path keeps the
# same ground-truth contract (known phone boundaries) but makes the task hard
# in exactly the dimensions the advanced components exist for:
#   * coarticulation  — formants GLIDE between adjacent phones with
#     phase-continuous synthesis, so a phone's realization depends on its
#     neighbors -> context-dependent (triphone) modeling has signal to win.
#   * speakers        — per-speaker vocal-tract (formant) scaling + spectral
#     channel tilt + level -> VTLN/fMLLR/MLLR adaptation has signal to win.
#   * additive noise  — per-utterance SNR drawn from a range -> acoustic
#     confusions appear, so LM / discriminative training / consensus win.
#   * vocabulary      — a few hundred generated words incl. minimal pairs ->
#     WER has headroom above the floor.
# v1 functions are untouched (byte-identical RNG draws) — tests rely on them.
# ---------------------------------------------------------------------------

_VOWELS = sorted(p for p, (f1, _) in PHONE_FORMANTS.items() if f1 < 800)
_CONSONANTS = sorted(p for p in PHONE_FORMANTS if p not in _VOWELS)


def extended_lexicon(n_words: int = 300, seed: int = 7) -> Dict[str, List[str]]:
    """The 30 hand-named words plus deterministically generated pseudo-words.

    Generated words are CVC / CVCV / CVCVC built from the phone inventory;
    orthography is the concatenated phone names (distinct by construction).
    Phone sequences already present in the hand lexicon are skipped so the
    vocabulary contains no accidental homophones.
    """
    rng = np.random.default_rng(seed)
    lex: Dict[str, List[str]] = {}
    seen: set = set()
    for w, v in LEXICON.items():  # drop v1's own homophones ("new"=="no")
        if tuple(v) not in seen:
            lex[w] = list(v)
            seen.add(tuple(v))
    templates = ["CVC", "CVCV", "CVCVC", "VCV", "CV"]
    while len(lex) < n_words:
        tpl = templates[int(rng.integers(0, len(templates)))]
        phones = [
            (_CONSONANTS if c == "C" else _VOWELS)[
                int(rng.integers(0, len(_CONSONANTS if c == "C" else _VOWELS)))
            ]
            for c in tpl
        ]
        key = tuple(phones)
        word = "".join(phones)
        if key in seen or word in lex:
            continue
        seen.add(key)
        lex[word] = phones
    return lex


@dataclasses.dataclass(frozen=True)
class Speaker:
    """A simulated talker: vocal-tract length + channel."""

    speaker_id: str
    formant_scale: float = 1.0   # vocal-tract length warp (VTLN target)
    tilt: float = 0.0            # one-tap FIR channel tilt (+ = low boost)
    level_db: float = 0.0        # overall gain


def make_speakers(
    n_speakers: int,
    seed: int = 11,
    scale_range: Tuple[float, float] = (0.88, 1.12),
    tilt_range: Tuple[float, float] = (-0.35, 0.35),
    level_range_db: Tuple[float, float] = (-6.0, 0.0),
) -> List[Speaker]:
    rng = np.random.default_rng(seed)
    return [
        Speaker(
            f"spk{i:02d}",
            formant_scale=float(rng.uniform(*scale_range)),
            tilt=float(rng.uniform(*tilt_range)),
            level_db=float(rng.uniform(*level_range_db)),
        )
        for i in range(n_speakers)
    ]


@dataclasses.dataclass(frozen=True)
class CorpusStyle:
    """Hardness knobs for the v2 synthesis."""

    coarticulation: float = 0.35          # fraction of a phone spent gliding
    snr_db: Tuple[float, float] = (8.0, 25.0)   # additive-noise SNR range
    freq_jitter: float = 0.03             # per-phone formant jitter (rel.)
    amp_jitter: float = 0.25              # per-phone amplitude jitter (rel.)


@dataclasses.dataclass(frozen=True)
class PhraseLm:
    """Ground-truth language structure for v2 word sequences.

    Utterances concatenate phrases drawn Zipf-weighted from a fixed
    inventory, so the word stream has REAL bigram/trigram structure an
    estimated LM can learn (uniform iid word draws — the v1 scheme — give a
    bigram nothing to beat a unigram with, by construction)."""

    phrases: Tuple[Tuple[str, ...], ...]
    weights: Tuple[float, ...]            # sampling probs (sum 1)


def make_phrase_lm(
    vocab: Sequence[str],
    n_phrases: int = 200,
    seed: int = 13,
    zipf_a: float = 0.8,
) -> PhraseLm:
    rng = np.random.default_rng(seed)
    vocab = list(vocab)
    # Zipf word marginals inside phrases (shuffled rank assignment)
    ranks = rng.permutation(len(vocab))
    w = 1.0 / (ranks + 1.0) ** zipf_a
    w = w / w.sum()
    lengths = rng.choice([1, 2, 3, 4], size=n_phrases, p=[0.2, 0.35, 0.3, 0.15])
    phrases = tuple(
        tuple(vocab[int(j)] for j in rng.choice(len(vocab), size=int(L), p=w))
        for L in lengths
    )
    pw = 1.0 / (np.arange(n_phrases) + 1.0)
    pw = pw / pw.sum()
    return PhraseLm(phrases=phrases, weights=tuple(float(x) for x in pw))


def sample_phrase_words(
    lm: PhraseLm, rng: np.random.Generator, words_per_utt: Tuple[int, int]
) -> List[str]:
    """Concatenate phrases until the target word count, respecting bounds."""
    target = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
    out: List[str] = []
    probs = np.asarray(lm.weights)
    while len(out) < target:
        ph = list(lm.phrases[int(rng.choice(len(lm.phrases), p=probs))])
        room = words_per_utt[1] - len(out)
        out.extend(ph[:room])
    return out


def _log_mid(a: float, b: float) -> float:
    return float(np.sqrt(a * b))


def synth_utterance_v2(
    utt_id: str,
    words: Sequence[str],
    lexicon: Dict[str, List[str]],
    speaker: Speaker,
    style: CorpusStyle = CorpusStyle(),
    sr: int = 16000,
    seed: int = 0,
    mean_phone_ms: float = 90.0,
) -> Utterance:
    """Phase-continuous coarticulated synthesis with speaker/channel/noise."""
    rng = np.random.default_rng(seed)
    phones = words_to_phones(words, lexicon=lexicon)
    bounds = [0]
    for p in phones:
        dur_ms = mean_phone_ms * (1.6 if p == SIL else 1.0) * rng.uniform(0.7, 1.4)
        bounds.append(bounds[-1] + max(int(sr * dur_ms / 1000.0), 160))
    n_total = bounds[-1]

    # Build formant tracks + amplitude envelope over the whole utterance.
    f1t = np.zeros(n_total)
    f2t = np.zeros(n_total)
    amp = np.zeros(n_total)
    for i, p in enumerate(phones):
        s, e = bounds[i], bounds[i + 1]
        if p == SIL:
            continue
        jit = 1.0 + style.freq_jitter * rng.standard_normal()
        f1, f2 = PHONE_FORMANTS[p]
        f1 = f1 * speaker.formant_scale * jit
        f2 = f2 * speaker.formant_scale * jit
        prev = phones[i - 1] if i > 0 else SIL
        nxt = phones[i + 1] if i + 1 < len(phones) else SIL

        def _targets(neigh: str, fa: float, fb: float) -> Tuple[float, float]:
            if neigh == SIL:
                return fa, fb
            g1, g2 = PHONE_FORMANTS[neigh]
            return (
                _log_mid(fa, g1 * speaker.formant_scale),
                _log_mid(fb, g2 * speaker.formant_scale),
            )

        ent1, ent2 = _targets(prev, f1, f2)
        ext1, ext2 = _targets(nxt, f1, f2)
        n = e - s
        glide = min(int(style.coarticulation * n), (n - 1) // 2)
        tr1 = np.full(n, f1)
        tr2 = np.full(n, f2)
        if glide > 0:
            tr1[:glide] = np.linspace(ent1, f1, glide)
            tr2[:glide] = np.linspace(ent2, f2, glide)
            tr1[-glide:] = np.linspace(f1, ext1, glide)
            tr2[-glide:] = np.linspace(f2, ext2, glide)
        f1t[s:e] = tr1
        f2t[s:e] = tr2
        a = 1.0 + style.amp_jitter * rng.standard_normal()
        env = np.full(n, max(a, 0.2))
        ramp = min(n // 4, 80)
        if ramp > 0:
            up = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
            env[:ramp] *= up
            env[-ramp:] *= up[::-1]
        amp[s:e] = env

    ph1 = 2.0 * np.pi * np.cumsum(f1t) / sr + rng.uniform(0, 2 * np.pi)
    ph2 = 2.0 * np.pi * np.cumsum(f2t) / sr + rng.uniform(0, 2 * np.pi)
    sig = amp * (0.5 * np.sin(ph1) + 0.3 * np.sin(ph2))
    sig += 0.001 * rng.standard_normal(n_total)  # breath/room floor

    # Channel tilt: one-tap FIR  y[n] = x[n] + tilt * x[n-1].
    if speaker.tilt != 0.0:
        sig = sig + speaker.tilt * np.concatenate([[0.0], sig[:-1]])

    # Additive noise at a per-utterance SNR over voiced power.
    voiced = amp > 0
    if voiced.any():
        snr = rng.uniform(*style.snr_db)
        p_sig = float(np.mean(sig[voiced] ** 2))
        sig = sig + np.sqrt(p_sig / 10.0 ** (snr / 10.0)) * rng.standard_normal(
            n_total
        )

    peak = max(float(np.abs(sig).max()), 1e-6)
    sig = (0.3 * 10.0 ** (speaker.level_db / 20.0)) * sig / peak
    return Utterance(
        utt_id, sig.astype(np.float32), sr, list(words), phones,
        np.array(bounds), speaker=speaker.speaker_id,
    )


def make_corpus_v2(
    n_utts: int,
    lexicon: Optional[Dict[str, List[str]]] = None,
    n_speakers: int = 12,
    style: CorpusStyle = CorpusStyle(),
    words_per_utt: Tuple[int, int] = (2, 6),
    sr: int = 16000,
    seed: int = 0,
    speakers: Optional[Sequence[Speaker]] = None,
    language: str = "phrases",   # phrases (ground-truth LM structure) | uniform
    mean_phone_ms: float = 90.0,
) -> List[Utterance]:
    """The discriminative corpus: multi-speaker, coarticulated, noisy.

    Deterministic in (n_utts, lexicon, n_speakers, style, seed, language).
    Speakers are assigned round-robin so per-speaker adaptation always has
    data.  language="phrases" draws word sequences from a fixed Zipf phrase
    inventory (shared across seeds — train and held-out text follow the SAME
    ground-truth LM, which estimated n-grams can therefore learn);
    "uniform" is iid uniform words (no LM structure, round-2-early scheme).
    """
    rng = np.random.default_rng(seed)
    lex = extended_lexicon() if lexicon is None else lexicon
    vocab = sorted(lex)
    spks = list(speakers) if speakers is not None else make_speakers(
        n_speakers, seed=seed + 11
    )
    # NOTE: the phrase inventory seed is FIXED (independent of `seed`) so all
    # corpora over the same vocabulary share one ground-truth language.
    plm = make_phrase_lm(vocab) if language == "phrases" else None
    utts = []
    for i in range(n_utts):
        if plm is not None:
            words = sample_phrase_words(plm, rng, words_per_utt)
        else:
            n_words = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
            words = [vocab[int(j)] for j in rng.integers(0, len(vocab), n_words)]
        utts.append(
            synth_utterance_v2(
                f"synth2-{i:05d}", words, lex, spks[i % len(spks)],
                style=style, sr=sr, seed=seed * 100003 + 31 * i + 17,
                mean_phone_ms=mean_phone_ms,
            )
        )
    return utts


# ---------------------------------------------------------------------------
# v3 corpus: the quality axes' WALL (round 5).
#
# The v2 regime stopped discriminating: the headline tied-triphone system
# reached 0.69% held-out WER and the top accuracy-ladder systems sit within
# fractions of a percent of each other (VERDICT r4 weak #4) — MWER, fusion,
# biasing and the discriminative trainers were being validated where a
# better system cannot show a better number, and BPE saturated at 99 units
# because the ~300-word orthography has too little text diversity. v3 keeps
# the same ground-truth contract (known phone boundaries, shared phrase LM)
# and turns every hardness knob:
#   * fast speech  — mean phone 55 ms (vs 90): ~2 frames of stable target
#     per phone after coarticulation, so acoustic confusions are common;
#   * more coarticulation (0.55) + stronger per-phone jitter;
#   * low SNR      — 0..12 dB (vs 8..25);
#   * wider speaker spread (scale 0.82..1.18, tilt ±0.5, level −10..0 dB);
#   * a 1000-word vocabulary (longer templates) — dense minimal pairs, and
#     enough orthography diversity that BPE inventories of 300+ units are
#     reachable;
#   * longer utterances (4..10 words).
# Deterministic; v1/v2 draws are untouched.
# ---------------------------------------------------------------------------


def v3_style() -> CorpusStyle:
    return CorpusStyle(
        coarticulation=0.55,
        snr_db=(0.0, 12.0),
        freq_jitter=0.07,
        amp_jitter=0.45,
    )


def extended_lexicon_v3(n_words: int = 1000, seed: int = 23) -> Dict[str, List[str]]:
    """Larger vocabulary over longer templates (adds CVCVCV / CVCCV /
    VCVC), built by the same deterministic generator."""
    rng = np.random.default_rng(seed)
    lex: Dict[str, List[str]] = {}
    seen: set = set()
    for w, v in LEXICON.items():
        if tuple(v) not in seen:
            lex[w] = list(v)
            seen.add(tuple(v))
    templates = ["CVC", "CVCV", "CVCVC", "VCV", "CV", "CVCVCV", "CVCCV",
                 "VCVC"]
    while len(lex) < n_words:
        tpl = templates[int(rng.integers(0, len(templates)))]
        phones = [
            (_CONSONANTS if c == "C" else _VOWELS)[
                int(rng.integers(
                    0, len(_CONSONANTS if c == "C" else _VOWELS)))
            ]
            for c in tpl
        ]
        key = tuple(phones)
        word = "".join(phones)
        if key in seen or word in lex:
            continue
        seen.add(key)
        lex[word] = phones
    return lex


def make_speakers_v3(n_speakers: int, seed: int = 11) -> List[Speaker]:
    return make_speakers(
        n_speakers, seed=seed,
        scale_range=(0.82, 1.18), tilt_range=(-0.5, 0.5),
        level_range_db=(-10.0, 0.0),
    )


def make_corpus_v3(
    n_utts: int,
    lexicon: Optional[Dict[str, List[str]]] = None,
    n_speakers: int = 24,
    words_per_utt: Tuple[int, int] = (4, 10),
    sr: int = 16000,
    seed: int = 0,
    speakers: Optional[Sequence[Speaker]] = None,
) -> List[Utterance]:
    """The round-5 hard corpus; same determinism/LM-sharing contract as v2."""
    lex = extended_lexicon_v3() if lexicon is None else lexicon
    spks = (list(speakers) if speakers is not None
            else make_speakers_v3(n_speakers, seed=seed + 11))
    return make_corpus_v2(
        n_utts, lexicon=lex, style=v3_style(),
        words_per_utt=words_per_utt, sr=sr, seed=seed, speakers=spks,
        mean_phone_ms=55.0,
    )

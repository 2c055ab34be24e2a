"""Waveform-level training augmentation: speed perturbation, additive noise,
volume perturbation.

The port's copy of mogasr/data/augment.py, its imports pointed at mogasr_torch.

Kaldi-style 3-way speed perturbation (0.9/1.0/1.1 resampling of the raw
waveform) plus SNR-controlled additive noise and random gain. These are
HOST-side corpus transforms applied before batching — they change utterance
lengths, so they must run before the static-shape bucketing; the device-side
spectral counterpart (SpecAugment) lives in mogasr_torch.am.neural.spec_augment.

Deterministic by construction: every random draw is keyed by (seed, utt_id)
position so re-running a corpus pass yields identical augmented data —
consistent with the repo's fixed-PRNG non-determinism guards (SURVEY.md §5).

No reference file can be cited (SURVEY.md §0: reference is empty);
speed/noise/volume perturbation is the standard ASR training recipe the
capability spec's "matched WER" gate presumes.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from mogasr_torch.data.audio import resample

CorpusItem = Tuple[str, np.ndarray, List[str]]


def speed_perturb(
    wave: np.ndarray, factor: float, sr: int = 16000
) -> np.ndarray:
    """Resample the waveform to play back ``factor``× faster (Kaldi sox
    'speed': duration scales by 1/factor, pitch shifts with it).

    Implemented as rate conversion: interpreting a waveform recorded at
    sr·factor as sr-rate audio is exactly sox speed. factor is snapped to
    3 decimals so the rational resampler stays small."""
    if abs(factor - 1.0) < 1e-9:
        return np.asarray(wave, np.float32)
    f = round(float(factor), 3)
    # resample_poly(wave, up=sr, down=sr*f) -> len/f samples
    return resample(wave, int(round(sr * f * 1000)), sr * 1000)


def add_noise_snr(
    wave: np.ndarray,
    snr_db: float,
    rng: np.random.Generator,
    noise: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Mix noise at an exact SNR relative to the signal power. White noise
    by default; pass ``noise`` to mix a real noise recording (looped or
    cropped to length)."""
    wave = np.asarray(wave, np.float32)
    sig_pow = float(np.mean(wave**2)) + 1e-12
    if noise is None:
        n = rng.standard_normal(len(wave)).astype(np.float32)
    else:
        noise = np.asarray(noise, np.float32)
        if len(noise) >= len(wave):
            off = int(rng.integers(0, len(noise) - len(wave) + 1))
            n = noise[off : off + len(wave)]
        else:
            reps = int(np.ceil(len(wave) / len(noise)))
            n = np.tile(noise, reps)[: len(wave)]
    n_pow = float(np.mean(n**2)) + 1e-12
    scale = np.sqrt(sig_pow / (n_pow * 10.0 ** (snr_db / 10.0)))
    return wave + scale * n.astype(np.float32)


def volume_perturb(
    wave: np.ndarray, gain_db: float
) -> np.ndarray:
    return np.asarray(wave, np.float32) * np.float32(10.0 ** (gain_db / 20.0))


def augment_corpus(
    corpus: Sequence[CorpusItem],
    speed_factors: Iterable[float] = (0.9, 1.0, 1.1),
    snr_db_range: Optional[Tuple[float, float]] = None,
    gain_db_range: Optional[Tuple[float, float]] = None,
    sr: int = 16000,
    seed: int = 0,
) -> List[CorpusItem]:
    """Kaldi-style corpus expansion: one copy per speed factor (suffixed
    ``-sp0.9`` etc.; factor 1.0 keeps the original id), then optional
    per-copy noise/volume draws. Deterministic in (seed, order)."""
    out: List[CorpusItem] = []
    rng = np.random.default_rng(seed)
    for utt_id, wave, words in corpus:
        for f in speed_factors:
            w = speed_perturb(wave, f, sr=sr)
            uid = utt_id if abs(f - 1.0) < 1e-9 else f"{utt_id}-sp{f:g}"
            if snr_db_range is not None:
                lo, hi = snr_db_range
                w = add_noise_snr(w, float(rng.uniform(lo, hi)), rng)
            if gain_db_range is not None:
                lo, hi = gain_db_range
                w = volume_perturb(w, float(rng.uniform(lo, hi)))
            out.append((uid, w, list(words)))
    return out

"""Energy-based voice activity detection and long-audio segmentation.

The port's copy of mogasr/frontend/vad.py, its imports pointed at mogasr_torch.

Endpointing for the streaming pipeline: a long recording is split at
silence into utterance-sized segments that the batched/streaming front end
then processes. Frame log-energy against an adaptive (percentile-anchored)
threshold, smoothed by minimum speech/silence durations (host-side state
machine — this is I/O-adjacent orchestration, not device compute).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from mogasr_torch.config import FrontendConfig


@dataclasses.dataclass(frozen=True)
class VadConfig:
    threshold_db: float = 25.0     # speech is this many dB above the noise floor
    noise_percentile: float = 10.0  # frame-energy percentile anchoring the floor
    peak_drop_db: float = 30.0     # ...but never more than this far below the
                                   # peak (guards against a digital-zero floor
                                   # dragging the threshold under ambient noise)
    min_speech_ms: float = 100.0
    min_sil_ms: float = 200.0      # silence shorter than this stays inside a segment
    margin_ms: float = 50.0        # padding kept around detected speech
    max_segment_s: float = 30.0    # hard cap (forced split at weakest frame)


def frame_log_energy(wave: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """[T] log frame energy (dB-like, natural log) under cfg's framing."""
    from mogasr_torch.frontend.numpy_ref import frame_signal

    frames = frame_signal(np.asarray(wave, np.float64), cfg)
    return np.log(np.maximum((frames ** 2).sum(-1), 1e-12))


def energy_vad(
    wave: np.ndarray,
    cfg: FrontendConfig,
    vcfg: VadConfig = VadConfig(),
    energies: np.ndarray = None,
) -> np.ndarray:
    """[T] bool speech mask with min-duration smoothing.

    energies: precomputed frame_log_energy (avoids re-framing long audio)."""
    e = energies if energies is not None else frame_log_energy(wave, cfg)
    if e.size == 0:
        return np.zeros(0, bool)
    ln10_per_db = np.log(10) / 10.0
    floor = np.percentile(e, vcfg.noise_percentile)
    peak = np.percentile(e, 97.5)
    thresh = max(
        floor + vcfg.threshold_db * ln10_per_db,
        peak - vcfg.peak_drop_db * ln10_per_db,
    )
    raw = e > thresh

    min_speech = max(int(vcfg.min_speech_ms / cfg.frame_shift_ms), 1)
    min_sil = max(int(vcfg.min_sil_ms / cfg.frame_shift_ms), 1)

    # fill short silence gaps, then drop short speech bursts
    out = raw.copy()
    t = 0
    T = len(out)
    while t < T:
        if not out[t]:
            j = t
            while j < T and not out[j]:
                j += 1
            if t > 0 and j < T and (j - t) < min_sil:
                out[t:j] = True
            t = j
        else:
            t += 1
    t = 0
    while t < T:
        if out[t]:
            j = t
            while j < T and out[j]:
                j += 1
            if (j - t) < min_speech:
                out[t:j] = False
            t = j
        else:
            t += 1
    return out


def segment_utterances(
    wave: np.ndarray, cfg: FrontendConfig, vcfg: VadConfig = VadConfig()
) -> List[Tuple[int, int]]:
    """Split a long recording into speech segments -> [(start, end)] samples.

    Segments include margin_ms of context; segments longer than max_segment_s
    are force-split at their weakest-energy frame.
    """
    e = frame_log_energy(wave, cfg)  # computed once, shared with the VAD
    mask = energy_vad(wave, cfg, vcfg, energies=e)
    H = cfg.frame_shift
    margin = int(vcfg.margin_ms / cfg.frame_shift_ms)
    max_frames = int(vcfg.max_segment_s * 1000 / cfg.frame_shift_ms)

    spans: List[Tuple[int, int]] = []
    t = 0
    T = len(mask)
    while t < T:
        if mask[t]:
            j = t
            while j < T and mask[j]:
                j += 1
            spans.append((max(t - margin, 0), min(j + margin, T)))
            t = j
        else:
            t += 1

    # force-split overlong spans at the weakest interior frame
    final: List[Tuple[int, int]] = []
    stack = list(reversed(spans))
    while stack:
        a, b = stack.pop()
        if b - a <= max_frames:
            final.append((a, b))
            continue
        lo = a + max_frames // 4
        hi = min(a + max_frames, b) - max_frames // 4
        cut = lo + int(np.argmin(e[lo:hi]))
        stack.append((cut, b))
        stack.append((a, cut))

    n = len(wave)
    return [
        (s * H, min(t_ * H + cfg.frame_length, n)) for s, t_ in final if t_ > s
    ]

"""Audio I/O: wav/flac reading, resampling, int->float conversion.

The port's copy of mogasr/data/audio.py, its imports pointed at mogasr_torch.

SURVEY.md §2 "Audio I/O" row. This box has neither soundfile nor librosa
(verified at build time), so:

- WAV: stdlib ``wave`` + NumPy (PCM16/PCM8/PCM24/PCM32 and float32).
- FLAC: native C++ decoder (mogasr/native/flac_native.cpp — full bitstream:
  constant/verbatim/fixed/LPC subframes, Rice residuals, all stereo modes,
  CRC-verified) with the optional ``soundfile`` package as fallback only.
  Writing is mogasr/data/flac_write.py.
- Resampling: polyphase-free rational resampler via ``scipy.signal.resample_poly``.
"""

from __future__ import annotations

import io
import wave as _wave
from math import gcd
from typing import Optional, Tuple, Union

import numpy as np

try:  # pragma: no cover - optional codec
    import soundfile as _soundfile
except ImportError:  # pragma: no cover
    _soundfile = None


def read_wav(path_or_bytes: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV (8/16/24/32-bit int) -> (float32 mono in [-1,1], sr).

    IEEE-float WAVs are not supported by the stdlib wave module.
    """
    if isinstance(path_or_bytes, bytes):
        f = _wave.open(io.BytesIO(path_or_bytes), "rb")
    else:
        f = _wave.open(path_or_bytes, "rb")
    with f:
        n_ch, sampwidth, sr, n_frames = (
            f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes(),
        )
        raw = f.readframes(n_frames)
    if sampwidth == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def decode_flac_bytes(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream with the native decoder.

    Returns (int32 samples [N] mono / [N, C] multichannel, sample_rate,
    bits_per_sample).  Raises RuntimeError if the native decoder is
    unavailable, ValueError on a malformed/corrupt stream (CRC-verified).
    """
    import ctypes

    from mogasr_torch.native import load_flac_lib

    lib = load_flac_lib()
    if lib is None:
        raise RuntimeError(
            "native FLAC decoder unavailable (g++ missing?) and no fallback "
            "codec installed"
        )
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    bits = ctypes.c_int32()
    total = ctypes.c_longlong()
    rc = lib.flac_stream_info(buf, len(data), ctypes.byref(sr),
                              ctypes.byref(ch), ctypes.byref(bits),
                              ctypes.byref(total))
    if rc != 0:
        raise ValueError(f"malformed FLAC stream (streaminfo, code {rc})")
    # total_samples may legitimately be 0 (unknown); start from a bound
    # implied by the compressed size and grow on ERR_TOO_SMALL (-2).
    cap = max(int(total.value) * ch.value, 4096 * ch.value)
    while True:
        out = np.empty(cap, np.int32)
        n = lib.flac_decode(
            buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap, ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(bits))
        if n == -2:
            cap *= 2
            continue
        if n < 0:
            raise ValueError(f"FLAC decode failed (code {n})")
        break
    samples = out[: int(n) * ch.value]
    if ch.value > 1:
        samples = samples.reshape(-1, ch.value)
    return samples, int(sr.value), int(bits.value)


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """FLAC -> (float32 mono in [-1,1], sr) via the native C++ decoder
    (mogasr/native/flac_native.cpp); falls back to soundfile if the
    native build is unavailable."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        samples, sr, bits = decode_flac_bytes(raw)
    except RuntimeError:
        if _soundfile is None:
            raise
        data, sr = _soundfile.read(path, dtype="float32")
        if data.ndim > 1:
            data = data.mean(axis=1)
        return np.ascontiguousarray(data, np.float32), sr
    data = samples.astype(np.float32) / float(1 << (bits - 1))
    if data.ndim > 1:
        data = data.mean(axis=1)
    return np.ascontiguousarray(data, np.float32), sr


def resample(wave: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return wave
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(wave, sr_out // g, sr_in // g).astype(np.float32)


def read_audio(path: str, target_sr: Optional[int] = 16000) -> Tuple[np.ndarray, int]:
    """``read_audio(path) -> (float32 mono waveform, sr)`` (SURVEY.md §1 L0)."""
    lower = path.lower()
    if lower.endswith(".flac"):
        data, sr = read_flac(path)
    elif lower.endswith(".wav"):
        data, sr = read_wav(path)
    else:
        raise ValueError(f"unsupported audio format: {path}")
    if target_sr is not None and sr != target_sr:
        data, sr = resample(data, sr, target_sr), target_sr
    return data, sr


def write_wav(path: str, wave: np.ndarray, sr: int) -> None:
    """Write float32 [-1,1] mono as PCM16 WAV (fixture generation)."""
    pcm = np.clip(np.asarray(wave, np.float32), -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with _wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())

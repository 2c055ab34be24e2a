"""NumPy oracle implementation of the audio front end (the port's copy of
mogasr/frontend/numpy_ref.py, which mogasr_torch does not import).

This is the from-first-principles reference implementation (SURVEY.md §4): it
serves both as the fp32 parity oracle for the fused JAX/Pallas front end and as
the single-core CPU baseline that makes the >=50x throughput target falsifiable
(BASELINE.md). It is deliberately straightforward NumPy, the shape a CPU
reference implementation of MOG-ASR's front end takes.

Stages: pre-emphasis -> framing -> window -> power spectrum -> mel filterbank
-> log -> DCT-II (MFCC) -> liftering -> deltas -> CMVN.
"""

from __future__ import annotations

import numpy as np

from mogasr_torch.config import FrontendConfig


def window_fn(name: str, length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    if name == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (length - 1))
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (length - 1))
    elif name == "povey":
        # Kaldi's default window: hann ** 0.85
        w = (0.5 - 0.5 * np.cos(2 * np.pi * n / (length - 1))) ** 0.85
    elif name == "rectangular":
        w = np.ones(length)
    else:
        raise ValueError(f"unknown window {name!r}")
    return w.astype(np.float64)


def hz_to_mel(hz: np.ndarray, scale: str = "htk") -> np.ndarray:
    hz = np.asarray(hz, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + hz / 700.0)
    if scale == "slaney":
        f_sp = 200.0 / 3
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        mel = hz / f_sp
        above = hz >= min_log_hz
        mel = np.where(above, min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep, mel)
        return mel
    raise ValueError(f"unknown mel scale {scale!r}")


def mel_to_hz(mel: np.ndarray, scale: str = "htk") -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    if scale == "slaney":
        f_sp = 200.0 / 3
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        hz = mel * f_sp
        above = mel >= min_log_mel
        hz = np.where(above, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)
        return hz
    raise ValueError(f"unknown mel scale {scale!r}")


def vtln_warp_freq(
    freq: np.ndarray,
    warp: float,
    vtln_low: float,
    vtln_high: float,
    low_hz: float,
    high_hz: float,
) -> np.ndarray:
    """Kaldi-convention piecewise-linear VTLN frequency warp.

    The central band [l, h] is scaled by 1/warp; the segments
    [low_hz, l] and [h, high_hz] interpolate linearly so the filterbank
    endpoints stay fixed (feat/mel-computations.cc VtlnWarpFreq semantics).
    """
    freq = np.asarray(freq, np.float64)
    if warp == 1.0:
        return freq
    scale = 1.0 / warp
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    Fl = scale * l
    Fh = scale * h
    scale_left = (Fl - low_hz) / max(l - low_hz, 1e-9)
    scale_right = (high_hz - Fh) / max(high_hz - h, 1e-9)
    out = np.where(
        freq < l,
        low_hz + scale_left * (freq - low_hz),
        np.where(freq < h, scale * freq, high_hz + scale_right * (freq - high_hz)),
    )
    return np.where((freq < low_hz) | (freq > high_hz), freq, out)


def _mel_centers(cfg: FrontendConfig) -> np.ndarray:
    """[n_mels + 2] mel-domain triangle corner/center points (VTLN-warped)."""
    high = cfg.mel_high_hz if cfg.mel_high_hz > 0 else cfg.sample_rate / 2.0
    mel_lo = hz_to_mel(np.array(cfg.mel_low_hz), cfg.mel_scale)
    mel_hi = hz_to_mel(np.array(high), cfg.mel_scale)
    centers_mel = np.linspace(mel_lo, mel_hi, cfg.n_mels + 2)
    if cfg.vtln_warp != 1.0:
        vtln_high = (
            cfg.vtln_high_hz if cfg.vtln_high_hz > 0
            else cfg.sample_rate / 2.0 + cfg.vtln_high_hz
        )
        centers_hz = mel_to_hz(centers_mel, cfg.mel_scale)
        warped_hz = vtln_warp_freq(
            centers_hz, cfg.vtln_warp, cfg.vtln_low_hz, vtln_high,
            cfg.mel_low_hz, high,
        )
        centers_mel = hz_to_mel(warped_hz, cfg.mel_scale)
    return centers_mel


def mel_filterbank_matrix(cfg: FrontendConfig) -> np.ndarray:
    """[n_fft//2 + 1, n_mels] triangular mel filterbank matrix.

    cfg.vtln_warp != 1 warps the triangle corner frequencies (Kaldi
    convention: warp in linear frequency, then convert to mel)."""
    n_bins = cfg.n_fft // 2 + 1
    centers_mel = _mel_centers(cfg)
    fft_bin_hz = np.arange(n_bins, dtype=np.float64) * cfg.sample_rate / cfg.n_fft
    fft_bin_mel = hz_to_mel(fft_bin_hz, cfg.mel_scale)
    left = centers_mel[:-2][None, :]
    center = centers_mel[1:-1][None, :]
    right = centers_mel[2:][None, :]
    m = fft_bin_mel[:, None]
    up = (m - left) / (center - left)
    down = (right - m) / (right - center)
    fbank = np.maximum(0.0, np.minimum(up, down))
    return fbank.astype(np.float64)  # [n_bins, n_mels]


def dct_matrix(n_ceps: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, [n_mels, n_ceps] (apply as mel @ D)."""
    k = np.arange(n_ceps, dtype=np.float64)[None, :]
    n = np.arange(n_mels, dtype=np.float64)[:, None]
    d = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels)) * np.sqrt(2.0 / n_mels)
    d[:, 0] *= 1.0 / np.sqrt(2.0)
    return d


def lifter_coeffs(n_ceps: int, q: float) -> np.ndarray:
    if q <= 0:
        return np.ones(n_ceps)
    return 1.0 + 0.5 * q * np.sin(np.pi * np.arange(n_ceps) / q)


# ------------------------------------------------------------------ PLP
# Hermansky 1990 perceptual linear prediction on the mel bank (Kaldi-style):
# mel power -> equal-loudness weighting -> cube-root intensity compression ->
# inverse DCT-I to autocorrelation -> Levinson-Durbin -> LPC cepstrum.
# Every stage is a GEMM or an O(order^2) fixed-size recursion, so the fused
# JAX path (jax_frontend) is the same chain with the matrices precomputed.

_PLP_R0_FLOOR = 1e-8  # absolute floor on the frame autocorrelation R[0]


def equal_loudness_weights(cfg: FrontendConfig) -> np.ndarray:
    """[n_mels] Hermansky equal-loudness curve at the mel center freqs."""
    f = mel_to_hz(_mel_centers(cfg)[1:-1], cfg.mel_scale)
    fsq = np.asarray(f, np.float64) ** 2
    return ((fsq / (fsq + 1.6e5)) ** 2) * ((fsq + 1.44e6) / (fsq + 9.61e6))


def plp_idft_matrix(n_mels: int, lpc_order: int) -> np.ndarray:
    """[n_mels + 2, lpc_order + 1] inverse-DCT-I matrix.

    The compressed auditory spectrum (endpoints duplicated) is treated as
    half a period of an even, nonnegative power spectrum; its inverse DCT-I
    is then a valid (positive-semidefinite) autocorrelation sequence, which
    keeps Levinson-Durbin stable.
    """
    M = n_mels
    j = np.arange(M + 2, dtype=np.float64)[:, None]
    k = np.arange(lpc_order + 1, dtype=np.float64)[None, :]
    mat = np.cos(np.pi * j * k / (M + 1))
    w = np.full(M + 2, 2.0)
    w[0] = w[-1] = 1.0
    return mat * w[:, None] / (2.0 * (M + 1))


def levinson_np(R: np.ndarray) -> tuple:
    """Batched Levinson-Durbin: R [N, p+1] -> (a [N, p], err [N]).

    Prediction convention x[t] ~ sum_j a_j x[t-j]; err is the residual
    energy after order-p prediction.
    """
    R = np.asarray(R, np.float64)
    N, p1 = R.shape
    p = p1 - 1
    a = np.zeros((N, p))
    err = np.maximum(R[:, 0], _PLP_R0_FLOOR).copy()
    for i in range(p):
        acc = np.sum(a[:, :i] * R[:, i:0:-1], axis=1) if i else np.zeros(N)
        k = (R[:, i + 1] - acc) / err
        a[:, :i] = a[:, :i] - k[:, None] * a[:, :i][:, ::-1]
        a[:, i] = k
        err = np.maximum(err * (1.0 - k * k), _PLP_R0_FLOOR * 1e-4)
    return a, err


def lpc_to_cepstrum_np(a: np.ndarray, err: np.ndarray, n_ceps: int) -> np.ndarray:
    """[N, p] LPC + [N] gain -> [N, n_ceps] cepstra (c0 = ln err).

    Standard minimum-phase recursion c_n = a_n + sum_{k<n} (k/n) c_k a_{n-k};
    requires lpc_order >= n_ceps - 1.
    """
    N, p = a.shape
    if n_ceps - 1 > p:
        raise ValueError(f"n_ceps={n_ceps} needs lpc_order >= {n_ceps - 1}")
    c = np.zeros((N, n_ceps))
    c[:, 0] = np.log(err)
    for n in range(1, n_ceps):
        acc = np.zeros(N)
        for k in range(1, n):
            acc += (k / n) * c[:, k] * a[:, n - 1 - k]
        c[:, n] = a[:, n - 1] + acc
    return c


def plp_from_pspec(pspec: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """[T, n_bins] power spectrum -> [T, n_ceps] liftered PLP cepstra."""
    mel = pspec @ mel_filterbank_matrix(cfg)
    aud = np.maximum(mel * equal_loudness_weights(cfg)[None, :], 0.0)
    compressed = np.cbrt(aud)
    padded = np.concatenate(
        [compressed[:, :1], compressed, compressed[:, -1:]], axis=1)
    R = padded @ plp_idft_matrix(cfg.n_mels, cfg.lpc_order)
    a, err = levinson_np(R)
    c = lpc_to_cepstrum_np(a, err, cfg.n_ceps)
    return c * lifter_coeffs(cfg.n_ceps, cfg.cepstral_lifter)[None, :]


_DITHER_SEED = 0x5EED1234  # fixed stream id shared by all three front ends


def dither_noise_np(start: int, n: int, seed: int = _DITHER_SEED) -> np.ndarray:
    """Deterministic unit-variance Gaussian dither, keyed on the ABSOLUTE
    sample index: noise[i] depends only on (start + i, seed), so the offline
    oracle, the batched fused path, and the streaming front end add bit-equal
    noise regardless of chunking or batch layout (the parity contract).

    Counter-based: murmur3-finalizer hash of the sample counter -> two
    uniforms -> Box-Muller. No RNG state, O(1) per sample, identical in
    NumPy and JAX (jax_frontend mirrors these exact integer ops).
    """
    M = np.uint64(0xFFFFFFFF)

    def mix(x: np.ndarray) -> np.ndarray:
        x = (x + np.uint64(seed)) * np.uint64(2654435761) & M
        x ^= x >> np.uint64(16)
        x = x * np.uint64(0x85EBCA6B) & M
        x ^= x >> np.uint64(13)
        x = x * np.uint64(0xC2B2AE35) & M
        x ^= x >> np.uint64(16)
        return x

    i = np.arange(start, start + n, dtype=np.uint64)
    u1 = (mix(2 * i & M).astype(np.float64) + 0.5) / 4294967296.0
    u2 = (mix((2 * i + 1) & M).astype(np.float64) + 0.5) / 4294967296.0
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def preemphasize(wave: np.ndarray, coeff: float) -> np.ndarray:
    if coeff == 0.0:
        return wave.astype(np.float64)
    w = wave.astype(np.float64)
    out = np.empty_like(w)
    out[0] = w[0] - coeff * w[0]  # Kaldi convention: first sample vs itself
    out[1:] = w[1:] - coeff * w[:-1]
    return out


def frame_signal(wave: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """[T, frame_length] frames.

    snip_edges=True: frame t covers [t*H, t*H + L) and only full frames are
    produced. snip_edges=False: frames are centered at (t + 0.5)*H and the
    window reflects symmetrically at the waveform edges (index -1 -> 0,
    n -> n-1, ...), the Kaldi convention.
    """
    L, H = cfg.frame_length, cfg.frame_shift
    T = cfg.num_frames(len(wave))
    if T <= 0:
        return np.zeros((0, L))
    if cfg.snip_edges:
        idx = np.arange(T)[:, None] * H + np.arange(L)[None, :]
        return wave[idx]
    n = len(wave)
    starts = np.arange(T) * H + H // 2 - L // 2
    idx = starts[:, None] + np.arange(L)[None, :]
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx >= n, 2 * n - idx - 1, idx)
    idx = np.clip(idx, 0, n - 1)  # guard: degenerate ultra-short waveforms
    return wave[idx]


def power_spectrum(frames: np.ndarray, n_fft: int) -> np.ndarray:
    """|rfft|^2 of zero-padded frames -> [T, n_fft//2+1]."""
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2)


def compute_deltas(feats: np.ndarray, window: int) -> np.ndarray:
    """Regression-formula deltas with edge replication, [T, D] -> [T, D]."""
    T = feats.shape[0]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    out = np.zeros_like(feats)
    for i in range(1, window + 1):
        fwd = feats[np.minimum(np.arange(T) + i, T - 1)]
        bwd = feats[np.maximum(np.arange(T) - i, 0)]
        out += i * (fwd - bwd)
    return out / denom


def cmvn_np(feats: np.ndarray, norm_var: bool) -> np.ndarray:
    mean = feats.mean(axis=0, keepdims=True)
    out = feats - mean
    if norm_var:
        std = np.sqrt(np.maximum(feats.var(axis=0, keepdims=True), 1e-10))
        out = out / std
    return out


def cmvn_sliding_np(feats: np.ndarray, window: int, norm_var: bool) -> np.ndarray:
    """CAUSAL sliding-window CMVN: frame t is normalized by the stats of the
    trailing ``window`` frames (inclusive). Streaming-safe by construction —
    the online front end emits identical values (tested). Early frames use
    the shorter available window; frame 0 normalizes to zero."""
    x = np.asarray(feats, np.float64)
    T = x.shape[0]
    cs = np.cumsum(x, axis=0)
    css = np.cumsum(x * x, axis=0)
    t = np.arange(T)
    lo = t - window  # exclusive index of the frame before the window
    s = cs - np.where(lo[:, None] >= 0, cs[np.maximum(lo, 0)], 0.0)
    ss = css - np.where(lo[:, None] >= 0, css[np.maximum(lo, 0)], 0.0)
    cnt = np.minimum(t + 1, window)[:, None].astype(np.float64)
    mean = s / cnt
    out = x - mean
    if norm_var:
        var = ss / cnt - mean**2
        out = out / np.sqrt(np.maximum(var, 1e-10))
    return out.astype(feats.dtype)


def extract_features_np(wave: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Full front end on one utterance -> [T, feat_dim] float32.

    The parity-critical entry point (BASELINE.json north_star: public API
    mirrors the reference's feature-extraction entry points within fp32
    tolerance on LibriSpeech features).
    """
    wave = np.asarray(wave, dtype=np.float64)
    if cfg.dither != 0.0:
        # deterministic shared-stream dither (see dither_noise_np): applied
        # to the waveform so spectral AND energy paths see the same samples
        wave = wave + cfg.dither * dither_noise_np(0, len(wave))
    emph = preemphasize(wave, cfg.preemphasis)
    frames = frame_signal(emph, cfg)
    if cfg.use_energy:
        raw_frames = frame_signal(wave, cfg)
        energy = np.log(np.maximum((raw_frames ** 2).sum(-1), cfg.log_floor))
    frames = frames * window_fn(cfg.window, cfg.frame_length)[None, :]
    pspec = power_spectrum(frames, cfg.n_fft)
    fbank = mel_filterbank_matrix(cfg)
    mel = pspec @ fbank
    logmel = np.log(np.maximum(mel, cfg.log_floor))
    if cfg.feature_type == "fbank":
        base = logmel
    elif cfg.feature_type == "plp":
        base = plp_from_pspec(pspec, cfg)
        if cfg.use_energy:
            base[:, 0] = energy
    else:
        mfcc = logmel @ dct_matrix(cfg.n_ceps, cfg.n_mels)
        mfcc = mfcc * lifter_coeffs(cfg.n_ceps, cfg.cepstral_lifter)[None, :]
        if cfg.use_energy:
            mfcc[:, 0] = energy
        base = mfcc
    feats = [base]
    prev = base
    for _ in range(cfg.delta_order):
        prev = compute_deltas(prev, cfg.delta_window)
        feats.append(prev)
    out = np.concatenate(feats, axis=-1)
    if cfg.cmvn == "utterance":
        out = cmvn_np(out, cfg.cmvn_norm_var)
    elif cfg.cmvn == "sliding":
        out = cmvn_sliding_np(out, cfg.cmvn_window, cfg.cmvn_norm_var)
    return out.astype(np.float32)

"""Pitch features: NCCF + Viterbi lag tracking (Kaldi-style), the port of
mogasr/frontend/pitch.py.

Per frame a (POV, mean-subtracted log-f0, delta log-f0) triple, appended to
MFCC/fbank/PLP features:

1. **Downsample** to ``work_rate`` (4 kHz): the windowed-sinc low-pass as one
   strided ``conv1d``.
2. **NCCF** per (frame, lag): ``<x, y_l> / sqrt(<x,x><y_l,y_l>)`` over a 25
   ms window for lags spanning [min_f0, max_f0], as one batched product over
   a gathered [B, T, L, win] tensor.
3. **Viterbi smoothing** over lag candidates: max-plus over frames with an
   [L, L] transition penalty proportional to (delta log lag)^2, and a
   backtrace, both on the device. The reference leaves this recursion to XLA
   (a ``lax.scan``), so it is no kernel here either: a plain PyTorch frame
   loop, a few launches a frame.
4. **Features**: POV = best-path NCCF, log-f0 mean-subtracted over the
   utterance's valid frames, and its first difference.

Frame timing mirrors the spectral front end (25 ms / 10 ms, snip_edges), so
``features_with_pitch`` concatenates the streams frame for frame.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PitchConfig:
    min_f0: float = 50.0          # Hz, lowest trackable pitch
    max_f0: float = 400.0         # Hz, highest trackable pitch
    work_rate: int = 4000         # Hz, NCCF runs at this rate
    window_ms: float = 25.0       # NCCF window
    shift_ms: float = 10.0        # frame shift (match FrontendConfig)
    lag_penalty: float = 10.0     # Viterbi cost = penalty * (dlog lag)^2
    lowpass_taps: int = 63        # windowed-sinc length for the decimator
    eps: float = 1e-8


def _lowpass_kernel(cfg: PitchConfig, sample_rate: int) -> np.ndarray:
    """Hamming-windowed sinc low-pass at 0.9 * work_rate/2 (host, once)."""
    n = cfg.lowpass_taps
    cutoff = 0.45 * cfg.work_rate / sample_rate  # cycles/sample, pre-decim
    t = np.arange(n) - (n - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.hamming(n)
    return (h / h.sum()).astype(np.float32)


def extract_pitch(
    waves: torch.Tensor,       # [B, S] float32 at sample_rate
    n_samples: torch.Tensor,   # [B]
    cfg: PitchConfig = PitchConfig(),
    sample_rate: int = 16000,
    t_out: int = 0,            # frames to emit (0 = derive from S)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pitch_feats [B, T, 3], n_frames [B] int32) on the device of
    ``waves``: POV, centered log-f0, delta log-f0. Padded frames are zero;
    n_frames follows the snip_edges frame count at ``sample_rate``."""
    dev = waves.device
    waves = waves.to(torch.float32)
    B, S = waves.shape
    factor = sample_rate // cfg.work_rate
    win = int(round(cfg.window_ms * 1e-3 * cfg.work_rate))
    shift = int(round(cfg.shift_ms * 1e-3 * cfg.work_rate))
    min_lag = int(np.floor(cfg.work_rate / cfg.max_f0))
    max_lag = int(np.ceil(cfg.work_rate / cfg.min_f0))
    lags = torch.arange(min_lag, max_lag + 1, device=dev)
    L = max_lag - min_lag + 1

    win16 = int(round(cfg.window_ms * 1e-3 * sample_rate))
    shift16 = int(round(cfg.shift_ms * 1e-3 * sample_rate))
    T = t_out if t_out > 0 else max((S - win16) // shift16 + 1, 1)
    ns = n_samples.to(device=dev, dtype=torch.int32)
    n_frames = torch.clamp((ns - win16) // shift16 + 1, min=0)
    n_frames = torch.clamp(n_frames, max=T)

    # 1. low-pass + decimate, padded samples zeroed first
    waves = torch.where(torch.arange(S, device=dev)[None, :] < ns[:, None], waves, 0.0)
    kern = torch.as_tensor(_lowpass_kernel(cfg, sample_rate), device=dev)
    y = F.conv1d(waves[:, None, :], kern[None, None, :], stride=factor, padding=cfg.lowpass_taps // 2)[:, 0, :]
    Sd = y.shape[1]
    # cut the filter's tail at each utterance's own decimated length
    nd = (ns - 1) // factor + 1
    y = torch.where(torch.arange(Sd, device=dev)[None, :] < nd[:, None], y, 0.0)

    # 2. extended frames [B, T, win + max_lag], zero out of range
    ext = win + max_lag
    idx = torch.arange(T, device=dev)[:, None] * shift + torch.arange(ext, device=dev)[None, :]
    frames = y[:, torch.clamp(idx, max=Sd - 1)]
    frames = torch.where((idx < Sd)[None], frames, 0.0)
    base = frames[:, :, :win]
    base = base - base.mean(dim=-1, keepdim=True)
    lag_idx = lags[:, None] + torch.arange(win, device=dev)[None, :]   # [L, win]
    shifted = frames[:, :, lag_idx]                                      # [B, T, L, win]
    shifted = shifted - shifted.mean(dim=-1, keepdim=True)
    num = torch.matmul(shifted, base[..., None])[..., 0]                 # [B, T, L]
    e0 = (base * base).sum(dim=-1) + cfg.eps
    e1 = (shifted * shifted).sum(dim=-1) + cfg.eps
    nccf = num / torch.sqrt(e0[..., None] * e1)

    # 3. Viterbi over lag candidates, rows frozen past n_frames
    log_lag = torch.log(lags.to(torch.float32))
    trans = -cfg.lag_penalty * (log_lag[:, None] - log_lag[None, :]) ** 2
    ident = torch.arange(L, device=dev)
    delta = nccf[:, 0]
    bps = []
    for t in range(1, T):
        scores = delta[:, :, None] + trans[None]
        best = scores.amax(dim=1) + nccf[:, t]
        bp = scores.argmax(dim=1)
        active = (t < n_frames)[:, None]
        delta = torch.where(active, best, delta)
        bps.append(torch.where(active, bp, ident[None]))
    lag_i = delta.argmax(dim=1)
    path = [lag_i]
    for bp in reversed(bps):
        lag_i = torch.gather(bp, 1, lag_i[:, None])[:, 0]
        path.append(lag_i)
    path = torch.stack(path[::-1], dim=1)                                # [B, T]

    # 4. features
    lag_of = lags[path].to(torch.float32)
    f0 = torch.full_like(lag_of, float(cfg.work_rate)) / lag_of
    pov = torch.gather(nccf, 2, path[..., None])[..., 0]
    mask = torch.arange(T, device=dev)[None, :] < n_frames[:, None]
    logf0 = torch.log(f0)
    denom = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    mean_lf = torch.where(mask, logf0, 0.0).sum(dim=1) / denom
    clf = logf0 - mean_lf[:, None]
    dlf = torch.diff(logf0, dim=1, prepend=logf0[:, :1])
    feats = torch.stack([pov, clf, dlf], dim=-1)
    feats = torch.where(mask[..., None], feats, 0.0)
    return feats, n_frames


def features_with_pitch(
    feats: torch.Tensor,       # [B, T, D] spectral features (any front end)
    n_frames: torch.Tensor,    # [B] its frame counts
    waves: torch.Tensor,       # [B, S] the same audio
    n_samples: torch.Tensor,   # [B]
    cfg: PitchConfig = PitchConfig(),
    sample_rate: int = 16000,
) -> torch.Tensor:
    """[B, T, D+3]: spectral features with the pitch triple appended,
    frame-aligned (both streams share the 25 ms / 10 ms snip_edges grid)."""
    p, _nf = extract_pitch(waves, n_samples, cfg, sample_rate, t_out=int(feats.shape[1]))
    return torch.cat([feats, p.to(feats.device)], dim=-1)

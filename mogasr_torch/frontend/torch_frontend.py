"""Batched audio front end in PyTorch: the port of mogasr/frontend/jax_frontend.py.

Same chain on padded utterance batches: pre-emphasis -> framing -> windowed
GEMM DFT -> power spectrum -> mel -> log -> DCT+lifter -> deltas -> CMVN.
DFT, mel and DCT are plain fp32 ``torch.matmul`` (TF32 is off package-wide,
the twin of the reference's ``Precision.HIGHEST``), so features keep fp32
parity with the NumPy oracle. Deltas replicate each utterance's own edge and
CMVN reduces over valid frames only, so a padded batch equals its utterances
run one by one.

``feature_type="plp"`` replaces log -> DCT with the PLP chain of
``_plp_cepstra`` (equal loudness, cube root, one iDCT-I GEMM, Levinson-Durbin
and the LPC -> cepstrum recursion unrolled over the static ``lpc_order``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mogasr_torch.config import FrontendConfig
from mogasr_torch.frontend import numpy_ref as npref


class FrontendConsts(NamedTuple):
    """Precomputed constant matrices for the front end (float32, on device)."""

    dft_cos_w: torch.Tensor  # [frame_length, n_bins], window folded in
    dft_sin_w: torch.Tensor  # [frame_length, n_bins]
    mel: torch.Tensor        # [n_bins, n_mels]
    dct_lift: torch.Tensor   # [n_mels, n_ceps], lifter folded in
    plp_eql: Optional[torch.Tensor] = None   # [n_mels] equal-loudness weights
    plp_idft: Optional[torch.Tensor] = None  # [n_mels + 2, lpc_order + 1] iDCT-I
    plp_lift: Optional[torch.Tensor] = None  # [n_ceps] cepstral lifter


def build_consts(cfg: FrontendConfig, device: torch.device) -> FrontendConsts:
    L, n_fft = cfg.frame_length, cfg.n_fft
    n_bins = n_fft // 2 + 1
    n = np.arange(L, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    win = npref.window_fn(cfg.window, L)
    dct = npref.dct_matrix(cfg.n_ceps, cfg.n_mels)
    dct = dct * npref.lifter_coeffs(cfg.n_ceps, cfg.cepstral_lifter)[None, :]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    plp = cfg.feature_type == "plp"
    return FrontendConsts(
        dft_cos_w=f32(np.cos(ang) * win[:, None]),
        dft_sin_w=f32(-np.sin(ang) * win[:, None]),
        mel=f32(npref.mel_filterbank_matrix(cfg)),
        dct_lift=f32(dct),
        plp_eql=f32(npref.equal_loudness_weights(cfg)) if plp else None,
        plp_idft=f32(npref.plp_idft_matrix(cfg.n_mels, cfg.lpc_order)) if plp else None,
        plp_lift=f32(npref.lifter_coeffs(cfg.n_ceps, cfg.cepstral_lifter)) if plp else None,
    )


def _plp_cepstra(mel: torch.Tensor, cfg: FrontendConfig, consts: FrontendConsts) -> torch.Tensor:
    """[N, n_mels] mel power -> [N, n_ceps] liftered PLP cepstra.

    The port of jax_frontend._plp_cepstra, mirroring numpy_ref.plp_from_pspec:
    equal loudness, cube-root compression, the iDCT-I autocorrelation (one
    fp32 GEMM), then Levinson-Durbin and the LPC -> cepstrum recursion
    unrolled over the static lpc_order, elementwise on [N] columns.
    """
    p = cfg.lpc_order
    aud = torch.clamp(mel * consts.plp_eql[None, :], min=0.0)
    compressed = aud.pow(1.0 / 3.0)  # aud >= 0: the real cube root
    padded = torch.cat([compressed[:, :1], compressed, compressed[:, -1:]], dim=1)
    R = padded @ consts.plp_idft  # [N, p + 1]
    floor = npref._PLP_R0_FLOOR
    a = [torch.zeros_like(R[:, 0]) for _ in range(p)]
    err = torch.clamp(R[:, 0], min=floor)
    for i in range(p):
        acc = sum((a[j] * R[:, i - j] for j in range(i)), start=torch.zeros_like(err))
        kref = (R[:, i + 1] - acc) / err
        new_a = [a[j] - kref * a[i - 1 - j] for j in range(i)]
        a = new_a + [kref] + a[i + 1:][: p - i - 1]
        err = torch.clamp(err * (1.0 - kref * kref), min=floor * 1e-4)
    c = [torch.log(err)]
    for n_i in range(1, cfg.n_ceps):
        acc = sum(((k_i / n_i) * c[k_i] * a[n_i - 1 - k_i] for k_i in range(1, n_i)),
                  start=torch.zeros_like(err))
        c.append(a[n_i - 1] + acc)
    return torch.stack(c, dim=1) * consts.plp_lift[None, :]


_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), exact in int64.

    The full product can reach 2**64 and overflow int64, so multiply the two
    16-bit halves of x separately; no partial product exceeds 2**49."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _dither_noise(n: int, device: torch.device, seed: int = npref._DITHER_SEED) -> torch.Tensor:
    """Mirror of numpy_ref.dither_noise_np for positions [0, n).

    The reference hashes the sample counter with a murmur3 finalizer in
    wrapping uint32; PyTorch's uint32 arithmetic is incomplete, so the same
    integer ops run in int64 with a 32-bit mask after every step. Noise
    depends only on the position in the utterance: batched == solo.
    """
    i = torch.arange(n, dtype=torch.int64, device=device)

    def mix(x):
        x = _mul_u32((x + seed) & _U32, 2654435761)
        x = x ^ (x >> 16)
        x = _mul_u32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = _mul_u32(x, 0xC2B2AE35)
        return x ^ (x >> 16)

    u1 = (mix((2 * i) & _U32).to(torch.float32) + 0.5) / 4294967296.0
    u2 = (mix((2 * i + 1) & _U32).to(torch.float32) + 0.5) / 4294967296.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def _frame_signal_strided(wave: torch.Tensor, t_max: int, cfg: FrontendConfig) -> torch.Tensor:
    """[B, N] -> [B, t_max, frame_length]: frame t is wave[t*H : t*H + L].

    A strided view (``unfold``), zero-padded at the end as the reference pads
    before its reshapes."""
    L, H = cfg.frame_length, cfg.frame_shift
    need = (t_max - 1) * H + L
    if wave.shape[1] < need:
        wave = torch.nn.functional.pad(wave, (0, need - wave.shape[1]))
    return wave.unfold(1, L, H)[:, :t_max]


def _frame_signal_reflect(
    wave: torch.Tensor, num_samples: torch.Tensor, t_max: int, cfg: FrontendConfig
) -> torch.Tensor:
    """snip_edges=False: centred frames, reflected at each utterance's TRUE end."""
    B = wave.shape[0]
    L, H = cfg.frame_length, cfg.frame_shift
    dev = wave.device
    starts = torch.arange(t_max, device=dev) * H + H // 2 - L // 2
    idx = starts[:, None] + torch.arange(L, device=dev)[None, :]  # [T, L]
    n = torch.clamp(num_samples.to(torch.int64), min=1)[:, None, None]
    idx = idx[None].expand(B, t_max, L)
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= n, 2 * n - idx - 1, idx)
    idx = torch.clamp(idx, 0, wave.shape[1] - 1)
    return torch.gather(wave, 1, idx.reshape(B, -1)).reshape(B, t_max, L)


def _deltas_batched(feats: torch.Tensor, n_frames: torch.Tensor, window: int,
                    reciprocal: bool = False) -> torch.Tensor:
    """Regression deltas with per-utterance edge replication on padded [B, T, D].

    ``reciprocal`` scales by 1 / denom instead of dividing by denom: what
    XLA makes of a division by a constant under jit, and what PyTorch on
    CUDA makes of a division by a Python scalar either way."""
    B, T, D = feats.shape
    t = torch.arange(T, device=feats.device)[None, :]
    last = torch.clamp(n_frames.to(torch.int64) - 1, min=0)[:, None]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    out = torch.zeros_like(feats)
    for i in range(1, window + 1):
        fwd_idx = torch.minimum(t + i, last)
        bwd_idx = torch.minimum(torch.clamp(t - i, min=0), last)
        fwd = torch.gather(feats, 1, fwd_idx[:, :, None].expand(B, T, D))
        bwd = torch.gather(feats, 1, bwd_idx[:, :, None].expand(B, T, D))
        out = out + i * (fwd - bwd)
    return out * (1.0 / denom) if reciprocal else out / denom


def _masked_cmvn(feats: torch.Tensor, mask: torch.Tensor, norm_var: bool) -> torch.Tensor:
    """Per-utterance CMVN over valid frames only. mask: [B, T] in {0, 1}."""
    m = mask[:, :, None]
    count = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    mean = (feats * m).sum(dim=1, keepdim=True) / count
    out = feats - mean
    if norm_var:
        var = ((feats - mean) ** 2 * m).sum(dim=1, keepdim=True) / count
        out = out / torch.sqrt(torch.clamp(var, min=1e-10))
    return out * m


def _sliding_cmvn(
    feats: torch.Tensor, mask: torch.Tensor, norm_var: bool, window: int
) -> torch.Tensor:
    """Causal trailing-window CMVN from cumulative sums (numpy_ref.cmvn_sliding_np).

    The statistics run in float64, as in the oracle: ``ss/cnt - mean**2``
    from float32 running sums cancels catastrophically over long utterances
    (the reference's float32 version sits up to ~6e-3 from the oracle)."""
    out_dtype = feats.dtype
    feats = feats.to(torch.float64)
    m = mask[:, :, None].to(torch.float64)
    x = feats * m
    cs = torch.cumsum(x, dim=1)
    css = torch.cumsum(x * x, dim=1)
    T = feats.shape[1]

    def lag(a):
        if window >= T:
            return torch.zeros_like(a)
        return torch.cat([torch.zeros_like(a[:, :window]), a[:, :-window]], dim=1)

    s = cs - lag(cs)
    ss = css - lag(css)
    cnt = torch.clamp(torch.arange(T, device=feats.device) + 1, max=window)
    cnt = cnt.to(feats.dtype)[None, :, None]
    mean = s / cnt
    out = feats - mean
    if norm_var:
        var = ss / cnt - mean**2
        out = out / torch.sqrt(torch.clamp(var, min=1e-10))
    return (out * m).to(out_dtype)


def make_frontend(
    cfg: FrontendConfig, max_samples: int, device: torch.device
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The batched front end for one max_samples bucket on ``device``.

    Returns ``extract(waves[B, max_samples], num_samples[B]) ->
    (feats[B, T_max, feat_dim] float32, num_frames[B] int32)``.
    """
    if cfg.feature_type not in ("mfcc", "fbank", "plp"):
        raise ValueError(f"unknown feature_type {cfg.feature_type!r}")
    consts = build_consts(cfg, device)
    t_max = max(cfg.num_frames(max_samples), 1)

    def frames_of(signal, num_samples):
        if cfg.snip_edges:
            return _frame_signal_strided(signal, t_max, cfg)
        return _frame_signal_reflect(signal, num_samples, t_max, cfg)

    def extract(waves: torch.Tensor, num_samples: torch.Tensor):
        waves = waves.to(device=device, dtype=torch.float32)
        num_samples = num_samples.to(device=device, dtype=torch.int64)
        B = waves.shape[0]
        if cfg.dither != 0.0:
            waves = waves + cfg.dither * _dither_noise(waves.shape[1], device)[None, :]
        if cfg.snip_edges:
            n_frames = torch.where(
                num_samples < cfg.frame_length,
                torch.zeros_like(num_samples),
                1 + (num_samples - cfg.frame_length) // cfg.frame_shift,
            )
        else:
            n_frames = (num_samples + cfg.frame_shift // 2) // cfg.frame_shift
        n_frames = torch.clamp(n_frames, max=t_max).to(torch.int32)

        # Kaldi convention: sample 0 is pre-emphasized against itself
        prev = torch.cat([waves[:, :1], waves[:, :-1]], dim=1)
        emph = waves - cfg.preemphasis * prev

        flat = frames_of(emph, num_samples).reshape(B * t_max, cfg.frame_length)
        re = flat @ consts.dft_cos_w
        im = flat @ consts.dft_sin_w
        pspec = re * re + im * im
        mel = pspec @ consts.mel
        logmel = torch.log(torch.clamp(mel, min=cfg.log_floor))

        if cfg.feature_type == "fbank":
            base = logmel.reshape(B, t_max, cfg.n_mels)
        else:
            ceps = _plp_cepstra(mel, cfg, consts) if cfg.feature_type == "plp" else logmel @ consts.dct_lift
            if cfg.use_energy:
                raw = frames_of(waves, num_samples).reshape(B * t_max, cfg.frame_length)
                energy = torch.log(torch.clamp((raw * raw).sum(dim=-1), min=cfg.log_floor))
                ceps = torch.cat([energy[:, None], ceps[:, 1:]], dim=1)
            base = ceps.reshape(B, t_max, cfg.n_ceps)

        feats = [base]
        prev_f = base
        for _ in range(cfg.delta_order):
            prev_f = _deltas_batched(prev_f, n_frames, cfg.delta_window)
            feats.append(prev_f)
        out = torch.cat(feats, dim=-1)

        mask = (torch.arange(t_max, device=device)[None, :] < n_frames[:, None]).to(torch.float32)
        if cfg.cmvn == "utterance":
            out = _masked_cmvn(out, mask, cfg.cmvn_norm_var)
        elif cfg.cmvn == "sliding":
            out = _sliding_cmvn(out, mask, cfg.cmvn_norm_var, cfg.cmvn_window)
        else:
            out = out * mask[:, :, None]
        return out, n_frames

    return extract


def extract_features(wave: np.ndarray, cfg: FrontendConfig, device: torch.device) -> np.ndarray:
    """Single-utterance entry point: ``[N] samples -> [T, feat_dim] float32``."""
    wave = np.asarray(wave, np.float32)
    n = wave.shape[0]
    fn = make_frontend(cfg, n, device)
    feats, n_frames = fn(torch.as_tensor(wave)[None, :], torch.as_tensor([n]))
    return feats[0, : int(n_frames[0])].cpu().numpy()

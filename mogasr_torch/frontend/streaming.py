"""Streaming (chunked) front end with exact chunk-boundary handling: the port
of mogasr/frontend/streaming.py.

The streamer produces the offline batched front end's features, with the
reference's rules:

- sample buffering keeps the frame_length-hop overlap across chunk
  boundaries, plus one trailing sample for pre-emphasis continuity;
- delta context induces an emission lag of ``delta_order * delta_window``
  frames; ``finalize()`` flushes the tail with offline edge replication;
- CMVN: ``global`` (precomputed stats applied frame-wise), ``sliding``
  (causal trailing-window stats, the offline sliding path's values),
  ``none``, or per-utterance normalization deferred to the caller after
  finalize.

Framing, pre-emphasis, energy, deltas and CMVN are per-stream host work in
numpy, as in the reference. The spectral chunk (windowed DFT -> mel -> log
-> DCT, or the PLP chain) runs on ``device`` as float32 GEMMs of
``torch_frontend.build_consts`` (TF32 off, the twin of the reference's
HIGHEST precision), over a fixed ``chunk_frames`` block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mogasr_torch.config import FrontendConfig
from mogasr_torch.frontend import numpy_ref as npref
from mogasr_torch.frontend.torch_frontend import _plp_cepstra, build_consts


def make_chunk_kernel(cfg: FrontendConfig, device: torch.device):
    """frames [N, frame_length] float32 -> base features [N, base_dim] on
    ``device``: the offline front end's spectral chain."""
    consts = build_consts(cfg, device)

    def run(frames: torch.Tensor) -> torch.Tensor:
        re = frames @ consts.dft_cos_w
        im = frames @ consts.dft_sin_w
        pspec = re * re + im * im
        mel = pspec @ consts.mel
        if cfg.feature_type == "plp":
            return _plp_cepstra(mel, cfg, consts)
        logmel = torch.log(torch.clamp(mel, min=cfg.log_floor))
        if cfg.feature_type == "fbank":
            return logmel
        return logmel @ consts.dct_lift

    return run


class StreamingFrontend:
    """Chunked feature extractor; emits [n, feat_dim] arrays incrementally.

    The spectral chunk runs on ``device`` (the card unless the caller asks
    for the CPU)."""

    def __init__(
        self,
        cfg: FrontendConfig,
        chunk_frames: int = 64,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        device: torch.device = torch.device("cuda"),
    ):
        if not cfg.snip_edges:
            raise NotImplementedError(
                "streaming requires snip_edges=True (centered frames need "
                "right-edge reflection, which is acausal)"
            )
        if cfg.add_pitch:
            raise NotImplementedError(
                "streaming add_pitch is unsupported: the pitch stream's lag "
                "Viterbi and log-f0 centering are utterance-level (acausal)"
            )
        self.cfg = cfg
        self.chunk_frames = chunk_frames
        self.device = torch.device(device)
        self._kernel = None
        self._buf = np.zeros(0, np.float64)   # un-consumed samples
        self._prev_sample = 0.0               # for pre-emphasis continuity
        self._first = True
        self._n_in = 0                        # absolute samples consumed (dither key)
        # rolling buffer of base (pre-delta) frames: only the delta-context
        # tail is kept; _buf_start is the global frame index of _base_buf[0]
        self._base_buf = np.zeros((0, cfg.base_dim), np.float32)
        self._buf_start = 0
        self._t_avail = 0
        self._emitted = 0                     # final frames already emitted
        if cfg.cmvn == "global":
            assert cmvn_mean is not None and cmvn_istd is not None, (
                "global CMVN streaming needs precomputed stats"
            )
        self.cmvn_mean = cmvn_mean
        self.cmvn_istd = cmvn_istd
        # sliding CMVN state: trailing raw (pre-normalization) final frames,
        # at most window-1 of them
        self._cmvn_hist = np.zeros((0, cfg.feat_dim), np.float64)

    @property
    def kernel(self):
        """The spectral chunk on ``device``, built at first use (an engine's
        per-session frontends frame and absorb only, and never build it)."""
        if self._kernel is None:
            self._kernel = make_chunk_kernel(self.cfg, self.device)
        return self._kernel

    @property
    def _lag(self) -> int:
        return self.cfg.delta_order * self.cfg.delta_window

    def _frame_pending(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Host half of frame extraction: framing + pre-emphasis (+ energy).

        Returns (frames [t, frame_length] float32, energy [t] float32 or
        None) and advances the sample buffer, without the spectral chunk."""
        cfg = self.cfg
        L, H = cfg.frame_length, cfg.frame_shift
        n = len(self._buf)
        if n < L:
            return np.zeros((0, L), np.float32), None
        t = (n - L) // H + 1
        idx = np.arange(t)[:, None] * H + np.arange(L)[None, :]
        raw = self._buf[idx]
        # pre-emphasis with cross-chunk continuity
        prevs = np.empty((t, L))
        prevs[:, 1:] = raw[:, :-1]
        starts = idx[:, 0]
        prev_of_start = np.where(
            starts > 0, self._buf[np.maximum(starts - 1, 0)], self._prev_sample
        )
        if self._first:
            # Kaldi convention: very first sample emphasized against itself
            prev_of_start = np.where(starts == 0, raw[:, 0], prev_of_start)
        prevs[:, 0] = prev_of_start
        frames = raw - cfg.preemphasis * prevs
        # log raw-frame energy before pre-emphasis and window, as the offline
        # path and the oracle take it (the buffer holds dithered samples)
        energy = None
        if cfg.use_energy and cfg.feature_type in ("mfcc", "plp"):
            raw32 = raw.astype(np.float32)
            energy = np.log(
                np.maximum((raw32 * raw32).sum(-1), cfg.log_floor)
            ).astype(np.float32)
        # keep from the start of the next frame, and one sample of
        # pre-emphasis history
        next_start = t * H
        self._prev_sample = float(self._buf[next_start - 1])
        self._buf = self._buf[next_start:]
        self._first = False
        return frames.astype(np.float32), energy

    def _absorb_base(self, out: np.ndarray) -> None:
        """Append spectral rows (base features, energy column already
        substituted when cfg.use_energy) to the rolling buffer."""
        if out.shape[0] == 0:
            return
        self._base_buf = np.concatenate([self._base_buf, out])
        self._t_avail += out.shape[0]

    def _consume_frames(self) -> None:
        """Turn buffered samples into base feature frames: framing on the
        host, the spectral chunk on the device per block of chunk_frames."""
        frames, energy = self._frame_pending()
        t = frames.shape[0]
        L = self.cfg.frame_length
        for i in range(0, t, self.chunk_frames):
            block = frames[i : i + self.chunk_frames]
            nb = block.shape[0]
            padded = np.zeros((self.chunk_frames, L), np.float32)
            padded[:nb] = block
            out = self.kernel(torch.from_numpy(padded).to(self.device)).cpu().numpy()[:nb]
            if energy is not None:
                out[:, 0] = energy[i : i + nb]
            self._absorb_base(out)

    def _deltas_ready(self, t_ready: int) -> np.ndarray:
        """Final features for frames [emitted, t_ready) with full context.

        The buffer keeps `lag` frames of left context before the first
        un-emitted frame (and starts at frame 0 until that many are
        emitted), so the values equal a full-utterance computation: left-edge
        clamping only when _buf_start == 0, right-edge clamping only at
        finalize."""
        cfg = self.cfg
        if t_ready <= self._emitted:
            return np.zeros((0, cfg.feat_dim), np.float32)
        feats = [self._base_buf]
        prev = self._base_buf
        for _ in range(cfg.delta_order):
            prev = npref.compute_deltas(prev, cfg.delta_window)
            feats.append(prev)
        full = np.concatenate(feats, axis=-1)
        lo = self._emitted - self._buf_start
        hi = t_ready - self._buf_start
        out = full[lo:hi].astype(np.float32)
        self._emitted = t_ready
        new_start = max(t_ready - self._lag, 0)
        if new_start > self._buf_start:
            self._base_buf = self._base_buf[new_start - self._buf_start :]
            self._buf_start = new_start
        if cfg.cmvn == "global":
            out = (out - self.cmvn_mean) * self.cmvn_istd
        elif cfg.cmvn == "sliding":
            out = self._sliding_normalize(out)
        return out

    def _sliding_normalize(self, out: np.ndarray) -> np.ndarray:
        """Causal trailing-window normalization of newly-final frames: each
        new frame's window lies in hist + out, so the values are the offline
        sliding path's."""
        W = self.cfg.cmvn_window
        h = self._cmvn_hist.shape[0]
        allf = np.concatenate([self._cmvn_hist, np.asarray(out, np.float64)])
        cs = np.cumsum(allf, axis=0)
        css = np.cumsum(allf * allf, axis=0)
        t = np.arange(h, allf.shape[0])          # rows to normalize
        lo = t - W
        s = cs[t] - np.where(lo[:, None] >= 0, cs[np.maximum(lo, 0)], 0.0)
        ss = css[t] - np.where(lo[:, None] >= 0, css[np.maximum(lo, 0)], 0.0)
        cnt = np.minimum(t + 1, W)[:, None].astype(np.float64)
        mean = s / cnt
        norm = allf[t] - mean
        if self.cfg.cmvn_norm_var:
            var = ss / cnt - mean**2
            norm = norm / np.sqrt(np.maximum(var, 1e-10))
        keep = W - 1
        self._cmvn_hist = allf[allf.shape[0] - min(keep, allf.shape[0]):] if keep > 0 else allf[:0]
        return norm.astype(np.float32)

    def _buffer_samples(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float64)
        if self.cfg.dither != 0.0 and len(samples):
            # the offline path's and the oracle's position-keyed stream
            samples = samples + self.cfg.dither * npref.dither_noise_np(self._n_in, len(samples))
        self._n_in += len(samples)
        self._buf = np.concatenate([self._buf, samples])

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Feed a chunk of audio; returns newly-final [n, feat_dim] features."""
        self._buffer_samples(samples)
        self._consume_frames()
        return self._deltas_ready(max(self._t_avail - self._lag, 0))

    # The engine half: an engine runs one spectral batch for many streams,
    # so the per-stream object does only the host work:
    #   frames, energy = fe.accept_samples(pcm)   # host framing
    #   ... the engine runs the spectral chunk over many streams' frames ...
    #   feats = fe.absorb(base_rows)              # rows back -> final features
    # The values are process()'s and finalize()'s.

    def accept_samples(self, samples: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Host framing only: (pre-emphasized frames [t, frame_length],
        energy [t] or None) for a shared spectral batch."""
        self._buffer_samples(samples)
        return self._frame_pending()

    def absorb(self, base_rows: np.ndarray) -> np.ndarray:
        """Accept spectral rows (energy column already substituted by the
        caller when cfg.use_energy); returns newly-final [n, feat_dim]
        features."""
        self._absorb_base(np.asarray(base_rows, np.float32))
        return self._deltas_ready(max(self._t_avail - self._lag, 0))

    def finalize_absorbed(self) -> np.ndarray:
        """Engine finalize: every accept_samples() frame has been absorb()ed;
        flushes the delta-lag tail with edge replication."""
        return self._deltas_ready(self._t_avail)

    def finalize(self) -> np.ndarray:
        """Flush remaining frames with end-of-utterance edge replication."""
        self._consume_frames()
        return self._deltas_ready(self._t_avail)

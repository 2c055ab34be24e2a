"""Streaming pitch: online NCCF + bounded-delay Viterbi lag commits.

The port's copy of mogasr/frontend/pitch_stream.py, its imports pointed at mogasr_torch.

The offline extractor (frontend/pitch.py) is utterance-level: the lag
Viterbi and the log-f0 centering are acausal, so `FrontendConfig.
add_pitch` is rejected by the streaming front end.  This module is the
ONLINE counterpart with the standard production compromise — a fixed
decision delay:

- NCCF rows are computed causally as samples arrive (a frame needs
  window + max-lag lookahead of raw samples, ~45 ms — the same samples
  the offline extractor uses for that frame; host NumPy, matching
  frontend/streaming.py's per-session model);
- the lag Viterbi runs incrementally; a frame is COMMITTED once
  ``lookahead`` further frames have arrived, by backtracing from the
  newest frame's best lag (a fixed ~lookahead·10 ms decision delay);
- log-f0 is centered by a CAUSAL running mean over committed frames
  (the offline path uses the utterance mean — documented deviation).

Exactness contract (tested): chunking-INVARIANT — any split of the same
samples commits bit-identical frames — and lag picks equal the offline
Viterbi wherever the offline backtrace has converged within the
lookahead window (measured ≥95% on tones/chirps in tests; the deviation
is the price of bounded latency, stated here rather than hidden).

No reference implementation exists for this capability (the
reference mount is empty — SURVEY.md §0).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mogasr_torch.frontend.pitch import PitchConfig, _lowpass_kernel


class StreamingPitch:
    """Chunked pitch extractor; emits committed [n, 3] rows incrementally.

    Feature columns match the offline extractor: (POV, centered log-f0,
    Δlog-f0), with the causal running-mean centering noted above.
    """

    def __init__(self, cfg: PitchConfig = PitchConfig(),
                 sample_rate: int = 16000, lookahead: int = 30):
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.lookahead = int(lookahead)
        self.factor = sample_rate // cfg.work_rate
        self.win = int(round(cfg.window_ms * 1e-3 * cfg.work_rate))
        self.shift = int(round(cfg.shift_ms * 1e-3 * cfg.work_rate))
        self.min_lag = int(np.floor(cfg.work_rate / cfg.max_f0))
        self.max_lag = int(np.ceil(cfg.work_rate / cfg.min_f0))
        self.lags = np.arange(self.min_lag, self.max_lag + 1)
        self.L = len(self.lags)
        log_lag = np.log(self.lags.astype(np.float64))
        self.trans = (-cfg.lag_penalty *
                      (log_lag[:, None] - log_lag[None, :]) ** 2)
        self._kern = _lowpass_kernel(cfg, sample_rate).astype(np.float64)
        self._pad = cfg.lowpass_taps // 2
        # raw 16 kHz buffer (uncommitted tail only) + absolute offsets
        self._raw = np.zeros(0, np.float64)
        self._raw_off = 0          # absolute index of _raw[0]
        self._n_in = 0             # absolute samples consumed
        # decimated signal buffer
        self._dec = np.zeros(0, np.float64)
        self._n_frames = 0         # NCCF rows produced so far
        self._committed = 0        # frames already emitted
        # Viterbi state over UNCOMMITTED frames
        self._delta: Optional[np.ndarray] = None      # [L]
        self._bps: List[np.ndarray] = []              # per frame [L] int32
        self._nccf_rows: List[np.ndarray] = []        # per frame [L]
        # causal centering state
        self._lf_sum = 0.0
        self._lf_n = 0
        self._prev_logf0: Optional[float] = None
        self.f0_history: List[float] = []   # committed raw f0 (Hz), for
        #                                     consumers/tests needing the
        #                                     uncentered track

    # -- internals ---------------------------------------------------------

    def _decimate_all(self, total_samples: int, final: bool = False) -> None:
        """Extend the decimated buffer with every position whose FULL FIR
        window [center-pad, center+pad] has arrived — computing a position
        early (zeros standing in for future samples) would make its value
        chunk-size dependent.  ``final`` computes the end-of-stream tail
        (there, zeros beyond the end are the truth, as in the offline
        extractor)."""
        if final:
            nd = (total_samples - 1) // self.factor + 1 if total_samples else 0
        elif total_samples <= self._pad:
            nd = 0
        else:
            nd = (total_samples - 1 - self._pad) // self.factor + 1
        new = []
        for k in range(len(self._dec), nd):
            center = k * self.factor
            lo = center - self._pad
            hi = lo + len(self._kern)
            seg = np.zeros(len(self._kern), np.float64)
            a = max(lo, 0)
            b = min(hi, total_samples)
            if b > a:
                seg[a - lo: b - lo] = self._raw[a - self._raw_off:
                                                b - self._raw_off]
            new.append(float(seg @ self._kern))
        if new:
            self._dec = np.concatenate([self._dec, np.asarray(new)])

    def _nccf_row(self, t: int,
                  allow_partial: bool = False) -> Optional[np.ndarray]:
        """NCCF row for frame t once its full extended window has arrived
        (allow_partial: end-of-stream — zero-extend, like the offline
        extractor's out-of-range zeroing)."""
        start = t * self.shift
        need = start + self.win + self.max_lag
        if need > len(self._dec) and not allow_partial:
            return None
        ext = np.zeros(self.win + self.max_lag, np.float64)
        avail = self._dec[start: min(need, len(self._dec))]
        ext[: len(avail)] = avail
        base = ext[: self.win] - ext[: self.win].mean()
        e0 = float(base @ base) + self.cfg.eps
        row = np.empty(self.L, np.float64)
        for i, lag in enumerate(self.lags):
            seg = ext[lag: lag + self.win]
            seg = seg - seg.mean()
            e1 = float(seg @ seg) + self.cfg.eps
            row[i] = float(base @ seg) / np.sqrt(e0 * e1)
        return row

    def _advance_viterbi(self, row: np.ndarray) -> None:
        if self._delta is None:
            self._delta = row.copy()
            self._bps.append(np.arange(self.L, dtype=np.int32))
        else:
            scores = self._delta[:, None] + self.trans       # [L, L]
            self._bps.append(np.argmax(scores, axis=0).astype(np.int32))
            self._delta = scores.max(axis=0) + row
        self._nccf_rows.append(row)

    def _commit_ready(self, upto: int) -> np.ndarray:
        """Backtrace from the newest frame and emit frames < upto."""
        out = []
        if upto <= self._committed or self._delta is None:
            return np.zeros((0, 3), np.float32)
        # path over the uncommitted window [committed, n_frames)
        j = int(np.argmax(self._delta))
        path = [j]
        for bp in reversed(self._bps[1:]):
            j = int(bp[j])
            path.append(j)
        path.reverse()               # index 0 == frame self._committed? no:
        # _bps[0] is identity for the FIRST uncommitted frame of the very
        # first window; in general _bps aligns with _nccf_rows
        n_emit = upto - self._committed
        for k in range(n_emit):
            lag = float(self.lags[path[k]])
            f0 = self.cfg.work_rate / lag
            self.f0_history.append(f0)
            pov = float(self._nccf_rows[k][path[k]])
            logf0 = float(np.log(f0))
            self._lf_sum += logf0
            self._lf_n += 1
            clf = logf0 - self._lf_sum / self._lf_n
            dlf = 0.0 if self._prev_logf0 is None else logf0 - self._prev_logf0
            self._prev_logf0 = logf0
            out.append((pov, clf, dlf))
        # drop committed frames' state. The delta row stays — it is the
        # recursion over ALL frames and is unchanged by committing; the
        # first kept frame's backpointer row is simply never dereferenced
        # (backtraces stop at the window's first frame).
        self._nccf_rows = self._nccf_rows[n_emit:]
        self._bps = self._bps[n_emit:]
        self._committed = upto
        return np.asarray(out, np.float32).reshape(-1, 3)

    # -- public ------------------------------------------------------------

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Feed raw 16 kHz samples; returns newly COMMITTED [n, 3] rows."""
        samples = np.asarray(samples, np.float64).reshape(-1)
        self._raw = np.concatenate([self._raw, samples])
        self._n_in += len(samples)
        self._decimate_all(self._n_in)
        while True:
            row = self._nccf_row(self._n_frames)
            if row is None:
                break
            self._advance_viterbi(row)
            self._n_frames += 1
        # trim raw we can never need again: the next decimated position's
        # FIR window starts at len(_dec)*factor - pad
        keep_from = max(0, len(self._dec) * self.factor - self._pad)
        if keep_from > self._raw_off:
            self._raw = self._raw[keep_from - self._raw_off:]
            self._raw_off = keep_from
        ready = self._n_frames - self.lookahead
        return self._commit_ready(max(ready, self._committed))

    def finalize(self) -> np.ndarray:
        """Commit every remaining frame (end of stream): compute the
        decimated/NCCF tail (zeros beyond the end are the truth now, with
        zero-extended windows up to the OFFLINE frame count) and flush the
        Viterbi window."""
        self._decimate_all(self._n_in, final=True)
        win16 = int(round(self.cfg.window_ms * 1e-3 * self.sample_rate))
        shift16 = int(round(self.cfg.shift_ms * 1e-3 * self.sample_rate))
        t_target = max((self._n_in - win16) // shift16 + 1, 0)
        while self._n_frames < t_target:
            row = self._nccf_row(self._n_frames, allow_partial=True)
            self._advance_viterbi(row)
            self._n_frames += 1
        return self._commit_ready(self._n_frames)

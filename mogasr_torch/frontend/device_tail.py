"""The batched streaming feature tail on the device (deltas, CMVN, the feature
queue): the port of mogasr/frontend/device_tail.py.

The serving engine (``serving/engine.py``, ``feature_path="device"``) keeps a
session's features on the card from the spectral chunk to the decode stage,
so a tick reads nothing back. Three pieces, each plain PyTorch ops on the
device of its state (the reference has no Pallas kernel here):

- **Delta tail** (:func:`_tail_core`): a [B, C, D_base] rolling window
  holding, per slot, the frames from ``emitted - lag`` on (the trim rule of
  ``StreamingFrontend._base_buf``), with a valid count per slot, so the
  regression deltas clamp at the same frames as the host rolling buffer.
  Exact against the per-slot host tail.
- **CMVN** (:func:`_cmvn_sliding_core`, or the affine global path): causal
  trailing-window normalization over a [B, W - 1 + O, D] rolling buffer of
  raw rows. The host path sums window statistics in float64 cumsums; here
  each window's mean is float32 and its variance a two-pass sum of squared
  deviations, so the contract is a tolerance (~1e-5 relative) and equal
  decode decisions, not bit equality.
- **Feature queue** (:func:`_q_append_core`, :func:`_q_pop_core`): a [B, Q, D]
  ragged queue between the tail and the decode stage. Its counts live on the
  host (integer mirrors of the emission rule), so no queue op reads the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mogasr_torch.config import FrontendConfig
from mogasr_torch.frontend.torch_frontend import _deltas_batched


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D] gathered at row indices idx [B, M] -> [B, M, D]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _below(n: int, count: torch.Tensor) -> torch.Tensor:
    """[B, n, 1] mask of the first count[b] positions of each row."""
    return (torch.arange(n, device=count.device)[None, :] < count[:, None])[..., None]


class TailState(NamedTuple):
    buf: torch.Tensor    # [B, C, D_base] rolling window (emitted - lag ...)
    valid: torch.Tensor  # [B] rows of buf that are real
    off: torch.Tensor    # [B] index in buf of the first frame not yet emitted (min(emitted, lag))


def tail_init(cfg: FrontendConfig, batch: int, chunk: int, device=torch.device("cuda")) -> TailState:
    """Carries for ``batch`` slots absorbing up to ``chunk`` rows a step."""
    lag = cfg.delta_order * cfg.delta_window
    zero = torch.zeros((batch,), dtype=torch.int64, device=device)
    return TailState(torch.zeros((batch, 2 * lag + chunk, cfg.base_dim), dtype=torch.float32, device=device),
                     zero, zero.clone())


def _tail_core(state: TailState, new_rows: torch.Tensor, n_new: torch.Tensor, final: torch.Tensor,
               delta_order: int, delta_window: int) -> Tuple[TailState, torch.Tensor, torch.Tensor]:
    """-> (state', out [B, F + lag, feat_dim], n_out [B]): out[b, :n_out[b]]
    are slot b's newly final full-context feature rows, those the host tail
    emits for the same absorb() call. final[b] flushes the lookahead tail
    (end of utterance) and resets the slot."""
    B, C, _D = state.buf.shape
    F = new_rows.shape[1]
    lag = delta_order * delta_window
    dev = state.buf.device
    n_new = n_new.to(torch.int64)
    idx = torch.arange(C, device=dev)[None, :]
    # ragged append: buf'[b, i] = buf[b, i] below valid, new[b, i - valid] after
    take_new = (idx - state.valid[:, None]).clamp(0, F - 1)
    appended = torch.where((idx < state.valid[:, None])[..., None], state.buf, _rows(new_rows, take_new))
    v = state.valid + n_new
    appended = torch.where(_below(C, v), appended, 0.0)
    # deltas over the valid region, clamped at [0, v): the host buffer's
    # edges; scaled by the reciprocal of the denominator, as the reference's
    # jitted tail computes them (XLA's rewrite of a division by a constant)
    feats = [appended]
    prev = appended
    for _ in range(delta_order):
        prev = _deltas_batched(prev, v, delta_window, reciprocal=True)
        feats.append(prev)
    full = torch.cat(feats, dim=-1)
    # emit every frame with its whole lookahead (all of them on final)
    lo = state.off
    t_ready = torch.where(final, v, v - lag)
    n_out = (t_ready - lo).clamp(0, F + lag)
    out_idx = (lo[:, None] + torch.arange(F + lag, device=dev)[None, :]).clamp(0, C - 1)
    out = torch.where(_below(F + lag, n_out), _rows(full, out_idx), 0.0)
    # trim: keep lag rows of context before the next frame to emit
    emitted = lo + n_out
    drop = (emitted - lag).clamp(min=0)
    buf2 = _rows(appended, (drop[:, None] + idx).clamp(0, C - 1))
    v2 = v - drop
    buf2 = torch.where(_below(C, v2), buf2, 0.0)
    off2 = emitted - drop
    # a finished slot starts clean for its next session
    buf2 = torch.where(final[:, None, None], 0.0, buf2)
    v2 = torch.where(final, 0, v2)
    off2 = torch.where(final, 0, off2)
    return TailState(buf2, v2, off2), out, n_out


def _cmvn_sliding_core(cbuf: torch.Tensor, ch: torch.Tensor, rows: torch.Tensor, n_rows: torch.Tensor,
                       final: torch.Tensor, window: int, norm_var: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (cbuf', ch', normalized rows [B, O, D]).

    Frame t is normalized by the statistics of its trailing min(t + 1,
    window) raw frames (itself included), as the host's
    ``StreamingFrontend._sliding_normalize``. With ch = min(emitted, W - 1)
    history rows kept, row i of this step sits at buffer position ch + i and
    its count is min(ch + i + 1, W). Float32, two-pass: the mean, then the
    mean of squared deviations."""
    B, Wbuf, D = cbuf.shape
    O = rows.shape[1]
    W = window
    dev = cbuf.device
    n_rows = n_rows.to(torch.int64)
    idx = torch.arange(Wbuf, device=dev)[None, :]
    src = (idx - ch[:, None]).clamp(0, O - 1)
    appended = torch.where((idx < ch[:, None])[..., None], cbuf, _rows(rows, src))
    appended = torch.where(_below(Wbuf, ch + n_rows), appended, 0.0)
    # each output row's trailing window: it ends at ch + i, cnt valid rows
    end = ch[:, None] + torch.arange(O, device=dev)[None, :]                    # [B, O]
    cnt = (end + 1).clamp(max=W).to(torch.float32)
    w_off = torch.arange(W, device=dev)[None, None, :]
    w_idx = (end[:, :, None] - (W - 1) + w_off).clamp(0, Wbuf - 1)            # [B, O, W]
    valid = (w_off >= (W - cnt[:, :, None]))[..., None]                         # [B, O, W, 1]
    g = _rows(appended, w_idx.reshape(B, O * W)).reshape(B, O, W, D)
    mean = torch.where(valid, g, 0.0).sum(dim=2) / cnt[..., None]
    out = rows - mean
    if norm_var:
        dev_ = torch.where(valid, g - mean[:, :, None, :], 0.0)
        var = (dev_ * dev_).sum(dim=2) / cnt[..., None]
        out = out / torch.sqrt(var.clamp(min=1e-10))
    # trim: keep the last min(ch + n_rows, W - 1) raw rows
    total = ch + n_rows
    keep = total.clamp(max=W - 1)
    drop = total - keep
    cbuf2 = _rows(appended, (drop[:, None] + idx).clamp(0, Wbuf - 1))
    cbuf2 = torch.where(_below(Wbuf, keep), cbuf2, 0.0)
    cbuf2 = torch.where(final[:, None, None], 0.0, cbuf2)
    keep = torch.where(final, 0, keep)
    return cbuf2, keep, out


class FeatTailState(NamedTuple):
    tail: TailState
    cbuf: torch.Tensor  # [B, Wbuf, D_feat] sliding-CMVN raw history
    ch: torch.Tensor    # [B] valid rows of cbuf


def feat_tail_init(cfg: FrontendConfig, batch: int, chunk: int, device=torch.device("cuda")) -> FeatTailState:
    """Carries for ``batch`` slots absorbing up to ``chunk`` base rows a step
    and emitting up to ``chunk + lag`` normalized rows."""
    lag = cfg.delta_order * cfg.delta_window
    wbuf = (cfg.cmvn_window - 1 + chunk + lag) if cfg.cmvn == "sliding" else 1
    return FeatTailState(tail_init(cfg, batch, chunk, device),
                         torch.zeros((batch, wbuf, cfg.feat_dim), dtype=torch.float32, device=device),
                         torch.zeros((batch,), dtype=torch.int64, device=device))


def _feat_tail_core(state: FeatTailState, new_rows: torch.Tensor, n_new: torch.Tensor, final: torch.Tensor, *,
                    delta_order: int, delta_window: int, cmvn: str, cmvn_window: int, cmvn_norm_var: bool,
                    cmvn_mean: Optional[torch.Tensor] = None, cmvn_istd: Optional[torch.Tensor] = None
                    ) -> Tuple[FeatTailState, torch.Tensor, torch.Tensor]:
    """-> (state', normalized out [B, F + lag, D_feat], n_out [B]): the delta
    tail, then CMVN; rows past n_out are zero."""
    tail, raw, n_out = _tail_core(state.tail, new_rows, n_new, final, delta_order, delta_window)
    cbuf, ch = state.cbuf, state.ch
    if cmvn == "sliding":
        cbuf, ch, out = _cmvn_sliding_core(cbuf, ch, raw, n_out, final, cmvn_window, cmvn_norm_var)
    elif cmvn == "global":
        out = (raw - cmvn_mean) * cmvn_istd
    elif cmvn == "none":
        out = raw
    else:
        raise NotImplementedError(f"device feature tail: cmvn={cmvn!r} (per-utterance CMVN is acausal; "
                                  "the streaming modes are none, global and sliding)")
    out = torch.where(_below(out.shape[1], n_out), out, 0.0)
    return FeatTailState(tail, cbuf, ch), out, n_out


def _stats(cfg: FrontendConfig, device, cmvn_mean, cmvn_istd) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global CMVN statistics as [D_feat] float32 tensors (0 and 1 when absent)."""
    mean = (torch.as_tensor(cmvn_mean, dtype=torch.float32).reshape(-1) if cmvn_mean is not None
            else torch.zeros(cfg.feat_dim))
    istd = (torch.as_tensor(cmvn_istd, dtype=torch.float32).reshape(-1) if cmvn_istd is not None
            else torch.ones(cfg.feat_dim))
    return mean.to(device), istd.to(device)


def _step_inputs(state_buf: torch.Tensor, lag: int, new_rows, n_new, final, name: str):
    chunk = state_buf.shape[1] - 2 * lag
    dev = state_buf.device
    new_rows = torch.as_tensor(new_rows, dtype=torch.float32, device=dev)
    if new_rows.shape[1] > chunk:
        # the rolling buffer sizes emission for at most `chunk` rows a step
        raise ValueError(f"{name} got {new_rows.shape[1]} rows but the state was initialized for chunks of {chunk}")
    B = new_rows.shape[0]
    final = (torch.zeros((B,), dtype=torch.bool, device=dev) if final is None
             else torch.as_tensor(final, dtype=torch.bool, device=dev))
    return new_rows, torch.as_tensor(n_new, dtype=torch.int64, device=dev), final


def feat_tail_step(cfg: FrontendConfig, state: FeatTailState, new_rows, n_new, final=None, cmvn_mean=None,
                   cmvn_istd=None):
    """The whole feature tail a step, callable with host arrays (the engine
    calls the core): StreamingFrontend.absorb and its CMVN for a batch."""
    lag = cfg.delta_order * cfg.delta_window
    new_rows, n_new, final = _step_inputs(state.tail.buf, lag, new_rows, n_new, final, "feat_tail_step")
    mean, istd = _stats(cfg, state.cbuf.device, cmvn_mean, cmvn_istd)
    return _feat_tail_core(state, new_rows, n_new, final, delta_order=cfg.delta_order,
                           delta_window=cfg.delta_window, cmvn=cfg.cmvn, cmvn_window=cfg.cmvn_window,
                           cmvn_norm_var=cfg.cmvn_norm_var, cmvn_mean=mean, cmvn_istd=istd)


def tail_step(cfg: FrontendConfig, state: TailState, new_rows, n_new, final=None):
    """The delta tail a step: (state, base rows [B, F, D_base], counts [B]) ->
    (state', full-context rows [B, F + lag, feat_dim], counts). final[b]
    flushes slot b's lookahead tail with end-of-utterance edge replication
    and resets its carry."""
    lag = cfg.delta_order * cfg.delta_window
    new_rows, n_new, final = _step_inputs(state.buf, lag, new_rows, n_new, final, "tail_step")
    return _tail_core(state, new_rows, n_new, final, cfg.delta_order, cfg.delta_window)


def _q_append_core(qbuf: torch.Tensor, qlen: torch.Tensor, rows: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """qbuf with rows[b, :n_rows[b]] written at qbuf[b, qlen[b]:]; the host
    keeps qlen + n_rows <= Q (the queue's sizing rule)."""
    Q = qbuf.shape[1]
    src = torch.arange(Q, device=qbuf.device)[None, :] - qlen[:, None].to(torch.int64)
    new = _rows(rows, src.clamp(0, rows.shape[1] - 1))
    return torch.where(((src >= 0) & (src < n_rows[:, None].to(torch.int64)))[..., None], new, qbuf)


def _q_pop_core(qbuf: torch.Tensor, take: torch.Tensor, n_take: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (feats [B, n_take, D], rows at and past take[b] zero; qbuf with the
    remaining rows shifted to the front)."""
    Q = qbuf.shape[1]
    take = take.to(torch.int64)
    feats = torch.where(_below(n_take, take), qbuf[:, :n_take], 0.0)
    shifted = _rows(qbuf, (torch.arange(Q, device=qbuf.device)[None, :] + take[:, None]).clamp(0, Q - 1))
    return feats, shifted

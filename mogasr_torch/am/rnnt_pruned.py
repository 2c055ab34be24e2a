"""Pruned RNN-T loss: the joint network evaluated only on a (t, u) band,
the port of mogasr/am/rnnt_pruned.py.

1. Simple pass: a factored joint am[t, v] + lm[u, v] (RnntModel's
   simple heads) scores the full lattice (``rnnt_grids_simple``, a few
   frames at a time), and the lattice DP (``am.rnnt.rnnt_dp_nll``) turns
   the grids into a transducer NLL.
2. Bounds: the gradient of that DP with respect to the grids is the arc
   occupancy table; its occupancy-weighted mean label position per frame,
   clamped to a monotone band that starts at u = 0, advances at most
   band - 1 a frame and ends covering u = n_labels, gives u_start[b, t]
   (``rnnt_prune_bounds``; the clamping scan is integer work on the host).
3. Pruned pass: the real joint on the band (``RnntJoint.banded``,
   [B, T, S, V]) and the banded DP (``rnnt_loss_banded``). Training loss =
   pruned NLL + a scaled simple NLL (+ the auxiliary CTC loss).

The banded DP is the lattice DP of ``am.rnnt`` restricted to the band's
cells (the cells off the band at NEG_INF): a band cell takes the same
``logaddexp`` of the same operands as the reference's band-coordinate
recursion, so rows whose final node lies in the band (every row the bounds
make feasible) get the reference's loss and gradient. With S >= U+1 and
u_start == 0 it is the full loss.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mogasr_torch.am.ctc import ctc_loss, masked_mean_objective
from mogasr_torch.am.rnnt import NEG_INF, RnntModel, _alpha_diagonals, rnnt_dp_nll
from mogasr_torch.am.train_nn import TrainState, apply_update
from mogasr_torch.config import TrainConfig

SIMPLE_CHUNK_FRAMES = 32  # frames of the simple joint's [B, c, U+1, V] sums at a time


def rnnt_grids_simple(am: torch.Tensor, lm: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(blank [B,T,U+1], emit [B,T,U]) log-prob grids of the factored joint
    logit(t,u,v) = am[t,v] + lm[u,v] (am [B,T,V], lm [B,U+1,V]),
    normalized over v per (t, u); blank = V-1."""
    B, T, V = am.shape
    U = lm.shape[1] - 1
    safe = torch.clamp(labels.to(am.device).long(), min=0)
    blanks, emits = [], []
    for t0 in range(0, T, SIMPLE_CHUNK_FRAMES):
        s = am[:, t0:t0 + SIMPLE_CHUNK_FRAMES, None, :] + lm[:, None, :, :]   # [B, c, U+1, V]
        c = s.shape[1]
        z = torch.logsumexp(s, dim=-1)
        blanks.append(s[..., -1] - z)
        emits.append(torch.gather(s[:, :, :-1, :], 3, safe[:, None, :, None].expand(B, c, U, 1))[..., 0] - z[:, :, :-1])
    return torch.cat(blanks, dim=1), torch.cat(emits, dim=1)


def rnnt_prune_bounds(blank: torch.Tensor, emit: torch.Tensor, n_frames, n_labels, band: int) -> torch.Tensor:
    """u_start [B, T] int64 on the grids' device: the first label position
    of each frame's band. For a row's valid frames: u_start[0] == 0; 0 <=
    u_start[t+1] - u_start[t] <= band-1 (adjacent bands overlap, so blank
    edges survive); u_start[n_frames-1] == max(n_labels+1-band, 0). A
    discrete choice: no gradient flows through it."""
    B, T, U1 = blank.shape
    S = band
    dev = blank.device
    nf = torch.as_tensor(n_frames).to(dev)
    nl = torch.as_tensor(n_labels).to(dev)
    with torch.enable_grad():
        gb = blank.detach().clone().requires_grad_(True)
        ge = emit.detach().clone().requires_grad_(True)
        g_blank, g_emit = torch.autograd.grad(rnnt_dp_nll(gb, ge, nf, nl).sum(), (gb, ge))
    # d(nll)/d(grid) = -(arc posterior); node occupancy = sum of out-arcs
    w = -g_blank + torch.nn.functional.pad(-g_emit, (0, 1))
    w = torch.clamp(w, min=0.0)
    u_idx = torch.arange(U1, dtype=torch.float32, device=dev)
    denom = torch.clamp(w.sum(dim=-1), min=1e-6)
    u_hat = (w * u_idx).sum(dim=-1) / denom
    raw = torch.round(u_hat - (S - 1) / 2.0).to(torch.int64).cpu().numpy()

    nf_h = nf.cpu().numpy().astype(np.int64)
    fin = np.maximum(nl.cpu().numpy().astype(np.int64) + 1 - S, 0)
    last = np.maximum(nf_h - 1, 0)
    t_idx = np.arange(T, dtype=np.int64)
    # the lowest start at t from which advancing <= S-1 a frame still
    # reaches fin by the last frame
    lower = np.minimum(np.maximum(0, fin[:, None] - (last[:, None] - t_idx[None, :]) * max(S - 1, 1)), fin[:, None])
    out = np.zeros((B, T), np.int64)
    u_prev = np.zeros(B, np.int64)
    for t in range(1, T):
        lo = np.maximum(u_prev, lower[:, t])
        hi = np.maximum(np.minimum(u_prev + (S - 1), fin), lo)
        u_t = np.clip(raw[:, t], lo, hi)
        u_prev = np.where(t < nf_h, u_t, u_prev)
        out[:, t] = u_prev
    return torch.as_tensor(out, device=dev)


def rnnt_loss_banded(logits_band: torch.Tensor, u_start: torch.Tensor, n_frames, labels: torch.Tensor,
                     n_labels) -> torch.Tensor:
    """Per-utterance NLL of the banded lattice [B]; logits_band [B, T, S, V]
    the joint on the band, u_start [B, T] its starts; blank = V-1. Edges
    leaving the band are lost (the pruning), so for S < U+1 the loss bounds
    the full one from above."""
    B, T, S, V = logits_band.shape
    dev = logits_band.device
    U = labels.shape[1]
    U1 = U + 1
    nf = torch.as_tensor(n_frames).to(dev).long()
    nl = torch.as_tensor(n_labels).to(dev).long()
    us = u_start.to(dev).long()
    logp = torch.log_softmax(logits_band.to(torch.float32), dim=-1)
    u_of = us[:, :, None] + torch.arange(S, device=dev)[None, None, :]           # [B, T, S]
    safe = torch.clamp(labels.to(dev).long(), min=0)
    blank_b = torch.where(u_of <= nl[:, None, None], logp[..., V - 1], NEG_INF)
    if U > 0:
        lab = torch.gather(safe[:, None, :].expand(B, T, U), 2, torch.clamp(u_of, 0, U - 1))
        emit_b = torch.where(u_of < nl[:, None, None], torch.gather(logp, 3, lab[..., None])[..., 0], NEG_INF)
    # the band in lattice coordinates
    s_of = torch.arange(U1, device=dev)[None, None, :] - us[:, :, None]             # [B, T, U+1]
    in_band = (s_of >= 0) & (s_of < S)
    sc = torch.clamp(s_of, 0, S - 1)
    blank_f = torch.where(in_band, torch.gather(blank_b, 2, sc), NEG_INF)
    if U > 0:
        emit_f = torch.where(in_band[..., :U], torch.gather(emit_b, 2, sc[..., :U]), NEG_INF)
    else:
        emit_f = blank_f[..., :0]
    alpha = _alpha_diagonals(blank_f, emit_f, cell_ok=in_band)
    rows = torch.arange(B, device=dev)
    last = torch.clamp(nf - 1, min=0)
    usl = us[rows, last]
    s_fin = torch.clamp(nl - usl, 0, S - 1)
    u_fin = torch.clamp(usl + s_fin, max=U)
    return -(alpha[rows, last + u_fin, last] + blank_b[rows, last, s_fin])


def rnnt_pruned_objective(model: RnntModel, feats, n_frames, labels, n_labels, band: int,
                          simple_scale: float = 0.5, ctc_weight: float = 1.0, *, use_kernels: bool = True):
    """Pruned training loss: banded NLL + simple_scale x factored NLL (+
    the auxiliary CTC loss), masked-mean normalized as ``rnnt_objective``.
    An utterance whose labels the band cannot traverse in its frames is
    left out of the pruned term (it trains through the simple term).
    Returns (loss, mean banded NLL)."""
    dev = feats.device
    labels, n_labels, nf = labels.to(dev), n_labels.to(dev), n_frames.to(dev)
    am, lm, enc, pred, ctc_logits = model.forward_simple(feats, nf, labels, use_kernels=False)
    blank_g, emit_g = rnnt_grids_simple(am, lm, labels)
    simple_nll = rnnt_dp_nll(blank_g, emit_g, nf, n_labels)
    u_start = rnnt_prune_bounds(blank_g.detach(), emit_g.detach(), nf, n_labels, band)
    pruned_nll = rnnt_loss_banded(model.joint_banded(enc, pred, u_start, band), u_start, nf, labels, n_labels)
    feasible = torch.clamp(n_labels + 1 - band, min=0) <= torch.clamp(nf - 1, min=0) * max(band - 1, 1)
    loss_p, mean_nll = masked_mean_objective(pruned_nll, nf, torch.where(feasible, n_labels, 0))
    loss_s, _ = masked_mean_objective(simple_nll, nf, n_labels)
    loss = loss_p + simple_scale * loss_s
    if model.aux_ctc:
        ctc_nll = ctc_loss(ctc_logits, nf, labels, n_labels, use_kernels=use_kernels)
        ctc_mean, _ = masked_mean_objective(ctc_nll, nf, n_labels)
        loss = loss + ctc_weight * ctc_mean
    return loss, mean_nll


def make_rnnt_pruned_train_step(model: RnntModel, cfg: TrainConfig, band: int, simple_scale: float = 0.5,
                                ctc_weight: float = 1.0, *, use_kernels: bool = True):
    """The pruned-transducer step, a drop-in for ``rnnt.make_rnnt_train_step``
    (the model must be built with simple_heads)."""
    if not model.simple_heads:
        raise ValueError("pruned training needs build_rnnt_model(simple_heads=True)")
    if band < 2:
        raise ValueError("pruned band must be >= 2 (band=1 cannot advance through the lattice)")

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        state.model.train()
        with torch.enable_grad():
            loss, mean_nll = rnnt_pruned_objective(state.model, feats, n_frames, labels, n_labels, band,
                                                   simple_scale, ctc_weight, use_kernels=use_kernels)
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item(), "utt_nll": mean_nll.item()}

    return train_step

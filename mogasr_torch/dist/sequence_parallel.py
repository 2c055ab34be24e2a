"""Sequence (context) parallelism over a ``('seq',)`` mesh: the port of
mogasr/dist/sequence_parallel.py.

Long audio shards its TIME axis: rank i holds frames [i Tl, (i + 1) Tl). The
offline front end's tail couples frames twice:

- **deltas** gather +-window frames with each utterance's edges repeated
  (indices clamped to [0, n_frames - 1]); each delta pass first takes
  ``window`` edge frames from both neighbours (a halo exchange: two ring
  shifts, ``comm.ring_shift``), and every VALID frame's clamped global index
  lands inside the haloed block (|idx - t| <= window). The first and last
  shards receive wrapped frames in their outer halo, which no valid frame
  can address; invalid frames are masked by the CMVN.
- **utterance CMVN** is a mean and variance over valid frames: their count,
  sum and squared deviations summed over the ranks (``comm.all_reduce``).

:func:`make_sp_feature_tail` equals the offline tail
(``frontend.torch_frontend._deltas_batched`` and ``_masked_cmvn``) gather
for gather, the CMVN up to the order of its sums; :func:`make_sp_score_step`
chains a per-frame scorer, so logits stay time-sharded.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mogasr_torch.dist import comm
from mogasr_torch.dist.mesh import Mesh, axis_mesh


def make_sp_mesh(n: int, device="cuda") -> Mesh:
    """The ('seq',) mesh over the first ``n`` ranks (every rank must call
    it)."""
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    return axis_mesh("seq", range(n), device, None if n == world else dist.new_group(list(range(n))))


def time_block(T: int, mesh: Mesh) -> slice:
    """The frames of a T-frame batch this rank holds."""
    if T % mesh.size:
        raise ValueError(f"T = {T} does not split over {mesh.size} 'seq' ranks")
    tl = T // mesh.size
    return slice(mesh.rank * tl, (mesh.rank + 1) * tl)


def _halo_exchange(x: torch.Tensor, window: int, mesh: Mesh) -> torch.Tensor:
    """[B, Tl, D] -> [B, Tl + 2 window, D]: the left neighbour's last and the
    right neighbour's first ``window`` frames around this rank's."""
    left = comm.ring_shift(x[:, -window:].contiguous(), mesh.group, 1)
    right = comm.ring_shift(x[:, :window].contiguous(), mesh.group, -1)
    return torch.cat([left, x, right], dim=1)


def _sp_delta_pass(x: torch.Tensor, n_frames: torch.Tensor, window: int, mesh: Mesh) -> torch.Tensor:
    """One regression-delta pass on a time shard, the offline
    ``_deltas_batched`` frame for frame."""
    B, Tl, D = x.shape
    off = mesh.rank * Tl
    ext = _halo_exchange(x, window, mesh)
    t = off + torch.arange(Tl, device=x.device)[None, :]                  # global [1, Tl]
    last = torch.clamp(n_frames.to(x.device).long() - 1, min=0)[:, None]  # [B, 1]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    out = torch.zeros_like(x)
    for i in range(1, window + 1):
        fwd_g = torch.minimum(t + i, last)
        bwd_g = torch.minimum(torch.clamp(t - i, min=0), last)
        # haloed-local coordinates; the clamp only touches masked frames
        fwd_l = torch.clamp(fwd_g - off + window, 0, Tl + 2 * window - 1)
        bwd_l = torch.clamp(bwd_g - off + window, 0, Tl + 2 * window - 1)
        fwd = torch.gather(ext, 1, fwd_l[:, :, None].expand(B, Tl, D))
        bwd = torch.gather(ext, 1, bwd_l[:, :, None].expand(B, Tl, D))
        out = out + i * (fwd - bwd)
    return out / denom


def make_sp_feature_tail(mesh: Mesh, delta_order: int = 2, window: int = 2, norm_var: bool = True):
    """(base [B, Tl, D] this rank's frames, n_frames [B]) -> feats
    [B, Tl, D (1 + order)] of those frames: deltas (halo exchange) and masked
    utterance CMVN (sums over the ranks), equal to the offline tail."""

    def tail(base: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        B, Tl, D = base.shape
        if Tl < window:
            # a shard shorter than the halo window would ship a truncated
            # halo, and the clamped gathers would move VALID frames' indices
            raise ValueError(f"sequence-parallel shard length {Tl} < delta window {window}: use fewer "
                             "'seq' shards or longer T")
        nf = n_frames.to(base.device)
        feats, prev = [base], base
        for _ in range(delta_order):
            prev = _sp_delta_pass(prev, nf, window, mesh)
            feats.append(prev)
        out = torch.cat(feats, dim=-1)
        t = mesh.rank * Tl + torch.arange(Tl, device=base.device)[None, :]
        m = (t < nf[:, None]).to(out.dtype)[:, :, None]
        cnt = torch.clamp(comm.all_reduce(m.sum(dim=1, keepdim=True), mesh.group), min=1.0)
        mean = comm.all_reduce((out * m).sum(dim=1, keepdim=True), mesh.group) / cnt
        res = out - mean
        if norm_var:
            var = comm.all_reduce(((out - mean) ** 2 * m).sum(dim=1, keepdim=True), mesh.group) / cnt
            res = res / torch.sqrt(torch.clamp(var, min=1e-10))
        return res * m

    return tail


def make_sp_score_step(mesh: Mesh, apply_fn, delta_order: int = 2, window: int = 2, norm_var: bool = True):
    """The sharded tail chained into a per-frame scorer ``apply_fn(params,
    feats [N, Din]) -> [N, V]``: (params, base [B, Tl, D], n_frames) ->
    logits [B, Tl, V] of this rank's frames."""
    tail = make_sp_feature_tail(mesh, delta_order, window, norm_var)

    def step(params, base, n_frames):
        with torch.no_grad():
            feats = tail(base, n_frames)
            B, Tl, D = feats.shape
            return apply_fn(params, feats.reshape(B * Tl, D)).reshape(B, Tl, -1)

    return step

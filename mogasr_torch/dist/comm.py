"""The collectives of the multi-device steps, over plain ``torch.distributed``
calls, as ``torch.autograd.Function`` where a gradient crosses them.

The reference never writes a collective by hand where jit can derive it
(psum, all-gather, all_to_all, ppermute inside shard_map; its transposes come
from JAX). Here each one is explicit, with its backward:

- :func:`copy_to_group`, Megatron's f: identity forward, all-reduce backward;
- :func:`reduce_from_group`, Megatron's g: all-reduce forward, identity
  backward (``torch.distributed.nn``'s all_reduce reduces again backward,
  which would scale the gradients by the group size);
- :func:`gather_last`: all-gather along the last dimension of a tensor whose
  consumers compute the same on every rank; backward keeps this rank's slice;
- :func:`all_to_all`: equal blocks of the leading dimension exchanged,
  backward the same exchange of the gradients;
- :func:`ring_shift`: every rank's tensor to the rank ``shift`` places on
  (the reference's ``ppermute`` ring), backward the reverse shift;
- :func:`all_gather`: the tensors of every rank (no gradient), for the edge
  frames of a halo exchange and for small per-row values.

:func:`batch_count` is the denominator of the port's batch means: inside
:func:`batch_over` it is summed over the data-parallel group, so each rank's
mean is its share of the global one.

Gloo runs all-reduce and broadcast on CUDA tensors itself. All-gather and
all-to-all of a CUDA tensor over gloo go through a pinned host buffer
(:data:`GLOO_STAGED`): the copies are the only host work; every operation on
the data stays on the card. NCCL (one rank a card) takes every collective
as it is.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional

import torch
import torch.distributed as dist

# collectives that a CUDA tensor takes through the host over gloo
GLOO_STAGED = frozenset({"all_gather", "all_to_all"})
# (the process group of the batch means,), or None: a mean over this rank's rows
_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_group", default=None)


def _staged(op: str, t: torch.Tensor, group) -> bool:
    return t.is_cuda and op in GLOO_STAGED and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (a new tensor)."""
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in the group's rank order."""
    t = t.detach().contiguous()
    src = _host(t) if _staged("all_gather", t, group) else t
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    return [o.to(t.device, non_blocking=True) for o in outs]


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    src = _host(t) if _staged("all_to_all", t, group) else t
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device, non_blocking=True)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return torch.cat(all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return all_gather(x, group)[(dist.get_rank(group) - shift) % n]


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's f: ``x`` forward; the gradient summed over the group."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's g: ``x`` summed over the group forward; the gradient as it
    is (each rank differentiates its own term)."""
    return _ReduceFromGroup.apply(x, group)


def gather_last(x: torch.Tensor, group=None) -> torch.Tensor:
    """[..., w] on each rank -> [..., w * n] in rank order; backward keeps
    this rank's columns of a gradient that every rank holds whole."""
    return _GatherLast.apply(x, group)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Block i of the leading dimension (n equal blocks) goes to rank i; the
    result holds block ``rank`` of every rank, in rank order."""
    return _AllToAll.apply(x, group)


def ring_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """The ``x`` of rank (rank - shift) mod n: every rank sends to the rank
    ``shift`` places on. Over an all-gather (gloo has no send/recv of CUDA
    tensors); backward shifts the gradient back."""
    return _RingShift.apply(x, group, shift)


@contextlib.contextmanager
def batch_over(group):
    """Inside, :func:`batch_count` sums the batch means' counts over
    ``group``: the rows of the batch are sharded over its ranks."""
    token = _BATCH_GROUP.set((group,))
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_count(local: torch.Tensor) -> torch.Tensor:
    """max(count, 1) for the denominator of a mean over a batch: the count of
    this rank's rows, or inside :func:`batch_over` the count of the whole
    sharded batch (summed over the group, without a gradient). A mean over
    the local numerator then is this rank's share of the global mean: the
    shares sum to it, and so do their gradients."""
    box: Optional[tuple] = _BATCH_GROUP.get()
    if box is not None:
        local = all_reduce(local, box[0])
    return torch.clamp(local, min=1)

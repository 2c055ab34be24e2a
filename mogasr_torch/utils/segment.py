"""Deterministic scatter-sums: the statistics of EM, MMI and sMBR.

On a CUDA device ``index_add_`` and ``scatter_add_`` add floats with atomics,
so the order of each sum, and with it the float32 rounding, changes from run
to run: two EM runs over the same batches part after the first iteration.
These sums sort the contributions by their target once (a stable sort, so
each target keeps its contributions in position order) and reduce each
target's contiguous run with ``torch.segment_reduce``, which adds a segment's
elements one after another in that order on the card as on the CPU. The
result has the same bits on every run, and it is the order ``index_add_``
and ``scatter_add_`` take on the CPU, so there the sums equal theirs bit
for bit.
"""

from __future__ import annotations

import torch


def index_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """``zeros(n, ...).index_add_(0, index, values)`` in a fixed order:
    out[i] is the sum of the rows ``values[r]`` with ``index[r] == i``, added
    in increasing r. ``index`` holds N ids in [0, n) for the N rows, or -1
    for a row that adds to nothing (a padding frame): those sort last, past
    the last segment, and are never read, so they cost the reduction no time
    (the segment of the target they would otherwise join is the longest
    chain of additions)."""
    index = index.to(device=values.device, dtype=torch.int64)
    index = torch.where(index < 0, n, index)
    order = torch.argsort(index, stable=True)
    lengths = torch.bincount(index, minlength=n + 1)[:n]
    # unsafe: the lengths sum to the rows with a target, not to N (and the
    # check would cost a host sync)
    return torch.segment_reduce(values[order], "sum", lengths=lengths, axis=0, unsafe=True)


def collapse_columns(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """``zeros(B, T, n).scatter_add_(2, index[:, None].expand(B, T, J), values)``
    in a fixed order: values [B, T, J] and index [B, J] (the target of each
    column j of row b, in [0, n)) give [B, T, n], each target's columns
    added in increasing j: graph-state quantities collapsed to pdfs."""
    B, T, J = values.shape
    index = index.to(device=values.device, dtype=torch.int64)
    order = torch.argsort(index, dim=1, stable=True)                              # [B, J]
    rows = torch.arange(B, device=values.device)[:, None] * n
    lengths = torch.bincount((index + rows).reshape(-1), minlength=B * n).reshape(B, n)
    # columns in target order, frames innermost: each segment is a run of
    # whole [T] rows, read contiguously by the reduction
    data = torch.gather(values.transpose(1, 2), 1, order[:, :, None].expand(B, J, T))
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=1, unsafe=True).transpose(1, 2).contiguous()

"""A rank's view of its process group, and the moves of data onto it: the
port of mogasr/dist/mesh.py.

The reference builds a ``jax.sharding.Mesh`` over devices of one process and
lets jit place arrays by their shardings. Here each rank is a process
(``dist.launch.run_ranks``), a :class:`Mesh` names its group, its index in
it and its device, and the moves are explicit: :func:`shard_batch` keeps
this rank's rows of the leading dimension (the reference's ``P('data')``),
:func:`replicate` broadcasts from the group's first rank (``P()``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mogasr_torch.config import MeshConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of ranks: ``ranks`` (global ranks, in the axis's order) of
    ``group`` (None: the default group), this process at index ``rank``,
    computing on ``device``."""

    axis: str
    group: Optional[dist.ProcessGroup]
    ranks: Tuple[int, ...]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def _device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" means this process's current
    card, and raises when there is none (the CPU only when asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"a mesh on {device} needs a CUDA card; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def axis_mesh(axis: str, ranks: Sequence[int], device="cuda", group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The :class:`Mesh` of this process over global ``ranks`` (``group`` the
    process group over exactly them; None when they are the whole world)."""
    ranks = tuple(int(r) for r in ranks)
    return Mesh(axis, group, ranks, ranks.index(dist.get_rank()), _device(device))


def make_mesh(cfg: Optional[MeshConfig] = None, device="cuda") -> Optional[Mesh]:
    """The 1-D ``(cfg.data_axis,)`` mesh over the first ``cfg.num_devices``
    ranks (0: all). Every rank must call it (a smaller mesh is a new group,
    which the whole world creates); a rank outside the mesh gets None."""
    cfg = cfg or MeshConfig()
    world = dist.get_world_size()
    n = cfg.num_devices if cfg.num_devices > 0 else world
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return axis_mesh(cfg.data_axis, range(n), device, group)


def tree_map(fn, tree):
    """``fn`` on every leaf (tensor, array, number) of nested dicts, lists,
    tuples and NamedTuples, keeping their types."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x, device: torch.device) -> torch.Tensor:
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def data_rows(n: int, mesh: Mesh) -> slice:
    """The rows of an ``n``-row batch that this rank holds (the reference's
    ``data_sharding``): equal contiguous blocks in rank order."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not shard over {mesh.size} ranks (pad_to_multiple first)")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every leaf's leading dimension, as tensors on the
    mesh's device."""
    return tree_map(lambda a: _tensor(a[data_rows(len(a), mesh)], mesh.device), tree)


def replicate(tree, mesh: Mesh):
    """Every leaf broadcast from the mesh's first rank, as tensors on the
    mesh's device; an ``nn.Module`` is moved there and its parameters and
    buffers broadcast in place."""
    if isinstance(tree, nn.Module):
        tree.to(mesh.device)
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                dist.broadcast(t.data, src=mesh.ranks[0], group=mesh.group)
        return tree

    def bcast(a):
        t = _tensor(a, mesh.device).contiguous()
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=mesh.ranks[0], group=mesh.group)
        return t

    return tree_map(bcast, tree)


def pad_to_multiple(arr: np.ndarray, multiple: int, fill=0):
    """Pad leading dim to a multiple (shardability); returns (padded, orig_n)."""
    n = arr.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr, n
    pad_shape = (target - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)]), n

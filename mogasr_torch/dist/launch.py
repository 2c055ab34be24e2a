"""Run one function on every rank of a process group, one process a rank.

The reference fakes its devices inside one process (JAX's host platform
device count); ``torch.distributed`` needs a process per rank, so this module
has no counterpart in mogasr/dist/. :func:`run_ranks` starts the ranks with
the ``spawn`` method (the caller may hold CUDA contexts and threads), meets
them through a ``file://`` rendezvous in a fresh temporary directory (no
fixed port: several launches may run at once), gives each a deadline, and
returns each rank's result as numpy.

A rank's body is a module-level function ``fn(rank, mesh, *args)`` of this
package (it is pickled by its import path), so the ranks import the port and
nothing else. On the card every rank uses ``cuda:<rank mod the card
count>``: more ranks than cards run over gloo (NCCL refuses two ranks on one
card), one rank a card over NCCL.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class RankError(RuntimeError):
    """A rank failed or missed its deadline; the message holds each failed
    rank's traceback."""


def to_numpy(tree):
    """Tensors -> numpy arrays (from any device), through dicts, lists,
    tuples and NamedTuples; anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def default_backend(device: str, world_size: int) -> str:
    """NCCL for one rank a card, gloo otherwise (the CPU, or several ranks
    sharing a card)."""
    cuda = torch.device(device).type == "cuda"
    return "nccl" if cuda and world_size <= torch.cuda.device_count() else "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: the CPU, or card rank mod the
    number of cards."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class _RankSpec:
    fn: Callable
    world_size: int
    backend: str
    device: str
    init_path: str
    out_dir: str
    timeout_s: float
    # the arguments, pickled by value into a file: multiprocessing would share CPU tensors' memory with
    # the caller, and the spawn pipe would block the caller for good on a child that dies before reading
    args_path: str


def _rank_main(spec: _RankSpec, rank: int) -> None:
    """A rank's process: join the group, run the body, write its result."""
    from mogasr_torch.config import MeshConfig
    from mogasr_torch.dist.mesh import make_mesh

    try:
        torch.set_num_threads(1)
        dev = rank_device(spec.device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(spec.backend, init_method=f"file://{spec.init_path}", world_size=spec.world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=spec.timeout_s))
        with open(spec.args_path, "rb") as f:
            args = pickle.load(f)
        out = to_numpy(spec.fn(rank, make_mesh(MeshConfig(), dev), *args))
        with open(os.path.join(spec.out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(spec.out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world_size: int, *, device: str = "cuda", backend: Optional[str] = None,
              timeout_s: float = 300.0, args: Sequence[Any] = ()) -> List[Any]:
    """``fn(rank, mesh, *args)`` on ``world_size`` ranks -> each rank's result
    as numpy (:func:`to_numpy`), in rank order.

    ``device`` "cuda" (the default) or "cpu"; ``backend`` defaults to
    :func:`default_backend`. ``timeout_s`` bounds both every collective (the
    process group's timeout) and the whole launch: past it, or as soon as
    one rank fails, every rank is killed and :class:`RankError` raised with
    the failed ranks' tracebacks.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: device 'cuda' asked for, but torch sees no CUDA device")
    backend = backend or default_backend(device, world_size)
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"NCCL puts one rank on a card: {world_size} ranks, "
                         f"{torch.cuda.device_count()} cards (use gloo)")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mogasr_ranks_") as tmp:
        spec = _RankSpec(fn, world_size, backend, str(device), os.path.join(tmp, "rendezvous"), tmp,
                         float(timeout_s), os.path.join(tmp, "args.pkl"))
        with open(spec.args_path, "wb") as f:
            pickle.dump(tuple(args), f)
        procs = [ctx.Process(target=_rank_main, args=(spec, r), daemon=True) for r in range(world_size)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed or all(c == 0 for c in codes):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RankError(f"{world_size} ranks ({backend}) missed their {timeout_s:.0f} s deadline; "
                                    f"still running: {[r for r, c in enumerate(codes) if c is None]}"
                                    + _errors(tmp, range(world_size)))
                mp.connection.wait([p.sentinel for p in procs if p.exitcode is None], timeout=min(left, 1.0))
            if failed:
                raise RankError(f"rank(s) {failed} of {world_size} ({backend}) failed with exit codes "
                                f"{[codes[r] for r in failed]}" + _errors(tmp, failed))
            out = []
            for r in range(world_size):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            started = [p for p in procs if p.pid is not None]
            for p in started:
                if p.is_alive():
                    p.kill()
            for p in started:
                p.join(timeout=10)


def _errors(tmp: str, ranks) -> str:
    parts = []
    for r in ranks:
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                parts.append(f"\n--- rank {r} ---\n{f.read()}")
    return "".join(parts)


def ranks_equal(results: Sequence[Any]) -> bool:
    """Whether every rank returned the same bits (numpy trees)."""
    def same(a, b) -> bool:
        if isinstance(a, np.ndarray):
            return isinstance(b, np.ndarray) and a.shape == b.shape and a.dtype == b.dtype and \
                a.tobytes() == b.tobytes()
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return isinstance(b, (list, tuple)) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    return all(same(results[0], r) for r in results[1:])

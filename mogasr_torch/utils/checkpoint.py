"""Checkpoint / resume for the port: its own format, in place of the
reference's orbax checkpoints (mogasr/utils/checkpoint.py), which need jax.

A checkpoint directory holds one subdirectory per saved step, ``step_<n>/``,
with ``state.npz`` (every leaf of the saved tree as a numpy array, keyed by
its path, e.g. ``gmm/means``) and ``meta.json`` (the step, the format version
and the tree's keys). A step is written into a temporary directory beside it,
its files flushed to disk, then renamed into place with ``os.replace``: a job
killed while saving leaves the previous steps as they were and no partial
``step_<n>``.

The tree is a nest of dicts whose leaves are arrays, tensors, numbers or
lists of numbers. Restoring needs no template: it returns the same nest of
dicts with numpy arrays as leaves (a saved number comes back as a 0-d
array), so shapes that grew while training (a GMM's components) restore as
saved.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

FORMAT_VERSION = 1
_STEP_DIR = re.compile(r"^step_(\d+)$")
_SEP = "/"


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str) or not k or _SEP in k:
                raise ValueError(f"checkpoint keys must be non-empty strings without {_SEP!r}, got {k!r}")
            _flatten(v, f"{prefix}{k}{_SEP}", out)
        return
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    arr = np.asarray(tree)
    if arr.dtype.kind not in "biuf":
        raise ValueError(f"checkpoint leaf {prefix[:-1]!r} is not numeric: {type(tree).__name__}")
    out[prefix[:-1]] = arr


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def step_dir(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{int(step)}")


def save_checkpoint(path: str, tree: Any, step: int = 0, force: bool = True) -> None:
    """Atomically save ``tree`` as step ``step`` under ``path``; an existing
    step is replaced when ``force``, else it raises FileExistsError."""
    if not isinstance(tree, dict):
        raise ValueError("a checkpoint tree is a dict")
    leaves: Dict[str, np.ndarray] = {}
    _flatten(tree, "", leaves)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    final = step_dir(path, step)
    if os.path.exists(final) and not force:
        raise FileExistsError(f"checkpoint step {step} exists under {path}")
    tmp = tempfile.mkdtemp(prefix=f".step_{int(step)}.", dir=path)
    try:
        with open(os.path.join(tmp, "state.npz"), "wb") as f:
            np.savez(f, **leaves)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"format_version": FORMAT_VERSION, "step": int(step), "keys": sorted(leaves)}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync(path)


def all_steps(path: str) -> List[int]:
    """Every complete step saved under ``path``, ascending."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        m = _STEP_DIR.match(name)
        if m and os.path.isfile(os.path.join(path, name, "meta.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(path: str) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None


def restore_checkpoint(path: str, template: Any = None, step: Optional[int] = None) -> Dict[str, Any]:
    """Restore the latest (or the given) step -> the saved nest of dicts with
    numpy leaves. ``template`` is accepted for the reference's signature and
    unused: the saved structure is returned as it was saved."""
    del template
    if step is None:
        step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {os.path.abspath(path)}")
    d = step_dir(path, step)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint format {meta.get('format_version')!r} in {d}")
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(d, "state.npz")) as z:
        if sorted(z.files) != meta["keys"]:
            raise ValueError(f"checkpoint {d}: state.npz does not hold the keys meta.json lists")
        for key in z.files:
            node = tree
            *parents, leaf = key.split(_SEP)
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree

"""Run metrics, timing and profiling for the port: mogasr/utils/metrics.py
with the card in place of the TPU.

- ``RunLogger`` appends one JSON record per event to
  ``<run_dir>/metrics.jsonl`` (the reference's records and file), echoing it
  to stdout.
- ``Timer`` measures wall seconds with the CUDA device synchronised at both
  edges, where the reference fences the TPU, so device work queued inside
  the block is counted.
- ``trace`` records a ``torch.profiler`` trace (CPU and CUDA activity) into a
  directory, the port's form of ``jax.profiler.trace``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


class RunLogger:
    def __init__(self, run_dir: str, echo: bool = True):
        self.run_dir = run_dir
        self.echo = echo
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record, time=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=_to_py) + "\n")
        if self.echo:
            short = {k: v for k, v in record.items() if k != "time"}
            print(json.dumps(short, default=_to_py), flush=True)


def _to_py(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def device_fence() -> None:
    """Wait for all work queued on the CUDA devices this process uses; a
    no-op when it has used none."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer that waits for the card at both edges."""

    def __enter__(self):
        device_fence()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        device_fence()
        self.seconds = time.perf_counter() - self.t0
        return False


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the block into ``log_dir/trace.json`` (a
    Chrome/Perfetto trace) when log_dir is given; a no-op otherwise."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        device_fence()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def rtf(audio_seconds: float, wall_seconds: float) -> float:
    """Real-time factor: processing time / audio time (lower is better)."""
    return wall_seconds / max(audio_seconds, 1e-9)

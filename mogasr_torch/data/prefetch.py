"""Prefetching input pipeline: the port of mogasr/data/prefetch.py.

The host stages the NEXT batch (audio decode, framing, the copy to the card)
while the device is still busy with the current one. Python threads do it:
the host side is IO and NumPy (which release the GIL) and CUDA launches are
asynchronous, so a bounded-queue producer thread overlaps without processes.

- ``prefetch(iterable, depth)``: order-preserving bounded lookahead; the
  producer thread runs ``depth`` items ahead. Exceptions raised by the
  producer re-raise at the consumer's ``next()``, and a consumer that stops
  early releases the producer.
- ``device_put_batches(batches, device)``: copies each FeatBatch's tensors to
  the card ahead of use, from pinned host memory with ``non_blocking=True``,
  so the consumer's first op on a batch finds them there or on their way on
  the current stream (for batches built on the host, e.g. read from an
  archive; ``featurize_iter`` on the card makes them there).
- ``pipeline.featurize_iter``: the lazy generator the above compose with
  (``featurize`` is ``list(featurize_iter(...))``).

Usage (the eval-sweep shape)::

    batches = prefetch(featurize_iter(corpus, fcfg, bcfg, torch.device("cuda")))
    metrics = evaluate(batches, gmm, lex, topo, dcfg)   # single pass
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, TypeVar

import torch

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from ``iterable`` with a background thread running ``depth``
    items ahead. Order-preserving; producer exceptions re-raise here."""
    if depth <= 0:
        yield from iterable
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        # timed puts, so an abandoned consumer (generator closed early)
        # releases this thread instead of pinning it on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 -- re-raised at the consumer
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                t.join()
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def _to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def device_put_batches(batches: Iterable, device: torch.device) -> Iterator:
    """Each FeatBatch with its ``feats`` and ``n_frames`` on ``device``;
    a copy to the card leaves from pinned memory without blocking the host."""
    for fb in batches:
        yield dataclasses.replace(fb, feats=_to_device(fb.feats, device), n_frames=_to_device(fb.n_frames, device))

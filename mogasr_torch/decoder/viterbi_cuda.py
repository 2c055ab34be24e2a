"""Viterbi decode on the CUDA kernel ``csrc/viterbi.cu`` (kernel K2): the port
of mogasr/decoder/viterbi_pallas.py.

A drop-in for ``decoder.viterbi.viterbi`` on chain+loop graphs, with or
without CTC skip transitions (``skip_logp``; the reference kernel has no such
arm), a beam and a backtrace, bitwise equal to it. A CUDA tensor runs the
kernel, a CPU tensor the plain version; any other device raises. ``LAUNCHES``
counts kernel launches (one per call with B * T > 0, the forward pass and the
backtrace in one kernel; an empty batch launches none). Without a backtrace
the kernel stores no backpointers and the result's path is zeros, as the
plain version's. ``LAST_ARMS`` is the last call's [B] int32 tensor on the
card: the arm each row took, ``ARM_CHAIN`` for a row without a loop arc (an
align graph) on the register chain arm, ``ARM_LOOP`` for a row with one (the
word loop: the compact exit set), ``ARM_BLOCK`` for a row without one too
wide for the chain arm. :func:`align` is forced alignment: the same call
that also returns each frame's pdf (``decoder.viterbi.path_to_pdfs``), which
the kernel writes in its backtrace.

The graph arrays go to the kernel as ``graphs_to_torch`` makes them from
``batch_graphs``: ``emit_id`` int32, the log-probs (``skip_logp`` too, where
the graphs have it) float32, contiguous, on
the device of ``emit_ll``. They are checked, never converted, so a graph
built once serves every batch without a copy. The kernel itself stops (a
device trap, as an out-of-range index does in ``torch.gather``) on an
``emit_id`` outside [0, P), and rejects J above the limit in viterbi.cu.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from mogasr_torch import _cuda
from mogasr_torch.decoder import viterbi as plain
from mogasr_torch.decoder.viterbi import ViterbiResult

LAUNCHES = 0
ARM_CHAIN, ARM_LOOP, ARM_BLOCK = 0, 1, 2
LAST_ARMS: Optional[torch.Tensor] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "viterbi_decode": [_P, _I, _I, _I, _F, _F] + [_P] * 9 + [_I] + [_P] * 8,
}
_GRAPH_KEYS = ("emit_id", "self_logp", "adv_logp", "enter_logp", "exit_logp",
               "init_logp", "final_logp")


def check_graphs(graphs: Dict[str, torch.Tensor], keys, B: int, dev: torch.device) -> int:
    """Check the graph arrays a kernel reads (``emit_id`` int32, the rest
    float32, contiguous [B, J] on ``dev``) and return J."""
    J = graphs["emit_id"].shape[1]
    for k in keys:
        a = graphs[k]
        dtype = torch.int32 if k == "emit_id" else torch.float32
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != (B, J) or not a.is_contiguous():
            raise ValueError(f"graphs[{k!r}] must be contiguous {dtype} [{B}, {J}] on {dev}, "
                             f"got {a.dtype} {list(a.shape)} on {a.device}")
    return J


def viterbi(
    emit_ll: torch.Tensor,            # [B, T, P] pdf log-likelihoods
    graphs: Dict[str, torch.Tensor],  # graphs_to_torch(batch_graphs(...))
    n_frames: torch.Tensor,           # [B]
    acoustic_scale: float = 1.0,
    beam: float = 0.0,
    with_backtrace: bool = True,
) -> ViterbiResult:
    if emit_ll.device.type == "cpu":
        return plain.viterbi(emit_ll, graphs, n_frames, acoustic_scale=acoustic_scale, beam=beam,
                             with_backtrace=with_backtrace)
    return _decode(emit_ll, graphs, n_frames, acoustic_scale, beam, with_backtrace, False)[0]


def align(
    emit_ll: torch.Tensor,
    graphs: Dict[str, torch.Tensor],
    n_frames: torch.Tensor,
    acoustic_scale: float = 1.0,
) -> Tuple[ViterbiResult, torch.Tensor]:
    """Forced alignment: ``viterbi`` and the [B, T] pdf of each frame's state
    (-1 past n_frames), ``decoder.viterbi.path_to_pdfs`` of its result."""
    if emit_ll.device.type == "cpu":
        res = plain.viterbi(emit_ll, graphs, n_frames, acoustic_scale=acoustic_scale)
        return res, plain.path_to_pdfs(res, graphs)
    return _decode(emit_ll, graphs, n_frames, acoustic_scale, 0.0, True, True)


def _decode(emit_ll, graphs, n_frames, acoustic_scale, beam, with_backtrace, with_pdfs):
    global LAUNCHES, LAST_ARMS
    if emit_ll.device.type != "cuda":
        raise ValueError(f"viterbi: unsupported device {emit_ll.device}")
    if emit_ll.dim() != 3 or emit_ll.dtype != torch.float32:
        raise ValueError(f"emit_ll must be float32 [B, T, P], got {emit_ll.dtype} {tuple(emit_ll.shape)}")
    B, T, P = emit_ll.shape
    dev = emit_ll.device
    skip = graphs.get("skip_logp")
    J = check_graphs(graphs, _GRAPH_KEYS + (() if skip is None else ("skip_logp",)), B, dev)
    ll = emit_ll.contiguous()
    nf = n_frames.to(device=dev, dtype=torch.int32).contiguous()

    score = torch.empty((B,), dtype=torch.float32, device=dev)
    arms = torch.empty((B,), dtype=torch.int32, device=dev)
    pdfs = torch.empty((B, T), dtype=torch.int32, device=dev) if with_pdfs else None
    if with_backtrace:
        # the codes' two bit planes per 32-state group, and the exit argmax per frame
        bp = torch.empty((B, T, -(-J // 32), 2), dtype=torch.int32, device=dev)
        exit_arg = torch.empty((B, T), dtype=torch.int32, device=dev)
        path = torch.empty((B, T), dtype=torch.int32, device=dev)
        entered = torch.empty((B, T), dtype=torch.bool, device=dev)
        scratch = [t.data_ptr() for t in (bp, exit_arg, path, entered)]
    else:  # NULL bp, exit_arg, path and entered: the forward pass alone
        scratch = [None, None, None, None]
    lib = _cuda.load("viterbi", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.viterbi_decode(
            ll.data_ptr(), B, T, P, float(acoustic_scale), float(beam),
            *(graphs[k].data_ptr() for k in _GRAPH_KEYS), None if skip is None else skip.data_ptr(),
            nf.data_ptr(), J, *scratch, None if pdfs is None else pdfs.data_ptr(), score.data_ptr(),
            arms.data_ptr(), stream,
        )
    _cuda.check(lib, "viterbi", err, "viterbi_decode launch")
    LAUNCHES += int(B * T > 0)  # the entry point returns at once on an empty batch
    LAST_ARMS = arms
    if not with_backtrace:
        path = torch.zeros((B, T), dtype=torch.int32, device=dev)
        entered = path.to(torch.bool)
    return ViterbiResult(path, entered, score), pdfs

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

The online decoder (``decoder/online.py``) and the serving engine
(``serving/engine.py``) run the kernel's chunk arm, :func:`chunk_step`
(``CHUNK_LAUNCHES``, one per chunk), which carries delta and started across
chunks and stores the codes in a per-stream buffer on the card, each row at
its own frame offset, and :func:`backtrace` (``BACKTRACE_LAUNCHES``, one per
partial or final result), the kernel's backtrace alone over that buffer.
Both run their plain versions on CPU tensors.

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

import numpy as np
import torch

from mogasr_torch import _cuda
from mogasr_torch.decoder import viterbi as plain
from mogasr_torch.decoder.viterbi import ViterbiResult

LAUNCHES = 0
CHUNK_LAUNCHES = 0
BACKTRACE_LAUNCHES = 0
ARM_CHAIN, ARM_LOOP, ARM_BLOCK = 0, 1, 2
LAST_ARMS: Optional[torch.Tensor] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "viterbi_decode": [_P, _I, _I, _I, _F, _F] + [_P] * 9 + [_I] + [_P] * 8,
    "viterbi_chunk": [_P, _I, _I, _I, _F, _F] + [_P] * 9 + [_I] + [_P] * 5 + [_I, _P, _P],
    "viterbi_backtrace": [_I, _I] + [_P] * 5 + [_I, _I] + [_P] * 4,
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
        bp = torch.empty(_code_shape(B, T, J), dtype=torch.int32, device=dev)
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


def _code_shape(B: int, frames: int, J: int) -> Tuple[int, int, int, int]:
    """The code planes' shape: per row and frame, two int32 bit planes for
    each group of 32 states."""
    return (B, frames, -(-J // 32), 2)


def code_frame_bytes(J: int) -> int:
    """Bytes one stream's frame takes in the code buffers: the two code
    planes and the exit argmax."""
    return -(-J // 32) * 2 * 4 + 4


def code_buffers(B: int, J: int, cap: int, device, keep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed stream buffers of ``cap`` frames for :func:`chunk_step` and
    :func:`backtrace`: the code planes [B, cap, ceil(J / 32), 2] int32 and
    the exit argmax [B, cap] int32. ``keep`` = (bp, exit_arg, frames) copies
    the first ``frames`` frames of smaller buffers in (to grow them)."""
    bp = torch.zeros(_code_shape(B, cap, J), dtype=torch.int32, device=device)
    exit_arg = torch.zeros((B, cap), dtype=torch.int32, device=device)
    if keep is not None:
        old_bp, old_exit_arg, frames = keep
        bp[:, :frames] = old_bp[:, :frames]
        exit_arg[:, :frames] = old_exit_arg[:, :frames]
    return bp, exit_arg


def unpack_codes(bp: torch.Tensor, frames: slice, J: int) -> torch.Tensor:
    """The 2-bit code planes [B, cap, ceil(J / 32), 2] of ``frames`` as uint8
    codes [frames, B, J] (0 stay, 1 advance, 2 enter, 3 skip), the layout of
    the plain chunk step's backpointers."""
    p = bp[:, frames].to(torch.int64) & 0xFFFFFFFF
    j = torch.arange(J, device=bp.device)
    lo = (p[..., 0][:, :, j // 32] >> (j % 32)) & 1
    hi = (p[..., 1][:, :, j // 32] >> (j % 32)) & 1
    return (lo | (hi << 1)).to(torch.uint8).permute(1, 0, 2)


def to_device(a, device: torch.device, dtype=torch.int32) -> torch.Tensor:
    """A host array as a tensor on ``device``; to the card from pinned memory
    without blocking, so that the host does not wait for the card."""
    t = torch.from_numpy(np.array(a)).to(dtype)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes [frames, B, J] as the code planes [B, frames, ceil(J / 32),
    2] int32: :func:`unpack_codes`'s inverse."""
    F, B, J = codes.shape
    G = -(-J // 32)
    c = torch.zeros((F, B, G * 32), dtype=torch.int64, device=codes.device)
    c[..., :J] = codes.to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=codes.device)
    planes = [(((c >> k) & 1).reshape(F, B, G, 32) << shift).sum(-1) for k in (0, 1)]
    p = torch.stack(planes, dim=-1)
    return torch.where(p >= 2 ** 31, p - 2 ** 32, p).to(torch.int32).permute(1, 0, 2, 3)


def chunk_step(
    delta: torch.Tensor,              # [B, J] float32, carried in and out (in place)
    started: torch.Tensor,            # [B] bool, carried in and out (in place)
    emit_ll: torch.Tensor,            # [B, Tc, P] float32: the chunk's scores
    n_valid: torch.Tensor,            # [B] int32: valid frames of the chunk (on the host: checked per row)
    graphs: Dict[str, torch.Tensor],
    acoustic_scale: float,
    beam: float,
    bp: torch.Tensor,                 # code_buffers(B, J, t_cap): the code planes
    exit_arg: torch.Tensor,           # and the exit argmax
    frame0,                           # [B] on the host (or an int for every row): row b's frame of its chunk frame 0
) -> None:
    """The online decoder's chunk step: ``decoder.online.chunk_step``, with
    row b's codes and exit argmax of its valid frames written into the stream
    buffers at frames ``frame0[b] ..`` instead of returned (the frame a row
    starts at excepted: the backtrace never reads it). The rows' offsets may
    all differ: a batch of sessions at ragged lengths, a reused row back at 0.

    On the card the kernel's chunk arm; on the CPU the plain step, its codes
    packed and scattered at the offsets. ``frame0`` is the host's mirror of
    the offsets, copied to the card without blocking; every row must fit,
    frame0[b] + n_valid[b] <= t_cap (with n_valid on the card, frame0[b] + Tc),
    and is checked here, so the launch reads nothing back."""
    global CHUNK_LAUNCHES, LAST_ARMS
    if emit_ll.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chunk_step: unsupported device {emit_ll.device}")
    if emit_ll.dim() != 3 or emit_ll.dtype != torch.float32:
        raise ValueError(f"emit_ll must be float32 [B, Tc, P], got {emit_ll.dtype} {tuple(emit_ll.shape)}")
    B, Tc, P = emit_ll.shape
    dev = emit_ll.device
    skip = graphs.get("skip_logp")
    J = check_graphs(graphs, _GRAPH_KEYS + (() if skip is None else ("skip_logp",)), B, dev)
    t_cap = bp.shape[1]
    for name, t, shape, dtype in (("delta", delta, (B, J), torch.float32), ("started", started, (B,), torch.bool),
                                  ("bp", bp, _code_shape(B, t_cap, J), torch.int32),
                                  ("exit_arg", exit_arg, (B, t_cap), torch.int32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {list(shape)} on {dev}, "
                             f"got {t.dtype} {list(t.shape)} on {t.device}")
    f0 = np.broadcast_to(np.asarray(frame0, np.int64), (B,))
    ends = f0 + (n_valid.numpy().astype(np.int64) if n_valid.device.type == "cpu" else Tc)
    if B and (f0.min() < 0 or ends.max() > t_cap):
        raise ValueError(f"chunk_step: a row's frames [frame0, frame0 + n_valid) leave the buffers' {t_cap} frames "
                         f"(frame0 {f0.min()}..{f0.max()}, ends up to {ends.max()})")
    if dev.type == "cpu":
        _plain_chunk_step(delta, started, emit_ll, n_valid, graphs, acoustic_scale, beam, bp, exit_arg, f0)
        return
    nv = n_valid.to(torch.int32) if n_valid.device == dev else to_device(n_valid.numpy(), dev)
    f0_dev = to_device(f0, dev)
    ll = emit_ll.contiguous()
    arms = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _cuda.load("viterbi", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.viterbi_chunk(
            ll.data_ptr(), B, Tc, P, float(acoustic_scale), float(beam),
            *(graphs[k].data_ptr() for k in _GRAPH_KEYS), None if skip is None else skip.data_ptr(),
            nv.contiguous().data_ptr(), J, delta.data_ptr(), started.data_ptr(), bp.data_ptr(),
            exit_arg.data_ptr(), f0_dev.data_ptr(), t_cap, arms.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(lib, "viterbi", err, "viterbi_chunk launch")
    CHUNK_LAUNCHES += int(B * Tc > 0)
    LAST_ARMS = arms


def _plain_chunk_step(delta, started, emit_ll, n_valid, graphs, acoustic_scale, beam, bp, exit_arg, f0) -> None:
    """chunk_step on the CPU: the plain step, its codes scattered at the rows'
    offsets, as the kernel stores them."""
    from mogasr_torch.decoder import online

    B, Tc, _P = emit_ll.shape
    was = started.clone()
    d, s, bps, xas = online.chunk_step(delta, started, emit_ll, n_valid, graphs, acoustic_scale, beam)
    delta.copy_(d)
    started.copy_(s)
    planes = pack_codes(bps)
    nv = n_valid.to(torch.int64)
    for b in range(B):
        lo = 0 if bool(was[b]) else 1
        n = int(nv[b])
        if n > lo:
            bp[b, f0[b] + lo:f0[b] + n] = planes[b, lo:n]
            exit_arg[b, f0[b] + lo:f0[b] + n] = xas[lo:n, b]


def backtrace(
    delta: torch.Tensor,                   # [B, J] float32
    final_logp: Optional[torch.Tensor],    # [B, J] float32, or None: a partial result
    n_frames: torch.Tensor,                # [B] int32: each stream's frames so far
    bp: torch.Tensor,                      # chunk_step's buffers
    exit_arg: torch.Tensor,
    t_out: int,                            # frames of the result (the buffers' frames so far)
) -> ViterbiResult:
    """The kernel's backtrace alone over ``chunk_step``'s buffers, from the
    first-index argmax of delta (+ final_logp): (path [B, t_out] int32, -1
    past n_frames; entered; score [B], that maximum)."""
    global BACKTRACE_LAUNCHES
    dev = delta.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"backtrace: unsupported device {dev}")
    B, J = delta.shape
    t_cap = bp.shape[1]
    if not 0 <= t_out <= t_cap:
        raise ValueError(f"t_out {t_out} outside [0, {t_cap}]")
    if final_logp is not None and (final_logp.dtype != torch.float32 or tuple(final_logp.shape) != (B, J)
                                   or not final_logp.is_contiguous() or final_logp.device != dev):
        raise ValueError(f"final_logp must be contiguous float32 [{B}, {J}] on {dev}")
    if dev.type == "cpu":
        return _plain_backtrace(delta, final_logp, n_frames, bp, exit_arg, t_out)
    nf = n_frames.to(torch.int32) if n_frames.device == dev else to_device(n_frames.cpu().numpy(), dev)
    path = torch.empty((B, t_out), dtype=torch.int32, device=dev)
    entered = torch.empty((B, t_out), dtype=torch.bool, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = _cuda.load("viterbi", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.viterbi_backtrace(
            B, J, delta.contiguous().data_ptr(), None if final_logp is None else final_logp.data_ptr(),
            nf.data_ptr(), bp.data_ptr(), exit_arg.data_ptr(), t_cap, int(t_out), path.data_ptr(),
            entered.data_ptr(), score.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(lib, "viterbi", err, "viterbi_backtrace launch")
    BACKTRACE_LAUNCHES += int(B > 0)
    return ViterbiResult(path, entered, score)


def _plain_backtrace(delta, final_logp, n_frames, bp, exit_arg, t_out) -> ViterbiResult:
    """backtrace on the CPU: the host walk of the reference's online decoder
    over the unpacked codes."""
    B, J = delta.shape
    scores = delta + final_logp if final_logp is not None else delta
    j_last = scores.argmax(dim=1).numpy()
    codes = unpack_codes(bp, slice(0, t_out), J).numpy()   # [t_out, B, J]
    xa = exit_arg[:, :t_out].numpy()
    nf = np.clip(np.asarray(n_frames, np.int64).reshape(B), 0, t_out)
    path = np.full((B, t_out), -1, np.int32)
    entered = np.zeros((B, t_out), bool)
    for b in range(B):
        n = int(nf[b])
        if n == 0:
            continue
        j = int(j_last[b])
        for t in range(n - 1, 0, -1):
            path[b, t] = j
            code = codes[t, b, j]
            entered[b, t] = code == 2
            if code == 1:
                j -= 1
            elif code == 3:
                j -= 2
            elif code == 2:
                j = int(xa[b, t])
        path[b, 0] = j
        entered[b, 0] = True
    return ViterbiResult(torch.from_numpy(path), torch.from_numpy(entered), scores.max(dim=1).values)

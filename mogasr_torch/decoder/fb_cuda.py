"""Forward-backward on the CUDA kernels ``csrc/forward_backward.cu`` (K3f, the
forward pass, K3b, the backward pass, and their combine): the port of
mogasr/decoder/fb_pallas.py.

A drop-in for ``decoder.forward_backward.forward_backward`` on chain+loop
graphs, with or without CTC skip transitions (``skip_logp``; the reference
kernels have no such arm), equal to it to a float tolerance (the logsumexp
over states sums in another order). A CUDA tensor runs the kernels, a CPU
tensor the plain version; any other device raises.

On the card a call runs K3f on the current stream and K3b, which needs no
alphas, on a second stream at the same time, and after both the combine
kernel, which turns the alphas (written into the result's buffer) and the
betas (a scratch of the same size) into ``(alpha + beta) - loglik``. The
current stream waits for all of it; nothing synchronises with the host. ``FWD_LAUNCHES``, ``BWD_LAUNCHES``
and ``COMBINE_LAUNCHES`` count the launches of the three kernels (one each
per call with B * T > 0; an empty batch launches none). ``LAST_ARMS`` is the
last call's [2, B] int32 tensor on the card: the arm each row took in K3f
(row 0) and K3b (row 1), ``ARM_CHAIN`` for a row without a loop arc on the
narrow chain arm, ``ARM_BLOCK`` for one too wide for it, ``ARM_GENERAL`` for
a row with a loop arc (forward_backward.cu says why the first two are
exact).

The kernels have no autograd backward: on the card a call with grad mode on
and an ``emit_ll`` that requires grad raises (``_cuda.refuse_grad``);
``am.nn_seq.FbLoglik`` and ``SmbrAcc`` carry the gradients of the sequence
criteria through them by the posterior identities.

The graph arrays go to the kernels as ``graphs_to_torch`` makes them
(``emit_id`` int32, the log-probs and any ``skip_logp`` float32, contiguous,
on the device of ``emit_ll``); they are checked, never converted. An
``emit_id`` outside [0, P) stops the kernels (a device trap); J above the
limit in forward_backward.cu is rejected.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from mogasr_torch import _cuda
from mogasr_torch.decoder import forward_backward as plain
from mogasr_torch.decoder.forward_backward import FBResult
from mogasr_torch.decoder.viterbi_cuda import check_graphs

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
COMBINE_LAUNCHES = 0
ARM_CHAIN, ARM_BLOCK, ARM_GENERAL = 0, 1, 2
LAST_ARMS: Optional[torch.Tensor] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"fb_forward_backward": [_P, _I, _I, _I, _F] + [_P] * 9 + [_I] + [_P] * 6}
_GRAPH_KEYS = ("emit_id", "self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp")
_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def forward_backward(
    emit_ll: torch.Tensor,            # [B, T, P] pdf log-likelihoods
    graphs: Dict[str, torch.Tensor],  # graphs_to_torch(batch_graphs(...))
    n_frames: torch.Tensor,           # [B]
    acoustic_scale: float = 1.0,
) -> FBResult:
    global FWD_LAUNCHES, BWD_LAUNCHES, COMBINE_LAUNCHES, LAST_ARMS
    if emit_ll.device.type == "cpu":
        return plain.forward_backward(emit_ll, graphs, n_frames, acoustic_scale=acoustic_scale)
    if emit_ll.device.type != "cuda":
        raise ValueError(f"forward_backward: unsupported device {emit_ll.device}")
    _cuda.refuse_grad("K3 (fb_cuda.forward_backward)", "use am.nn_seq.FbLoglik or SmbrAcc, whose backward "
                      "is the posterior identity, or run the kernels under torch.no_grad()", emit_ll)
    if emit_ll.dim() != 3 or emit_ll.dtype != torch.float32:
        raise ValueError(f"emit_ll must be float32 [B, T, P], got {emit_ll.dtype} {tuple(emit_ll.shape)}")
    B, T, P = emit_ll.shape
    dev = emit_ll.device
    skip = graphs.get("skip_logp")
    J = check_graphs(graphs, _GRAPH_KEYS + (() if skip is None else ("skip_logp",)), B, dev)
    skip_ptr = None if skip is None else skip.data_ptr()
    ll = emit_ll.contiguous()
    nf = n_frames.to(device=dev, dtype=torch.int32).contiguous()
    scale = float(acoustic_scale)
    launches = int(B * T > 0)  # the entry point returns at once on an empty batch

    log_gamma = torch.empty((B, T, J), dtype=torch.float32, device=dev)  # alphas, then log_gamma
    betas = torch.empty((B, T, J), dtype=torch.float32, device=dev)
    loglik = torch.empty((B,), dtype=torch.float32, device=dev)
    arms = torch.empty((2, B), dtype=torch.int32, device=dev)
    lib = _cuda.load("forward_backward", _SIGNATURES)
    with torch.cuda.device(dev):
        side = _SIDE_STREAMS.get(dev.index)
        if side is None:
            side = _SIDE_STREAMS[dev.index] = torch.cuda.Stream(dev)
        # K3b runs on the side stream after the work queued on the current
        # one, which waits for K3b before the combine: no tensor here is
        # reused by the allocator before K3b has read it
        err = lib.fb_forward_backward(
            ll.data_ptr(), B, T, P, scale, *(graphs[k].data_ptr() for k in _GRAPH_KEYS), skip_ptr,
            nf.data_ptr(), J, log_gamma.data_ptr(), betas.data_ptr(), loglik.data_ptr(), arms.data_ptr(),
            torch.cuda.current_stream().cuda_stream, side.cuda_stream,
        )
        _cuda.check(lib, "forward_backward", err, f"fb_forward_backward launch (B={B}, T={T}, J={J}; a J above "
                    f"MAX_J in csrc/forward_backward.cu is rejected)")
    FWD_LAUNCHES += launches
    BWD_LAUNCHES += launches
    COMBINE_LAUNCHES += launches
    LAST_ARMS = arms
    return FBResult(log_gamma, loglik)

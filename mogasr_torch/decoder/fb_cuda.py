"""Forward-backward on the CUDA kernels ``csrc/forward_backward.cu`` (K3f, the
forward pass, and K3b, the backward pass): the port of
mogasr/decoder/fb_pallas.py.

A drop-in for ``decoder.forward_backward.forward_backward`` on chain+loop
graphs, with or without CTC skip transitions (``skip_logp``; the reference
kernels have no such arm), equal to it to a float tolerance (the logsumexp
over states sums in another order). A CUDA tensor runs the kernels, a CPU tensor the plain version; any other
device raises. ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the launches of
the forward and the backward kernel (one each per call with B * T > 0; an
empty batch launches neither).

The graph arrays go to the kernels as ``graphs_to_torch`` makes them
(``emit_id`` int32, the log-probs and any ``skip_logp`` float32, contiguous,
on the device of
``emit_ll``); they are checked, never converted. The kernels stop (a device
trap) on an ``emit_id`` outside [0, P) and reject J above the limit in
forward_backward.cu.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from mogasr_torch import _cuda
from mogasr_torch.decoder import forward_backward as plain
from mogasr_torch.decoder.forward_backward import FBResult
from mogasr_torch.decoder.viterbi_cuda import check_graphs

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fb_forward": [_P, _I, _I, _I, _F] + [_P] * 9 + [_I] + [_P] * 3,
    "fb_backward": [_P, _I, _I, _I, _F] + [_P] * 8 + [_I] + [_P] * 4,
}
_FWD_KEYS = ("emit_id", "self_logp", "adv_logp", "enter_logp", "exit_logp",
             "init_logp", "final_logp")
_BWD_KEYS = ("emit_id", "self_logp", "adv_logp", "enter_logp", "exit_logp", "final_logp")


def forward_backward(
    emit_ll: torch.Tensor,            # [B, T, P] pdf log-likelihoods
    graphs: Dict[str, torch.Tensor],  # graphs_to_torch(batch_graphs(...))
    n_frames: torch.Tensor,           # [B]
    acoustic_scale: float = 1.0,
) -> FBResult:
    global FWD_LAUNCHES, BWD_LAUNCHES
    if emit_ll.device.type == "cpu":
        return plain.forward_backward(emit_ll, graphs, n_frames, acoustic_scale=acoustic_scale)
    if emit_ll.device.type != "cuda":
        raise ValueError(f"forward_backward: unsupported device {emit_ll.device}")
    if emit_ll.dim() != 3 or emit_ll.dtype != torch.float32:
        raise ValueError(f"emit_ll must be float32 [B, T, P], got {emit_ll.dtype} {tuple(emit_ll.shape)}")
    B, T, P = emit_ll.shape
    dev = emit_ll.device
    skip = graphs.get("skip_logp")
    J = check_graphs(graphs, _FWD_KEYS + (() if skip is None else ("skip_logp",)), B, dev)
    skip_ptr = None if skip is None else skip.data_ptr()
    ll = emit_ll.contiguous()
    nf = n_frames.to(device=dev, dtype=torch.int32).contiguous()
    scale = float(acoustic_scale)
    launches = int(B * T > 0)  # the entry points return at once on an empty batch

    alphas = torch.empty((B, T, J), dtype=torch.float32, device=dev)
    loglik = torch.empty((B,), dtype=torch.float32, device=dev)
    log_gamma = torch.empty((B, T, J), dtype=torch.float32, device=dev)
    lib = _cuda.load("forward_backward", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fb_forward(
            ll.data_ptr(), B, T, P, scale, *(graphs[k].data_ptr() for k in _FWD_KEYS), skip_ptr,
            nf.data_ptr(), J, alphas.data_ptr(), loglik.data_ptr(), stream,
        )
        _cuda.check(lib, "forward_backward", err, "fb_forward launch")
        FWD_LAUNCHES += launches
        err = lib.fb_backward(
            ll.data_ptr(), B, T, P, scale, *(graphs[k].data_ptr() for k in _BWD_KEYS), skip_ptr,
            nf.data_ptr(), J, alphas.data_ptr(), loglik.data_ptr(), log_gamma.data_ptr(), stream,
        )
        _cuda.check(lib, "forward_backward", err, "fb_backward launch")
        BWD_LAUNCHES += launches
    return FBResult(log_gamma, loglik)

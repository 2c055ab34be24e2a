"""LSTM recurrence on the CUDA kernel ``csrc/lstm_scan.cu`` (kernel K4): the
port of mogasr/am/lstm_pallas.py's ``lstm_layer_pallas``.

``lstm_layer`` is a drop-in for ``am.fast_lstm.lstm_layer``, equal to it to
a float tolerance (the h @ w_rec sum runs in another order, and in bfloat16
on the tensor cores): a CUDA tensor runs the kernel, a CPU tensor runs the
plain version, any other device raises. On the card the rows go to the
kernel ordered by n_frames, longest first (``row_order``), so that the rows
live at a frame are a prefix of them; up to 64 rows (four blocks of 16, each
running on its own) go in one launch of thread-block clusters, and a wider
batch runs one launch per 64 rows, from the one C entry point.
``LAUNCHES`` counts kernel launches (none for B * T = 0); ``LAST_LAUNCH``
holds the cluster size, CTAs and rows of the last call's launches. With
initial carries (``h0``, ``c0``) or ``return_carry`` the kernel runs its carry
arm (the streaming LstmAm's chunk), counted in ``CARRY_LAUNCHES`` as well:
the carries go in and out through the row order, float32 in either
compute dtype.

K4 has no backward, as the reference's kernel has none: on the card a call
with grad mode on and an input that requires grad raises
(``_cuda.refuse_grad``) rather than return a result without a gradient;
training runs the plain recurrence (``use_kernels=False``).

Unlike the reference, which demoted its kernel behind ``use_pallas_lstm``
after a TPU measurement, every LSTM of the port runs through this kernel on
the card: the alternatives are the plain loop (about ten launches per frame)
or cuDNN, a library kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import torch

from mogasr_torch import _cuda
from mogasr_torch.am import fast_lstm as plain

LAUNCHES = 0
CARRY_LAUNCHES = 0
LAST_LAUNCH: Dict[str, int] = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"lstm_scan": [_P] * 6 + [ctypes.c_longlong] + [_I] * 4 + [_P] * 5 + [ctypes.POINTER(ctypes.c_int)]}


def row_order(n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's row order: (perm, nfs), int32 on n_frames' device.

    perm [B] lists the rows by n_frames, longest first (ties in row order),
    nfs [B] their n_frames, non-increasing: the rows live at any frame t
    (n_frames > t) are a prefix of perm, and so are those of every
    NRB-strided subsequence of it, a row block of the kernel."""
    nf = n_frames.to(torch.int32)
    order = torch.argsort(nf, descending=True, stable=True)
    return order.to(torch.int32), nf[order]


def lstm_layer(
    xg: torch.Tensor,        # [B, T, 4H] float32 input projection + bias
    w_rec: torch.Tensor,     # [H, 4H] recurrent weight, gate blocks i, f, g, o
    n_frames: torch.Tensor,  # [B]
    compute_dtype: str = "float32",
    h0: Optional[torch.Tensor] = None,  # [B, H] float32 initial carries (zero when not given)
    c0: Optional[torch.Tensor] = None,
    return_carry: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """[B, T, H] float32 hidden states of one LSTM layer from the carries
    (h0, c0), zero when not given, frozen past each row's n_frames; with
    ``return_carry`` also (h_T, c_T) [B, H], each row's carries at its
    n_frames (a row with none keeps h0 and c0). compute_dtype "bfloat16"
    rounds h and w_rec to bf16 for the product; sums, gates and carries stay
    float32."""
    global LAUNCHES, CARRY_LAUNCHES, LAST_LAUNCH
    plain.check_compute_dtype(compute_dtype)
    if xg.device.type == "cpu":
        return plain.lstm_layer(xg, w_rec, n_frames, compute_dtype, h0=h0, c0=c0, return_carry=return_carry)
    if xg.device.type != "cuda":
        raise ValueError(f"lstm_layer: unsupported device {xg.device}")
    _cuda.refuse_grad("K4 (lstm_cuda.lstm_layer)", "train with use_kernels=False (the plain recurrence, "
                      "am.fast_lstm, under autograd), or run the kernel under torch.no_grad()", xg, w_rec, h0, c0)
    if xg.dim() != 3 or xg.dtype != torch.float32 or xg.shape[2] % 4 or xg.shape[2] == 0:
        raise ValueError(f"xg must be float32 [B, T, 4H], got {xg.dtype} {tuple(xg.shape)}")
    B, T, H4 = xg.shape
    H = H4 // 4
    if tuple(w_rec.shape) != (H, H4) or w_rec.device != xg.device:
        raise ValueError(f"w_rec must be [{H}, {H4}] on {xg.device}, got {tuple(w_rec.shape)} on {w_rec.device}")
    if tuple(n_frames.shape) != (B,):
        raise ValueError(f"n_frames must be [{B}], got {tuple(n_frames.shape)}")
    dev = xg.device
    carry = h0 is not None or c0 is not None or return_carry
    if carry:
        zero = torch.zeros((B, H), dtype=torch.float32, device=dev)
        h0 = zero if h0 is None else h0
        c0 = zero if c0 is None else c0
        for name, t in (("h0", h0), ("c0", c0)):
            if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (B, H):
                raise ValueError(f"{name} must be float32 [{B}, {H}] on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        h0, c0 = h0.contiguous(), c0.contiguous()
        h_out, c_out = torch.empty_like(h0), torch.empty_like(c0)
    out = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    if B * T == 0:
        if carry:  # no frame: the carries go through unchanged
            h_out.copy_(h0)
            c_out.copy_(c0)
        return (out, (h_out, c_out)) if return_carry else out
    bf16 = compute_dtype == "bfloat16"
    w = w_rec.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    x = xg.contiguous()
    perm, nfs = row_order(n_frames.to(dev))
    # the kernel's scratch, zero: per block of 16 rows two frame buffers of
    # the h image (at most 2 x 64 x (2H + 144) floats in all) and a frame
    # counter 32 words wide
    ws = torch.zeros(2 * 64 * (2 * H + 144) + 32 * (-(-B // 16) + 4), dtype=torch.float32, device=dev)
    info = (ctypes.c_int * 4)()
    lib = _cuda.load("lstm_scan", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lstm_scan(x.data_ptr(), w.data_ptr(), perm.data_ptr(), nfs.data_ptr(), out.data_ptr(),
                            ws.data_ptr(), ws.numel() * 4, B, T, H, int(bf16),
                            *((h0.data_ptr(), c0.data_ptr(), h_out.data_ptr(), c_out.data_ptr()) if carry
                              else (None,) * 4), stream, info)
    _cuda.check(lib, "lstm_scan", err, "lstm_scan launch")
    LAUNCHES += info[0]
    CARRY_LAUNCHES += info[0] if carry else 0
    LAST_LAUNCH = {"launches": info[0], "cluster": info[1], "ctas": info[2], "rows": info[3]}
    return (out, (h_out, c_out)) if return_carry else out

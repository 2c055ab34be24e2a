"""LSTM recurrence on the CUDA kernel ``csrc/lstm_scan.cu`` (kernel K4): the
port of mogasr/am/lstm_pallas.py's ``lstm_layer_pallas``.

``lstm_layer`` is a drop-in for ``am.fast_lstm.lstm_layer``, equal to it to
a float tolerance (the h @ w_rec sum runs in another order): a CUDA tensor
runs the kernel, one cooperative launch for the whole recurrence of up to
64 batch rows (a wider batch runs one launch per block of rows, from the one
C entry point); a CPU tensor runs the plain version; any other device
raises. ``LAUNCHES`` counts kernel launches (none for B * T = 0).

Unlike the reference, which demoted its kernel behind ``use_pallas_lstm``
after a TPU measurement, every LSTM of the port runs through this kernel on
the card: the alternatives are the plain loop (about ten launches per frame)
or cuDNN, a library kernel.
"""

from __future__ import annotations

import ctypes

import torch

from mogasr_torch import _cuda
from mogasr_torch.am import fast_lstm as plain

LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"lstm_scan": [_P] * 5 + [_I] * 4 + [_P, ctypes.POINTER(ctypes.c_int)]}


def lstm_layer(
    xg: torch.Tensor,        # [B, T, 4H] float32 input projection + bias
    w_rec: torch.Tensor,     # [H, 4H] recurrent weight, gate blocks i, f, g, o
    n_frames: torch.Tensor,  # [B]
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """[B, T, H] float32 hidden states of one LSTM layer from zero carries,
    frozen past each row's n_frames. compute_dtype "bfloat16" rounds h and
    w_rec to bf16 for the product; sums, gates and carries stay float32."""
    global LAUNCHES
    plain.check_compute_dtype(compute_dtype)
    if xg.device.type == "cpu":
        return plain.lstm_layer(xg, w_rec, n_frames, compute_dtype)
    if xg.device.type != "cuda":
        raise ValueError(f"lstm_layer: unsupported device {xg.device}")
    if xg.dim() != 3 or xg.dtype != torch.float32 or xg.shape[2] % 4 or xg.shape[2] == 0:
        raise ValueError(f"xg must be float32 [B, T, 4H], got {xg.dtype} {tuple(xg.shape)}")
    B, T, H4 = xg.shape
    H = H4 // 4
    if tuple(w_rec.shape) != (H, H4) or w_rec.device != xg.device:
        raise ValueError(f"w_rec must be [{H}, {H4}] on {xg.device}, got {tuple(w_rec.shape)} on {w_rec.device}")
    if tuple(n_frames.shape) != (B,):
        raise ValueError(f"n_frames must be [{B}], got {tuple(n_frames.shape)}")
    dev = xg.device
    bf16 = compute_dtype == "bfloat16"
    w = w_rec.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    x = xg.contiguous()
    nf = n_frames.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    hbuf = torch.zeros((2, B, -(-H // 4) * 4), dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    lib = _cuda.load("lstm_scan", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lstm_scan(x.data_ptr(), w.data_ptr(), nf.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
                            B, T, H, int(bf16), stream, ctypes.byref(launched))
    _cuda.check(lib, "lstm_scan", err, "lstm_scan launch")
    LAUNCHES += launched.value  # none on an empty batch
    return out

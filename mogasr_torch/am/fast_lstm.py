"""Prefused LSTM forward in PyTorch: the port of mogasr/am/fast_lstm.py, and
the plain version of the CUDA kernel in ``am.lstm_cuda`` (K4).

An LSTM layer's input projection does not depend on the recurrence, so it
runs for all frames as one GEMM (``xg = x @ w_in + bias``, [B, T, 4H]); what
is left is the recurrent half, ``lstm_layer`` here: a Python loop over
frames, one [B, H] x [H, 4H] product and the gate math per frame, carries
frozen at each row's ``n_frames``. Gate order and math are flax's
OptimizedLSTMCell: i, f, o = sigmoid, g = tanh, c' = f * c + i * g,
h' = o * tanh(c').

The frozen carries are the kernel's contract and the reference's fused
paths' (``lstm_layer_pallas``, ``lstm_am_apply_prefused``): a padded frame
repeats the row's last valid h. flax's stock ``RNN(seq_lengths=...)`` keeps
evolving its outputs past ``n_frames``, so the two agree on valid frames
only; every consumer masks by ``n_frames``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

COMPUTE_DTYPES = ("float32", "bfloat16")


def check_compute_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")


def lstm_layer(
    xg: torch.Tensor,        # [B, T, 4H] input projection + bias
    w_rec: torch.Tensor,     # [H, 4H] recurrent weight, gate blocks i, f, g, o
    n_frames: torch.Tensor,  # [B]
    compute_dtype: str = "float32",
    h0: Optional[torch.Tensor] = None,  # [B, H] initial carries (zero when not given)
    c0: Optional[torch.Tensor] = None,
    return_carry: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """[B, T, H] float32 hidden states of one LSTM layer from the carries
    (h0, c0), zero when not given; with ``return_carry`` also (h_T, c_T), each
    row's carries at its n_frames (a row with none keeps h0 and c0).

    compute_dtype "bfloat16" rounds h and w_rec to bf16 before the product
    and keeps the sum (in float32: every bf16 x bf16 product is exact), the
    gates and the carries in float32. K4 multiplies the same operands on the
    tensor cores, whose float32 sums truncate, so it agrees with this to a
    tolerance (K4_ATOL["bfloat16"]), not bit for bit.
    """
    check_compute_dtype(compute_dtype)
    B, T, H4 = xg.shape
    H = H4 // 4
    xg = xg.to(torch.float32)
    if compute_dtype == "bfloat16":
        round_ = lambda a: a.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    else:
        round_ = lambda a: a  # noqa: E731
    w = round_(w_rec.to(device=xg.device, dtype=torch.float32))
    nf = n_frames.to(xg.device)
    h = torch.zeros((B, H), dtype=torch.float32, device=xg.device) if h0 is None else h0.to(xg.device, torch.float32)
    c = torch.zeros_like(h) if c0 is None else c0.to(xg.device, torch.float32)
    # one unbind and one stack (under autograd, a slice a frame would
    # allocate a zero gradient of all of xg a frame)
    xs, hs = xg.unbind(1), []
    for t in range(T):
        gates = xs[t] + round_(h) @ w
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        keep = (t < nf)[:, None]
        c = torch.where(keep, c_new, c)
        h = torch.where(keep, h_new, h)
        hs.append(h)
    out = torch.stack(hs, dim=1) if T else torch.empty((B, 0, H), dtype=torch.float32, device=xg.device)
    return (out, (h, c)) if return_carry else out

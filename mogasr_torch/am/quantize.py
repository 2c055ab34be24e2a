"""Reduced-precision inference for the neural frame classifiers: the port of
mogasr/am/quantize.py (bfloat16, dynamic int8, the int8 checkpoint format).

- **bfloat16.** MlpAm, TdnnAm and MoeAm run a bf16 copy of the module on
  bf16 inputs; LstmAm and BlstmAm run their input GEMMs, K4 and the head
  with bf16 operands and float32 sums, gates and carries (their
  ``compute_dtype="bfloat16"``). Logits come back float32 either way, so
  the prior-scaled log-softmax and Viterbi stay float32.
- **int8 (MlpAm, LstmAm).** Weight kernels per output channel (symmetric,
  127 levels), activations per row at run time, round-half-even in both
  (``torch.round``, as ``jnp.round``), so ``q`` and the scales are the
  reference's. The integer product runs as a float32 ``torch.matmul`` of
  integer-valued tensors (TF32 is off package-wide): every partial sum is an
  integer below K * 127^2, exact in float32 while that stays under 2^24
  (K <= 1040), and ``int8_dynamic_dot`` refuses wider products. For LstmAm
  the input projections and the head are int8; the recurrence (K4 on the
  card) and the gates stay float32.

``make_quantized_logits`` dispatches on precision; ``save_quantized`` /
``load_quantized`` keep an int8 tree in the reference's .npz layout.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mogasr_torch.am import fast_lstm, lstm_cuda
from mogasr_torch.am.neural import LN_EPS, RECURRENT, LstmAm, MlpAm, splice_frames

Logits = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (feats, n_frames) -> f32 logits
PRECISIONS = ("float32", "bfloat16", "int8")
_EXACT_K = 1040  # the widest int8 product whose float32 sums are exact: K * 127^2 < 2^24


def make_bf16_logits(model: nn.Module, use_kernels: bool = True) -> Logits:
    """(feats, n_frames) -> float32 logits with bf16 parameters and activations."""
    if isinstance(model, RECURRENT):
        return lambda feats, n_frames: model(feats, n_frames, "bfloat16", use_kernels)
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    return lambda feats, n_frames: m16(feats.to(torch.bfloat16), n_frames).float()


def quantize_dense_int8(kernel: torch.Tensor):
    """(q int8 [din, dout], scale float32 [dout]): symmetric per output
    channel, max-abs to 127 levels; a zero column gets scale 1 (q == 0)."""
    kernel = kernel.to(torch.float32)
    scale = kernel.abs().amax(dim=0) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(kernel / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def int8_dynamic_dot(x: torch.Tensor, q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """The int8 equivalent of ``x @ kernel``: x [..., din] float32 quantized
    per row (dynamic max-abs), q [din, dout] int8 per channel; the integer
    product is rescaled by (row scale x channel scale)."""
    if q.shape[0] > _EXACT_K:
        raise ValueError(f"int8_dynamic_dot: din = {q.shape[0]} > {_EXACT_K}, where float32 sums of "
                         "int8 products stop being exact")
    ax = x.abs().amax(dim=-1, keepdim=True) / 127.0
    ax = torch.where(ax > 0, ax, torch.ones_like(ax))
    xq = torch.clamp(torch.round(x / ax), -127, 127)
    acc = torch.matmul(xq, q.to(torch.float32))
    return acc * ax * w_scale


def _dense_int8(layer: nn.Linear) -> Dict[str, torch.Tensor]:
    q, s = quantize_dense_int8(layer.weight.detach().T)
    return {"q": q, "scale": s, "bias": layer.bias.detach().float().clone()}


def quantize_mlp_int8(model: MlpAm) -> Dict[str, Any]:
    """An MlpAm's Dense kernels to int8 + scales (biases and LayerNorm stay
    float32), keyed as the reference's flax tree."""
    out: Dict[str, Any] = {}
    for i, (d, ln) in enumerate(zip(model.dense, model.norms)):
        out[f"Dense_{i}"] = _dense_int8(d)
        out[f"LayerNorm_{i}"] = {"scale": ln.weight.detach().float().clone(),
                                 "bias": ln.bias.detach().float().clone()}
    out[f"Dense_{model.layers}"] = _dense_int8(model.head)
    return out


def _layer_norm(x, scale, bias, eps=LN_EPS):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def mlp_apply_int8(model: MlpAm, qparams: Dict[str, Any], feats, n_frames) -> torch.Tensor:
    """MlpAm's forward on int8 kernels: splice -> [int8 GEMM -> float32
    LayerNorm -> relu] x layers -> int8 GEMM."""
    x = splice_frames(feats, n_frames, model.context)
    for i in range(model.layers):
        d, ln = qparams[f"Dense_{i}"], qparams[f"LayerNorm_{i}"]
        x = F.relu(_layer_norm(int8_dynamic_dot(x, d["q"], d["scale"]) + d["bias"], ln["scale"], ln["bias"]))
    d = qparams[f"Dense_{model.layers}"]
    return int8_dynamic_dot(x, d["q"], d["scale"]) + d["bias"]


def quantize_lstm_int8(model: LstmAm) -> Dict[str, Any]:
    """An LstmAm for the prefused int8 forward: input projections [D, 4H]
    and the head int8 per channel; recurrent kernels and biases float32."""
    layers = []
    for cell in model.cells:
        q, s = quantize_dense_int8(cell.w_in.detach())
        layers.append({"q_in": q, "scale_in": s, "w_rec": cell.w_rec.detach().float().clone(),
                       "bias": cell.bias.detach().float().clone()})
    return {"layers": layers, "out": _dense_int8(model.head)}


def lstm_apply_int8(qparams: Dict[str, Any], feats, n_frames, use_kernels: bool = True) -> torch.Tensor:
    """The prefused LstmAm forward with int8 input projections and head, and
    the float32 recurrence (K4 on the card, the plain loop on the CPU or
    with ``use_kernels=False``)."""
    layer = lstm_cuda.lstm_layer if use_kernels else fast_lstm.lstm_layer
    x = feats.to(torch.float32)
    for p in qparams["layers"]:
        x = layer(int8_dynamic_dot(x, p["q_in"], p["scale_in"]) + p["bias"], p["w_rec"], n_frames)
    d = qparams["out"]
    return int8_dynamic_dot(x, d["q"], d["scale"]) + d["bias"]


def make_int8_logits(model: nn.Module, use_kernels: bool = True) -> Logits:
    """(feats, n_frames) -> float32 logits through the int8 path; MlpAm and
    LstmAm only, any other family raises."""
    if isinstance(model, MlpAm):
        qm = quantize_mlp_int8(model)
        return lambda feats, n_frames: mlp_apply_int8(model, qm, feats, n_frames)
    if isinstance(model, LstmAm):
        ql = quantize_lstm_int8(model)
        return lambda feats, n_frames: lstm_apply_int8(ql, feats, n_frames, use_kernels)
    raise NotImplementedError(
        f"int8 inference is implemented for MlpAm/LstmAm (use bfloat16 for {type(model).__name__})")


def make_quantized_logits(model: nn.Module, precision: str, use_kernels: bool = True) -> Logits:
    """precision "float32" | "bfloat16" | "int8" -> (feats, n_frames) ->
    float32 logits. ``use_kernels=False`` runs the plain recurrence in place
    of K4 (LstmAm and BlstmAm; the other families have no kernel)."""
    if precision == "float32":
        if isinstance(model, RECURRENT):
            return lambda feats, n_frames: model(feats, n_frames, "float32", use_kernels)
        return model
    if precision == "bfloat16":
        return make_bf16_logits(model, use_kernels)
    if precision == "int8":
        return make_int8_logits(model, use_kernels)
    raise ValueError(f"unknown precision {precision!r} (one of {PRECISIONS})")


def save_quantized(path: str, qparams: Dict[str, Any]) -> None:
    """Write a ``quantize_{mlp,lstm}_int8`` tree to one .npz, keys as the
    reference's (``Dense_0/q``, ``layers/0/q_in``, ...)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node.detach().cpu().numpy()

    walk("", qparams)
    np.savez_compressed(path, **flat)


def load_quantized(path: str, device: torch.device) -> Dict[str, Any]:
    """Inverse of ``save_quantized``, tensors on ``device`` (lists come back
    from integer path segments)."""
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = root
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.as_tensor(data[key], device=device)

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)

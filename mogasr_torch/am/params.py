"""Parameters of the neural frame classifiers (``am.neural``): a flax
checkpoint of the reference converted to the port's ``state_dict``
(``from_flax``), and seeded initialisation with flax's initializers
(``init_``).

flax layouts: a ``Dense`` kernel is [in, out] (torch ``Linear``: [out, in]),
a ``Conv`` kernel [k, in, out] (torch ``Conv1d``: [out, in, k]); an
``OptimizedLSTMCell`` keeps input kernels ``ii/if/ig/io`` [in, H] without
bias and recurrent kernels ``hi/hf/hg/ho`` [H, H] with bias, which the port
concatenates in that gate order into ``w_in``, ``w_rec`` and ``bias``. A
BlstmAm's cells are numbered in construction order: cell 2l is layer l's
forward LSTM, cell 2l + 1 its backward one.

ConformerAm (``am.aed``): a 2-D ``Conv`` kernel is [kh, kw, in, out] (torch
``Conv2d``: [out, in, kh, kw]), the depthwise one [k, 1, D] (torch: [D, 1,
k]); an FFN's Dense that flax numbers 0 is its second layer (``fc2``: the
outer ``Dense(D)`` is built before the inner one), and ``rel_bias`` [heads,
2 max_rel + 1] is taken as it is.

The AED (``am.aed.AedModel``): its encoder is the ConformerAm's under
``encoder``; flax numbers a decoder block's compact modules in construction
order: ``LayerNorm_0..2`` (before the self-attention, the cross-attention
and the FFN), ``Dense_0..3`` (q, k, v, the self-attention output),
``CrossAttention_0/Dense_0..3`` (q, k, v, output) and ``_Ffn_0``.

The neural LMs (``lm.neural``) and the RNN-T (``am.rnnt``): an ``Embed``'s
table is taken as it is; flax numbers the TransformerLm's Dense layers in
construction order, six a block (q, k, v, the attention output, then the
FFN's outer Dense(D) before its inner Dense(hidden)) and the output head
last; the RNN-T's encoder is an LstmAm subtree and its prediction LSTM an
``OptimizedLSTMCell_0``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from mogasr_torch.am.aed import AedModel, RelSelfAttention
from mogasr_torch.am.neural import BlstmAm, ConformerAm, LstmAm, LstmLayer, MlpAm, MoeAm, MoeBlock, TdnnAm
from mogasr_torch.am.rnnt import RnntModel, RnntPrediction
from mogasr_torch.lm.neural import NeuralLm, TransformerLm

_IN_GATES = ("ii", "if", "ig", "io")
_REC_GATES = ("hi", "hf", "hg", "ho")
# flax's truncated normal is cut at 2 standard deviations; this rescales its
# std to the untruncated one (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _dense(prefix: str, leaf: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(leaf["kernel"]).T.contiguous(), f"{prefix}.bias": _t(leaf["bias"])}


def _norm(prefix: str, leaf: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(leaf["scale"]), f"{prefix}.bias": _t(leaf["bias"])}


def _lstm(prefix: str, cell: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.w_in": torch.cat([_t(cell[g]["kernel"]) for g in _IN_GATES], dim=1),
        f"{prefix}.w_rec": torch.cat([_t(cell[g]["kernel"]) for g in _REC_GATES], dim=1),
        f"{prefix}.bias": torch.cat([_t(cell[g]["bias"]) for g in _REC_GATES]),
    }


def _conformer_block(prefix: str, p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for ln in ("ln_ffn1", "ln_attn", "ln_conv", "ln_dconv", "ln_ffn2", "ln_out"):
        sd.update(_norm(f"{prefix}.{ln}", p[ln]))
    for ffn in ("ffn1", "ffn2"):
        sd.update(_dense(f"{prefix}.{ffn}.fc1", p[ffn]["Dense_1"]))
        sd.update(_dense(f"{prefix}.{ffn}.fc2", p[ffn]["Dense_0"]))
    a = p["attn"]
    for proj in ("q_proj", "k_proj", "v_proj"):
        sd[f"{prefix}.attn.{proj}.weight"] = _t(a[proj]["kernel"]).T.contiguous()
    sd.update(_dense(f"{prefix}.attn.o_proj", a["o_proj"]))
    sd[f"{prefix}.attn.rel_bias"] = _t(a["rel_bias"])
    sd.update(_dense(f"{prefix}.conv_in", p["conv_in"]))
    sd.update(_dense(f"{prefix}.conv_out", p["conv_out"]))
    sd[f"{prefix}.dconv.weight"] = _t(p["dconv"]["kernel"]).permute(2, 1, 0).contiguous()
    sd[f"{prefix}.dconv.bias"] = _t(p["dconv"]["bias"])
    return sd


def _conformer_encoder(prefix: str, enc: Mapping[str, Any], blocks: int) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for conv in ("conv1", "conv2"):
        sd[f"{prefix}.sub.{conv}.weight"] = _t(enc["sub"][conv]["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{prefix}.sub.{conv}.bias"] = _t(enc["sub"][conv]["bias"])
    sd.update(_dense(f"{prefix}.sub.proj", enc["sub"]["proj"]))
    for i in range(blocks):
        sd.update(_conformer_block(f"{prefix}.blks.{i}", enc[f"blks_{i}"]))
    return sd


def _no_bias(prefix: str, leaf: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(leaf["kernel"]).T.contiguous()}


def _aed(model: AedModel, p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd = _conformer_encoder("encoder", p["encoder"], model.enc_blocks)
    sd["embed.weight"] = _t(p["embed"]["embedding"])
    for i in range(model.dec_blocks):
        d, pre = p[f"dec_{i}"], f"dec.{i}"
        for j, name in enumerate(("q", "k", "v")):
            sd.update(_no_bias(f"{pre}.{name}", d[f"Dense_{j}"]))
            sd.update(_no_bias(f"{pre}.cross.{name}", d["CrossAttention_0"][f"Dense_{j}"]))
        sd.update(_dense(f"{pre}.o", d["Dense_3"]))
        sd.update(_dense(f"{pre}.cross.o", d["CrossAttention_0"]["Dense_3"]))
        for j, name in enumerate(("ln_self", "ln_cross", "ln_ffn")):
            sd.update(_norm(f"{pre}.{name}", d[f"LayerNorm_{j}"]))
        sd.update(_dense(f"{pre}.ffn.fc1", d["_Ffn_0"]["Dense_1"]))
        sd.update(_dense(f"{pre}.ffn.fc2", d["_Ffn_0"]["Dense_0"]))
    sd.update(_norm("dec_norm", p["dec_norm"]))
    sd.update(_dense("out", p["out"]))
    sd.update(_dense("ctc_head", p["ctc_head"]))
    return sd


def _prefixed(prefix: str, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _rnnt(model: RnntModel, p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd = _prefixed("encoder", from_flax(model.encoder, p["encoder"]))
    pp = p["prediction"]
    sd["prediction.embedding.weight"] = _t(pp["Embed_0"]["embedding"])
    if isinstance(model.prediction, RnntPrediction):
        sd.update(_lstm("prediction.cell", pp["OptimizedLSTMCell_0"]))
    else:
        sd.update(_dense("prediction.dense", pp["Dense_0"]))
    for name in ("enc_proj", "pred_proj", "out"):
        sd.update(_dense(f"joint.{name}", p["joint"][name]))
    for name in ("ctc_head", "simple_am", "simple_lm"):
        if name in p:
            sd.update(_dense(name, p[name]))
    return sd


def _transformer_lm(model: TransformerLm, p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd = {"embedding.weight": _t(p["Embed_0"]["embedding"]), "pos.weight": _t(p["Embed_1"]["embedding"])}
    for i in range(model.layers):
        pre = f"blocks.{i}"
        for j, name in enumerate(("q", "k", "v")):
            sd[f"{pre}.{name}.weight"] = _t(p[f"Dense_{6 * i + j}"]["kernel"]).T.contiguous()
        sd.update(_dense(f"{pre}.o", p[f"Dense_{6 * i + 3}"]))
        sd.update(_dense(f"{pre}.fc2", p[f"Dense_{6 * i + 4}"]))
        sd.update(_dense(f"{pre}.fc1", p[f"Dense_{6 * i + 5}"]))
        sd.update(_norm(f"{pre}.ln_attn", p[f"LayerNorm_{2 * i}"]))
        sd.update(_norm(f"{pre}.ln_ffn", p[f"LayerNorm_{2 * i + 1}"]))
    sd.update(_norm("ln_out", p[f"LayerNorm_{2 * model.layers}"]))
    sd.update(_dense("head", p[f"Dense_{6 * model.layers}"]))
    return sd


def from_flax(model: nn.Module, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` from the reference's flax parameters
    (``model.init(...)`` of the same family and sizes, the ``{"params": ...}``
    tree or its inside), as float32 CPU tensors; ``model.load_state_dict``
    takes it and copies to the model's device."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    if isinstance(model, MlpAm):
        for i in range(model.layers):
            sd.update(_dense(f"dense.{i}", p[f"Dense_{i}"]))
            sd.update(_norm(f"norms.{i}", p[f"LayerNorm_{i}"]))
        sd.update(_dense("head", p[f"Dense_{model.layers}"]))
    elif isinstance(model, LstmAm):
        for i in range(model.layers):
            sd.update(_lstm(f"cells.{i}", p[f"OptimizedLSTMCell_{i}"]))
        sd.update(_dense("head", p["Dense_0"]))
    elif isinstance(model, BlstmAm):
        for i in range(model.layers):
            sd.update(_lstm(f"fwd.{i}", p[f"OptimizedLSTMCell_{2 * i}"]))
            sd.update(_lstm(f"bwd.{i}", p[f"OptimizedLSTMCell_{2 * i + 1}"]))
        sd.update(_dense("head", p["Dense_0"]))
    elif isinstance(model, TdnnAm):
        for i in range(model.layers):
            conv = p[f"Conv_{i}"]
            sd[f"convs.{i}.weight"] = _t(conv["kernel"]).permute(2, 1, 0).contiguous()
            sd[f"convs.{i}.bias"] = _t(conv["bias"])
            sd.update(_norm(f"norms.{i}", p[f"LayerNorm_{i}"]))
        sd.update(_dense("head", p["Dense_0"]))
    elif isinstance(model, MoeAm):
        sd.update(_dense("in_proj", p["in_proj"]))
        for i in range(model.layers):
            sd.update(_norm(f"blocks.{i}.ln", p[f"ln_{i}"]))
            for name in ("Wr", "W1", "b1", "W2", "b2"):
                sd[f"blocks.{i}.{name}"] = _t(p[f"{name}_{i}"])
        sd.update(_norm("ln_out", p["ln_out"]))
        sd.update(_dense("head", p["head"]))
    elif isinstance(model, ConformerAm):
        sd.update(_conformer_encoder("enc", p["enc"], model.layers))
        sd.update(_dense("head", p["head"]))
    elif isinstance(model, AedModel):
        sd.update(_aed(model, p))
    elif isinstance(model, RnntModel):
        sd.update(_rnnt(model, p))
    elif isinstance(model, NeuralLm):
        sd["embedding.weight"] = _t(p["Embed_0"]["embedding"])
        for i in range(model.layers):
            sd.update(_lstm(f"cells.{i}", p[f"OptimizedLSTMCell_{i}"]))
        sd.update(_dense("head", p["Dense_0"]))
    elif isinstance(model, TransformerLm):
        sd.update(_transformer_lm(model, p))
    else:
        raise TypeError(f"from_flax: unsupported model {type(model).__name__}")
    return sd


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``model``'s weights in place from ``generator`` with flax's
    initializers and return it: ``lecun_normal`` (truncated normal over the
    fan-in) for Dense and Conv kernels and the LSTM input kernels, an
    orthogonal matrix per gate for the recurrent kernels, an embedding
    table truncated normal over its width, zero biases,
    LayerNorm scale 1 and bias 0; MoeAm's router and expert kernels normal
    with std 1/sqrt(fan-in), as MoeAm declares them; a Conformer's
    relative-position bias zero."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)  # fan-in: (in / groups) x kernel
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            _lecun_normal_(m.weight, m.embedding_dim, generator)  # flax's Embed: variance over the features
        elif isinstance(m, RelSelfAttention):
            nn.init.zeros_(m.rel_bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, LstmLayer):
            H = m.w_rec.shape[0]
            _lecun_normal_(m.w_in, m.w_in.shape[0], generator)
            for g in range(4):
                m.w_rec[:, g * H:(g + 1) * H] = nn.init.orthogonal_(torch.empty_like(m.w_rec[:, :H]),
                                                                    generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, MoeBlock):
            hidden, ffn = m.W1.shape[1], m.W1.shape[2]
            nn.init.normal_(m.Wr, std=1.0 / math.sqrt(hidden), generator=generator)
            nn.init.normal_(m.W1, std=1.0 / math.sqrt(hidden), generator=generator)
            nn.init.normal_(m.W2, std=1.0 / math.sqrt(ffn), generator=generator)
            nn.init.zeros_(m.b1)
            nn.init.zeros_(m.b2)
    return model

"""Attention encoder-decoder (AED) ASR: the port of mogasr/am/aed.py.

A Conformer encoder, a Transformer decoder and a CTC head on the encoder,
trained with label-smoothed cross-entropy plus the auxiliary CTC loss (the
joint CTC/attention recipe) and decoded by a batched beam search.

The encoder. Two stride-2 3x3 convolutions over (time, frequency) subsample
time 4x (frequency TF-SAME; time padded (1, 1), or (2, 0) in the causal
encoder), a Dense projects to d_model, then a stack of Conformer blocks:
macaron FFN, multi-head self-attention with a learned clipped
relative-position bias, a depthwise convolution module (GLU, padded frames
zeroed before the depthwise kernel, LayerNorm in place of BatchNorm), FFN,
LayerNorm, every LayerNorm with flax's epsilon. ``am.neural.ConformerAm``
runs the offline encoder under its head. With ``chunk_frames > 0`` the
encoder is streaming-capable: attention is masked to the query's chunk and
``left_chunks`` chunks before it, and every convolution is causal, so the
chunk-incremental ``stream_step`` (caches: the last two raw and two
first-convolution frames, and per block the post-FFN1 attention context and
the k - 1 frames before the depthwise convolution) equals the offline
chunk-masked forward.

The decoder: a token embedding (of max(token, 0)) scaled by sqrt(d_model)
plus sinusoidal positions, pre-LayerNorm blocks of causal self-attention,
cross-attention over the valid encoder frames and an FFN, a final LayerNorm
and the output layer over n_units + 2 tokens (sos = n_units, eos = n_units
+ 1). The CTC head has n_units + 1 outputs, blank = n_units.

Attention is written out, softmax(QK^T / sqrt(d) (+ rel_bias)) V with masked
keys at NEG_INF, as the reference computes it (it has no Pallas kernel); so
are the decoder and the beam. The convolutions run as matrix products
(``F.unfold`` and a GEMM; the depthwise one as a contraction over its taps'
windows), so their float32 precision is the matmul's: on the card cuBLAS with TF32 off
(the package turns it off), forward and backward alike.

Training (``aed_objective``, ``make_aed_train_step``): the CE is normalised
over n_labels + 1 tokens (eos is a target), the CTC term (``am.ctc.
ctc_loss``: kernel K3's chain arm with skips on the card) over max(n_labels,
1), combined as (1 - w) CE + w CTC; the optimizer is the CE path's AdamW
(``am.train_nn``).

Decoding (``make_aed_decoder``): the reference's beam search as a loop of
plain ops. Each step recomputes the causal decoder over the whole [B K, U]
token buffer and reads position u; the top K of the K x V candidates go to
the lower index on ties (a stable sort, as ``jax.lax.top_k``); a finished
beam expands only eos at its score. ``early_exit`` stops once every beam
has emitted eos, as the reference's ``while_loop`` does: a step is applied
only while some beam is still open (a flag on the card), and the host reads
that flag every ``AED_EXIT_CHECK`` steps. With ``ctc_weight > 0`` the final
K hypotheses are rescored with the CTC head, (1 - w) att + w log p_ctc, the
CTC term on K3 over the token buffer cut to the batch's longest hypothesis
(the states past a row's own are NEG_INF in K3's graphs, so the value does
not change; a call whose longest hypothesis has up to 511 tokens runs K3's
chain arm, a longer one its block arm); a hypothesis that cannot fit its
subsampled frames keeps K3's ~1e30. K3 failing raises: nothing falls back to the plain recursion.

MWER (``aed_mwer_objective``): the expected edit distance over the
renormalised N-best, minus its mean, plus a CE anchor.

Parameters are in torch layouts: a 2-D convolution's weight [out, in, kh,
kw] (flax: [kh, kw, in, out]), the depthwise one [D, 1, k] (flax: [k, 1,
D]); ``am.params.from_flax`` converts, ``am.params.init_`` draws fresh ones.
Unlike flax, the model needs its input width when built (``feat_dim``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mogasr_torch.am.ctc import ctc_loss, masked_mean_objective
from mogasr_torch.am.neural import LN_EPS, spec_augment as _spec_augment, valid_mask
from mogasr_torch.am.rnnt import _dev_of, _on, _topk_stable
from mogasr_torch.am.train_nn import apply_update, init_train_state, step_generator
from mogasr_torch.config import TrainConfig
from mogasr_torch.dist.comm import batch_count

NEG_INF = -1e30
SUB_CHANNELS = 32     # ConvSubsample's channels; aed_stream_init's c1 cache is this wide
AED_EXIT_CHECK = 8    # beam steps between the host's reads of the all-finished flag


def subsampled_frames(n_frames, n_convs: int = 2):
    """Frame count after ``n_convs`` stride-2 convolutions: ceil-div by 2 each."""
    n = n_frames
    for _ in range(n_convs):
        n = -(-n // 2)
    return n


def _same_lohi(n: int, k: int = 3, s: int = 2) -> Tuple[int, int]:
    """TF-'SAME' (lo, hi) padding for kernel k stride s over n elements."""
    out = -(-n // s)
    pt = max((out - 1) * s + k - n, 0)
    return (pt // 2, pt - pt // 2)


def _conv2d_s2(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (3x3, stride 2, no padding) on [B, C, T, F] as one GEMM over
    its unfolded windows, channels-major as the weight is laid out."""
    B, _C, T, Fq = x.shape
    To, Fo = (T - 3) // 2 + 1, (Fq - 3) // 2 + 1
    cols = F.unfold(x, kernel_size=3, stride=2)                      # [B, C * 9, To * Fo]
    y = torch.matmul(conv.weight.reshape(conv.out_channels, -1), cols) + conv.bias[:, None]
    return y.reshape(B, conv.out_channels, To, Fo)


class ConvSubsample(nn.Module):
    """Two stride-2 2-D convolutions over (time, frequency), TF-SAME in
    frequency and padded (1, 1) in time, or (2, 0) when ``causal`` (no
    lookahead: ``step`` then runs it chunk by chunk), then a Dense to
    d_model: 4x fewer frames (ceil-div by 2 per convolution)."""

    def __init__(self, d_model: int, feat_dim: int, channels: int = SUB_CHANNELS, causal: bool = False):
        super().__init__()
        self.causal = causal
        self.conv1 = nn.Conv2d(1, channels, 3, stride=2)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=2)
        f4 = subsampled_frames(feat_dim)
        self.proj = nn.Linear(f4 * channels, d_model)

    @staticmethod
    def _conv(conv: nn.Conv2d, x: torch.Tensor, time_pad: Tuple[int, int]) -> torch.Tensor:
        return F.relu(_conv2d_s2(conv, F.pad(x, (*_same_lohi(x.shape[3]), *time_pad))))

    def _proj(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T4, F4 = x.shape
        # flax flattens [B, T4, F4, C] with C fastest
        return self.proj(x.permute(0, 2, 3, 1).reshape(B, T4, F4 * C))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B, ceil(T/4), d_model]
        x = feats[:, None]                                   # [B, 1, T, D]
        # time (1, 1), not TF-SAME, whose lo pad depends on T's parity:
        # the windows must not move with the bucket's padding
        tp = (2, 0) if self.causal else (1, 1)
        for conv in (self.conv1, self.conv2):
            x = self._conv(conv, x, tp)
        return self._proj(x)

    def step(self, feats: torch.Tensor, raw_cache: torch.Tensor, c1_cache: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The causal chunk step: the time convolutions unpadded over [cache
        || chunk] reproduce the left-padded offline ones. feats [B, F, D], F
        a multiple of 4; raw_cache [B, 2, D], c1_cache [B, 2, ceil(D/2), C]
        (the reference's channels-last layout) -> (subsampled [B, F/4,
        d_model], new raw, new c1)."""
        x = torch.cat([raw_cache, feats], dim=1)[:, None]              # [B, 1, 2 + F, D]
        c1 = self._conv(self.conv1, x, (0, 0))                         # [B, C, F/2, ceil(D/2)]
        x2 = torch.cat([c1_cache.permute(0, 3, 1, 2), c1], dim=2)
        c2 = self._conv(self.conv2, x2, (0, 0))
        return self._proj(c2), feats[:, -2:], c1[:, :, -2:].permute(0, 2, 3, 1)


class RelSelfAttention(nn.Module):
    """Multi-head self-attention with a learned clipped relative-position
    bias: bias[h, clip(q - k, -max_rel, max_rel)] added to the logits.
    Queries and keys may differ (streaming: the keys hold the cached left
    context); qpos/kpos carry the positions."""

    def __init__(self, d_model: int, heads: int, max_rel: int = 64):
        super().__init__()
        self.heads, self.max_rel = heads, max_rel
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.o_proj = nn.Linear(d_model, d_model)
        self.rel_bias = nn.Parameter(torch.zeros(heads, 2 * max_rel + 1))

    def forward(
        self,
        xq: torch.Tensor,        # [B, Q, D]
        xkv: torch.Tensor,       # [B, K, D]
        key_mask: torch.Tensor,  # [B, K] bool
        qpos: torch.Tensor,      # [Q]
        kpos: torch.Tensor,      # [K]
        attn_mask: Optional[torch.Tensor] = None,  # [Q, K] bool
    ) -> torch.Tensor:
        B, Q, D = xq.shape
        Kn = xkv.shape[1]
        H = self.heads
        hd = D // H
        q = self.q_proj(xq).reshape(B, Q, H, hd)
        k = self.k_proj(xkv).reshape(B, Kn, H, hd)
        v = self.v_proj(xkv).reshape(B, Kn, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        idx = torch.clamp(qpos[:, None] - kpos[None, :], -self.max_rel, self.max_rel) + self.max_rel
        logits = logits + self.rel_bias[:, idx][None]        # [1, H, Q, K]
        mask = key_mask[:, None, None, :]
        if attn_mask is not None:
            mask = mask & attn_mask[None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
        return self.o_proj(out.reshape(B, Q, D))


class _Ffn(nn.Module):
    def __init__(self, d_model: int, mult: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(d_model, mult * d_model)
        self.fc2 = nn.Linear(mult * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(x)))


class ConformerBlock(nn.Module):
    """Macaron FFN / MHSA / depthwise-conv module / FFN with pre-LayerNorm,
    then LayerNorm (the conv module's BatchNorm is a LayerNorm, as in the
    reference). Padded frames are zeroed before the depthwise convolution, so
    its window never reads them; ``causal`` left-pads it by k - 1 (no
    lookahead), which ``step`` needs."""

    def __init__(self, d_model: int, heads: int = 4, conv_kernel: int = 15, max_rel: int = 64,
                 causal: bool = False):
        super().__init__()
        D = d_model
        self.conv_kernel, self.causal = conv_kernel, causal
        self.ln_ffn1 = nn.LayerNorm(D, eps=LN_EPS)
        self.ffn1 = _Ffn(D)
        self.ln_attn = nn.LayerNorm(D, eps=LN_EPS)
        self.attn = RelSelfAttention(D, heads, max_rel)
        self.ln_conv = nn.LayerNorm(D, eps=LN_EPS)
        self.conv_in = nn.Linear(D, 2 * D)
        self.dconv = nn.Conv1d(D, D, conv_kernel, groups=D)
        self.ln_dconv = nn.LayerNorm(D, eps=LN_EPS)
        self.conv_out = nn.Linear(D, D)
        self.ln_ffn2 = nn.LayerNorm(D, eps=LN_EPS)
        self.ffn2 = _Ffn(D)
        self.ln_out = nn.LayerNorm(D, eps=LN_EPS)

    def _depthwise_valid(self, yp: torch.Tensor) -> torch.Tensor:
        """The depthwise convolution over time, unpadded, as one contraction
        over its taps' windows: [B, T + k - 1, D] -> [B, T, D]."""
        win = yp.unfold(1, self.conv_kernel, 1)              # [B, T, D, k]
        return torch.einsum("btdk,dk->btd", win, self.dconv.weight[:, 0, :]) + self.dconv.bias

    def _conv_tail(self, y: torch.Tensor) -> torch.Tensor:
        return self.conv_out(F.silu(self.ln_dconv(self._depthwise_valid(y))))

    def _conv_module(self, x: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
        y = F.glu(self.conv_in(self.ln_conv(x)), dim=-1)
        y = torch.where(frame_mask[..., None], y, torch.zeros_like(y))
        k = self.conv_kernel
        tp = (k - 1, 0) if self.causal else ((k - 1) // 2, (k - 1) - (k - 1) // 2)
        return self._conv_tail(F.pad(y, (0, 0, *tp)))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + 0.5 * self.ffn1(self.ln_ffn1(x))
        h = self.ln_attn(x)
        x = x + self.attn(h, h, frame_mask, pos, pos, attn_mask)
        x = x + self._conv_module(x, frame_mask)
        x = x + 0.5 * self.ffn2(self.ln_ffn2(x))
        return self.ln_out(x)

    def step(self, x_new: torch.Tensor, x1_ctx: torch.Tensor, ctx_valid: torch.Tensor, y_ctx: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One chunk of C new (all valid) frames [B, C, D] with the cached
        post-FFN1 context x1_ctx [B, Lc, D] (ctx_valid [B, Lc]) and the k - 1
        pre-convolution frames y_ctx -> (out [B, C, D], new x1_ctx, new
        y_ctx)."""
        B, C, _D = x_new.shape
        Lc = x1_ctx.shape[1]
        dev = x_new.device
        x1 = x_new + 0.5 * self.ffn1(self.ln_ffn1(x_new))
        cat = torch.cat([x1_ctx, x1], dim=1)
        h = self.ln_attn(cat)
        kmask = torch.cat([ctx_valid, torch.ones((B, C), dtype=torch.bool, device=dev)], dim=1)
        x2 = x1 + self.attn(h[:, Lc:], h, kmask, torch.arange(C, device=dev) + Lc, torch.arange(Lc + C, device=dev))
        y = F.glu(self.conv_in(self.ln_conv(x2)), dim=-1)
        ycat = torch.cat([y_ctx, y], dim=1)
        x3 = x2 + self._conv_tail(ycat)
        x4 = x3 + 0.5 * self.ffn2(self.ln_ffn2(x3))
        new_x1_ctx = cat[:, cat.shape[1] - Lc:] if Lc > 0 else x1_ctx
        return self.ln_out(x4), new_x1_ctx, ycat[:, -(self.conv_kernel - 1):]


class ConformerEncoder(nn.Module):
    """Subsample 4x, then a stack of Conformer blocks. ``chunk_frames`` 0 is
    the offline encoder (global attention over each utterance's valid
    frames); above 0 the chunked streaming-capable one (subsampled frames a
    chunk; ``left_chunks`` of left context), whose ``stream_step`` equals
    its offline forward."""

    def __init__(self, feat_dim: int, d_model: int = 144, blocks: int = 4, heads: int = 4, conv_kernel: int = 15,
                 chunk_frames: int = 0, left_chunks: int = 1):
        super().__init__()
        causal = chunk_frames > 0
        self.d_model, self.chunk_frames, self.left_chunks = d_model, int(chunk_frames), int(left_chunks)
        self.sub = ConvSubsample(d_model, feat_dim, causal=causal)
        self.blks = nn.ModuleList(ConformerBlock(d_model, heads, conv_kernel, causal=causal) for _ in range(blocks))

    def chunk_mask(self, T: int, device: torch.device) -> Optional[torch.Tensor]:
        """[T, T] bool: query q may attend key k (same chunk or up to
        left_chunks before it); None for the offline encoder."""
        if self.chunk_frames <= 0:
            return None
        c = torch.arange(T, device=device) // self.chunk_frames
        return (c[None, :] <= c[:, None]) & (c[None, :] >= c[:, None] - self.left_chunks)

    def forward(self, feats: torch.Tensor, n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(encoded [B, ceil(T/4), d_model], zero past each row's n_out; n_out [B])."""
        nf = n_frames.to(feats.device)
        x = torch.where(valid_mask(nf, feats.shape[1], feats.device)[..., None], feats, torch.zeros_like(feats))
        x = self.sub(x)
        n_out = subsampled_frames(nf)
        mask = valid_mask(n_out, x.shape[1], x.device)
        x = torch.where(mask[..., None], x, torch.zeros_like(x))
        attn_mask = self.chunk_mask(x.shape[1], x.device)
        for blk in self.blks:
            x = blk(x, mask, attn_mask)
        return x, n_out

    def stream_step(self, feats_chunk: torch.Tensor, state: Dict) -> Tuple[torch.Tensor, Dict]:
        """One chunk of 4 chunk_frames (all valid) feature frames -> (enc
        [B, chunk_frames, d_model], new state); see ``aed_stream_init``."""
        x, raw, c1 = self.sub.step(feats_chunk, state["raw"], state["c1"])
        B, C, _ = x.shape
        x1_list, y_list = [], []
        for i, blk in enumerate(self.blks):
            x, x1c, yc = blk.step(x, state["x1"][i], state["valid"], state["y"][i])
            x1_list.append(x1c)
            y_list.append(yc)
        Lc = state["valid"].shape[1]
        valid = state["valid"]
        if Lc > 0:
            valid = torch.cat([valid, torch.ones((B, C), dtype=torch.bool, device=valid.device)], dim=1)[:, -Lc:]
        return x, {"raw": raw, "c1": c1, "valid": valid, "x1": x1_list, "y": y_list}


@functools.lru_cache(maxsize=64)
def _positions_on(U: int, D: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_sin_positions`` as a tensor on ``device``, copied there once per
    shape (a beam step reuses it without a host copy)."""
    return torch.as_tensor(_sin_positions(U, D)).to(device=device, dtype=dtype)


def _sin_positions(U: int, D: int) -> np.ndarray:
    """Sinusoidal absolute positions for the decoder (any length, no params),
    in numpy float32 as the reference computes them."""
    pos = np.arange(U)[:, None]
    i = np.arange((D + 1) // 2)[None, :]  # ceil(D/2): survives odd d_model
    ang = pos / np.power(10000.0, 2 * i / D)
    out = np.zeros((U, D), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang[:, : D // 2])
    return out


def _mha(q_proj: nn.Linear, k_proj: nn.Linear, v_proj: nn.Linear, o_proj: nn.Linear, heads: int,
         x: torch.Tensor, mem: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multi-head attention of x [B, U, D] over mem [B, M, D]; mask
    broadcasts to [B, H, U, M] (False: NEG_INF)."""
    B, U, D = x.shape
    hd = D // heads
    q = q_proj(x).reshape(B, U, heads, hd)
    k = k_proj(mem).reshape(B, -1, heads, hd)
    v = v_proj(mem).reshape(B, -1, heads, hd)
    logits = torch.einsum("buhd,bthd->bhut", q, k) / math.sqrt(hd)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    out = torch.einsum("bhut,bthd->buhd", torch.softmax(logits, dim=-1), v)
    return o_proj(out.reshape(B, U, D))


class CrossAttention(nn.Module):
    """Decoder-side multi-head attention over the encoder's valid frames."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(d_model, d_model, bias=False)
        self.k = nn.Linear(d_model, d_model, bias=False)
        self.v = nn.Linear(d_model, d_model, bias=False)
        self.o = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, mem: torch.Tensor, mem_mask: torch.Tensor) -> torch.Tensor:
        return _mha(self.q, self.k, self.v, self.o, self.heads, x, mem, mem_mask[:, None, None, :])


class DecoderBlock(nn.Module):
    """Pre-LayerNorm causal self-attention, cross-attention, FFN."""

    def __init__(self, d_model: int, heads: int = 4):
        super().__init__()
        D = d_model
        self.heads = heads
        self.ln_self = nn.LayerNorm(D, eps=LN_EPS)
        self.q = nn.Linear(D, D, bias=False)
        self.k = nn.Linear(D, D, bias=False)
        self.v = nn.Linear(D, D, bias=False)
        self.o = nn.Linear(D, D)
        self.ln_cross = nn.LayerNorm(D, eps=LN_EPS)
        self.cross = CrossAttention(D, heads)
        self.ln_ffn = nn.LayerNorm(D, eps=LN_EPS)
        self.ffn = _Ffn(D)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor, mem: torch.Tensor, mem_mask: torch.Tensor
                ) -> torch.Tensor:
        y = self.ln_self(x)
        x = x + _mha(self.q, self.k, self.v, self.o, self.heads, y, y, causal_mask[None, None])
        x = x + self.cross(self.ln_cross(x), mem, mem_mask)
        return x + self.ffn(self.ln_ffn(x))


class AedModel(nn.Module):
    """Conformer encoder + Transformer decoder + CTC head. Tokens 0..n_units-1
    are units, sos = n_units, eos = n_units + 1 (decoder side); the CTC head
    has n_units + 1 outputs, blank = n_units."""

    def __init__(self, n_units: int, feat_dim: int, d_model: int = 144, enc_blocks: int = 4, dec_blocks: int = 2,
                 heads: int = 4, conv_kernel: int = 15, chunk_frames: int = 0, left_chunks: int = 1):
        super().__init__()
        self.n_units, self.feat_dim, self.d_model = n_units, feat_dim, d_model
        self.enc_blocks, self.dec_blocks, self.heads, self.conv_kernel = enc_blocks, dec_blocks, heads, conv_kernel
        self.chunk_frames, self.left_chunks = int(chunk_frames), int(left_chunks)
        self.encoder = ConformerEncoder(feat_dim, d_model, enc_blocks, heads, conv_kernel, chunk_frames, left_chunks)
        self.embed = nn.Embedding(self.vocab, d_model)
        self.dec = nn.ModuleList(DecoderBlock(d_model, heads) for _ in range(dec_blocks))
        self.dec_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.out = nn.Linear(d_model, self.vocab)
        self.ctc_head = nn.Linear(d_model, n_units + 1)

    @property
    def sos(self) -> int:
        return self.n_units

    @property
    def eos(self) -> int:
        return self.n_units + 1

    @property
    def vocab(self) -> int:
        return self.n_units + 2

    def encode(self, feats: torch.Tensor, n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(feats, n_frames)

    def encode_with_ctc(self, feats: torch.Tensor, n_frames: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        enc, n_out = self.encoder(feats, n_frames)
        return enc, n_out, self.ctc_head(enc)

    def encode_stream_step(self, feats_chunk: torch.Tensor, state: Dict):
        """A streaming chunk (chunk_frames > 0) -> (enc chunk, CTC logits
        chunk, new state)."""
        enc, state = self.encoder.stream_step(feats_chunk, state)
        return enc, self.ctc_head(enc), state

    def decode_logits(self, enc: torch.Tensor, n_out: torch.Tensor, tokens_in: torch.Tensor) -> torch.Tensor:
        """The causal decoder: tokens_in [B, U] -> logits [B, U, vocab]."""
        U = tokens_in.shape[1]
        dev = enc.device
        mem_mask = valid_mask(n_out.to(dev), enc.shape[1], dev)
        x = self.embed(torch.clamp(tokens_in, min=0))
        x = x * math.sqrt(self.d_model) + _positions_on(U, self.d_model, dev, x.dtype)
        causal = torch.tril(torch.ones((U, U), dtype=torch.bool, device=dev))
        for blk in self.dec:
            x = blk(x, causal, enc, mem_mask)
        return self.out(self.dec_norm(x))

    def forward(self, feats: torch.Tensor, n_frames: torch.Tensor, tokens_in: torch.Tensor):
        enc, n_out, ctc_logits = self.encode_with_ctc(feats, n_frames)
        return self.decode_logits(enc, n_out, tokens_in.to(enc.device)), ctc_logits, n_out


def build_aed_model(n_units: int, tcfg: TrainConfig, feat_dim: int, dec_blocks: Optional[int] = None, heads: int = 4,
                    chunk_frames: int = 0, left_chunks: int = 1) -> AedModel:
    """The TrainConfig -> AedModel derivation shared by training and every
    decoder: d_model = max(heads (nn_hidden // heads), heads), nn_layers
    encoder blocks, max(nn_layers // 2, 1) decoder blocks; chunk_frames > 0
    builds the streaming-capable chunked encoder. Weights uninitialised
    (``am.params.init_`` or ``from_flax``)."""
    d = max(heads * (tcfg.nn_hidden // heads), heads)
    return AedModel(n_units, feat_dim, d_model=d, enc_blocks=tcfg.nn_layers,
                    dec_blocks=dec_blocks if dec_blocks is not None else max(tcfg.nn_layers // 2, 1),
                    heads=heads, chunk_frames=chunk_frames, left_chunks=left_chunks)


def aed_stream_init(model: AedModel, batch: int, n_feats: int, device: Optional[torch.device] = None) -> Dict:
    """Zero streaming state for ``AedModel.encode_stream_step``, on the
    model's device unless ``device`` is given. The offline causal path
    left-pads every convolution with zeros, so zero caches make the first
    chunk equal the offline prefix; ``valid`` starts all False. Layout (B =
    batch, D = d_model, Lc = left_chunks chunk_frames):

      raw   [B, 2, n_feats]                  the last 2 raw feature frames
      c1    [B, 2, ceil(n_feats / 2), 32]    the last 2 first-convolution frames
      valid [B, Lc]                          which context frames exist
      x1    blocks x [B, Lc, D]              post-FFN1 frames (attention keys)
      y     blocks x [B, k - 1, D]           frames before the depthwise conv
    """
    if model.chunk_frames <= 0:
        raise ValueError("streaming state requires chunk_frames > 0")
    dev = _dev_of(model) if device is None else torch.device(device)
    B, D = batch, model.d_model
    Lc = model.left_chunks * model.chunk_frames
    f1 = -(-n_feats // 2)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        "raw": z(B, 2, n_feats),
        "c1": z(B, 2, f1, SUB_CHANNELS),
        "valid": torch.zeros((B, Lc), dtype=torch.bool, device=dev),
        "x1": [z(B, Lc, D) for _ in range(model.enc_blocks)],
        "y": [z(B, model.conv_kernel - 1, D) for _ in range(model.enc_blocks)],
    }


def make_aed_stream_step(model: AedModel):
    """(feats_chunk [B, 4 chunk_frames, F], state) -> (enc [B, chunk_frames,
    D], ctc_logits [B, chunk_frames, n_units + 1], new state), without
    gradients; equal to the offline chunk-masked encoder on the same
    prefix."""

    @torch.no_grad()
    def step(feats_chunk, state):
        return model.encode_stream_step(_on(feats_chunk, _dev_of(model)), state)

    return step


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


def make_teacher_batch(labels: torch.Tensor, n_labels: torch.Tensor, sos: int, eos: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(labels [B, L] -1-padded) -> (dec_in [B, L+1], targets [B, L+1],
    target_mask [B, L+1]): dec_in = sos + labels; targets = labels, eos at
    position n_labels; positions past the eos masked out."""
    B, _L = labels.shape
    dev = labels.device
    nl = n_labels.to(dev).long()
    safe = torch.clamp(labels.long(), min=0)
    dec_in = torch.cat([torch.full((B, 1), sos, dtype=torch.int64, device=dev), safe], dim=1)
    u = torch.arange(safe.shape[1] + 1, device=dev)[None, :]
    tgt = torch.where(u < nl[:, None], F.pad(safe, (0, 1)), eos)
    return dec_in, tgt, u <= nl[:, None]


def smoothed_ce(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor, smoothing: float = 0.1
                ) -> torch.Tensor:
    """Per-utterance label-smoothed cross-entropy (sum over valid tokens)."""
    logp = torch.log_softmax(logits, dim=-1)
    tgt_lp = torch.gather(logp, 2, targets[..., None])[..., 0]
    tok = (1.0 - smoothing) * tgt_lp + smoothing * logp.mean(dim=-1)
    return -torch.where(mask, tok, 0.0).sum(dim=-1)


def init_aed_train_state(model: AedModel, cfg: TrainConfig):
    """A fresh state for an initialised ``model``: the CE path's AdamW and
    schedule (``am.train_nn``)."""
    return init_train_state(model, cfg)


def aed_objective(model: AedModel, feats, n_frames, labels, n_labels, ctc_weight: float = 0.3,
                  smoothing: float = 0.1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(1 - w) label-smoothed attention CE + w CTC on the encoder, each
    through ``masked_mean_objective`` (the CE over n_labels + 1 tokens, the
    CTC over max(n_labels, 1)) -> (loss, {"loss", "ce", "ctc"}). The CTC
    term runs on K3 on the card."""
    dev = feats.device
    nf = n_frames.to(dev)
    labels, n_labels = labels.to(dev), n_labels.to(dev)
    dec_in, tgt, mask = make_teacher_batch(labels, n_labels, model.sos, model.eos)
    dec_logits, ctc_logits, n_out = model(feats, nf, dec_in)
    ce = smoothed_ce(dec_logits, tgt, mask, smoothing)
    ce_obj, ce_nll = masked_mean_objective(ce, nf, n_labels + 1)
    ctc_nll = ctc_loss(ctc_logits, n_out, labels, n_labels)
    ctc_obj, _ = masked_mean_objective(ctc_nll, n_out, torch.clamp(n_labels, min=1))
    loss = (1.0 - ctc_weight) * ce_obj + ctc_weight * ctc_obj
    return loss, {"loss": loss, "ce": ce_nll, "ctc": ctc_obj}


def make_aed_train_step(model: AedModel, cfg: TrainConfig, ctc_weight: float = 0.3, smoothing: float = 0.1,
                        spec_augment: bool = False):
    """(state, feats, n_frames, labels, n_labels) -> (state, {"loss", "ce",
    "ctc"} as 0-dim tensors on the model's device): one AED step; nothing
    reads the card, so the host queues the next step while this one runs
    (read a metric with ``float``, as the reference's jitted step returns
    device arrays). SpecAugment's draws are the CE step's
    (``am.train_nn.step_generator``)."""

    def train_step(state, feats, n_frames, labels, n_labels):
        state.model.train()
        feats_in = _spec_augment(feats, n_frames, step_generator(cfg, state.step)) if spec_augment else feats
        with torch.enable_grad():
            loss, metrics = aed_objective(state.model, feats_in, n_frames, labels, n_labels, ctc_weight, smoothing)
            loss.backward()
        apply_update(state, cfg)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


# --------------------------------------------------------------------------
# Decoding: the batched beam search
# --------------------------------------------------------------------------


def aed_fusion_matrix(model: AedModel, unit_lm, weight: float) -> np.ndarray:
    """The beam's [V, V] shallow-fusion table: entry (prev, token) the
    weighted unit-bigram log-prob; row sos the sentence-initial
    distribution; the sos and eos columns and the eos row zero (ending costs
    no LM term; finished beams' forced eos steps are LM-free)."""
    V, sos = model.vocab, model.sos
    nu = unit_lm.n_units
    assert nu == model.n_units, f"unit LM vocabulary ({nu}) != AED units ({model.n_units})"
    m = np.zeros((V, V), np.float32)
    m[:nu, :nu] = weight * unit_lm.pair_logp
    m[sos, :nu] = weight * unit_lm.init_logp
    return m


def make_aed_decoder(model: AedModel, beam: int = 4, max_tokens: int = 48, ctc_weight: float = 0.0,
                     length_penalty: float = 0.0, return_all: bool = False, fusion: Optional[np.ndarray] = None,
                     early_exit: bool = True, *, use_kernels: bool = True):
    """The batched beam search: (feats, n_frames) -> (tokens [B, U], n_tokens
    [B], scores [B]) on the model's device, or with ``return_all`` all K
    beams best-first ([B, K, U], [B, K], [B, K]). See the module docstring;
    ``length_penalty`` > 0 divides the final scores by (n_tokens + 1)^p.
    ``use_kernels=False`` runs the CTC rescoring on the plain recursion.
    ``decode.steps_run`` holds the last call's loop steps (the early exit
    stops at a multiple of AED_EXIT_CHECK, or at max_tokens)."""
    K, U = int(beam), int(max_tokens)
    sos, eos, V = model.sos, model.eos, model.vocab
    fusion_np = None if fusion is None else np.array(fusion, np.float32)

    @torch.no_grad()
    def decode(feats, n_frames):
        dev = _dev_of(model)
        feats = _on(feats, dev).to(torch.float32)
        nf = _on(n_frames, dev)
        B = feats.shape[0]
        enc, n_out, ctc_logits = model.encode_with_ctc(feats, nf)
        enc_k = torch.repeat_interleave(enc, K, dim=0)          # [B K, T', D]
        n_out_k = torch.repeat_interleave(n_out, K, dim=0)
        toks = torch.full((B, K, U), eos, dtype=torch.int64, device=dev)
        scores = torch.where(torch.arange(K, device=dev) == 0, 0.0, NEG_INF).to(torch.float32).expand(B, K)
        fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
        eos_only = torch.full((V,), NEG_INF, dtype=torch.float32, device=dev)
        eos_only[eos] = 0.0
        fus = None if fusion_np is None else torch.as_tensor(fusion_np, device=dev)
        sos_col = torch.full((B, K, 1), sos, dtype=torch.int64, device=dev)
        u = 0
        while u < U:
            open_ = ~fin.all() if early_exit else None
            dec_in = torch.cat([sos_col, toks[:, :, :-1]], dim=2).reshape(B * K, U)
            logits = model.decode_logits(enc_k, n_out_k, dec_in)
            logp = torch.log_softmax(logits[:, u], dim=-1).reshape(B, K, V)
            if fus is not None:
                prev = sos_col[..., 0] if u == 0 else toks[:, :, u - 1]
                logp = logp + fus[prev]
            logp[:, :, sos] = NEG_INF
            logp = torch.where(fin[..., None], eos_only, logp)
            top, idx = _topk_stable((scores[..., None] + logp).reshape(B, K * V), K)
            src, tok = idx // V, idx % V
            new_toks = torch.gather(toks, 1, src[..., None].expand(B, K, U))
            new_toks[:, :, u] = tok
            new_fin = torch.gather(fin, 1, src) | (tok == eos)
            if early_exit:
                # the reference's while_loop: a step counts only while a beam is open
                toks = torch.where(open_, new_toks, toks)
                scores = torch.where(open_, top, scores)
                fin = torch.where(open_, new_fin, fin)
            else:
                toks, scores, fin = new_toks, top, new_fin
            u += 1
            if early_exit and u % AED_EXIT_CHECK == 0 and u < U and bool(fin.all()):
                break
        decode.steps_run = u
        is_eos = toks == eos
        n_toks = torch.where(is_eos.any(dim=-1), torch.argmax(is_eos.to(torch.uint8), dim=-1), U)
        final = scores
        if ctc_weight > 0.0:
            # K3 over the buffer cut to the longest hypothesis (its NEG_INF
            # states past a row's own do not change the value)
            Lw = max(int(n_toks.max()), 1)
            labels = torch.where(torch.arange(Lw, device=dev) < n_toks[..., None], toks[:, :, :Lw], -1)
            ctc_k = torch.repeat_interleave(ctc_logits, K, dim=0)
            ctc_lp = -ctc_loss(ctc_k, n_out_k, labels.reshape(B * K, Lw), n_toks.reshape(B * K),
                               use_kernels=use_kernels).reshape(B, K)
            final = (1.0 - ctc_weight) * scores + ctc_weight * ctc_lp
        if length_penalty > 0.0:
            final = final / (n_toks.to(torch.float32) + 1.0) ** length_penalty
        if return_all:
            order = torch.sort(-final, dim=1, stable=True).indices
            return (torch.gather(toks, 1, order[..., None].expand(B, K, U)), torch.gather(n_toks, 1, order),
                    torch.gather(final, 1, order))
        best = torch.argmax(final, dim=1)
        rows = torch.arange(B, device=dev)
        return toks[rows, best], n_toks[rows, best], final[rows, best]

    return decode


def aed_decode_batch(model: AedModel, feats, n_frames, beam: int = 4, max_tokens: int = 48, ctc_weight: float = 0.0,
                     length_penalty: float = 0.0, fusion: Optional[np.ndarray] = None) -> List[List[int]]:
    """The beam's best hypothesis of every row as a list of unit ids (the
    caller trims batch padding by its size)."""
    dec = make_aed_decoder(model, beam=beam, max_tokens=max_tokens, ctc_weight=ctc_weight,
                           length_penalty=length_penalty, fusion=fusion)
    toks, n_toks, _ = dec(feats, n_frames)
    toks, n_toks = toks.cpu().numpy(), n_toks.cpu().numpy()
    return [[int(t) for t in toks[b, : n_toks[b]]] for b in range(len(toks))]


# --------------------------------------------------------------------------
# MWER fine-tuning (minimum word/unit error rate)
# --------------------------------------------------------------------------


def aed_seq_logprob(model: AedModel, enc: torch.Tensor, n_out: torch.Tensor, hyps: torch.Tensor,
                    n_hyp_tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced log-probability of unit sequences, the eos emission
    included. enc [R, T', D] / n_out [R] pair with hyps [R, U] (-1-padded),
    n_hyp_tokens [R] -> [R]."""
    dec_in, tgt, mask = make_teacher_batch(hyps, n_hyp_tokens, model.sos, model.eos)
    lp = torch.log_softmax(model.decode_logits(enc, n_out, dec_in), dim=-1)
    tok_lp = torch.gather(lp, 2, tgt[..., None])[..., 0]
    return torch.where(mask, tok_lp, 0.0).sum(dim=-1)


def aed_mwer_objective(model: AedModel, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks, labels, n_labels,
                       ce_weight: float = 0.1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expected risk over the renormalised N-best (hyps [B, N, U] -1-padded,
    n_hyp_tokens [B, N], hyp_mask [B, N], risks [B, N]) minus the mean risk
    of the valid slots, plus ce_weight x the unsmoothed CE on the references.
    Rows without frames or without a valid hypothesis count nothing."""
    dev = feats.device
    hyps, n_hyp_tokens = hyps.to(dev), n_hyp_tokens.to(dev)
    hyp_mask, risks = hyp_mask.to(dev), risks.to(dev, torch.float32)
    nf = n_frames.to(dev)
    B, N, U = hyps.shape
    enc, n_out = model.encode(feats, nf)
    seq_lp = aed_seq_logprob(model, torch.repeat_interleave(enc, N, dim=0), torch.repeat_interleave(n_out, N, dim=0),
                             hyps.reshape(B * N, U), n_hyp_tokens.reshape(B * N)).reshape(B, N)
    seq_lp = torch.where(hyp_mask, seq_lp, NEG_INF)
    phat = torch.softmax(seq_lp, dim=1)
    n_valid = torch.clamp(hyp_mask.sum(dim=1), min=1)
    masked_risk = torch.where(hyp_mask, risks, 0.0)
    rbar = masked_risk.sum(dim=1) / n_valid
    row_risk = (phat * masked_risk).sum(dim=1)
    row_ok = (nf > 0) & hyp_mask.any(dim=1)
    denom = batch_count(row_ok.sum())
    mwer = torch.where(row_ok, row_risk - rbar, 0.0).sum() / denom
    exp_risk = torch.where(row_ok, row_risk, 0.0).sum() / denom
    metrics = {"mwer": mwer, "expected_risk": exp_risk}
    loss = mwer
    if ce_weight > 0.0:
        labels, n_labels = labels.to(dev), n_labels.to(dev)
        dec_in, tgt, mask = make_teacher_batch(labels, n_labels, model.sos, model.eos)
        ce = smoothed_ce(model.decode_logits(enc, n_out, dec_in), tgt, mask, smoothing=0.0)
        ce_obj, _ = masked_mean_objective(ce, nf, n_labels + 1)
        loss = loss + ce_weight * ce_obj
        metrics["ce"] = ce_obj
    metrics["loss"] = loss
    return loss, metrics


def make_aed_mwer_step(model: AedModel, cfg: TrainConfig, ce_weight: float = 0.1):
    """(state, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks, labels,
    n_labels) -> (state, metrics as Python floats): one MWER step; the
    N-best and the risks come from the host (``pipeline.
    finetune_aed_mwer``)."""

    def step(state, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks, labels, n_labels):
        state.model.train()
        with torch.enable_grad():
            loss, metrics = aed_mwer_objective(state.model, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks,
                                               labels, n_labels, ce_weight=ce_weight)
            loss.backward()
        apply_update(state, cfg)
        return state, {k: v.item() for k, v in metrics.items()}

    return step

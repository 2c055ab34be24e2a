"""The Conformer encoder of the attention encoder-decoder: the port of the
encoder half of mogasr/am/aed.py (``subsampled_frames`` to the offline
``ConformerEncoder``), which ``am.neural.ConformerAm`` runs under its head.

Two stride-2 3x3 convolutions over (time, frequency) subsample time 4x (time
padded (1, 1), frequency TF-SAME), a Dense projects to d_model, then a stack
of Conformer blocks: macaron FFN, multi-head self-attention with a learned
clipped relative-position bias, a depthwise convolution module (GLU, padded
frames zeroed before the depthwise kernel, LayerNorm in place of BatchNorm),
FFN, LayerNorm, every LayerNorm with flax's epsilon. Attention is written
out, softmax(QK^T / sqrt(d) + rel_bias) V with padded keys at NEG_INF, as
the reference computes it (it has no Pallas kernel).

The convolutions run as matrix products (``F.unfold`` and a GEMM; the
depthwise one as a sum over its taps), so their float32 precision is the
matmul's: on the card cuBLAS with TF32 off, PyTorch's default, forward and
backward alike, where cuDNN convolutions would take TF32 by default.

Parameters are in torch layouts: a 2-D convolution's weight [out, in, kh,
kw] (flax: [kh, kw, in, out]), the depthwise one [D, 1, k] (flax: [k, 1, D]);
``am.params.from_flax`` converts. The chunked streaming encoder
(``chunk_frames``, causal convolutions, ``stream_step``) and the decoder are
not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mogasr_torch.am.neural import LN_EPS, valid_mask

NEG_INF = -1e30


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
    """Two stride-2 2-D convolutions over (time, frequency), each padded
    (1, 1) in time and TF-SAME in frequency, then a Dense to d_model: 4x fewer
    frames (ceil-div by 2 per convolution)."""

    def __init__(self, d_model: int, feat_dim: int, channels: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(1, channels, 3, stride=2)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=2)
        f4 = subsampled_frames(feat_dim)
        self.proj = nn.Linear(f4 * channels, d_model)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B, ceil(T/4), d_model]
        x = feats[:, None]                                   # [B, 1, T, D]
        for conv in (self.conv1, self.conv2):
            # time (1, 1), not TF-SAME, whose lo pad depends on T's parity:
            # the windows must not move with the bucket's padding
            x = F.relu(_conv2d_s2(conv, F.pad(x, (*_same_lohi(x.shape[3]), 1, 1))))
        B, C, T4, F4 = x.shape
        # flax flattens [B, T4, F4, C] with C fastest
        return self.proj(x.permute(0, 2, 3, 1).reshape(B, T4, F4 * C))


class RelSelfAttention(nn.Module):
    """Multi-head self-attention with a learned clipped relative-position
    bias: bias[h, clip(q - k, -max_rel, max_rel)] added to the logits."""

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
    its window never reads them."""

    def __init__(self, d_model: int, heads: int = 4, conv_kernel: int = 15, max_rel: int = 64):
        super().__init__()
        D = d_model
        self.conv_kernel = conv_kernel
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

    def _depthwise(self, y: torch.Tensor) -> torch.Tensor:
        """The depthwise convolution over time, SAME-padded, as a sum over
        its taps: [B, T, D] -> [B, T, D]."""
        k = self.conv_kernel
        T = y.shape[1]
        yp = F.pad(y, (0, 0, (k - 1) // 2, (k - 1) - (k - 1) // 2))
        w = self.dconv.weight[:, 0, :]                       # [D, k]
        out = self.dconv.bias
        for j in range(k):
            out = out + yp[:, j:j + T] * w[:, j]
        return out

    def _conv_module(self, x: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
        y = F.glu(self.conv_in(self.ln_conv(x)), dim=-1)
        y = torch.where(frame_mask[..., None], y, torch.zeros_like(y))
        return self.conv_out(F.silu(self.ln_dconv(self._depthwise(y))))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + 0.5 * self.ffn1(self.ln_ffn1(x))
        h = self.ln_attn(x)
        x = x + self.attn(h, h, frame_mask, pos, pos, attn_mask)
        x = x + self._conv_module(x, frame_mask)
        x = x + 0.5 * self.ffn2(self.ln_ffn2(x))
        return self.ln_out(x)


class ConformerEncoder(nn.Module):
    """Subsample 4x, then a stack of Conformer blocks (the offline encoder:
    global attention over each utterance's valid frames)."""

    def __init__(self, feat_dim: int, d_model: int = 144, blocks: int = 4, heads: int = 4, conv_kernel: int = 15):
        super().__init__()
        self.d_model = d_model
        self.sub = ConvSubsample(d_model, feat_dim)
        self.blks = nn.ModuleList(ConformerBlock(d_model, heads, conv_kernel) for _ in range(blocks))

    def forward(self, feats: torch.Tensor, n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(encoded [B, ceil(T/4), d_model], zero past each row's n_out; n_out [B])."""
        nf = n_frames.to(feats.device)
        x = torch.where(valid_mask(nf, feats.shape[1], feats.device)[..., None], feats, torch.zeros_like(feats))
        x = self.sub(x)
        n_out = subsampled_frames(nf)
        mask = valid_mask(n_out, x.shape[1], x.device)
        x = torch.where(mask[..., None], x, torch.zeros_like(x))
        for blk in self.blks:
            x = blk(x, mask)
        return x, n_out

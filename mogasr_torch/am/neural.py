"""Neural frame classifiers for hybrid NN-HMM decoding: the port of
mogasr/am/neural.py.

Every family maps (feats [B, T, D], n_frames [B]) to logits [B, T, n_pdfs];
hybrid decoding turns them into scaled likelihoods,
log p(x|s) ~ log p(s|x) - log p(s) (``posteriors_to_loglik``), with state
priors from alignment label counts (``state_priors``).

The modules hold their parameters in the layouts the port computes with (a
torch ``Linear`` weight is [out, in], a ``Conv1d`` weight [out, in, k], an
LSTM layer its prefused ``w_in`` [D, 4H], ``w_rec`` [H, 4H] and ``bias``
[4H] in flax's gate order i, f, g, o); ``am.params.from_flax`` converts a
flax checkpoint of the reference to a ``state_dict``, ``am.params.init_``
draws fresh weights with flax's initializers. LayerNorm uses flax's
epsilon, 1e-6. Unlike flax, a module needs its input width when built
(``feat_dim``).

LstmAm and BlstmAm run each layer as one input GEMM over all frames
(``torch.matmul``) and then the recurrence: kernel K4 (``am.lstm_cuda``) on
the card, the plain loop (``am.fast_lstm``) on the CPU or with
``use_kernels=False``. Their carries freeze at each row's n_frames, so
padded frames differ from flax's stock ``nn.RNN`` (which keeps evolving
them); valid frames agree.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mogasr_torch.am import fast_lstm, lstm_cuda
from mogasr_torch.config import TrainConfig
from mogasr_torch.dist.comm import batch_count

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon (torch's default is 1e-5)


def splice_frames(feats: torch.Tensor, n_frames: torch.Tensor, context: int) -> torch.Tensor:
    """[B, T, D] -> [B, T, (2*context+1)*D] with per-utterance edge clamping."""
    if context == 0:
        return feats
    B, T, D = feats.shape
    t = torch.arange(T, device=feats.device)[None, :]
    last = torch.clamp(n_frames.to(feats.device).long() - 1, min=0)[:, None]
    cols = []
    for off in range(-context, context + 1):
        idx = torch.minimum(torch.clamp(t + off, min=0), last)
        cols.append(torch.gather(feats, 1, idx[:, :, None].expand(B, T, D)))
    return torch.cat(cols, dim=-1)


def valid_mask(n_frames: torch.Tensor, T: int, device: torch.device) -> torch.Tensor:
    """[B, T] bool: frame t of row b is valid (t < n_frames[b])."""
    return torch.arange(T, device=device)[None, :] < n_frames.to(device)[:, None]


def dense(layer: nn.Linear, x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """``layer(x)`` in float32, or with bf16 operands (float32 result)."""
    if compute_dtype == "bfloat16":
        return F.linear(x.to(torch.bfloat16), layer.weight.to(torch.bfloat16)).float() + layer.bias
    return layer(x)


class MlpAm(nn.Module):
    """Feed-forward frame classifier over spliced context windows."""

    def __init__(self, n_pdfs: int, feat_dim: int, hidden: int = 512, layers: int = 3, context: int = 4):
        super().__init__()
        self.n_pdfs, self.hidden, self.layers, self.context = n_pdfs, hidden, layers, context
        dims = [(2 * context + 1) * feat_dim] + [hidden] * layers
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(nn.LayerNorm(hidden, eps=LN_EPS) for _ in range(layers))
        self.head = nn.Linear(hidden, n_pdfs)

    def forward(self, feats: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        x = splice_frames(feats, n_frames, self.context)
        for d, ln in zip(self.dense, self.norms):
            x = F.relu(ln(d(x)))
        return self.head(x)


class LstmLayer(nn.Module):
    """One LSTM layer in the prefused layout: gates = x @ w_in + bias + h @ w_rec."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.w_in = nn.Parameter(torch.empty(in_dim, 4 * hidden))
        self.w_rec = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def input_gates(self, x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
        """xg [B, T, 4H] float32: the input projection of every frame, one GEMM."""
        if compute_dtype == "bfloat16":
            return torch.matmul(x.to(torch.bfloat16), self.w_in.to(torch.bfloat16)).float() + self.bias
        return torch.matmul(x, self.w_in) + self.bias

    def forward(self, x, n_frames, compute_dtype="float32", use_kernels=True):
        layer = lstm_cuda.lstm_layer if use_kernels else fast_lstm.lstm_layer
        return layer(self.input_gates(x, compute_dtype), self.w_rec, n_frames, compute_dtype)


def flip_valid(x: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
    """Reverse each row's first n_frames frames along time, the padding kept
    after them (flax's ``flip_sequences``; applying it twice is the identity)."""
    B, T = x.shape[:2]
    t = torch.arange(T, device=x.device)[None, :]
    idx = (T - 1 - t + n_frames.to(x.device).long()[:, None]) % T
    return torch.gather(x, 1, idx[:, :, None].expand(x.shape))


class LstmAm(nn.Module):
    """Unidirectional stacked-LSTM frame classifier."""

    def __init__(self, n_pdfs: int, feat_dim: int, hidden: int = 512, layers: int = 2):
        super().__init__()
        self.n_pdfs, self.hidden, self.layers = n_pdfs, hidden, layers
        self.cells = nn.ModuleList(LstmLayer(feat_dim if i == 0 else hidden, hidden) for i in range(layers))
        self.head = nn.Linear(hidden, n_pdfs)

    def forward(self, feats, n_frames, compute_dtype: str = "float32", use_kernels: bool = True):
        """compute_dtype "bfloat16": bf16 operands in the input GEMMs, K4 and
        the head, float32 sums, gates, carries and logits."""
        x = feats.to(torch.float32)
        for cell in self.cells:
            x = cell(x, n_frames, compute_dtype, use_kernels)
        return dense(self.head, x, compute_dtype)


Carries = List[Tuple[torch.Tensor, torch.Tensor]]  # per layer (c, h) [B, H], flax's order


def lstm_stream_apply(
    model: LstmAm,
    feats: torch.Tensor,                  # [B, Tc, D] a chunk
    carries: Carries,
    n_valid: Optional[torch.Tensor] = None,  # [B]; None: every frame
    compute_dtype: str = "float32",
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Carries]:
    """(logits [B, Tc, P], the carries after the chunk): LstmAm's forward
    from the given carries, each layer's recurrence on K4's carry arm on the
    card (``lstm_cuda.lstm_layer`` with h0, c0 and return_carry). The carries
    are each row's at its n_valid, and a row with n_valid == 0 keeps its own,
    as the reference restores them. Past n_valid the outputs repeat the
    frozen h, where flax's go on; valid frames agree."""
    B, T = feats.shape[:2]
    nv = torch.full((B,), T, dtype=torch.int32, device=feats.device) if n_valid is None else n_valid
    layer = lstm_cuda.lstm_layer if use_kernels else fast_lstm.lstm_layer
    x = feats.to(torch.float32)
    new: Carries = []
    for cell, (c, h) in zip(model.cells, carries):
        x, (h, c) = layer(cell.input_gates(x, compute_dtype), cell.w_rec, nv, compute_dtype, h0=h, c0=c,
                          return_carry=True)
        new.append((c, h))
    return dense(model.head, x, compute_dtype), new


class LstmAmStream(LstmAm):
    """Chunked stateful forward of LstmAm, the port of the reference's
    ``LstmAmStream``: the same parameters (so ``am.params.from_flax`` of an
    LstmAm checkpoint loads into it), carrying each layer's (c, h) across
    calls, so any chunking gives the offline LstmAm's outputs."""

    def forward(self, feats, carries: Carries, n_valid=None, compute_dtype: str = "float32",
                use_kernels: bool = True) -> Tuple[torch.Tensor, Carries]:
        return lstm_stream_apply(self, feats, carries, n_valid, compute_dtype, use_kernels)


def lstm_stream_init(model: LstmAm, batch: int, device: torch.device) -> Carries:
    """Zero (c, h) carries for a batch of streams."""
    zero = torch.zeros((batch, model.hidden), dtype=torch.float32, device=device)
    return [(zero, zero) for _ in range(model.layers)]


def make_lstm_stream_step(model: LstmAm, log_priors: torch.Tensor, compute_dtype: str = "float32",
                          use_kernels: bool = True):
    """(carries, feats chunk [B, Tc, D]) -> (carries, loglik chunk): the
    offline LstmAm's parameters used as they are, with the prior scaling of
    ``pipeline.make_nn_scorer``."""

    @torch.no_grad()
    def step(carries: Carries, feats: torch.Tensor) -> Tuple[Carries, torch.Tensor]:
        logits, new = lstm_stream_apply(model, feats, carries, None, compute_dtype, use_kernels)
        return new, posteriors_to_loglik(logits, log_priors)

    return step


class BlstmAm(nn.Module):
    """Bidirectional stacked-LSTM frame classifier (offline decoding).

    Per layer, the forward LSTM and, on each row's valid prefix reversed and
    then re-reversed, the backward LSTM (flax's ``Bidirectional`` with
    ``seq_lengths``); their outputs concatenate to [B, T, 2H]."""

    def __init__(self, n_pdfs: int, feat_dim: int, hidden: int = 512, layers: int = 2):
        super().__init__()
        self.n_pdfs, self.hidden, self.layers = n_pdfs, hidden, layers
        dims = [feat_dim] + [2 * hidden] * (layers - 1)
        self.fwd = nn.ModuleList(LstmLayer(d, hidden) for d in dims)
        self.bwd = nn.ModuleList(LstmLayer(d, hidden) for d in dims)
        self.head = nn.Linear(2 * hidden, n_pdfs)

    def forward(self, feats, n_frames, compute_dtype: str = "float32", use_kernels: bool = True):
        x = feats.to(torch.float32)
        for fwd, bwd in zip(self.fwd, self.bwd):
            back = flip_valid(bwd(flip_valid(x, n_frames), n_frames, compute_dtype, use_kernels), n_frames)
            x = torch.cat([fwd(x, n_frames, compute_dtype, use_kernels), back], dim=-1)
        return dense(self.head, x, compute_dtype)


class TdnnAm(nn.Module):
    """Time-delay NN: dilated 1-D convolutions over time (dilation 1, 2, 4,
    ...), padding zeroed before the first and after every layer."""

    def __init__(self, n_pdfs: int, feat_dim: int, hidden: int = 512, layers: int = 3, kernel: int = 3):
        super().__init__()
        self.n_pdfs, self.hidden, self.layers, self.kernel = n_pdfs, hidden, layers, kernel
        self.convs = nn.ModuleList(
            nn.Conv1d(feat_dim if i == 0 else hidden, hidden, kernel, dilation=2 ** i, padding="same")
            for i in range(layers))
        self.norms = nn.ModuleList(nn.LayerNorm(hidden, eps=LN_EPS) for _ in range(layers))
        self.head = nn.Linear(hidden, n_pdfs)

    def forward(self, feats: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        mask = valid_mask(n_frames, feats.shape[1], feats.device).to(feats.dtype)[:, :, None]
        x = feats * mask
        for conv, ln in zip(self.convs, self.norms):
            x = conv(x.transpose(1, 2)).transpose(1, 2)
            x = F.relu(ln(x)) * mask
        return self.head(x)


def moe_block_dense(
    x: torch.Tensor,      # [N, H] tokens
    Wr: torch.Tensor,     # [H, E] router
    W1: torch.Tensor,     # [E, H, F]
    b1: torch.Tensor,     # [E, F]
    W2: torch.Tensor,     # [E, F, H]
    b2: torch.Tensor,     # [E, H]
    valid: torch.Tensor,  # [N] bool: the load-balance loss counts valid tokens only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1-routed MoE FFN, dense: every token through every expert, the
    routed one kept. Returns (y [N, H], the Switch-style load-balance loss
    E * sum_e mean(gate_prob_e) * mean(route_frac_e) over valid tokens)."""
    n_exp = Wr.shape[1]
    scores = x @ Wr
    probs = torch.softmax(scores, dim=-1)
    e = torch.argmax(scores, dim=-1)
    gate = torch.gather(probs, 1, e[:, None])[:, 0]
    ys = torch.einsum("nh,ehf->nef", x, W1) + b1[None]
    ys = torch.einsum("nef,efh->neh", F.relu(ys), W2) + b2[None]
    y = gate[:, None] * ys[torch.arange(x.shape[0], device=x.device), e]
    vw = valid.to(probs.dtype)
    n_valid = torch.clamp(vw.sum(), min=1.0)
    me = (probs * vw[:, None]).sum(0) / n_valid
    ce = (F.one_hot(e, n_exp).to(probs.dtype) * vw[:, None]).sum(0) / n_valid
    return y, n_exp * (me * ce).sum()


class MoeBlock(nn.Module):
    """One pre-LN residual MoE FFN block's parameters."""

    def __init__(self, hidden: int, n_experts: int, ffn: int):
        super().__init__()
        self.ln = nn.LayerNorm(hidden, eps=LN_EPS)
        self.Wr = nn.Parameter(torch.empty(hidden, n_experts))
        self.W1 = nn.Parameter(torch.empty(n_experts, hidden, ffn))
        self.b1 = nn.Parameter(torch.zeros(n_experts, ffn))
        self.W2 = nn.Parameter(torch.empty(n_experts, ffn, hidden))
        self.b2 = nn.Parameter(torch.zeros(n_experts, hidden))


class MoeAm(nn.Module):
    """Mixture-of-experts frame classifier, dense single-device form:
    spliced context -> input projection -> ``layers`` pre-LN residual MoE
    FFN blocks (top-1 routing) -> LayerNorm -> head. The load-balance losses
    are what training adds; inference drops them."""

    def __init__(self, n_pdfs: int, feat_dim: int, hidden: int = 512, layers: int = 2, context: int = 4,
                 n_experts: int = 4, ffn: int = 0):
        super().__init__()
        self.n_pdfs, self.hidden, self.layers, self.context = n_pdfs, hidden, layers, context
        self.n_experts, self.ffn = n_experts, ffn or 2 * hidden
        self.in_proj = nn.Linear((2 * context + 1) * feat_dim, hidden)
        self.blocks = nn.ModuleList(MoeBlock(hidden, n_experts, self.ffn) for _ in range(layers))
        self.ln_out = nn.LayerNorm(hidden, eps=LN_EPS)
        self.head = nn.Linear(hidden, n_pdfs)

    def forward(self, feats: torch.Tensor, n_frames: torch.Tensor, return_aux: bool = False):
        """Logits [B, T, n_pdfs]; with ``return_aux`` also the list of each
        block's load-balance loss, which training adds (the reference sows
        them into its "losses" collection)."""
        B, T, _ = feats.shape
        x = self.in_proj(splice_frames(feats, n_frames, self.context))
        valid = valid_mask(n_frames, T, feats.device).reshape(-1)
        lbs = []
        for blk in self.blocks:
            h = blk.ln(x).reshape(B * T, self.hidden)
            y, lb = moe_block_dense(h, blk.Wr, blk.W1, blk.b1, blk.W2, blk.b2, valid)
            lbs.append(lb)
            x = x + y.reshape(B, T, self.hidden)
        logits = self.head(self.ln_out(x))
        return (logits, lbs) if return_aux else logits


class ConformerAm(nn.Module):
    """Conformer frame classifier: the 4x-subsampled Conformer encoder
    (``am.aed.ConformerEncoder``) and an output head, its logits repeated 4x
    back to the input frame rate and cut to T, so that every consumer sees
    [B, T, n_pdfs]. ``subsampled`` gives the 25 Hz head without the repeat."""

    def __init__(self, n_pdfs: int, feat_dim: int, hidden: int = 256, layers: int = 3, heads: int = 4,
                 conv_kernel: int = 15):
        super().__init__()
        from mogasr_torch.am.aed import ConformerEncoder  # aed imports this module

        self.n_pdfs, self.hidden, self.layers = n_pdfs, hidden, layers
        d = max(heads * (hidden // heads), heads)
        self.enc = ConformerEncoder(feat_dim, d_model=d, blocks=layers, heads=heads, conv_kernel=conv_kernel)
        self.head = nn.Linear(d, n_pdfs)

    def forward(self, feats: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        enc, _n_out = self.enc(feats, n_frames)
        return torch.repeat_interleave(self.head(enc), 4, dim=1)[:, : feats.shape[1]]

    def subsampled(self, feats: torch.Tensor, n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, ceil(T/4), P], n_out [B]) without the repeat-upsample."""
        enc, n_out = self.enc(feats, n_frames)
        return self.head(enc), n_out


RECURRENT = (LstmAm, BlstmAm)  # families whose forward takes compute_dtype and use_kernels


def build_model(arch: str, n_pdfs: int, cfg: TrainConfig, feat_dim: int) -> nn.Module:
    """The reference's ``build_model`` with the input width given; weights
    are uninitialised (``am.params.init_`` or a ``from_flax`` state_dict)."""
    if arch == "conformer":
        return ConformerAm(n_pdfs, feat_dim, hidden=cfg.nn_hidden, layers=cfg.nn_layers)
    if arch == "mlp":
        return MlpAm(n_pdfs, feat_dim, hidden=cfg.nn_hidden, layers=cfg.nn_layers, context=cfg.nn_context)
    if arch == "lstm":
        return LstmAm(n_pdfs, feat_dim, hidden=cfg.nn_hidden, layers=max(cfg.nn_layers - 1, 1))
    if arch == "blstm":
        return BlstmAm(n_pdfs, feat_dim, hidden=cfg.nn_hidden, layers=max(cfg.nn_layers - 1, 1))
    if arch == "tdnn":
        return TdnnAm(n_pdfs, feat_dim, hidden=cfg.nn_hidden, layers=cfg.nn_layers)
    if arch == "moe":
        return MoeAm(n_pdfs, feat_dim, hidden=cfg.nn_hidden, layers=max(cfg.nn_layers - 1, 1),
                     context=cfg.nn_context, n_experts=cfg.nn_experts, ffn=cfg.moe_ffn)
    raise ValueError(f"unknown arch {arch!r}")


def spec_augment(
    feats: torch.Tensor,        # [B, T, D]
    n_frames: torch.Tensor,     # [B]
    generator: torch.Generator,
    n_time_masks: int = 2,
    time_mask_width: int = 20,
    n_feat_masks: int = 2,
    feat_mask_width: int = 8,
) -> torch.Tensor:
    """SpecAugment-style time and feature masking: zeroed regions (the
    features are about CMVN-normalized, so zero is the mean), widths fixed,
    positions drawn from ``generator`` (a CPU generator: the draws do not
    depend on the device).

    The widths are capped as the reference caps them: a time mask by T (the
    bucket) and by each utterance's n_frames, so that a short utterance in a
    long bucket is never zeroed whole, a feature mask by D. A time mask
    starts inside the utterance, so padding is never masked past it.
    """
    B, T, D = feats.shape
    dev = feats.device
    nf = n_frames.to(device=dev, dtype=torch.int64)
    tw_static = max(min(time_mask_width, T // (4 * max(n_time_masks, 1))), 1)
    tw = torch.clamp(torch.clamp(nf // (4 * max(n_time_masks, 1)), max=tw_static), min=1)[:, None, None]
    fw = max(min(feat_mask_width, D // (4 * max(n_feat_masks, 1))), 1)
    t_idx = torch.arange(T, device=dev)[None, :, None]
    d_idx = torch.arange(D, device=dev)[None, None, :]
    out = feats
    for _ in range(n_time_masks):
        hi = torch.clamp(nf[:, None, None] - tw + 1, min=1)  # exclusive: the last frame can be masked
        u = torch.rand((B, 1, 1), generator=generator).to(dev)
        start = torch.minimum((u * hi).long(), hi - 1)
        out = torch.where((t_idx >= start) & (t_idx < start + tw), torch.zeros_like(out), out)
    for _ in range(n_feat_masks):
        start = torch.randint(0, max(D - fw + 1, 1), (B, 1, 1), generator=generator).to(dev)
        out = torch.where((d_idx >= start) & (d_idx < start + fw), torch.zeros_like(out), out)
    return out


def frame_ce_loss(
    logits: torch.Tensor,  # [B, T, P]
    labels: torch.Tensor,  # [B, T] pdf ids, -1 padding
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked frame cross-entropy -> (mean loss, frame accuracy)."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[:, :, None])[:, :, 0]
    n = batch_count(valid.sum())
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n
    acc = (valid & (torch.argmax(logits, dim=-1) == safe)).sum() / n
    return loss, acc


def state_priors(labels: np.ndarray, n_pdfs: int, smooth: float = 1.0) -> np.ndarray:
    """log p(s) from alignment label counts (for hybrid decoding)."""
    counts = np.bincount(labels[labels >= 0].reshape(-1), minlength=n_pdfs) + smooth
    return np.log(counts / counts.sum()).astype(np.float32)


def posteriors_to_loglik(logits: torch.Tensor, log_priors: torch.Tensor) -> torch.Tensor:
    """Hybrid scaled likelihood: log p(x|s) ∝ log p(s|x) - log p(s)."""
    return torch.log_softmax(logits, dim=-1) - log_priors[None, None, :]

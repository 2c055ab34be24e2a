"""Neural language models (LSTM and causal Transformer): training,
perplexity and batched N-best rescoring, the port of mogasr/lm/neural.py.

The neural LM is a second pass: N-best hypotheses (from a lattice or a
prefix beam) are scored by the LM in one padded batch, and the scores are
log-linearly interpolated with the first-pass ones.

``NeuralLm`` runs each LSTM layer as ``am.neural.LstmLayer``: the input
GEMM over all tokens, then the recurrence, on kernel K4 (``am.lstm_cuda``)
in a forward without gradients on the card (the scorer: perplexity and
rescoring), the plain recurrence (``am.fast_lstm``) on the CPU and under
autograd (training: K4 has no backward). Carries freeze at each row's
length, where flax's ``nn.RNN(seq_lengths=...)`` keeps evolving its outputs;
every consumer masks by the length, so the scores agree.

``TransformerLm`` is written out: learned positions, pre-norm blocks with
causal attention (masked logits at the reference's -1e30, then softmax),
a GELU FFN (the tanh approximation, flax's ``nn.gelu``), LayerNorm with
flax's epsilon 1e-6. Training uses the CE path's optimizer
(``am.train_nn``). ``am.params.from_flax`` converts the reference's
parameters; ``am.params.init_`` draws fresh ones.

Checkpoints are the port's format (``utils.checkpoint``): <dir>/nnlm.json
(the reference's keys) and <dir>/ckpt holding ``{"params": state_dict}``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mogasr_torch.am.neural import LN_EPS, LstmLayer
from mogasr_torch.am.train_nn import TrainState, apply_update, init_train_state
from mogasr_torch.config import TrainConfig

MASK_LOGIT = -1e30  # the reference's causal-mask logit


# --------------------------------------------------------------------------
# Vocabulary
# --------------------------------------------------------------------------


class LmVocab(NamedTuple):
    """Token inventory with reserved <s>/</s>/<unk> ids at the end."""

    tokens: Tuple[str, ...]  # regular tokens only (specials are implicit)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens) + 3  # + bos, eos, unk

    @property
    def bos(self) -> int:
        return len(self.tokens)

    @property
    def eos(self) -> int:
        return len(self.tokens) + 1

    @property
    def unk(self) -> int:
        return len(self.tokens) + 2

    def encode(self, words: Sequence[str]) -> List[int]:
        idx = _index_cache(self)
        return [idx.get(w.lower(), self.unk) for w in words]


_INDEX_CACHE: Dict[int, Dict[str, int]] = {}


def _index_cache(vocab: LmVocab) -> Dict[str, int]:
    key = id(vocab.tokens)
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = {t: i for i, t in enumerate(vocab.tokens)}
    return _INDEX_CACHE[key]


def vocab_from_transcripts(transcripts: Sequence[Sequence[str]]) -> LmVocab:
    toks = sorted({w.lower() for s in transcripts for w in s})
    return LmVocab(tuple(toks))


# --------------------------------------------------------------------------
# Models: (tokens_in [B, U], n_tokens [B]) -> next-token logits [B, U, V]
# --------------------------------------------------------------------------


class NeuralLm(nn.Module):
    """Token-level LSTM LM: P(w_u | w_<u). Input is [B, U] ids starting with
    <s>; output is next-token logits [B, U, V]."""

    def __init__(self, n_tokens: int, embed: int = 64, hidden: int = 128, layers: int = 1):
        super().__init__()
        self.n_tokens, self.embed, self.hidden, self.layers = n_tokens, embed, hidden, layers
        self.embedding = nn.Embedding(n_tokens, embed)
        self.cells = nn.ModuleList(LstmLayer(embed if i == 0 else hidden, hidden) for i in range(layers))
        self.head = nn.Linear(hidden, n_tokens)

    def forward(self, tokens_in: torch.Tensor, n_tokens: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        x = self.embedding(tokens_in.long())
        for cell in self.cells:
            x = cell(x, n_tokens, "float32", use_kernels)
        return self.head(x)


class TransformerBlock(nn.Module):
    """One pre-norm block: causal multi-head attention, then the FFN."""

    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.ln_attn = nn.LayerNorm(d, eps=LN_EPS)
        self.q = nn.Linear(d, d, bias=False)
        self.k = nn.Linear(d, d, bias=False)
        self.v = nn.Linear(d, d, bias=False)
        self.o = nn.Linear(d, d)
        self.ln_ffn = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)


class TransformerLm(nn.Module):
    """Causal Transformer LM with NeuralLm's contract. Padding needs no mask
    of its own: ``lm_batch`` pads after the valid prefix, so the causal mask
    hides every padded key from every valid query."""

    def __init__(self, n_tokens: int, embed: int = 64, hidden: int = 128, layers: int = 2, heads: int = 4,
                 max_len: int = 512):
        super().__init__()
        self.n_tokens, self.embed, self.hidden, self.layers = n_tokens, embed, hidden, layers
        self.heads, self.max_len = heads, max_len
        self.embedding = nn.Embedding(n_tokens, embed)
        self.pos = nn.Embedding(max_len, embed)
        self.blocks = nn.ModuleList(TransformerBlock(embed, hidden) for _ in range(layers))
        self.ln_out = nn.LayerNorm(embed, eps=LN_EPS)
        self.head = nn.Linear(embed, n_tokens)

    def forward(self, tokens_in: torch.Tensor, n_tokens: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        B, U = tokens_in.shape
        D, H = self.embed, self.heads
        hd = D // H
        dev = tokens_in.device
        x = self.embedding(tokens_in.long()) + self.pos(torch.arange(U, device=dev))[None]
        causal = torch.tril(torch.ones((U, U), dtype=torch.bool, device=dev))
        for blk in self.blocks:
            h = blk.ln_attn(x)
            q = blk.q(h).reshape(B, U, H, hd)
            k = blk.k(h).reshape(B, U, H, hd)
            v = blk.v(h).reshape(B, U, H, hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            logits = torch.where(causal[None, None], logits, MASK_LOGIT)
            att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
            x = x + blk.o(att.reshape(B, U, D))
            h = blk.ln_ffn(x)
            x = x + blk.fc2(F.gelu(blk.fc1(h), approximate="tanh"))
        return self.head(self.ln_out(x))


def build_nnlm(vocab: LmVocab, cfg: TrainConfig, arch: str = "lstm") -> nn.Module:
    """arch "lstm" (NeuralLm) or "transformer" (TransformerLm), the
    reference's sizes; weights uninitialised (``am.params.init_`` or a
    ``from_flax`` state_dict)."""
    if arch == "transformer":
        return TransformerLm(vocab.n_tokens, embed=max(cfg.nn_hidden // 2, 16), hidden=cfg.nn_hidden,
                             layers=cfg.nn_layers)
    if arch != "lstm":
        raise ValueError(f"unknown nnlm arch: {arch!r}")
    return NeuralLm(vocab.n_tokens, embed=max(cfg.nn_hidden // 2, 8), hidden=cfg.nn_hidden, layers=cfg.nn_layers)


# --------------------------------------------------------------------------
# Batching (host): [<s>, w1..wn] -> targets [w1..wn, </s>]
# --------------------------------------------------------------------------


def lm_batch(seqs: Sequence[Sequence[int]], vocab: LmVocab, u_max: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad to u_max: (inp [B, u_max], tgt [B, u_max], n [B]) with n =
    len(seq) + 1 (eos is a real prediction target). Sequences longer than
    u_max - 1 are truncated."""
    B = len(seqs)
    inp = np.full((B, u_max), vocab.eos, np.int32)
    tgt = np.full((B, u_max), vocab.eos, np.int32)
    n = np.zeros(B, np.int32)
    for b, s in enumerate(seqs):
        s = list(s)[: u_max - 1]
        inp[b, 0] = vocab.bos
        inp[b, 1: 1 + len(s)] = s
        tgt[b, : len(s)] = s
        tgt[b, len(s)] = vocab.eos
        n[b] = len(s) + 1
    return inp, tgt, n


# --------------------------------------------------------------------------
# Scoring and training
# --------------------------------------------------------------------------


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _token_logp(model: nn.Module, inp, tgt, n, use_kernels: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-token target log-probs [B, U], valid mask [B, U] float)."""
    dev = _model_device(model)
    inp, tgt, n = (torch.as_tensor(np.asarray(a)).to(dev) for a in (inp, tgt, n))
    logp = torch.log_softmax(model(inp, n, use_kernels=use_kernels), dim=-1)
    tok_lp = torch.gather(logp, 2, tgt.long()[..., None])[..., 0]
    mask = (torch.arange(tgt.shape[1], device=dev)[None, :] < n[:, None]).to(tok_lp.dtype)
    return tok_lp, mask


def make_nnlm_scorer(model: nn.Module, use_kernels: bool = True):
    """Batched sequence scorer: (inp, tgt, n) -> total log-prob [B] on the
    model's device, without gradients (K4 for NeuralLm on the card)."""

    @torch.no_grad()
    def score(inp, tgt, n) -> torch.Tensor:
        model.eval()
        tok_lp, mask = _token_logp(model, inp, tgt, n, use_kernels)
        return torch.sum(tok_lp * mask, dim=1)

    return score


def init_nnlm_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """A fresh state for an initialised ``model``: the CE path's AdamW and
    schedule (``am.train_nn``)."""
    return init_train_state(model, cfg)


def make_nnlm_train_step(model: nn.Module, cfg: TrainConfig):
    """(state, inp, tgt, n) -> (state, {"loss"}): the mean next-token NLL
    over the valid positions, on the plain recurrence under autograd."""

    def train_step(state: TrainState, inp, tgt, n):
        state.model.train()
        with torch.enable_grad():
            tok_lp, mask = _token_logp(state.model, inp, tgt, n, use_kernels=False)
            nll = -torch.sum(tok_lp * mask)
            loss = nll / torch.clamp(torch.sum(mask), min=1.0)
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item()}

    return train_step


def train_nnlm(
    transcripts: Sequence[Sequence[str]],
    vocab: LmVocab,
    cfg: TrainConfig,
    batch_size: int = 64,
    seed: int = 0,
    arch: str = "lstm",
    logger=None,
    device=torch.device("cuda"),
) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """Train the neural LM (LSTM or causal Transformer) on word transcripts
    for cfg.num_nn_steps steps on ``device`` -> (model, state_dict). Weights
    are drawn from ``seed``; the batches are the reference's draws (numpy
    ``default_rng(seed)``), all padded to one u_max."""
    from mogasr_torch.am.params import init_

    model = build_nnlm(vocab, cfg, arch=arch)
    init_(model, torch.Generator().manual_seed(seed)).to(torch.device(device))
    state = init_nnlm_train_state(model, cfg)
    step_fn = make_nnlm_train_step(model, cfg)
    seqs = [vocab.encode(s) for s in transcripts]
    u_max = max(len(s) for s in seqs) + 1
    rng = np.random.default_rng(seed)
    for i in range(cfg.num_nn_steps):
        pick = rng.integers(0, len(seqs), size=min(batch_size, len(seqs)))
        inp, tgt, n = lm_batch([seqs[j] for j in pick], vocab, u_max)
        state, m = step_fn(state, inp, tgt, n)
        if logger is not None and (i % 50 == 0 or i == cfg.num_nn_steps - 1):
            logger.log({"stage": "train_nnlm", "step": i, "loss": m["loss"]})
    model.eval()
    return model, model.state_dict()


def nnlm_perplexity(model: nn.Module, vocab: LmVocab, transcripts: Sequence[Sequence[str]],
                    use_kernels: bool = True) -> float:
    """Held-out per-token perplexity (eos counts as a token, as in training)."""
    seqs = [vocab.encode(s) for s in transcripts]
    u_max = max(len(s) for s in seqs) + 1
    inp, tgt, n = lm_batch(seqs, vocab, u_max)
    lp = make_nnlm_scorer(model, use_kernels)(inp, tgt, n).cpu().numpy()
    return float(np.exp(-np.sum(lp) / np.sum(n)))


# --------------------------------------------------------------------------
# N-best rescoring
# --------------------------------------------------------------------------


def rescore_nbest_nnlm(
    model: nn.Module,
    vocab: LmVocab,
    nbest: Sequence[Sequence[Tuple[Sequence[str], float]]],
    weight: float = 0.5,
    u_max: Optional[int] = None,
    use_kernels: bool = True,
) -> List[List[Tuple[List[str], float]]]:
    """Rescore per-utterance N-best lists [(words, first_pass_logp), ...]:
    combined = first_pass_logp + weight * nnlm_logp, all hypotheses of all
    utterances scored in one padded batch; each list re-sorted by combined
    score (a stable sort: ties keep their input order)."""
    flat: List[Tuple[int, List[str], float]] = []
    for u, lst in enumerate(nbest):
        for words, lp in lst:
            flat.append((u, [w.lower() for w in words], float(lp)))
    if not flat:
        return [[] for _ in nbest]
    seqs = [vocab.encode(words) for _, words, _ in flat]
    if u_max is None:
        u_max = max(len(s) for s in seqs) + 1
    inp, tgt, n = lm_batch(seqs, vocab, u_max)
    lm_lp = make_nnlm_scorer(model, use_kernels)(inp, tgt, n).cpu().numpy()
    out: List[List[Tuple[List[str], float]]] = [[] for _ in nbest]
    for (u, words, lp), nlp in zip(flat, lm_lp):
        out[u].append((words, lp + weight * float(nlp)))
    for lst in out:
        lst.sort(key=lambda x: -x[1])
    return out


# --------------------------------------------------------------------------
# Save / load
# --------------------------------------------------------------------------


def save_nnlm(ckpt_dir: str, model: nn.Module, vocab: LmVocab) -> None:
    """<ckpt_dir>/nnlm.json (the reference's keys) and <ckpt_dir>/ckpt, the
    port's checkpoint of ``{"params": state_dict}``."""
    from mogasr_torch.utils.checkpoint import save_checkpoint

    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "nnlm.json"), "w") as f:
        json.dump({"tokens": list(vocab.tokens), "arch": "transformer" if isinstance(model, TransformerLm) else "lstm",
                   "embed": model.embed, "hidden": model.hidden, "layers": model.layers}, f)
    save_checkpoint(os.path.join(ckpt_dir, "ckpt"), {"params": model.state_dict()}, step=0)


def load_nnlm(ckpt_dir: str, device=torch.device("cuda")) -> Tuple[nn.Module, LmVocab]:
    """(model in eval mode on ``device``, vocab) of a ``save_nnlm`` dir."""
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    with open(os.path.join(ckpt_dir, "nnlm.json")) as f:
        meta = json.load(f)
    vocab = LmVocab(tuple(meta["tokens"]))
    cls = TransformerLm if meta.get("arch", "lstm") == "transformer" else NeuralLm
    model = cls(vocab.n_tokens, embed=meta["embed"], hidden=meta["hidden"], layers=meta["layers"])
    ck = restore_checkpoint(os.path.join(ckpt_dir, "ckpt"))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in ck["params"].items()})
    return model.to(torch.device(device)).eval(), vocab

"""Sequence-discriminative training of the hybrid NN (MMI and sMBR): the port
of mogasr/am/nn_seq.py.

The reference differentiates through its forward-backward scan: d loglik /
d emit_ll is the acoustic scale times the pdf occupancies, and d E[acc] /
d emit_ll the acoustic scale times the signed sMBR weights. The port runs
the forward-backward on kernel K3 (K3f, K3b and their combine, ``fb_cuda``)
and gets those two gradients from the identities, as two autograd
Functions:

- ``FbLoglik``: the per-utterance loglik from K3; its backward the scaled
  pdf occupancies of K3's log gamma (``state_posteriors_to_pdf``), zero on
  padded frames. MMI runs it on the numerator (the utterances' align graphs,
  K3's chain arm) and the denominator (the word loop, its general arm).
- ``SmbrAcc``: the posterior-expected frame accuracy E[acc] from K3's gamma
  over the denominator; its backward the scaled signed weights of
  ``am.smbr.smbr_quantities``, whose accuracy-carrying passes are plain
  PyTorch frame loops (there is no kernel for them).

On the CPU ``fb_cuda`` runs the plain passes, so the Functions run there too;
``use_kernels=False`` differentiates through the plain passes
(``decoder.forward_backward``) with autograd instead, the Functions' plain
version. The CE priors stay frozen; the acoustic scale is MMI's kappa
(about 0.1). The network's forward is ``am.train_nn.train_logits`` (LstmAm
and BlstmAm on their plain recurrence).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mogasr_torch import pipeline as pipe
from mogasr_torch.am.neural import posteriors_to_loglik, valid_mask
from mogasr_torch.am.smbr import smbr_quantities
from mogasr_torch.am.train_nn import TrainState, apply_update, init_train_state, train_logits
from mogasr_torch.config import DecodeConfig, TrainConfig
from mogasr_torch.decoder import fb_cuda
from mogasr_torch.dist.comm import batch_count
from mogasr_torch.decoder import forward_backward as fbd
from mogasr_torch.decoder.viterbi import graphs_to_torch
from mogasr_torch.hmm import graph as gr

Graphs = Dict[str, torch.Tensor]


def expected_accuracy(log_gamma: torch.Tensor, emit_id: torch.Tensor, ref_pdf: torch.Tensor,
                      n_frames: torch.Tensor) -> torch.Tensor:
    """E[acc] [B] = sum over valid frames and states of gamma(t, j) times
    1[emit_id(j) == ref_pdf(t)] (the reference's, gamma floored at exp(-80))."""
    T = log_gamma.shape[1]
    acc = emit_id.to(log_gamma.device)[:, None, :] == ref_pdf.to(log_gamma.device)[:, :, None]
    mask = valid_mask(n_frames, T, log_gamma.device)[..., None]
    gamma = torch.where(mask, torch.exp(torch.clamp(log_gamma, min=-80.0)), torch.zeros_like(log_gamma))
    return (gamma * acc.to(gamma.dtype)).sum(dim=(1, 2))


class FbLoglik(torch.autograd.Function):
    """loglik [B] of the forward-backward on K3; backward: the incoming
    gradient times acoustic_scale times the pdf occupancies, zero on padded
    frames."""

    @staticmethod
    def forward(ctx, emit_ll: torch.Tensor, graphs: Graphs, n_frames: torch.Tensor, acoustic_scale: float):
        res = fb_cuda.forward_backward(emit_ll, graphs, n_frames, acoustic_scale=acoustic_scale)
        ctx.save_for_backward(res.log_gamma)
        ctx.emit_id, ctx.n_pdfs, ctx.scale = graphs["emit_id"], emit_ll.shape[-1], float(acoustic_scale)
        return res.loglik

    @staticmethod
    def backward(ctx, grad_loglik: torch.Tensor):
        (log_gamma,) = ctx.saved_tensors
        occ = fbd.state_posteriors_to_pdf(log_gamma, ctx.emit_id, ctx.n_pdfs)
        return ctx.scale * occ * grad_loglik[:, None, None], None, None, None


class SmbrAcc(torch.autograd.Function):
    """E[acc] [B] over the denominator graphs from K3's gamma; backward: the
    incoming gradient times acoustic_scale times the signed sMBR weights
    (``am.smbr.smbr_quantities``)."""

    @staticmethod
    def forward(ctx, emit_ll: torch.Tensor, den_graphs: Graphs, ref_pdf: torch.Tensor, n_frames: torch.Tensor,
                acoustic_scale: float):
        res = fb_cuda.forward_backward(emit_ll, den_graphs, n_frames, acoustic_scale=acoustic_scale)
        ctx.save_for_backward(emit_ll, ref_pdf, n_frames)
        ctx.graphs, ctx.scale = den_graphs, float(acoustic_scale)
        return expected_accuracy(res.log_gamma, den_graphs["emit_id"], ref_pdf, n_frames)

    @staticmethod
    def backward(ctx, grad_acc: torch.Tensor):
        emit_ll, ref_pdf, n_frames = ctx.saved_tensors
        q = smbr_quantities(emit_ll, ctx.graphs, ref_pdf, n_frames, ctx.scale, emit_ll.shape[-1])
        return ctx.scale * q.weights_pdf * grad_acc[:, None, None], None, None, None, None


def fb_loglik(emit_ll, graphs, n_frames, acoustic_scale: float, use_kernels: bool = True) -> torch.Tensor:
    """Per-utterance loglik with a gradient: ``FbLoglik`` or, without
    kernels, autograd through the plain passes."""
    if use_kernels:
        return FbLoglik.apply(emit_ll, graphs, n_frames, acoustic_scale)
    return fbd.forward_backward(emit_ll, graphs, n_frames, acoustic_scale=acoustic_scale).loglik


def smbr_accuracy(emit_ll, den_graphs, ref_pdf, n_frames, acoustic_scale: float,
                  use_kernels: bool = True) -> torch.Tensor:
    """Per-utterance E[acc] with a gradient: ``SmbrAcc`` or, without
    kernels, autograd through the plain passes."""
    if use_kernels:
        return SmbrAcc.apply(emit_ll, den_graphs, ref_pdf, n_frames, acoustic_scale)
    res = fbd.forward_backward(emit_ll, den_graphs, n_frames, acoustic_scale=acoustic_scale)
    return expected_accuracy(res.log_gamma, den_graphs["emit_id"], ref_pdf, n_frames)


def _per_frame_mean(values: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
    """The mean over rows with frames of values / n_frames."""
    nf = n_frames.to(values.device)
    valid = nf > 0
    per_frame = torch.where(valid, values / torch.clamp(nf, min=1), torch.zeros_like(values))
    return per_frame.sum() / batch_count(valid.sum())


def nn_mmi_objective(
    model: nn.Module,
    log_priors: torch.Tensor,
    feats: torch.Tensor,      # [B, T, D]
    n_frames: torch.Tensor,   # [B]
    num_graphs: Graphs,
    den_graphs: Graphs,
    acoustic_scale: float = 0.1,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, mmi_per_frame): loss = -(the mean over rows with frames of
    (num - den) / n_frames)."""
    logits, _aux = train_logits(model, feats, n_frames)
    ll = posteriors_to_loglik(logits, log_priors)
    num = fb_loglik(ll, num_graphs, n_frames, acoustic_scale, use_kernels)
    den = fb_loglik(ll, den_graphs, n_frames, acoustic_scale, use_kernels)
    mmi = _per_frame_mean(num - den, n_frames)
    return -mmi, mmi


def nn_smbr_objective(
    model: nn.Module,
    log_priors: torch.Tensor,
    feats: torch.Tensor,      # [B, T, D]
    n_frames: torch.Tensor,   # [B]
    den_graphs: Graphs,
    ref_pdf: torch.Tensor,    # [B, T] reference pdf ids (-1 on padding)
    acoustic_scale: float = 0.1,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, acc_per_frame): sMBR, the posterior-expected frame accuracy
    over the word-loop denominator, per frame."""
    logits, _aux = train_logits(model, feats, n_frames)
    ll = posteriors_to_loglik(logits, log_priors)
    acc = _per_frame_mean(smbr_accuracy(ll, den_graphs, ref_pdf, n_frames, acoustic_scale, use_kernels), n_frames)
    return -acc, acc


def make_nn_mmi_step(cfg: TrainConfig, log_priors: torch.Tensor, acoustic_scale: float = 0.1,
                     use_kernels: bool = True):
    """(state, feats, n_frames, num_graphs, den_graphs) -> (state, metrics
    {"loss", "mmi_per_frame"}): one MMI step with the CE trainer's optimizer."""

    def train_step(state: TrainState, feats, n_frames, num_graphs, den_graphs):
        state.model.train()
        with torch.enable_grad():
            loss, mmi = nn_mmi_objective(state.model, log_priors, feats, n_frames, num_graphs, den_graphs,
                                         acoustic_scale, use_kernels)
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item(), "mmi_per_frame": mmi.item()}

    return train_step


def make_nn_smbr_step(cfg: TrainConfig, log_priors: torch.Tensor, acoustic_scale: float = 0.1,
                      use_kernels: bool = True):
    """(state, feats, n_frames, den_graphs, ref_pdf) -> (state, metrics
    {"loss", "acc_per_frame"}): one sMBR step."""

    def train_step(state: TrainState, feats, n_frames, den_graphs, ref_pdf):
        state.model.train()
        with torch.enable_grad():
            loss, acc = nn_smbr_objective(state.model, log_priors, feats, n_frames, den_graphs, ref_pdf,
                                          acoustic_scale, use_kernels)
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item(), "acc_per_frame": acc.item()}

    return train_step


def _den_graphs(den_graph: gr.Graph, rows: int, device: torch.device) -> Graphs:
    return graphs_to_torch(gr.batch_graphs([den_graph] * rows), device)


def _loop(prepared: Sequence, steps: int, step_fn, state: TrainState, metric: str, stage: str, logger
          ) -> List[float]:
    if not prepared:
        raise ValueError(f"{stage}: no batches to train on (an empty list would loop forever)")
    history: List[float] = []
    i = 0
    while i < steps:
        for args in prepared:
            state, m = step_fn(state, *args)
            history.append(m[metric])
            i += 1
            if logger is not None and (i % 10 == 0 or i == steps):
                logger.log({"stage": stage, "step": i, metric: history[-1]})
            if i >= steps:
                break
    return history


def finetune_nn_mmi(
    batches,                  # Sequence[pipeline.FeatBatch]
    lexicon,
    topo,
    model: nn.Module,
    log_priors,
    tcfg: TrainConfig,
    steps: int,
    acoustic_scale: float = 0.1,
    logger=None,
    *,
    den_graph: Optional[gr.Graph] = None,
    align_fn=None,
    use_kernels: bool = True,
) -> Tuple[nn.Module, List[float]]:
    """MMI fine-tuning of a CE-trained hybrid NN, in place, with a fresh
    optimizer (the reference's) -> (model, the per-frame MMI criterion of
    each step). Numerator graphs: each batch's align graphs (``align_fn``
    overrides the monophone expansion, e.g. the tied-triphone
    ``hmm.triphone.align_graph_cd``); denominator: ``den_graph``, by default
    the word loop at ``acoustic_scale``."""
    if den_graph is None:
        den_graph = pipe.word_decode_graph(lexicon, topo, DecodeConfig(acoustic_scale=acoustic_scale))
    dev = next(model.parameters()).device
    lp = torch.as_tensor(log_priors, dtype=torch.float32).to(dev)
    prepared = [(fb.feats, fb.n_frames,
                 graphs_to_torch(pipe.build_align_graphs(fb.words, lexicon, topo, align_fn=align_fn), dev),
                 _den_graphs(den_graph, fb.feats.shape[0], dev)) for fb in batches]
    state = init_train_state(model, tcfg)
    history = _loop(prepared, steps, make_nn_mmi_step(tcfg, lp, acoustic_scale, use_kernels), state,
                    "mmi_per_frame", "nn_mmi", logger)
    return model, history


def finetune_nn_smbr(
    labeled,                  # Sequence[(FeatBatch, labels [B, T])]
    lexicon,
    topo,
    model: nn.Module,
    log_priors,
    tcfg: TrainConfig,
    steps: int,
    acoustic_scale: float = 0.1,
    logger=None,
    *,
    den_graph: Optional[gr.Graph] = None,
    use_kernels: bool = True,
) -> Tuple[nn.Module, List[float]]:
    """sMBR fine-tuning of a CE-trained hybrid NN against its alignment
    labels (the CE targets are the sMBR reference), in place -> (model, the
    per-frame expected accuracy of each step)."""
    if den_graph is None:
        den_graph = pipe.word_decode_graph(lexicon, topo, DecodeConfig(acoustic_scale=acoustic_scale))
    dev = next(model.parameters()).device
    lp = torch.as_tensor(log_priors, dtype=torch.float32).to(dev)
    prepared = [(fb.feats, fb.n_frames, _den_graphs(den_graph, fb.feats.shape[0], dev), labels.to(dev))
                for fb, labels in labeled]
    state = init_train_state(model, tcfg)
    history = _loop(prepared, steps, make_nn_smbr_step(tcfg, lp, acoustic_scale, use_kernels), state,
                    "acc_per_frame", "nn_smbr", logger)
    return model, history

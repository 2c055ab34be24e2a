"""Neural acoustic-model training: frame cross-entropy on forced-alignment
labels, the port of mogasr/am/train_nn.py.

The optimizer is the reference's optax chain, written with
``torch.optim.AdamW``: the gradients clipped to global norm 5, then AdamW
(b1 0.9, b2 0.999, eps 1e-8, ``cfg.weight_decay`` on every parameter) at the
learning rate of optax's ``warmup_cosine_decay_schedule`` (init 0, peak
``cfg.lr``, warmup ``max(steps // 20, 1)``, decay steps ``max(steps, 2)``,
end 0), set before each update from the step count as optax reads it.

The models train where they live (the card unless the caller asks for the
CPU). Their forward runs under autograd: LstmAm and BlstmAm with
``use_kernels=False``, the plain recurrence (``am.fast_lstm``), since kernel
K4 has no backward (its wrapper refuses a forward that needs one), as the
reference trains through its stock scan and never through its Pallas
kernel. Decoding keeps K4.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mogasr_torch.am.neural import RECURRENT, MoeAm, frame_ce_loss, spec_augment
from mogasr_torch.config import TrainConfig

CLIP_NORM = 5.0


def lr_schedule(cfg: TrainConfig):
    """step -> learning rate: optax's ``warmup_cosine_decay_schedule`` with
    the reference's arguments (a linear warmup from 0, then a cosine decay to
    0 over the remaining steps, constant past them)."""
    peak = float(cfg.lr)
    warmup = max(cfg.num_nn_steps // 20, 1)
    decay = max(cfg.num_nn_steps, 2) - warmup

    def lr(step: int) -> float:
        if step < warmup:
            return peak * (min(max(step, 0), warmup) / warmup)
        c = min(step - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return lr


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer (AdamW's moments) and the
    number of updates taken, which the learning rate and SpecAugment's draws
    read."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.Optimizer:
    """AdamW over every parameter of ``model``; :func:`apply_update` clips
    and sets the learning rate."""
    return torch.optim.AdamW(model.parameters(), lr=float(cfg.lr), betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=float(cfg.weight_decay))


def init_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """A fresh state for ``model`` (already initialised: ``am.params.init_``
    or a ``from_flax`` state_dict)."""
    return TrainState(model, make_optimizer(model, cfg), 0)


def clip_by_global_norm_(params: List[nn.Parameter], max_norm: float = CLIP_NORM,
                         split: Optional[Tuple[Iterable[nn.Parameter], Optional[dist.ProcessGroup]]] = None
                         ) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient scaled by max_norm /
    norm when the global norm is at or above max_norm; returns the norm.
    The norms and the scaling are multi-tensor launches (a few in all, not
    a few a parameter). ``split`` = (parameters, process group): those
    parameters are this rank's slices of tensors split over the group (a
    tensor- or expert-parallel model), so their squared norm is summed over
    the group before the root; the others are whole on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if split is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        ids = {id(p) for p in split[0]}
        zero = torch.zeros((), device=grads[0].device)

        def sq(gs):
            return torch.stack(torch._foreach_norm(gs)).square().sum() if gs else zero

        part = sq([p.grad for p in params if p.grad is not None and id(p) in ids])
        dist.all_reduce(part, group=split[1])
        norm = torch.sqrt(sq([p.grad for p in params if p.grad is not None and id(p) not in ids]) + part)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def apply_update(state: TrainState, cfg: TrainConfig,
                 split: Optional[Tuple[Iterable[nn.Parameter], Optional[dist.ProcessGroup]]] = None) -> None:
    """Clip the gradients (``split``: as :func:`clip_by_global_norm_`), take
    one AdamW step at the schedule's learning rate for ``state.step``, zero
    the gradients, count the step."""
    clip_by_global_norm_([p for group in state.opt.param_groups for p in group["params"]], split=split)
    lr = lr_schedule(cfg)(state.step)
    for group in state.opt.param_groups:
        group["lr"] = lr
    state.opt.step()
    state.opt.zero_grad(set_to_none=True)
    state.step += 1


def train_logits(model: nn.Module, feats: torch.Tensor, n_frames: torch.Tensor
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(logits, auxiliary losses) of a training forward: MoeAm's load-balance
    terms, none for the other families; LstmAm and BlstmAm on their plain
    recurrence (K4 has no backward)."""
    if isinstance(model, MoeAm):
        return model(feats, n_frames, return_aux=True)
    if isinstance(model, RECURRENT):
        return model(feats, n_frames, use_kernels=False), []
    return model(feats, n_frames), []


def step_generator(cfg: TrainConfig, step: int) -> torch.Generator:
    """The CPU generator of one step's random draws, seeded from (cfg.seed,
    step) as the reference folds the step into its key."""
    seed = int(np.random.SeedSequence([int(cfg.seed), int(step)]).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def make_train_step(cfg: TrainConfig, spec_aug: bool = False):
    """(state, feats [B, T, D], n_frames [B], labels [B, T]) -> (state,
    metrics): one CE step. The loss is frame CE plus ``cfg.moe_lb_weight``
    times the sum of the auxiliary losses; the metrics are "loss" (that
    total), "ce" and "frame_acc", as Python floats."""

    def train_step(state: TrainState, feats: torch.Tensor, n_frames: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, float]]:
        model = state.model
        model.train()
        feats_in = spec_augment(feats, n_frames, step_generator(cfg, state.step)) if spec_aug else feats
        with torch.enable_grad():
            logits, aux = train_logits(model, feats_in, n_frames)
            ce, acc = frame_ce_loss(logits, labels.to(logits.device))
            loss = ce + cfg.moe_lb_weight * sum(aux, torch.zeros((), device=logits.device))
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item(), "ce": ce.item(), "frame_acc": acc.item()}

    return train_step


def make_eval_step():
    """(model, feats, n_frames, labels) -> {"loss", "frame_acc"} without
    gradients (K4 runs for LstmAm and BlstmAm on the card)."""

    @torch.no_grad()
    def eval_step(model: nn.Module, feats, n_frames, labels) -> Dict[str, float]:
        model.eval()
        loss, acc = frame_ce_loss(model(feats, n_frames), labels.to(feats.device))
        return {"loss": float(loss), "frame_acc": float(acc)}

    return eval_step

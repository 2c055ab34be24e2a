"""Teacher-student knowledge distillation for CTC acoustic models: the port of
mogasr/am/distill.py.

A trained CTC teacher's frame posteriors at temperature tau are the soft
targets of a student over the same units and frame rate; the loss is
alpha * KL(teacher || student) * tau^2 + (1 - alpha) * the student's CTC
loss (``am.ctc``: kernel K3 on the card). The teacher runs without
gradients on the clean features (LstmAm and BlstmAm teachers on kernel K4 on
the card); SpecAugment, when on, perturbs only the student's input. The step
is the CTC step's (``am.ctc.make_ctc_train_step``): the same optimizer,
state and checkpoint layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mogasr_torch.am.ctc import ctc_loss, masked_mean_objective
from mogasr_torch.am.neural import RECURRENT, spec_augment, valid_mask
from mogasr_torch.am.train_nn import TrainState, apply_update, step_generator, train_logits
from mogasr_torch.config import TrainConfig
from mogasr_torch.dist.comm import batch_count


def distill_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor, n_frames: torch.Tensor,
               temperature: float = 1.0) -> torch.Tensor:
    """Masked mean frame-level KL(teacher_tau || student_tau) * tau^2 over the
    valid frames."""
    tau = float(temperature)
    logp_t = torch.log_softmax(teacher_logits / tau, dim=-1)
    logp_s = torch.log_softmax(student_logits / tau, dim=-1)
    kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_s), dim=-1)  # [B, T]
    mask = valid_mask(n_frames, student_logits.shape[1], kl.device)
    n_valid = batch_count(mask.sum())
    return torch.where(mask, kl, 0.0).sum() / n_valid * (tau * tau)


def teacher_logits(teacher_model: nn.Module, feats: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
    """The teacher's logits without gradients (K4 for a recurrent teacher on
    the card)."""
    with torch.no_grad():
        teacher_model.eval()
        if isinstance(teacher_model, RECURRENT):
            return teacher_model(feats, n_frames, use_kernels=True)
        return teacher_model(feats, n_frames)


def distill_objective(
    student_model: nn.Module,
    teacher_model: nn.Module,
    feats: torch.Tensor,        # student input (possibly augmented)
    feats_clean: torch.Tensor,  # teacher input (always clean)
    n_frames: torch.Tensor,
    labels: torch.Tensor,
    n_labels: torch.Tensor,
    alpha: float = 0.5,
    temperature: float = 2.0,
    blank_id: Optional[int] = None,
    *,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """alpha * soft KL + (1 - alpha) * hard CTC -> (loss, {"kl", "ctc",
    "utt_nll"})."""
    t_logits = teacher_logits(teacher_model, feats_clean, n_frames)
    s_logits, _aux = train_logits(student_model, feats, n_frames)
    kl = distill_kl(s_logits, t_logits, n_frames, temperature)
    nll = ctc_loss(s_logits, n_frames, labels, n_labels, blank_id, use_kernels=use_kernels)
    hard, mean_nll = masked_mean_objective(nll, n_frames, n_labels)
    loss = alpha * kl + (1.0 - alpha) * hard
    return loss, {"kl": kl, "ctc": hard, "utt_nll": mean_nll}


def make_distill_train_step(
    teacher_model: nn.Module,
    cfg: TrainConfig,
    alpha: float = 0.5,
    temperature: float = 2.0,
    blank_id: Optional[int] = None,
    spec_aug: bool = False,
    *,
    use_kernels: bool = True,
):
    """(state, feats, n_frames, labels, n_labels) -> (state, metrics) of the
    student in ``state``; metrics "loss", "kl", "ctc", "utt_nll" as Python
    floats."""

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        model = state.model
        model.train()
        feats_in = spec_augment(feats, n_frames, step_generator(cfg, state.step)) if spec_aug else feats
        with torch.enable_grad():
            loss, aux = distill_objective(model, teacher_model, feats_in, feats, n_frames, labels, n_labels,
                                          alpha=alpha, temperature=temperature, blank_id=blank_id,
                                          use_kernels=use_kernels)
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item(), **{k: v.item() for k, v in aux.items()}}

    return train_step


def distill_kl_oracle_np(student_logits, teacher_logits, n_frames, temperature=1.0) -> float:
    """NumPy oracle for distill_kl (tests)."""
    tau = float(temperature)
    s = np.asarray(student_logits, np.float64) / tau
    t = np.asarray(teacher_logits, np.float64) / tau

    def logsm(x):
        m = x.max(axis=-1, keepdims=True)
        z = x - m
        return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))

    lp_t, lp_s = logsm(t), logsm(s)
    kl = (np.exp(lp_t) * (lp_t - lp_s)).sum(axis=-1)
    total, n = 0.0, 0
    for b, nf in enumerate(np.asarray(n_frames)):
        total += kl[b, : int(nf)].sum()
        n += int(nf)
    return total / max(n, 1) * tau * tau

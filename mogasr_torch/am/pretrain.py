"""Self-supervised encoder pretraining, masked predictive coding (MPC): the
port of mogasr/am/pretrain.py.

Random time spans of the input features are zeroed and the network,
``build_model(arch, feat_dim, ...)`` with its head sized to the feature
width, is trained to reconstruct the original features there (mean squared
error over the masked and valid positions only: padding is never masked nor
scored). Every trunk parameter keeps the name it has in the supervised model
of the same family, so ``transfer_pretrained`` is a merge of state_dicts by
name and shape (the head, sized otherwise, keeps its fresh weights). The
spans are drawn from a CPU ``torch.Generator`` seeded from (cfg.seed, step),
as the reference folds the step into its key; the optimizer is the CE
trainer's (``am.train_nn``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from mogasr_torch.am.neural import build_model
from mogasr_torch.am.params import init_
from mogasr_torch.am.train_nn import TrainState, apply_update, init_train_state, step_generator, train_logits
from mogasr_torch.config import TrainConfig
from mogasr_torch.dist.comm import batch_count


def span_time_mask(
    generator: torch.Generator,
    n_frames: torch.Tensor,   # [B]
    t_max: int,
    n_masks: int = 4,
    width: int = 12,
) -> torch.Tensor:
    """Bool [B, T]: the union of n_masks random spans per row, clipped to the
    valid prefix. Widths uniform in [1, width]; starts uniform in
    [0, max(n_frames - width_i, 1)), so a span starts inside the utterance."""
    B = n_frames.shape[0]
    dev = n_frames.device
    w = torch.randint(1, width + 1, (B, n_masks), generator=generator).to(dev)
    hi = torch.clamp(n_frames.long()[:, None] - w, min=1)
    start = (torch.rand((B, n_masks), generator=generator).to(dev) * hi).long()
    t = torch.arange(t_max, device=dev)[None, None, :]
    spans = (t >= start[..., None]) & (t < (start + w)[..., None])
    return spans.any(dim=1) & (torch.arange(t_max, device=dev)[None, :] < n_frames.to(dev)[:, None])


def mpc_objective(model: nn.Module, feats: torch.Tensor, n_frames: torch.Tensor, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked-position MSE, masked-frame count): the frames under ``mask``
    zeroed at the input, the network's output held to the original features
    there."""
    masked_in = torch.where(mask[..., None], torch.zeros_like(feats), feats)
    pred, _aux = train_logits(model, masked_in, n_frames)
    se = ((pred - feats) ** 2).sum(dim=-1)                  # [B, T]
    n = batch_count(mask.sum())
    return torch.where(mask, se, torch.zeros_like(se)).sum() / (n * feats.shape[-1]), n


def make_mpc_train_step(cfg: TrainConfig, n_masks: int = 4, mask_width: int = 12):
    """(state, feats, n_frames) -> (state, metrics {"loss", "masked_frames"});
    no labels. The state is the CE trainer's (``train_nn.init_train_state``)."""

    def train_step(state: TrainState, feats: torch.Tensor, n_frames: torch.Tensor):
        mask = span_time_mask(step_generator(cfg, state.step), n_frames.to(feats.device), feats.shape[1],
                              n_masks, mask_width)
        state.model.train()
        with torch.enable_grad():
            loss, n = mpc_objective(state.model, feats, n_frames, mask)
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item(), "masked_frames": int(n)}

    return train_step


def pretrain_mpc(
    batches,                 # Sequence[pipeline.FeatBatch]
    tcfg: TrainConfig,
    arch: str = "conformer",
    steps=None,
    n_masks: int = 4,
    mask_width: int = 12,
    logger=None,
) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """Unsupervised MPC pretraining over feature batches (the transcripts are
    never read) -> (model with the reconstruction head, its state_dict).
    The model lives on the batches' device; its weights are drawn from
    ``tcfg.seed`` (``am.params.init_``)."""
    feat_dim = int(batches[0].feats.shape[-1])
    model = init_(build_model(arch, feat_dim, tcfg, feat_dim), torch.Generator().manual_seed(tcfg.seed))
    model.to(batches[0].feats.device)
    state = init_train_state(model, tcfg)
    step_fn = make_mpc_train_step(tcfg, n_masks, mask_width)
    total = steps if steps is not None else tcfg.num_nn_steps
    i = 0
    while i < total:
        for fb in batches:
            state, m = step_fn(state, fb.feats, fb.n_frames)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "pretrain_mpc", "step": i, "loss": m["loss"]})
            if i >= total:
                break
    return model, model.state_dict()


def transfer_pretrained(pretrained: Mapping[str, torch.Tensor], target: Mapping[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Merge two state_dicts: every target entry whose name and shape a
    pretrained entry shares takes the pretrained value (the differently
    shaped head keeps its own) -> (merged, n_copied, n_total_target)."""
    merged, copied = {}, 0
    for name, leaf in target.items():
        cand = pretrained.get(name)
        if cand is not None and tuple(cand.shape) == tuple(leaf.shape):
            merged[name] = cand
            copied += 1
        else:
            merged[name] = leaf
    return merged, copied, len(target)

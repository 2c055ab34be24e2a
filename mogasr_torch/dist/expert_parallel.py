"""Expert parallelism (MoE FFN) over an ``('expert',)`` mesh: the port of
mogasr/dist/expert_parallel.py.

One expert a rank; the tokens (frames) are split over the same ranks. A
replicated router picks each token's expert (top-1, softmax gate), and two
all-to-alls (``comm.all_to_all``, backward the same exchange of the
gradients) move the tokens to their expert's rank and back, through
fixed-capacity slot buffers [E, C, H]: a token past its expert's capacity
is dropped and combines with weight exactly 0 (Switch's overflow rule);
padding frames take no capacity and are never kept.

Every global reduction of the forward (the CE's sum and count, the
load-balance means) is ``comm.reduce_from_group``: each rank holds the whole
value and differentiates only its own term, so after backward the gradients
of the replicated parameters are summed over the ranks and each expert's
are whole on its rank (its tokens' gradients came back through the
all-to-all). The optimizer's clip sums the experts' squares over the ranks.

The toy MoE (:func:`init_moe_params`, :func:`make_moe_forward`,
:func:`make_ep_train_step`) and the production MoeAm path
(:func:`shard_moe_am_params`, :func:`make_moe_am_ep_forward`,
:func:`make_moe_am_ep_train_step`) share the block.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mogasr_torch.am.neural import MoeAm, splice_frames, valid_mask
from mogasr_torch.am.train_nn import TrainState, apply_update, make_optimizer
from mogasr_torch.config import TrainConfig
from mogasr_torch.dist import comm
from mogasr_torch.dist.mesh import Mesh, axis_mesh
from mogasr_torch.dist.sharded import sum_grads

EXPERT_PARAMS = ("W1", "b1", "W2", "b2")


def make_ep_mesh(n_experts: int, device="cuda") -> Mesh:
    """The ('expert',) mesh over the first ``n_experts`` ranks (every rank
    must call it)."""
    world = dist.get_world_size()
    if world < n_experts:
        raise ValueError(f"need {n_experts} ranks, have {world}")
    group = None if n_experts == world else dist.new_group(list(range(n_experts)))
    return axis_mesh("expert", range(n_experts), device, group)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a.detach().cpu() if torch.is_tensor(a) else a)).to(device)


# ------------------------------------------------------------------ toy MoE


def init_moe_params(generator: torch.Generator, n_experts: int, hidden: int, ffn: int, n_out: int
                    ) -> Dict[str, torch.Tensor]:
    """Router (replicated), per-expert FFN stacks (split on axis 0) and a
    replicated head, with the reference's shapes and scales (normal draws
    from ``generator``; tests pass the reference's arrays instead)."""
    s_h, s_f = 1.0 / math.sqrt(hidden), 1.0 / math.sqrt(ffn)
    n = lambda *shape: torch.randn(shape, generator=generator)  # noqa: E731
    return {"Wr": n(hidden, n_experts) * s_h, "W1": n(n_experts, hidden, ffn) * s_h,
            "b1": torch.zeros(n_experts, ffn), "W2": n(n_experts, ffn, hidden) * s_f,
            "b2": torch.zeros(n_experts, hidden), "Wo": n(hidden, n_out) * s_h, "bo": torch.zeros(n_out)}


def shard_moe_params(params: Mapping[str, object], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's expert ([1, ...] slices of W1, b1, W2, b2) and the
    replicated router and head, as leaf tensors that require grad."""
    r = mesh.rank
    return {k: _tensor(v, mesh.device)[r:r + 1].clone().requires_grad_() if k in EXPERT_PARAMS
            else _tensor(v, mesh.device).clone().requires_grad_() for k, v in params.items()}


def _expert_ffn(W1, b1, W2, b2, h):
    return F.relu(h @ W1 + b1) @ W2 + b2


def moe_dense_reference(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Per-token dense reference (no dropping): each token through its
    routed expert, gated; then the head. [N, H] -> [N, V]."""
    scores = x @ params["Wr"]
    e = torch.argmax(scores, dim=-1)
    gate = torch.gather(torch.softmax(scores, dim=-1), 1, e[:, None])[:, 0]
    ys = torch.einsum("nh,ehf->nef", x, params["W1"]) + params["b1"][None]
    ys = torch.einsum("nef,efh->neh", F.relu(ys), params["W2"]) + params["b2"][None]
    h = gate[:, None] * ys[torch.arange(x.shape[0], device=x.device), e]
    return h @ params["Wo"] + params["bo"]


def _dispatch(x, Wr, W1, b1, W2, b2, valid, capacity: int, mesh: Mesh):
    """One top-1 MoE FFN over this rank's tokens x [n, H] with its expert
    W1 [1, H, F] ...: -> (y [n, H], probs [n, E], onehot [n, E] of the valid
    tokens' routes, keep [n])."""
    n_exp = Wr.shape[1]
    n, H = x.shape
    scores = x @ Wr
    probs = torch.softmax(scores, dim=-1)
    e = torch.argmax(scores, dim=-1)
    gate = torch.gather(probs, 1, e[:, None])[:, 0]
    # padding takes no slot (splice-clamped padding would route like the
    # last valid frame and evict valid tokens) and is never kept
    onehot = F.one_hot(e, n_exp) * valid[:, None].long()
    rank = torch.cumsum(onehot, dim=0) - onehot
    r = torch.gather(rank, 1, e[:, None])[:, 0]
    keep = (r < capacity) & valid
    slot = torch.clamp(r, max=capacity - 1)
    buf = torch.zeros((n_exp, capacity, H), dtype=x.dtype, device=x.device)
    buf = buf.index_put((e, slot), torch.where(keep[:, None], x, torch.zeros_like(x)), accumulate=True)
    recv = comm.all_to_all(buf, mesh.group)
    y = _expert_ffn(W1[0], b1[0], W2[0], b2[0], recv.reshape(n_exp * capacity, H))
    back = comm.all_to_all(y.reshape(n_exp, capacity, H), mesh.group)
    out = back[e, slot]
    out = torch.where(keep[:, None], gate[:, None] * out, torch.zeros_like(out))
    return out, probs, onehot, keep


def make_moe_forward(mesh: Mesh, capacity: int):
    """(params from :func:`shard_moe_params`, x [n, H] this rank's tokens) ->
    (logits [n, V], load-balance loss, dropped fraction), the last two the
    whole mesh's (capacity C a (rank, expert) pair)."""
    n_dev = mesh.size

    def forward(params, x):
        valid = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        out, probs, onehot, keep = _dispatch(x, params["Wr"], params["W1"], params["b1"], params["W2"],
                                             params["b2"], valid, capacity, mesh)
        logits = out @ params["Wo"] + params["bo"]
        me = comm.reduce_from_group(probs.mean(dim=0), mesh.group) / n_dev
        ce = comm.all_reduce(onehot.to(probs.dtype).mean(dim=0), mesh.group) / n_dev
        lb = n_dev * (me * ce).sum()
        dropped = 1.0 - comm.all_reduce(keep.to(probs.dtype).mean(), mesh.group) / n_dev
        return logits, lb, dropped

    return forward


def _ce_mean(logits, y, mesh: Mesh, n_total: int) -> torch.Tensor:
    ll = torch.gather(torch.log_softmax(logits, dim=-1), 1, y[:, None].long())[:, 0]
    return -comm.reduce_from_group(ll.sum(), mesh.group) / n_total


def make_ep_train_step(mesh: Mesh, capacity: int, lr: float = 1e-2, lb_weight: float = 0.01):
    """(params, x [n, H], y [n] this rank's tokens) -> (params, loss): one
    SGD step of CE + lb_weight x load balance; the router's and head's
    gradients summed over the ranks, each expert's whole on its rank."""
    forward = make_moe_forward(mesh, capacity)

    def step(params, x, y):
        with torch.enable_grad():
            logits, lb, _ = forward(params, x)
            loss = _ce_mean(logits, y, mesh, x.shape[0] * mesh.size) + lb_weight * lb
            grads = torch.autograd.grad(loss, list(params.values()))
        new = {}
        for (k, p), g in zip(params.items(), grads):
            if k not in EXPERT_PARAMS:
                g = comm.all_reduce(g, mesh.group)
            new[k] = (p.detach() - lr * g).requires_grad_()
        return new, float(loss.detach())

    return step


# --------------------------------------------------- production MoeAm (EP)


def moe_am_param_specs(state_dict: Mapping[str, object]) -> Dict[str, Optional[str]]:
    """name -> "expert" for the per-expert FFN stacks (split on axis 0),
    None for the router, projections and norms (replicated)."""
    return {k: "expert" if k.rsplit(".", 1)[-1] in EXPERT_PARAMS and k.startswith("blocks.") else None
            for k in state_dict}


def shard_moe_am_params(model: MoeAm, state_dict: Mapping[str, object], mesh: Mesh) -> MoeAm:
    """A MoeAm on the mesh's device holding this rank's expert of every
    block (W1 [1, H, F] ...) and the replicated rest, from a dense
    ``state_dict`` (``from_flax`` layout, tensors or numpy)."""
    if mesh.size != model.n_experts:
        raise ValueError(f"EP needs one expert per rank: the mesh has {mesh.size} ranks, the model "
                         f"{model.n_experts} experts")
    ep = copy.deepcopy(model)
    specs = moe_am_param_specs(state_dict)
    r = mesh.rank
    for blk in ep.blocks:
        for name in EXPERT_PARAMS:
            full = getattr(blk, name)
            setattr(blk, name, nn.Parameter(torch.empty((1,) + tuple(full.shape[1:]))))
    ep.load_state_dict({k: _tensor(v, "cpu")[r:r + 1] if specs[k] else _tensor(v, "cpu")
                        for k, v in state_dict.items()})
    return ep.to(mesh.device)


def expert_parameters(ep: MoeAm):
    """The parameters that are this rank's expert."""
    return [getattr(blk, name) for blk in ep.blocks for name in EXPERT_PARAMS]


def _moe_am_body(ep: MoeAm, feats, n_frames, capacity: int, mesh: Mesh):
    """The MoeAm forward on this rank's rows: (logits [b, T, P], the sum of
    the blocks' load-balance losses over the whole batch's valid frames)."""
    B, T, _ = feats.shape
    H = ep.hidden
    x = ep.in_proj(splice_frames(feats, n_frames, ep.context))
    valid = valid_mask(n_frames, T, feats.device).reshape(-1)
    vw = valid.to(x.dtype)
    nv = torch.clamp(comm.all_reduce(vw.sum(), mesh.group), min=1.0)
    lb_sum = torch.zeros((), device=x.device)
    for blk in ep.blocks:
        h = blk.ln(x).reshape(B * T, H)
        y, probs, onehot, _keep = _dispatch(h, blk.Wr, blk.W1, blk.b1, blk.W2, blk.b2, valid, capacity, mesh)
        me = comm.reduce_from_group((probs * vw[:, None]).sum(0), mesh.group) / nv
        ce = comm.all_reduce((onehot.to(probs.dtype) * vw[:, None]).sum(0), mesh.group) / nv
        lb_sum = lb_sum + ep.n_experts * (me * ce).sum()
        x = x + y.reshape(B, T, H)
    return ep.head(ep.ln_out(x)), lb_sum


def make_moe_am_ep_forward(model: MoeAm, mesh: Mesh, capacity: int):
    """(the EP MoeAm, feats [b, T, D], n_frames [b] this rank's rows) ->
    logits [b, T, n_pdfs]. At a capacity no rank's tokens exceed, this equals
    the dense MoeAm on valid frames (padding frames are unspecified)."""
    if mesh.size != model.n_experts:
        raise ValueError(f"EP needs one expert per rank: the mesh has {mesh.size} ranks, the model "
                         f"{model.n_experts} experts")

    def forward(ep: MoeAm, feats, n_frames):
        with torch.no_grad():
            return _moe_am_body(ep, feats, n_frames, capacity, mesh)[0]

    return forward


def ep_opt_init(model: MoeAm, cfg: TrainConfig, ep: MoeAm) -> TrainState:
    """The training state of the EP MoeAm: AdamW (``am.train_nn``) over this
    rank's parameters, its moments on them."""
    return TrainState(ep, make_optimizer(ep, cfg), 0)


def make_moe_am_ep_train_step(model: MoeAm, cfg: TrainConfig, mesh: Mesh, capacity: int):
    """(state from :func:`ep_opt_init`, feats, n_frames, labels [b, T] this
    rank's rows) -> (state, {"loss", "ce", "frame_acc"}): frame CE over the
    whole batch + cfg.moe_lb_weight x the load balance, AdamW with the
    dense path's clip and schedule; the metrics are the whole batch's."""
    if mesh.size != model.n_experts:
        raise ValueError(f"EP needs one expert per rank: the mesh has {mesh.size} ranks, the model "
                         f"{model.n_experts} experts")

    def step(state: TrainState, feats, n_frames, labels):
        ep = state.model
        ep.train()
        labels = labels.to(feats.device)
        with torch.enable_grad():
            logits, lb_sum = _moe_am_body(ep, feats, n_frames, capacity, mesh)
            lv = labels >= 0
            safe = torch.clamp(labels, min=0).long()
            nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, safe[..., None])[..., 0]
            n = torch.clamp(comm.all_reduce(lv.sum(), mesh.group), min=1)
            ce = comm.reduce_from_group(torch.where(lv, nll, torch.zeros_like(nll)).sum(), mesh.group) / n
            acc = comm.all_reduce((lv & (torch.argmax(logits, dim=-1) == safe)).sum(), mesh.group) / n
            loss = ce + cfg.moe_lb_weight * lb_sum
            loss.backward()
        experts = expert_parameters(ep)
        expert_ids = {id(p) for p in experts}
        sum_grads([p for p in ep.parameters() if id(p) not in expert_ids], mesh)
        apply_update(state, cfg, split=(experts, mesh.group))
        return state, {"loss": float(loss.detach()), "ce": float(ce.detach()), "frame_acc": float(acc)}

    return step


def gather_experts(ep: MoeAm, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The dense state_dict: every block's experts gathered in rank order."""
    out = {}
    for k, v in ep.state_dict().items():
        out[k] = torch.cat(comm.all_gather(v, mesh.group)) if moe_am_param_specs({k: v})[k] else v
    return out


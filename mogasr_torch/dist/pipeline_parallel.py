"""Pipeline parallelism (GPipe microbatches) over a ``('pipe',)`` mesh: the
port of mogasr/dist/pipeline_parallel.py.

Stage s (rank s) holds layer s of an H -> H tanh stack; a replicated head
follows the last stage. The forward runs the GPipe schedule as the
reference's scan does: M + P - 1 ticks, at tick t stage s computes
microbatch t - s (bubble ticks compute zeros that are masked), and the
activations move one stage on through a ring shift (``comm.ring_shift``,
backward the reverse shift). The finished microbatches live on the last
stage; ``comm.reduce_from_group`` sums them over the ranks (zeros
elsewhere), so every rank holds them and computes the head and the loss
alike. Autograd runs the schedule backward through the ring: each stage's
gradients are whole on its rank, the head's whole on every rank, so the
SGD step needs no reduction.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist

from mogasr_torch.dist import comm
from mogasr_torch.dist.mesh import Mesh, axis_mesh

STAGE_PARAMS = ("W", "b")


def make_pp_mesh(n_stages: int, device="cuda") -> Mesh:
    """The ('pipe',) mesh over the first ``n_stages`` ranks (every rank must
    call it)."""
    world = dist.get_world_size()
    if world < n_stages:
        raise ValueError(f"need {n_stages} ranks, have {world}")
    return axis_mesh("pipe", range(n_stages), device,
                     None if n_stages == world else dist.new_group(list(range(n_stages))))


def init_pp_params(generator: torch.Generator, n_stages: int, hidden: int, n_out: int) -> Dict[str, torch.Tensor]:
    """The stacked stages W [P, H, H], b [P, H] and the head Wo [H, V], bo
    [V], with the reference's shapes and scale (normal draws from
    ``generator``; tests pass the reference's arrays instead)."""
    scale = 1.0 / math.sqrt(hidden)
    return {"W": torch.randn((n_stages, hidden, hidden), generator=generator) * scale,
            "b": torch.zeros(n_stages, hidden),
            "Wo": torch.randn((hidden, n_out), generator=generator) * scale, "bo": torch.zeros(n_out)}


def shard_pp_params(params: Mapping[str, object], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's stage (W [1, H, H], b [1, H]) and the replicated head, as
    leaf tensors on the mesh's device that require grad."""
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)).to(mesh.device)
        if k in STAGE_PARAMS:
            t = t[mesh.rank:mesh.rank + 1]
        out[k] = t.clone().requires_grad_()
    return out


def serial_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Single-device reference: x [N, H] -> the stages -> logits [N, V]."""
    h = x
    for s in range(params["W"].shape[0]):
        h = torch.tanh(h @ params["W"][s] + params["b"][s])
    return h @ params["Wo"] + params["bo"]


def make_pp_forward(mesh: Mesh, n_micro: int):
    """(params from :func:`shard_pp_params`, x [M, mb, H] on every rank) ->
    logits [M, mb, V] on every rank; M = n_micro, M + P - 1 ticks."""
    n_stages = mesh.size
    idx = mesh.rank

    def forward(params, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != n_micro:
            raise ValueError(f"expected {n_micro} microbatches, got {x.shape[0]}")
        M = n_micro
        W, b = params["W"][0], params["b"][0]
        act_in = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
        outs = torch.zeros_like(x)
        # every rank builds the same graph (masks, not branches), so the ring
        # shifts' backward collectives run in one order on every rank
        for t in range(M + n_stages - 1):
            inp = torch.where(torch.tensor(idx == 0, device=x.device), x[min(t, M - 1)], act_in)
            live = 0 <= t - idx < M    # false on a bubble tick
            act = torch.tanh(inp @ W + b) * float(live)
            m = t - (n_stages - 1)
            if 0 <= m < M:
                write = torch.tensor(idx == n_stages - 1, device=x.device)
                outs = torch.cat([outs[:m], torch.where(write, act, outs[m])[None], outs[m + 1:]])
            if t < M + n_stages - 2:
                act_in = comm.ring_shift(act, mesh.group, 1)
        # the finished microbatches live on the last stage: summed, every rank has them
        h = comm.reduce_from_group(outs, mesh.group)
        return h @ params["Wo"] + params["bo"]

    return forward


def make_pp_train_step(mesh: Mesh, n_micro: int, lr: float = 1e-2):
    """(params, x [M, mb, H], y [M, mb]) -> (params, loss): one pipelined CE
    step of SGD; the gradients flow back through the ring."""
    forward = make_pp_forward(mesh, n_micro)

    def step(params, x, y):
        with torch.enable_grad():
            logp = torch.log_softmax(forward(params, x), dim=-1)
            loss = -torch.gather(logp, -1, y[..., None].long())[..., 0].mean()
            grads = torch.autograd.grad(loss, list(params.values()))
        new = {k: (p.detach() - lr * g).requires_grad_() for (k, p), g in zip(params.items(), grads)}
        return new, float(loss.detach())

    return step

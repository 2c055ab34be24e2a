"""Tensor (model) parallelism over a 2-D ``('data', 'model')`` mesh: the port
of mogasr/dist/tensor_parallel.py.

- **State-sharded GMM scoring**: each rank holds a contiguous block of the
  GMM's states (:func:`shard_gmm_states`), scores its rows of the batch
  against them with kernel K1 (float32, sum or max), and the blocks are
  all-gathered over 'model' into the full [b, T, S] loglik of its rows. The
  reference writes this scorer as an einsum at HIGHEST precision outside any
  Pallas kernel; the function is the same, so the port's main-path scorer
  carries it.
- **Megatron-style MLP**: the Dense layers of MlpAm alternate
  column-parallel (the output features split over 'model') and row-parallel
  (the input features split), as the reference's ``mlp_shardings`` lays
  them out. LayerNorm needs whole rows, so a column-parallel output is
  all-gathered (``comm.gather_last``) and a row-parallel product summed
  (``comm.reduce_from_group``); the input of each split layer passes
  ``comm.copy_to_group``, whose backward sums the gradient over 'model'.
  Every replicated tensor is computed alike on each 'model' rank, so the
  gradients of the replicated parameters are whole there; over 'data' every
  gradient is summed (the batch means through ``comm.batch_over``).

Ranks are laid out model-innermost (global rank = data index x n_model +
model index), as the reference's device grid.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mogasr_torch.am.gmm import GmmSet
from mogasr_torch.am.gmm_cuda import gmm_loglik_batched
from mogasr_torch.am.neural import LN_EPS, MlpAm, frame_ce_loss, splice_frames
from mogasr_torch.am.train_nn import TrainState, apply_update, make_optimizer
from mogasr_torch.config import TrainConfig
from mogasr_torch.dist import comm
from mogasr_torch.dist.mesh import Mesh, axis_mesh
from mogasr_torch.dist.sharded import _sum_metrics, sum_grads


@dataclasses.dataclass(frozen=True)
class TpMesh:
    """This rank's two axes: ``data`` (the ranks with its model index) and
    ``model`` (the ranks with its data index)."""

    data: Mesh
    model: Mesh

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.size, "model": self.model.size}

    @property
    def axis_names(self) -> Tuple[str, str]:
        return ("data", "model")

    @property
    def device(self) -> torch.device:
        return self.data.device


def make_tp_mesh(n_data: int, n_model: int, device="cuda") -> TpMesh:
    """The 2-D mesh over the first n_data x n_model ranks (every rank of the
    world must call it: it creates the axis groups)."""
    world = dist.get_world_size()
    if world < n_data * n_model:
        raise ValueError(f"need {n_data * n_model} ranks, have {world}")
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    me = dist.get_rank()
    data_axis = model_axis = None
    for m in range(n_model):  # every rank creates every group, in one order
        ranks = grid[:, m].tolist()
        g = dist.new_group(ranks)
        if me in ranks:
            data_axis = axis_mesh("data", ranks, device, g)
    for d in range(n_data):
        ranks = grid[d].tolist()
        g = dist.new_group(ranks)
        if me in ranks:
            model_axis = axis_mesh("model", ranks, device, g)
    if data_axis is None:
        raise ValueError(f"rank {me} is outside the {n_data} x {n_model} mesh")
    return TpMesh(data_axis, model_axis)


def _block(n: int, mesh: Mesh) -> slice:
    if n % mesh.size:
        raise ValueError(f"{n} does not split over {mesh.size} '{mesh.axis}' ranks")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


# ---------------------------------------------------------------- GMM (TP)


def shard_gmm_states(gmm, mesh: TpMesh) -> GmmSet:
    """This rank's block of states (the reference's P('model') on the state
    axis) of a GmmSet of tensors or numpy arrays, on the mesh's device."""
    rows = _block(np.shape(gmm[1])[0], mesh.model)
    return GmmSet(*(torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a)[rows]).to(mesh.device)
                    .contiguous() for a in gmm))


def make_tp_score_step(mesh: TpMesh, mode: str = "sum", var_floor: float = 1e-3):
    """(this rank's state block, feats [b, T, D] this rank's rows over
    'data') -> loglik [b, T, S]: K1 float32 on the block (the plain scorer
    on the CPU), all-gathered over 'model' in state order."""
    if var_floor != 1e-3:
        raise ValueError("the scorer floors variances at 1e-3 (am.gmm.natural_params)")

    def score(gmm: GmmSet, feats: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            ll = gmm_loglik_batched(feats, gmm, compute_dtype="float32", mode=mode)
            return torch.cat(comm.all_gather(ll, mesh.model.group), dim=-1)

    return score


# ---------------------------------------------------------------- MLP (TP)

COL, ROW = "col", "row"


def _split_of(name: str, n_dense: int) -> Optional[str]:
    """Column- or row-parallel for Dense_i of the flax tree: the hidden
    layers i < n_dense and the head (Dense_{n_dense}) alternate from
    column-parallel at i = 0."""
    m = re.match(r"(dense\.(\d+)|head)\.(weight|bias)$", name)
    if m is None:
        return None
    i = int(m.group(2)) if m.group(2) is not None else n_dense
    return COL if i % 2 == 0 else ROW


def mlp_shardings(state_dict: Mapping[str, object], mesh: TpMesh) -> Dict[str, Optional[int]]:
    """name -> the dimension of the port's layout split over 'model', or
    None (replicated): a column-parallel Linear splits its weight's rows
    (out features) and its bias, a row-parallel one its weight's columns (in
    features); LayerNorms replicate. A dimension that does not divide by the
    model axis replicates, as in the reference."""
    n_dense = sum(1 for k in state_dict if re.match(r"dense\.\d+\.weight$", k))
    m = mesh.model.size
    out = {}
    for name, t in state_dict.items():
        split = _split_of(name, n_dense)
        dim = None
        if split == COL:
            dim = 0
        elif split == ROW and name.endswith("weight"):
            dim = 1
        if dim is not None and np.shape(t)[dim] % m:
            dim = None
        out[name] = dim
    return out


def shard_mlp_state(state_dict: Mapping[str, object], mesh: TpMesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of every MlpAm parameter (``from_flax`` layout,
    tensors or numpy), on the mesh's device."""
    dims = mlp_shardings(state_dict, mesh)
    out = {}
    for name, a in state_dict.items():
        t = torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a))
        d = dims[name]
        if d is not None:
            t = t.narrow(d, _block(t.shape[d], mesh.model).start, t.shape[d] // mesh.model.size)
        out[name] = t.contiguous().to(mesh.device)
    return out


class TpMlp(nn.Module):
    """MlpAm with its Dense layers split over the 'model' axis: the
    parameters are this rank's slices (:func:`shard_mlp_state`)."""

    def __init__(self, model: MlpAm, shards: Mapping[str, torch.Tensor], mesh: TpMesh):
        super().__init__()
        self.context, self.layers = model.context, model.layers
        self.mesh = mesh
        self.dims = mlp_shardings({k: v for k, v in model.state_dict().items()}, mesh)
        self.params = nn.ParameterDict({k.replace(".", "__"): nn.Parameter(v.clone()) for k, v in shards.items()})

    def p(self, name: str) -> torch.Tensor:
        return self.params[name.replace(".", "__")]

    def sharded_names(self):
        return [k for k, d in self.dims.items() if d is not None]

    def _linear(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.p(f"{prefix}.weight"), self.p(f"{prefix}.bias")
        g = self.mesh.model.group
        dim = self.dims[f"{prefix}.weight"]
        if dim == 0:    # column-parallel: this rank's output features
            return comm.gather_last(F.linear(comm.copy_to_group(x, g), w, b), g)
        if dim == 1:    # row-parallel: this rank's input features, partial sums
            cols = _block(x.shape[-1], self.mesh.model)
            return comm.reduce_from_group(F.linear(comm.copy_to_group(x, g)[..., cols], w), g) + b
        return F.linear(x, w, b)

    def forward(self, feats: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        x = splice_frames(feats, n_frames, self.context)
        for i in range(self.layers):
            x = self._linear(f"dense.{i}", x)
            x = F.relu(F.layer_norm(x, x.shape[-1:], self.p(f"norms.{i}.weight"), self.p(f"norms.{i}.bias"), LN_EPS))
        return self._linear("head", x)

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole parameters (every slice gathered over 'model')."""
        out = {}
        for name, d in self.dims.items():
            t = self.p(name).detach()
            if d is not None:
                t = torch.cat(comm.all_gather(t, self.mesh.model.group), dim=d)
            out[name] = t
        return out


def make_tp_forward(model: MlpAm, mesh: TpMesh):
    """(TpMlp, feats [b, T, D] this rank's rows, n_frames [b]) -> logits
    [b, T, n_pdfs] of those rows."""

    def fwd(tp_model: TpMlp, feats, n_frames):
        with torch.no_grad():
            return tp_model(feats, n_frames)

    return fwd


def init_tp_state(model: MlpAm, state_dict: Mapping[str, object], cfg: TrainConfig, mesh: TpMesh) -> TrainState:
    """A TrainState over the TpMlp of this rank's slices of ``state_dict``:
    AdamW's moments live on the slices, as the reference's inherit the
    parameters' shardings."""
    tp = TpMlp(model, shard_mlp_state(state_dict, mesh), mesh)
    return TrainState(tp, make_optimizer(tp, cfg), 0)


def make_tp_train_step(model: MlpAm, cfg: TrainConfig, mesh: TpMesh):
    """(state from :func:`init_tp_state`, feats [b, T, D], n_frames [b],
    labels [b, T] this rank's rows over 'data') -> (state, {"loss",
    "frame_acc"}): the frame-CE step of ``am.train_nn.make_train_step`` (the
    same AdamW, clip and schedule) with the batch over 'data' and the hidden
    features over 'model'."""

    def train_step(state: TrainState, feats, n_frames, labels):
        tp = state.model
        tp.train()
        with comm.batch_over(mesh.data.group), torch.enable_grad():
            loss, acc = frame_ce_loss(tp(feats, n_frames), labels.to(feats.device))
            loss.backward()
        sum_grads(tp.parameters(), mesh.data)
        apply_update(state, cfg, split=([tp.p(n) for n in tp.sharded_names()], mesh.model.group))
        return state, _sum_metrics({"loss": loss, "frame_acc": acc}, mesh.data)

    return train_step


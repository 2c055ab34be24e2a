"""Rank bodies that run named cases of the multi-device steps and return
their results, for ``dist.launch.run_ranks``: the CPU tests hold them to the
reference's sharded steps, ``chip_smoke.py`` to one process on the card.

A case is a dict of picklable inputs: numpy arrays of the whole batch (each
rank keeps its rows), the port's models (their weights set by the caller),
configs. Every body returns numpy trees (``run_ranks`` converts them) and
the rank's kernel launches.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict

import numpy as np
import torch

from mogasr_torch import _cuda
from mogasr_torch.am.gmm import gmm_from_numpy
from mogasr_torch.am.train_nn import init_train_state
from mogasr_torch.dist import mesh as M
from mogasr_torch.dist import sharded as SH


def _moments(model: torch.nn.Module, opt: torch.optim.Optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """AdamW's state of each named parameter (copies)."""
    return {name: {k: t.detach().clone() for k, t in opt.state[p].items() if torch.is_tensor(t)}
            for name, p in model.named_parameters() if p in opt.state}


def gmm_case(mesh, step: str, gmm, inputs, accumulate=None, acoustic_scale: float = 1.0) -> Dict[str, Any]:
    """One GMM step: ``step`` "em", "stats" (with ``accumulate``), "align",
    "soft" or "decode" over the whole batch ``inputs`` (numpy; graphs as a
    dict), ``gmm`` (weights, means, vars) replicated."""
    g = M.replicate(gmm_from_numpy(*gmm, device=mesh.device), mesh)
    x = M.shard_batch(tuple(inputs), mesh)
    if step == "em":
        return {"stats": SH.make_sharded_em_step(mesh)(g, *x)}
    if step == "stats":
        return {"stats": SH.make_sharded_stats_step(mesh, accumulate)(g, *x)}
    if step == "align":
        return {"result": SH.make_sharded_align_step(mesh, acoustic_scale)(g, *x)}
    if step == "soft":
        return {"stats": SH.make_sharded_soft_em_step(mesh, acoustic_scale)(g, *x)}
    if step == "decode":
        res, totals = SH.make_sharded_decode_step(mesh, acoustic_scale)(g, *x)
        return {"result": res, "totals": totals}
    raise ValueError(f"unknown GMM step {step!r}")


def train_case(mesh, factory: str, model, cfg, inputs, steps: int = 1, pre=(), post=(),
               kwargs=None) -> Dict[str, Any]:
    """``steps`` steps of ``sharded.<factory>(model, *pre, cfg, mesh, *post,
    **kwargs)`` from ``model``'s weights (replicated) over the whole batch
    ``inputs``: each step's metrics and seconds, and the parameters and
    AdamW's moments after the first, after the second (when there are more
    than two) and after the last step (copies: cases may share a model)."""
    model = M.replicate(copy.deepcopy(model), mesh)
    pre = tuple(M.replicate(p, mesh) if isinstance(p, torch.nn.Module) else p for p in pre)
    post = tuple(M.replicate(p, mesh) for p in post)
    state = init_train_state(model, cfg)
    step = getattr(SH, factory)(model, *pre, cfg, mesh, *post, **(kwargs or {}))
    x = M.shard_batch(tuple(inputs), mesh)
    out: Dict[str, Any] = {"metrics": [], "step_seconds": []}
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, *x)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out["step_seconds"].append(time.perf_counter() - t0)
        out["metrics"].append(m)
        keys = [k for k, at in (("first", 0), ("second", 1 if steps > 2 else -1), ("last", steps - 1)) if at == i]
        if keys:
            snap = {"params": {k: v.detach().clone() for k, v in model.state_dict().items()},
                    "moments": _moments(model, state.opt)}
            out.update(dict.fromkeys(keys, snap))
    return out


def run_cases(rank: int, mesh, cases: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Every case in order: {"kind": "gmm" or "train", **its arguments}; each
    result carries the kernel launches it made on this rank."""
    out = {}
    for name, case in cases.items():
        case = dict(case)
        fn = {"gmm": gmm_case, "train": train_case}[case.pop("kind")]
        before = _cuda.launch_counts()
        t0 = time.perf_counter()
        res = fn(mesh, **case)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        res["seconds"] = time.perf_counter() - t0
        after = _cuda.launch_counts()
        res["launches"] = {k: after[k] - before[k] for k in after}
        out[name] = res
    return out


def sections(rank: int, mesh, dp=None, par=None, dryrun: int = 0) -> Dict[str, Any]:
    """Every kind of case in one launch: ``dp`` for :func:`run_cases`,
    ``par`` the keyword arguments of :func:`parallel_cases`, and with
    ``dryrun`` = n the sections of ``graft_entry``'s dry run over these n
    ranks."""
    out: Dict[str, Any] = {}
    if dp:
        out["dp"] = run_cases(rank, mesh, dp)
    if par:
        out["par"] = parallel_cases(rank, mesh, **par)
    if dryrun:
        from mogasr_torch.graft_entry import _dryrun_rank

        out["dryrun"] = _dryrun_rank(rank, mesh, dryrun)
    return out


def failing_rank(rank: int, mesh, bad_rank: int) -> None:
    """Rank ``bad_rank`` raises; the others wait in a collective for it."""
    if rank == bad_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()


def hung_rank(rank: int, mesh, seconds: float) -> None:
    """Every rank sleeps past the launch's deadline."""
    time.sleep(seconds)


# --------------------------------------------------------------------------
# Tensor, expert, sequence and pipeline parallelism (whole results gathered
# on every rank)
# --------------------------------------------------------------------------


def _t(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=dev)


def _rows_of_all(x: torch.Tensor, group) -> torch.Tensor:
    from mogasr_torch.dist import comm

    return torch.cat(comm.all_gather(x.contiguous(), group))


def tp_cases(mesh, n_data: int, n_model: int, score=(), forward=None, train=None) -> Dict[str, Any]:
    """``score``: [(gmm, feats, mode)] -> the whole batch's loglik;
    ``forward``: (model, feats, n_frames) -> logits; ``train``: (model, cfg,
    feats, n_frames, labels, steps) -> each step's metrics, the whole
    parameters, the step count and this rank's slice of dense.0.weight."""
    from mogasr_torch.dist import tensor_parallel as TP

    tp = TP.make_tp_mesh(n_data, n_model, mesh.device)
    dev = mesh.device
    out: Dict[str, Any] = {"shape": tp.shape}
    out["score"] = []
    for gmm, feats, mode in score:
        rows = M.data_rows(len(feats), tp.data)
        ll = TP.make_tp_score_step(tp, mode=mode)(TP.shard_gmm_states(gmm, tp), _t(feats[rows], dev))
        out["score"].append(_rows_of_all(ll, tp.data.group))
    if forward is not None:
        model, feats, nf = forward
        rows = M.data_rows(len(feats), tp.data)
        tpm = TP.TpMlp(model, TP.shard_mlp_state(model.state_dict(), tp), tp)
        logits = TP.make_tp_forward(model, tp)(tpm, _t(feats[rows], dev), _t(nf[rows], dev))
        out["forward"] = _rows_of_all(logits, tp.data.group)
    if train is not None:
        model, cfg, feats, nf, labels, steps = train
        rows = M.data_rows(len(feats), tp.data)
        state = TP.init_tp_state(model, model.state_dict(), cfg, tp)
        step = TP.make_tp_train_step(model, cfg, tp)
        metrics = []
        for _ in range(steps):
            state, m = step(state, *(_t(a[rows], dev) for a in (feats, nf, labels)))
            metrics.append(m)
        out["train"] = {"metrics": metrics, "params": state.model.full_state_dict(), "step": state.step,
                        "dense0_slice": tuple(state.model.p("dense.0.weight").shape)}
    return out


def ep_cases(mesh, toy=None, toy_drop=None, toy_train=None, toy_grads=None, am_forward=None,
             am_padding=None, am_train=None) -> Dict[str, Any]:
    """The expert-parallel cases over ``mesh`` as the ('expert',) axis: the
    toy MoE's forward, capacity drops, SGD steps and gradients; MoeAm's
    forward, padding invariance and AdamW step. Token rows are split
    evenly; results are gathered whole."""
    from mogasr_torch.dist import comm
    from mogasr_torch.dist import expert_parallel as EP

    ep = EP.make_ep_mesh(mesh.size, mesh.device)
    dev, g = mesh.device, ep.group
    out: Dict[str, Any] = {}

    def rows(a):
        return _t(np.asarray(a)[M.data_rows(len(a), ep)], dev)

    for name, case in (("toy", toy), ("toy_drop", toy_drop)):
        if case is not None:
            params, x, capacity = case
            with torch.no_grad():
                logits, lb, dropped = EP.make_moe_forward(ep, capacity)(EP.shard_moe_params(params, ep), rows(x))
            out[name] = {"logits": _rows_of_all(logits, g), "lb": lb, "dropped": dropped}
    if toy_grads is not None:
        params, x, y, capacity = toy_grads
        sharded = EP.shard_moe_params(params, ep)
        logits, _lb, _d = EP.make_moe_forward(ep, capacity)(sharded, rows(x))
        loss = EP._ce_mean(logits, rows(y), ep, len(x))
        grads = torch.autograd.grad(loss, list(sharded.values()))
        out["toy_grads"] = {k: torch.cat(comm.all_gather(gr, g)) if k in EP.EXPERT_PARAMS
                            else comm.all_reduce(gr, g) for k, gr in zip(sharded, grads)}
    if toy_train is not None:
        params, x, y, capacity, lr, steps = toy_train
        sharded = EP.shard_moe_params(params, ep)
        step = EP.make_ep_train_step(ep, capacity, lr=lr)
        losses = []
        for _ in range(steps):
            sharded, loss = step(sharded, rows(x), rows(y))
            losses.append(loss)
        out["toy_train"] = {"losses": losses, "W1_slice": tuple(sharded["W1"].shape)}
    if am_forward is not None:
        model, feats, nf, capacity = am_forward
        epm = EP.shard_moe_am_params(model, model.state_dict(), ep)
        out["am_forward"] = _rows_of_all(EP.make_moe_am_ep_forward(model, ep, capacity)(epm, rows(feats), rows(nf)),
                                         g)
    if am_padding is not None:
        model, feats, nf, cut, capacity = am_padding
        epm = EP.shard_moe_am_params(model, model.state_dict(), ep)
        fwd = EP.make_moe_am_ep_forward(model, ep, capacity)
        padded = fwd(epm, rows(feats), rows(nf))[:, :cut]
        tight = fwd(epm, rows(np.asarray(feats)[:, :cut]), rows(nf))
        out["am_padding"] = {"padded": _rows_of_all(padded, g), "tight": _rows_of_all(tight, g)}
    if am_train is not None:
        model, cfg, feats, nf, labels, capacity = am_train
        state = EP.ep_opt_init(model, cfg, EP.shard_moe_am_params(model, model.state_dict(), ep))
        state, m = EP.make_moe_am_ep_train_step(model, cfg, ep, capacity)(state, rows(feats), rows(nf), rows(labels))
        out["am_train"] = {"metrics": m, "params": EP.gather_experts(state.model, ep),
                           "W1_slice": tuple(state.model.blocks[0].W1.shape)}
    return out


def sp_cases(mesh, tails=(), score=None, short=None) -> Dict[str, Any]:
    """``tails``: [(base [B, T, D], n_frames, norm_var)] -> the whole tail;
    ``score``: (base, n_frames, W, b) -> the whole logits; ``short``: (base,
    n_frames) whose shards are shorter than the window -> the error raised."""
    from mogasr_torch.dist import sequence_parallel as SP

    sp = SP.make_sp_mesh(mesh.size, mesh.device)
    dev = mesh.device
    out: Dict[str, Any] = {"tails": []}

    def block(base):
        return _t(np.asarray(base)[:, SP.time_block(base.shape[1], sp)], dev)

    def whole(x):
        from mogasr_torch.dist import comm

        return torch.cat(comm.all_gather(x.contiguous(), sp.group), dim=1)

    for base, nf, norm_var in tails:
        with torch.no_grad():
            out["tails"].append(whole(SP.make_sp_feature_tail(sp, norm_var=norm_var)(block(base), _t(nf, dev))))
    if score is not None:
        base, nf, W, b = score
        logits = SP.make_sp_score_step(sp, _affine)({"W": _t(W, dev), "b": _t(b, dev)}, block(base), _t(nf, dev))
        out["score"] = whole(logits)
    if short is not None:
        base, nf = short
        try:
            SP.make_sp_feature_tail(sp, window=2)(block(base), _t(nf, dev))
            out["short"] = ""
        except ValueError as e:
            out["short"] = str(e)
    return out


def _affine(params, feats):
    return feats @ params["W"] + params["b"]


def pp_cases(mesh, forwards=(), train=None, descent=None) -> Dict[str, Any]:
    """``forwards``: [(params, x)] -> logits; ``train``: (params, x, y, lr)
    -> the new whole parameters and the loss; ``descent``: (params, x, y,
    lr, steps) -> the losses."""
    from mogasr_torch.dist import comm
    from mogasr_torch.dist import pipeline_parallel as PP

    pp = PP.make_pp_mesh(mesh.size, mesh.device)
    dev = mesh.device
    out: Dict[str, Any] = {"forwards": []}
    for params, x in forwards:
        with torch.no_grad():
            out["forwards"].append(PP.make_pp_forward(pp, len(x))(PP.shard_pp_params(params, pp), _t(x, dev)))
    if train is not None:
        params, x, y, lr = train
        new, loss = PP.make_pp_train_step(pp, len(x), lr=lr)(PP.shard_pp_params(params, pp), _t(x, dev), _t(y, dev))
        out["train"] = {"loss": loss, "params": {k: torch.cat(comm.all_gather(v.detach(), pp.group))
                                                 if k in PP.STAGE_PARAMS else v for k, v in new.items()}}
    if descent is not None:
        params, x, y, lr, steps = descent
        p = PP.shard_pp_params(params, pp)
        step = PP.make_pp_train_step(pp, len(x), lr=lr)
        losses = []
        for _ in range(steps):
            p, loss = step(p, _t(x, dev), _t(y, dev))
            losses.append(loss)
        out["descent"] = losses
    return out


def parallel_cases(rank: int, mesh, tp=None, ep=None, sp=None, pp=None) -> Dict[str, Any]:
    """The TP, EP, SP and PP cases in one launch (each a dict of the
    keyword arguments of its function), with this rank's kernel launches."""
    before = _cuda.launch_counts()
    out = {}
    for name, fn, kw in (("tp", tp_cases, tp), ("ep", ep_cases, ep), ("sp", sp_cases, sp), ("pp", pp_cases, pp)):
        if kw is not None:
            out[name] = fn(mesh, **kw)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    after = _cuda.launch_counts()
    out["launches"] = {k: after[k] - before[k] for k in after}
    return out

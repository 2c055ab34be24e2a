"""Data-parallel (sharded) pipeline steps: EM, align, decode, NN training —
the port of mogasr/dist/sharded.py.

Every rank holds its rows of the batch (``mesh.shard_batch``) and the same
parameters (``mesh.replicate``). A step returns what the reference's jit
replicates (statistics, totals, the new training state, the metrics) equal
on every rank, and what it shards (alignments, decodes) as this rank's rows.
The reference lets XLA insert the psums; here they are explicit:

- the GMM steps sum their statistics and totals over the ranks, one
  all-reduce of one flat buffer. They run the kernels on the card: K1
  float32/sum scoring, then K2 (align: its chain arm; decode: its word-loop
  arm) or K3 (soft EM: its chain arm).
- the training steps run the port's local objective on the rank's rows
  inside ``comm.batch_over``: each batch mean divides by the count of the
  whole batch (``comm.batch_count``), so a rank's loss is its share of the
  global loss and the gradients' sum over the ranks (one all-reduce) is the
  global gradient, also when one rank's rows are all padding. Then every
  rank clips and takes the same AdamW step (``am.train_nn.apply_update``),
  so the states stay bitwise equal. The metrics are the shares' sums.
- random draws (SpecAugment, the MPC span mask) are made for the global
  batch from the replicated step counter, then sliced, as the reference
  draws them from its replicated state.

As in the reference, ``make_sharded_train_step`` runs the model's plain
forward: a MoeAm's load-balance term, which the local step adds, is not in
its loss, and its metrics are "loss" and "frame_acc".
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch
from torch import nn

from mogasr_torch.am import em
from mogasr_torch.am.gmm import GmmSet
from mogasr_torch.am.gmm_cuda import gmm_loglik_batched
from mogasr_torch.am.neural import RECURRENT, frame_ce_loss, spec_augment
from mogasr_torch.am.train_nn import TrainState, apply_update, step_generator
from mogasr_torch.config import TrainConfig
from mogasr_torch.decoder import fb_cuda, viterbi_cuda
from mogasr_torch.decoder import forward_backward as fbd
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.dist import comm
from mogasr_torch.dist.mesh import Mesh, data_rows


# --------------------------------------------------------------------------
# Reductions
# --------------------------------------------------------------------------


def sum_tensors(tensors: Iterable[torch.Tensor], mesh: Mesh):
    """The tensors (one dtype) summed over the mesh: one all-reduce of one
    flat buffer; returns a list of the same shapes."""
    tensors = list(tensors)
    flat = comm.all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh.group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off: off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def sum_stats(stats, mesh: Mesh):
    """A NamedTuple of float tensors summed over the mesh."""
    return type(stats)(*sum_tensors([t.to(torch.float32) for t in stats], mesh))


def sum_grads(params: Iterable[nn.Parameter], mesh: Mesh) -> None:
    """Every parameter's gradient replaced by its sum over the mesh. A
    parameter without a gradient on one rank takes zeros there if another
    rank has one; without one on every rank it keeps None (AdamW skips it,
    as in the local step)."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    dev = params[0].device
    have = comm.all_reduce(torch.tensor([p.grad is not None for p in params], dtype=torch.int32, device=dev),
                           mesh.group).tolist()
    live = [p for p, h in zip(params, have) if h]
    if not live:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in live]
    for p, g in zip(live, sum_tensors(grads, mesh)):
        p.grad = g


def _sum_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh, totals: Tuple[str, ...] = ()) -> Dict[str, float]:
    """The shares of the global metrics summed over the mesh, as floats;
    ``totals`` are already global (read as they are)."""
    names = [k for k in metrics if k not in totals]
    out = {}
    if names:
        summed = sum_tensors([metrics[k].detach().to(torch.float32).reshape(1) for k in names], mesh)
        out = {k: float(v) for k, v in zip(names, summed)}
    out.update({k: float(metrics[k]) for k in totals})
    return out


def _dp_update(state: TrainState, cfg: TrainConfig, mesh: Mesh, objective: Callable,
               totals: Tuple[str, ...] = ()) -> Dict[str, float]:
    """One data-parallel update: ``objective(model) -> (loss share, metric
    shares)`` under ``comm.batch_over``, backward, the gradients summed,
    clip and AdamW on every rank."""
    model = state.model
    model.train()
    with comm.batch_over(mesh.group), torch.enable_grad():
        loss, metrics = objective(model)
        loss.backward()
    sum_grads(model.parameters(), mesh)
    apply_update(state, cfg)
    return _sum_metrics(metrics, mesh, totals)


def _check_model(model: nn.Module, state: TrainState) -> None:
    if state.model is not model:
        raise ValueError("the step was made for another model than the state's")


def global_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch's [N, ...] from every rank's rows (small per-row
    values: frame counts)."""
    return torch.cat(comm.all_gather(x, mesh.group))


def _spec_augment_global(feats: torch.Tensor, n_frames: torch.Tensor, cfg: TrainConfig, step: int,
                         mesh: Mesh) -> torch.Tensor:
    """SpecAugment with the draws of the whole batch, sliced to this rank's
    rows: the rows the local step would mask on one device."""
    nf = global_rows(n_frames.to(feats.device), mesh)
    B, T, D = feats.shape
    keep = spec_augment(torch.ones((B * mesh.size, T, D), device=feats.device), nf,
                        step_generator(cfg, step))[data_rows(B * mesh.size, mesh)]
    return torch.where(keep == 0, torch.zeros_like(feats), feats)


# --------------------------------------------------------------------------
# GMM steps
# --------------------------------------------------------------------------


def make_sharded_em_step(mesh: Mesh):
    """(gmm, feats [N, D] this rank's frames, labels [N]) -> GmmStats of all
    the ranks' frames, on every rank."""

    def em_step(gmm: GmmSet, feats: torch.Tensor, labels: torch.Tensor) -> em.GmmStats:
        return sum_stats(em.accumulate_stats(gmm, feats, labels), mesh)

    return em_step


def make_sharded_align_step(mesh: Mesh, acoustic_scale: float = 1.0):
    """(gmm, feats [b, T, D], n_frames [b], graphs {...[b, J]}) ->
    ViterbiResult of this rank's utterances: K1 float32/sum then K2's chain
    arm (the reference's ``use_pallas``; tensors on the CPU take the kernels'
    plain versions). No traffic between ranks."""

    def align_step(gmm: GmmSet, feats, n_frames, graphs) -> vit.ViterbiResult:
        ll = gmm_loglik_batched(feats, gmm, compute_dtype="float32", mode="sum")
        return viterbi_cuda.viterbi(ll, graphs, n_frames, acoustic_scale=acoustic_scale)

    return align_step


def make_sharded_soft_em_step(mesh: Mesh, acoustic_scale: float = 1.0):
    """(gmm, feats [b, T, D], n_frames [b], graphs) -> the Baum-Welch E-step's
    GmmStats of all the ranks' utterances: K1 float32/sum, K3 over the align
    graphs (its chain arm), soft statistics; loglik sums the rows that have
    frames (a padding row's forward loglik is -inf)."""

    def soft_em_step(gmm: GmmSet, feats, n_frames, graphs) -> em.GmmStats:
        B, T, D = feats.shape
        n_pdfs = gmm.means.shape[0]
        with torch.no_grad():
            ll = gmm_loglik_batched(feats, gmm, compute_dtype="float32", mode="sum")
            res = fb_cuda.forward_backward(ll, graphs, n_frames, acoustic_scale=acoustic_scale)
            post = fbd.state_posteriors_to_pdf(res.log_gamma, graphs["emit_id"], n_pdfs)
            s = em.accumulate_stats_soft(gmm, feats.reshape(B * T, D), post.reshape(-1, n_pdfs))
            has = n_frames.to(res.loglik.device) > 0
            s = s._replace(loglik=torch.where(has, res.loglik, torch.zeros_like(res.loglik)).sum())
        return sum_stats(s, mesh)

    return soft_em_step


def make_sharded_decode_step(mesh: Mesh, acoustic_scale: float = 1.0):
    """(gmm, feats [b, T, D], n_frames [b], graphs) -> (this rank's
    ViterbiResult, totals {"frames", "score"} of all the ranks): K1
    float32/sum, K2 over the word loop; the score total sums rows with
    frames."""

    def decode_step(gmm: GmmSet, feats, n_frames, graphs):
        with torch.no_grad():
            ll = gmm_loglik_batched(feats, gmm, compute_dtype="float32", mode="sum")
            res = viterbi_cuda.viterbi(ll, graphs, n_frames, acoustic_scale=acoustic_scale)
            nf = n_frames.to(res.score.device)
            frames, score = sum_tensors([nf.sum().to(torch.float64).reshape(1),
                                         torch.where(nf > 0, res.score, 0.0).sum().to(torch.float64).reshape(1)],
                                        mesh)
        return res, {"frames": int(frames.item()), "score": score[0].to(torch.float32)}

    return decode_step


def make_sharded_stats_step(mesh: Mesh, accumulate_fn):
    """Any accumulator (gmm, feats [N, D], labels [N]) -> NamedTuple of
    tensors (``em.accumulate_stats``, ``am.fmllr.accumulate_fmllr_stats``,
    ``am.mllr.accumulate_mllr_stats``) over this rank's frames, summed over
    the ranks."""

    def stats_step(gmm, feats, labels):
        return sum_stats(accumulate_fn(gmm, feats, labels), mesh)

    return stats_step


# --------------------------------------------------------------------------
# Training steps
# --------------------------------------------------------------------------


def make_sharded_train_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh, spec_augment: bool = False):
    """(state, feats [b, T, D], n_frames [b], labels [b, T]) -> (state,
    {"loss", "frame_acc"}): frame CE over the whole batch (LstmAm and BlstmAm
    on their plain recurrence; a MoeAm without its load-balance term, as the
    reference's sharded step)."""

    def train_step(state: TrainState, feats, n_frames, labels):
        _check_model(model, state)
        feats_in = _spec_augment_global(feats, n_frames, cfg, state.step, mesh) if spec_augment else feats

        def objective(m):
            logits = m(feats_in, n_frames, use_kernels=False) if isinstance(m, RECURRENT) else m(feats_in, n_frames)
            loss, acc = frame_ce_loss(logits, labels.to(logits.device))
            return loss, {"loss": loss, "frame_acc": acc}

        return state, _dp_update(state, cfg, mesh, objective)

    return train_step


def make_sharded_ctc_train_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh):
    """(state, feats, n_frames, labels, n_labels) -> (state, {"loss",
    "utt_nll"}): the CTC objective (K3 on the card) over the whole batch."""
    from mogasr_torch.am.ctc import ctc_objective

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        _check_model(model, state)

        def objective(m):
            loss, mean_nll = ctc_objective(m, feats, n_frames, labels, n_labels)
            return loss, {"loss": loss, "utt_nll": mean_nll}

        return state, _dp_update(state, cfg, mesh, objective)

    return train_step


def make_sharded_distill_train_step(student_model: nn.Module, teacher_model: nn.Module, cfg: TrainConfig,
                                    mesh: Mesh, alpha: float = 0.5, temperature: float = 2.0):
    """(state of the student, feats, n_frames, labels, n_labels) -> (state,
    {"loss", "kl", "ctc", "utt_nll"}): the teacher (replicated) runs on this
    rank's rows; the KL's mean over frames and the CTC term's over rows are
    the whole batch's."""
    from mogasr_torch.am.distill import distill_objective

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        _check_model(student_model, state)

        def objective(m):
            loss, aux = distill_objective(m, teacher_model, feats, feats, n_frames, labels, n_labels,
                                          alpha=alpha, temperature=temperature)
            return loss, {"loss": loss, **aux}

        return state, _dp_update(state, cfg, mesh, objective)

    return train_step


def make_sharded_mpc_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh, n_masks: int = 4, mask_width: int = 12):
    """(state, feats, n_frames) -> (state, {"loss", "masked_frames"}): masked
    predictive coding; the span mask is drawn for the whole batch from the
    step counter, then sliced."""
    from mogasr_torch.am.pretrain import mpc_objective, span_time_mask

    def train_step(state: TrainState, feats, n_frames):
        _check_model(model, state)
        B, T, _ = feats.shape
        nf = global_rows(n_frames.to(feats.device), mesh)
        mask = span_time_mask(step_generator(cfg, state.step), nf, T, n_masks, mask_width)[
            data_rows(B * mesh.size, mesh)]

        def objective(m):
            loss, n = mpc_objective(m, feats, n_frames, mask)
            return loss, {"loss": loss, "masked_frames": n}

        return state, _dp_update(state, cfg, mesh, objective, totals=("masked_frames",))

    return train_step


def make_sharded_rnnt_train_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh):
    """(state, feats, n_frames, labels, n_labels) -> (state, {"loss",
    "utt_nll"}): the transducer objective (its aux CTC on K3 on the card)."""
    from mogasr_torch.am.rnnt import rnnt_objective

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        _check_model(model, state)

        def objective(m):
            loss, mean_nll = rnnt_objective(m, feats, n_frames, labels, n_labels)
            return loss, {"loss": loss, "utt_nll": mean_nll}

        return state, _dp_update(state, cfg, mesh, objective)

    return train_step


def make_sharded_rnnt_pruned_train_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh, band: int):
    """The pruned-transducer step: the simple pass, the bounds and the banded
    joint of each utterance on its rank, the three means over the whole
    batch."""
    from mogasr_torch.am.rnnt_pruned import rnnt_pruned_objective

    if not model.simple_heads:
        raise ValueError("pruned training needs build_rnnt_model(simple_heads=True)")

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        _check_model(model, state)

        def objective(m):
            loss, mean_nll = rnnt_pruned_objective(m, feats, n_frames, labels, n_labels, band)
            return loss, {"loss": loss, "utt_nll": mean_nll}

        return state, _dp_update(state, cfg, mesh, objective)

    return train_step


def make_sharded_nn_mmi_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh, log_priors: torch.Tensor,
                             acoustic_scale: float = 0.1):
    """(state, feats, n_frames, num_graphs, den_graphs) -> (state, {"loss",
    "mmi_per_frame"}): the MMI objective (numerator and denominator on K3 on
    the card) with the per-frame mean over the whole batch's rows."""
    from mogasr_torch.am.nn_seq import nn_mmi_objective

    def train_step(state: TrainState, feats, n_frames, num_graphs, den_graphs):
        _check_model(model, state)
        priors = log_priors.to(feats.device)

        def objective(m):
            loss, mmi = nn_mmi_objective(m, priors, feats, n_frames, num_graphs, den_graphs, acoustic_scale)
            return loss, {"loss": loss, "mmi_per_frame": mmi}

        return state, _dp_update(state, cfg, mesh, objective)

    return train_step


def make_sharded_aed_train_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh):
    """(state, feats, n_frames, labels, n_labels) -> (state, {"loss", "ce",
    "ctc"}): the AED objective (its CTC term on K3 on the card)."""
    from mogasr_torch.am.aed import aed_objective

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        _check_model(model, state)
        return state, _dp_update(state, cfg, mesh,
                                 lambda m: aed_objective(m, feats, n_frames, labels, n_labels))

    return train_step


def make_sharded_aed_mwer_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh, ce_weight: float = 0.1):
    """(state, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks, labels,
    n_labels) -> (state, {"mwer", "expected_risk", "ce", "loss"}): the rows
    and their N-best lists sharded; the expected risk averages over the
    valid rows of the whole batch."""
    from mogasr_torch.am.aed import aed_mwer_objective

    def mwer_step(state: TrainState, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks, labels, n_labels):
        _check_model(model, state)
        return state, _dp_update(state, cfg, mesh, lambda m: aed_mwer_objective(
            m, feats, n_frames, hyps, n_hyp_tokens, hyp_mask, risks, labels, n_labels, ce_weight=ce_weight))

    return mwer_step

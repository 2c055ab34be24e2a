"""Forward-backward (Baum-Welch E-step) over chain+loop graphs: the port of
mogasr/decoder/forward_backward.py, and the plain version of the CUDA
kernels in ``fb_cuda`` (K3f, K3b).

The log-semiring twin of ``decoder.viterbi``: the same graph arrays and the
same frame loop, with logaddexp in place of max. Per frame, one logsumexp
over the states (the loop state's exit in the forward pass, its entry in the
backward pass), the stay / advance / enter terms, and CTC skip terms where
the graph has ``skip_logp``. Rows freeze past ``n_frames``: alpha keeps its
last valid value, beta stays at ``final_logp`` so that the last valid frame
picks it up. The result is the state log-posterior ``alpha + beta - loglik``
(NEG_INF on padded frames) and the data log-likelihood per utterance.

The arithmetic runs in the dtype of ``emit_ll`` (the graph log-probs are
cast to it), so a float64 call gives the reference that the float32 kernels
and this float32 version are both held against.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from mogasr_torch.utils.segment import collapse_columns

NEG_INF = -1e30


class FBResult(NamedTuple):
    log_gamma: torch.Tensor  # [B, T, J] state log-posteriors (NEG_INF on padding)
    loglik: torch.Tensor     # [B] total data log-likelihood


def _graph_logps(graphs: Dict[str, torch.Tensor], keys, like: torch.Tensor):
    """The graph log-probs ``keys`` on the device and in the dtype of
    ``like``; None for a key the graphs lack (``skip_logp``)."""
    return [None if graphs.get(k) is None else graphs[k].to(device=like.device, dtype=like.dtype)
            for k in keys]


def gather_emissions(emit_ll: torch.Tensor, emit_id: torch.Tensor, acoustic_scale: float) -> torch.Tensor:
    """[B, T, P] pdf log-likelihoods -> [B, T, J] scaled graph-state emissions."""
    B, T, _ = emit_ll.shape
    J = emit_id.shape[1]
    idx = emit_id.to(device=emit_ll.device, dtype=torch.int64)[:, None, :].expand(B, T, J)
    return torch.gather(emit_ll * acoustic_scale, 2, idx)


def forward_pass(
    emit_graph: torch.Tensor,         # [B, T, J] from gather_emissions
    graphs: Dict[str, torch.Tensor],
    n_frames: torch.Tensor,           # [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3f -> (alphas [B, T, J], NEG_INF on frames past
    n_frames but frame 0; loglik [B])."""
    B, T, J = emit_graph.shape
    dev, dt = emit_graph.device, emit_graph.dtype
    self_logp, adv_logp, enter_logp, exit_logp, init_logp, final_logp, skip_logp = _graph_logps(
        graphs, ("self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp",
                 "skip_logp"), emit_graph)
    n_frames = n_frames.to(dev)
    neg1 = torch.full((B, 1), NEG_INF, dtype=dt, device=dev)
    neg2 = torch.full((B, 2), NEG_INF, dtype=dt, device=dev)

    alpha = init_logp + emit_graph[:, 0]
    alphas = [alpha]
    for t in range(1, T):
        exit_lse = torch.logsumexp(alpha + exit_logp, dim=1)
        stay = alpha + self_logp
        adv = torch.cat([neg1, alpha[:, :-1] + adv_logp[:, 1:]], dim=1)
        ent = exit_lse[:, None] + enter_logp
        new_alpha = torch.logaddexp(torch.logaddexp(stay, adv), ent)
        if skip_logp is not None:
            skp = torch.cat([neg2, alpha[:, :-2] + skip_logp[:, 2:]], dim=1)
            new_alpha = torch.logaddexp(new_alpha, skp)
        new_alpha = new_alpha + emit_graph[:, t]
        active = (t < n_frames)[:, None]
        alphas.append(torch.where(active, new_alpha, torch.full_like(new_alpha, NEG_INF)))
        alpha = torch.where(active, new_alpha, alpha)
    return torch.stack(alphas, dim=1), torch.logsumexp(alpha + final_logp, dim=1)


def backward_pass(
    emit_graph: torch.Tensor,         # [B, T, J] from gather_emissions
    graphs: Dict[str, torch.Tensor],
    n_frames: torch.Tensor,           # [B]
    alphas: torch.Tensor,             # [B, T, J] from forward_pass
    loglik: torch.Tensor,             # [B]
) -> torch.Tensor:
    """The plain version of K3b -> log_gamma [B, T, J] (NEG_INF on padding)."""
    B, T, J = emit_graph.shape
    dev, dt = emit_graph.device, emit_graph.dtype
    self_logp, adv_logp, enter_logp, exit_logp, final_logp, skip_logp = _graph_logps(
        graphs, ("self_logp", "adv_logp", "enter_logp", "exit_logp", "final_logp", "skip_logp"),
        emit_graph)
    n_frames = n_frames.to(dev)
    neg1 = torch.full((B, 1), NEG_INF, dtype=dt, device=dev)
    neg2 = torch.full((B, 2), NEG_INF, dtype=dt, device=dev)

    beta = final_logp  # betas[t] pairs with alphas[t]
    betas = [beta]
    for t in range(T - 2, -1, -1):
        eb = emit_graph[:, t + 1] + beta  # emit(t+1, j) + beta_{t+1}[j]
        enter_lse = torch.logsumexp(enter_logp + eb, dim=1)
        stay = self_logp + eb
        adv = torch.cat([adv_logp[:, 1:] + eb[:, 1:], neg1], dim=1)
        ext = exit_logp + enter_lse[:, None]
        new_beta = torch.logaddexp(torch.logaddexp(stay, adv), ext)
        if skip_logp is not None:
            skb = torch.cat([skip_logp[:, 2:] + eb[:, 2:], neg2], dim=1)
            new_beta = torch.logaddexp(new_beta, skb)
        # frame t+1 is past this utterance: beta stays frozen at final_logp
        beta = torch.where((t + 1 < n_frames)[:, None], new_beta, beta)
        betas.append(beta)
    betas.reverse()

    log_gamma = alphas + torch.stack(betas, dim=1) - loglik[:, None, None]
    mask = (torch.arange(T, device=dev)[None, :] < n_frames[:, None])[:, :, None]
    return torch.where(mask, log_gamma, torch.full_like(log_gamma, NEG_INF))


def forward_backward(
    emit_ll: torch.Tensor,            # [B, T, P]
    graphs: Dict[str, torch.Tensor],  # graphs_to_torch(batch_graphs(...))
    n_frames: torch.Tensor,           # [B]
    acoustic_scale: float = 1.0,
) -> FBResult:
    emit_graph = gather_emissions(emit_ll, graphs["emit_id"], acoustic_scale)
    alphas, loglik = forward_pass(emit_graph, graphs, n_frames)
    return FBResult(backward_pass(emit_graph, graphs, n_frames, alphas, loglik), loglik)


def state_posteriors_to_pdf(
    log_gamma: torch.Tensor,  # [B, T, J]
    emit_id: torch.Tensor,    # [B, J]
    n_pdfs: int,
) -> torch.Tensor:
    """Collapse graph-state posteriors to pdf posteriors: [B, T, n_pdfs],
    each pdf's states summed in state order (``utils.segment``: the same bits
    on every run)."""
    gamma = torch.exp(torch.clamp(log_gamma, min=-80.0))
    gamma = torch.where(log_gamma <= NEG_INF / 2, torch.zeros_like(gamma), gamma)
    return collapse_columns(gamma, emit_id, n_pdfs)

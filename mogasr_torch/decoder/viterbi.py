"""Frame-synchronous Viterbi over chain+loop graphs: the port of
mogasr/decoder/viterbi.py, and the plain version of the CUDA kernel in
``viterbi_cuda`` (kernel K2).

Same recursion, operation for operation, so results are bitwise equal to the
reference: per frame an exit max with its first-index argmax, the stay /
advance / enter candidates, backpointer codes where stay beats advance beats
enter on ties, the graph-gathered emission, the beam mask, rows frozen past
``n_frames``, and CTC skip transitions (code 3, from j-2) where the graphs
have ``skip_logp``.
The backtrace follows the stored uint8 codes back from the best final state;
``with_backtrace=False`` skips it and returns only the score (a zero path).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

NEG_INF = -1e30


class ViterbiResult(NamedTuple):
    path: torch.Tensor     # [B, T] int32 graph-state index per frame (-1 on padding)
    entered: torch.Tensor  # [B, T] bool: frame t entered its chain via the loop
    score: torch.Tensor    # [B] float32 best log-prob (acoustic*scale + transition)


def graphs_to_torch(graphs_np: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """``mogasr.hmm.graph.batch_graphs`` output as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in graphs_np.items()}


def viterbi(
    emit_ll: torch.Tensor,               # [B, T, P] pdf log-likelihoods
    graphs: Dict[str, torch.Tensor],     # graphs_to_torch(batch_graphs(...))
    n_frames: torch.Tensor,              # [B]
    acoustic_scale: float = 1.0,
    beam: float = 0.0,                   # 0 = exact (no pruning)
    with_backtrace: bool = True,
) -> ViterbiResult:
    B, T, P = emit_ll.shape
    dev = emit_ll.device
    emit_id = graphs["emit_id"].to(torch.int64)
    self_logp = graphs["self_logp"]
    adv_logp = graphs["adv_logp"]
    enter_logp = graphs["enter_logp"]
    exit_logp = graphs["exit_logp"]
    skip_logp = graphs.get("skip_logp")
    J = emit_id.shape[1]
    n_frames = n_frames.to(dev)

    emit_graph = torch.gather(
        emit_ll * acoustic_scale, 2, emit_id[:, None, :].expand(B, T, J)
    )  # [B, T, J]
    neg1 = torch.full((B, 1), NEG_INF, dtype=torch.float32, device=dev)
    neg2 = torch.full((B, 2), NEG_INF, dtype=torch.float32, device=dev)
    # backpointer codes: 0 stay, 1 advance, 2 enter, 3 skip
    zero, one, two, three = (torch.tensor(v, dtype=torch.uint8, device=dev) for v in range(4))

    delta = graphs["init_logp"] + emit_graph[:, 0]
    bps, exit_args = [], []
    for t in range(1, T):
        exit_scores = delta + exit_logp
        exit_best = exit_scores.amax(dim=1)
        exit_arg = exit_scores.argmax(dim=1).to(torch.int32)

        stay = delta + self_logp
        adv = torch.cat([neg1, delta[:, :-1] + adv_logp[:, 1:]], dim=1)
        ent = exit_best[:, None] + enter_logp

        best = torch.maximum(torch.maximum(stay, adv), ent)
        bp = torch.where(best == ent, two, torch.where(best == adv, one, zero))
        if skip_logp is not None:
            skip = torch.cat([neg2, delta[:, :-2] + skip_logp[:, 2:]], dim=1)
            bp = torch.where(skip > best, three, bp)
            best = torch.maximum(best, skip)
        # stay wins exact ties, for deterministic alignments
        bp = torch.where(best == stay, zero, bp)

        new_delta = best + emit_graph[:, t]
        if beam > 0:
            thresh = new_delta.amax(dim=1, keepdim=True) - beam
            new_delta = torch.where(new_delta >= thresh, new_delta, torch.full_like(new_delta, NEG_INF))

        active = (t < n_frames)[:, None]
        delta = torch.where(active, new_delta, delta)
        if with_backtrace:
            bps.append(torch.where(active, bp, zero))
            exit_args.append(exit_arg)

    final_scores = delta + graphs["final_logp"]
    score = final_scores.amax(dim=1)
    if not with_backtrace:
        empty = torch.zeros((B, T), dtype=torch.int32, device=dev)
        return ViterbiResult(empty, empty.to(torch.bool), score)
    j = final_scores.argmax(dim=1)

    # backtrace: path[t] is the state at frame t; bps[t-1] holds frame t's codes
    path = [None] * T
    entered = [None] * T
    for t in range(T - 1, 0, -1):
        path[t] = j
        b = torch.gather(bps[t - 1], 1, j[:, None])[:, 0]
        entered[t] = b == 2
        j = torch.where(
            b == 0, j,
            torch.where(b == 1, j - 1, torch.where(b == 3, j - 2, exit_args[t - 1].to(j.dtype))),
        )
    path[0] = j
    entered[0] = torch.ones(B, dtype=torch.bool, device=dev)
    path = torch.stack(path, dim=1).to(torch.int32)
    entered = torch.stack(entered, dim=1)
    mask = torch.arange(T, device=dev)[None, :] < n_frames[:, None]
    path = torch.where(mask, path, torch.full_like(path, -1))
    return ViterbiResult(path, entered & mask, score)


def path_to_pdfs(result: ViterbiResult, graphs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B, T] pdf id per frame (-1 on padding)."""
    emit_id = graphs["emit_id"]
    safe = torch.clamp(result.path, min=0).to(torch.int64)
    pdfs = torch.gather(emit_id, 1, safe)
    return torch.where(result.path >= 0, pdfs, torch.full_like(pdfs, -1))


def path_to_tokens(result: ViterbiResult, graph_labels, chain_id: np.ndarray):
    """Host-side: collapse a decoded path into token label sequences per utt.

    chain_id: [B, J]; graph_labels: the shared chain labels, or one list per
    utterance.
    """
    path = result.path.cpu().numpy()
    entered = result.entered.cpu().numpy()
    B, T = path.shape
    out = []
    for b in range(B):
        labels = graph_labels[b] if isinstance(graph_labels[0], (list, tuple)) else graph_labels
        toks = []
        for t in range(T):
            if path[b, t] < 0:
                break
            if entered[b, t]:
                toks.append(labels[chain_id[b, path[b, t]]])
        out.append(toks)
    return out

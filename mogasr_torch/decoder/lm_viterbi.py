"""Frame-synchronous Viterbi with an exact bigram word LM: the port of
mogasr/decoder/lm_viterbi.py.

The token-passing decoder of ``decoder.viterbi`` with its one loop state
factored into per-word LM context: at each frame the best exit of every word
w is combined with the [W, W] bigram matrix in one max-plus contraction, so
a cross-word transition carries exact P(w'|w). Chains that share an LM word
(multi-pronunciation lexicons) reduce to word exits through a second segment
max, and ``chain_entry_logp`` carries per-variant pronunciation log-priors on
word entry. All utterances decode against one shared loop graph.

The reference leaves the recursion to XLA as one ``lax.scan``; here it is
plain PyTorch ops on the device of the emissions, one step per frame over
[B, J], [B, C] and [B, W] tensors, the per-frame outputs written into
tensors allocated once, and the backtrace on the device too. It is the same
recursion operation for operation, so on float32 emissions the path, the
entry flags and the lattice's entry frames equal the reference's and the
scores are bitwise equal: the same order of additions, the segment argmax
as the first index within 1e-6 of the segment max (``scatter_reduce``'s
"amax" and "amin" are exact in any order of their atomic updates, so the
card gives the CPU's result), the backpointer precedence enter, advance,
skip, then stay on ties, and rows frozen past ``n_frames``.

Two rearrangements leave every output unchanged: the lattice slice of frame
t is the chain segment max that the step of frame t + 1 computes anyway (the
reference computes it twice), and the forward pass stores, per frame and
next word, the state the best entry into that word came from (the exit
argmax through the word argmax through the bigram argmax) instead of the
three argmax arrays, so the backtrace gathers once a frame instead of three
times.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mogasr_torch.hmm.graph import Graph
from mogasr_torch.lm.ngram import BigramLm

NEG_INF = -1e30


class LmViterbiResult(NamedTuple):
    path: torch.Tensor     # [B, T] int32 graph-state index per frame (-1 on padding)
    entered: torch.Tensor  # [B, T] bool: frame t entered its chain via the LM
    score: torch.Tensor    # [B] float32


def _segmax(scores: torch.Tensor, seg: torch.Tensor, n_seg: int, cols: torch.Tensor):
    """Per-segment (max, argmax) over the last axis of [B, N] scores, the
    argmax being the first index within 1e-6 of the segment's max. ``seg`` is
    the [B, N] int64 segment of each column, ``cols`` the [B, N] int64 column
    indices. A segment without members gets (-inf, 0)."""
    B, N = scores.shape
    m = torch.full((B, n_seg), float("-inf"), dtype=scores.dtype, device=scores.device)
    m.scatter_reduce_(1, seg, scores, "amax", include_self=False)
    hit = scores >= m.gather(1, seg) - 1e-6
    a = torch.zeros((B, n_seg), dtype=torch.int64, device=scores.device)
    a.scatter_reduce_(1, seg, torch.where(hit, cols, N), "amin", include_self=False)
    return m, a


def chain_token_map(graph: Graph, lm: BigramLm) -> np.ndarray:
    """[n_chains] LM-token index per graph chain (labels may repeat under
    multi-pronunciation graphs; every label must be an LM token)."""
    tok_idx = {t: i for i, t in enumerate(lm.tokens)}
    missing = [lab for lab in graph.labels if lab not in tok_idx]
    assert not missing, f"graph chains not in LM vocabulary: {missing[:5]}"
    return np.asarray([tok_idx[lab] for lab in graph.labels], np.int32)


def viterbi_lm(
    emit_ll: torch.Tensor,   # [B, T, P] float32
    graph: Graph,            # shared loop graph (host object)
    lm: BigramLm,            # every graph chain label must be an lm token
    n_frames: torch.Tensor,  # [B]
    acoustic_scale: float = 1.0,
    insertion_penalty: float = 0.0,
    chain_entry_logp: Optional[np.ndarray] = None,  # [n_chains] pron log-priors
    with_lattice: bool = False,
):
    """-> LmViterbiResult, or (LmViterbiResult, (lat_score, lat_start,
    lat_base)) with ``with_lattice``: [B, T, C] tensors (float32, int32,
    float32) on the device of ``emit_ll`` holding, for every (frame t, chain
    c), the best score of a path ending chain c at t, that token's
    chain-entry frame, and its cumulative score at entry (the LM transition
    included): the inputs of ``decoder.lattice.lattices_from_pass``."""
    dev = emit_ll.device
    B, T, _P = emit_ll.shape
    J = graph.n_states
    token_of_chain_np = chain_token_map(graph, lm)
    C = len(graph.labels)
    W = lm.pair_logp.shape[0]
    if chain_entry_logp is None:
        chain_entry_logp = np.zeros(C, np.float32)

    def dev_t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    chain_id = dev_t(graph.chain_id, torch.int64)                 # [J]
    token_of_chain = dev_t(token_of_chain_np, torch.int64)        # [C]
    word_of_state = token_of_chain[chain_id]                      # [J]
    is_start = dev_t(graph.enter_logp > NEG_INF / 2, torch.bool)
    is_end = dev_t(graph.exit_logp > NEG_INF / 2, torch.bool)
    self_logp = dev_t(graph.self_logp, torch.float32)
    adv_logp = dev_t(graph.adv_logp, torch.float32)
    skip_logp = None if graph.skip_logp is None else dev_t(graph.skip_logp, torch.float32)
    entry = dev_t(chain_entry_logp, torch.float32)
    pair_logp = dev_t(lm.pair_logp, torch.float32)
    lm_init = dev_t(lm.init_logp, torch.float32)
    lm_final = dev_t(lm.final_logp, torch.float32)
    n_frames = n_frames.to(device=dev, dtype=torch.int64)

    emit = (emit_ll * acoustic_scale).index_select(2, chain_id.new_tensor(graph.emit_id))  # [B, T, J]
    enter_local = torch.where(is_start, entry[chain_id] - insertion_penalty, NEG_INF)      # [J]
    exit_w = torch.where(is_end, dev_t(graph.exit_logp, torch.float32), NEG_INF)          # [J]
    init_state = lm_init[word_of_state]
    delta = torch.where(is_start, enter_local + init_state + emit[:, 0], NEG_INF)
    adv_tail = adv_logp[1:]
    skip_tail = None if skip_logp is None else skip_logp[2:]
    seg_state = chain_id.expand(B, J)
    seg_chain = token_of_chain.expand(B, C)
    cols_state = torch.arange(J, device=dev).expand(B, J)
    cols_chain = torch.arange(C, device=dev).expand(B, C)
    active = torch.arange(T, device=dev)[:, None, None] < n_frames[None, :, None]  # [T, B, 1]
    zero_u8 = torch.zeros((), dtype=torch.uint8, device=dev)
    codes = [torch.tensor(v, dtype=torch.uint8, device=dev) for v in (1, 2, 3)]

    # per frame t >= 1: the backpointer codes, and for each next word the
    # state its best entry came from
    bps = torch.empty((max(T - 1, 0), B, J), dtype=torch.uint8, device=dev)
    src = torch.empty((max(T - 1, 0), B, W), dtype=torch.int64, device=dev)
    if with_lattice:
        lat_score = torch.empty((B, T, C), dtype=torch.float32, device=dev)
        lat_start = torch.empty((B, T, C), dtype=torch.int32, device=dev)
        lat_base = torch.empty((B, T, C), dtype=torch.float32, device=dev)
        # for the token at state j: its chain-entry frame and its score at entry
        ent_t = torch.zeros((B, J), dtype=torch.int32, device=dev)
        ent_base = init_state.expand(B, J)

        def lat_slice(t, chain_exit, exit_arg):
            lat_score[:, t] = chain_exit
            lat_start[:, t] = ent_t.gather(1, exit_arg)
            lat_base[:, t] = ent_base.gather(1, exit_arg)

    for t in range(1, T):
        chain_exit, exit_arg = _segmax(delta + exit_w, seg_state, C, cols_state)   # [B, C]
        if with_lattice:
            lat_slice(t - 1, chain_exit, exit_arg)
        word_exit, word_arg = _segmax(chain_exit, seg_chain, W, cols_chain)      # [B, W]
        # max-plus contraction with the bigram matrix
        ent_word, prev_word = (word_exit[:, :, None] + pair_logp).max(dim=1)      # [B, W']
        src[t - 1] = exit_arg.gather(1, word_arg.gather(1, prev_word))

        stay = delta + self_logp
        adv = F.pad(delta[:, :-1] + adv_tail, (1, 0), value=NEG_INF)
        ent_state = ent_word[:, word_of_state]
        ent = ent_state + enter_local
        best = torch.maximum(torch.maximum(stay, adv), ent)
        bp = torch.where(best == ent, codes[1], torch.where(best == adv, codes[0], zero_u8))
        if skip_tail is not None:
            skp = F.pad(delta[:, :-2] + skip_tail, (2, 0), value=NEG_INF)
            bp = torch.where(skp > best, codes[2], bp)
            best = torch.maximum(best, skp)
        bp = torch.where(best == stay, zero_u8, bp)
        act = active[t]
        bp = torch.where(act, bp, zero_u8)
        bps[t - 1] = bp
        new_delta = torch.where(act, best + emit[:, t], delta)
        if with_lattice:
            enter, advance = bp == codes[1], bp == codes[0]
            new_t = torch.where(advance, F.pad(ent_t[:, :-1], (1, 0), value=0), ent_t)
            new_base = torch.where(advance, F.pad(ent_base[:, :-1], (1, 0), value=NEG_INF), ent_base)
            if skip_tail is not None:
                skipped = bp == codes[2]
                new_t = torch.where(skipped, F.pad(ent_t[:, :-2], (2, 0), value=0), new_t)
                new_base = torch.where(skipped, F.pad(ent_base[:, :-2], (2, 0), value=NEG_INF), new_base)
            # inactive rows have code 0 (stay): their carries are unchanged
            ent_t = torch.where(enter, t, new_t)
            ent_base = torch.where(enter, ent_state, new_base)
        delta = new_delta

    exit_scores = delta + exit_w
    if with_lattice and T > 0:
        lat_slice(T - 1, *_segmax(exit_scores, seg_state, C, cols_state))
    final_scores = exit_scores + lm_final[word_of_state]
    score, j = final_scores.max(dim=1)

    # backtrace: frame t's codes and entry sources are bps[t - 1], src[t - 1];
    # a code of 0 stays at j, 1 steps back 1, 3 steps back 2 (3 - (3 >> 1)),
    # 2 enters from src
    path = torch.empty((T, B), dtype=torch.int64, device=dev)
    entered = torch.empty((T, B), dtype=torch.bool, device=dev)
    for t in range(T - 1, 0, -1):
        path[t] = j
        b = bps[t - 1].gather(1, j[:, None])[:, 0]
        ent_here = b == codes[1]
        entered[t] = ent_here
        j_ent = src[t - 1].gather(1, word_of_state[j][:, None])[:, 0]
        j = torch.where(ent_here, j_ent, j - (b - (b >> 1)))
    if T > 0:
        path[0] = j
        entered[0] = True
    mask = torch.arange(T, device=dev)[None, :] < n_frames[:, None]
    path = torch.where(mask, path.T, -1).to(torch.int32)
    result = LmViterbiResult(path, entered.T & mask, score)
    if with_lattice:
        return result, (lat_score, lat_start, lat_base)
    return result


def path_to_tokens_lm(result: LmViterbiResult, graph: Graph):
    """Host-side token readout, mirroring ``viterbi.path_to_tokens``."""
    path = result.path.cpu().numpy()
    entered = result.entered.cpu().numpy()
    B, T = path.shape
    out = []
    for b in range(B):
        toks = []
        for t in range(T):
            if path[b, t] < 0:
                break
            if entered[b, t]:
                toks.append(graph.labels[graph.chain_id[path[b, t]]])
        out.append(toks)
    return out

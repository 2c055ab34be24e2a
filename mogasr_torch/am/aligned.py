"""Per-frame quantities against each frame's aligned pdf, the shared core of
the adaptation statistics (``am/{fmllr,mllr,stc}.py``, the LDA statistics
and the VTLN objective).

A frame labelled s (its pdf in a forced alignment; -1 marks padding) is
scored against the K components of state s only: the reference gathers
``means[labels]`` etc. into [N, K, D] tensors inside one jitted function. On
the card a gather of the decode batch's 153,600 frames at K = 16, D = 40 is
~0.4 GB a tensor, and the STC scatter "ns,nk,nkd,nke->skde" contracted
naively would build [N, K, D, D] (~15 GB). So every accumulator here walks
the frames in chunks under a byte budget (``CHUNK_BYTES`` of temporaries a
chunk), and sums per state with sorted segment sums (``state_sums``): the
same bits on every run, as ``utils.segment.index_sum`` gives EM.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from mogasr_torch.am.gmm import LOG_2PI, GmmSet

CHUNK_BYTES = 256 << 20  # temporaries of one frame chunk (read at each call)


def frame_chunks(n: int, bytes_per_frame: int) -> List[Tuple[int, int]]:
    """[(start, stop)] ranges over n frames, each within ``CHUNK_BYTES``."""
    step = max(1, CHUNK_BYTES // max(int(bytes_per_frame), 1))
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def component_loglik(gmm: GmmSet, feats: torch.Tensor, labels: torch.Tensor):
    """-> (ll_k [N, K], valid [N], mu [N, K, D], var [N, K, D]): each frame's
    log-likelihood under each component of its aligned state (label -1 reads
    state 0 and is marked invalid), the reference's formula term for term."""
    D = gmm.means.shape[-1]
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)
    mu = gmm.means[safe]
    var = torch.clamp(gmm.vars[safe], min=1e-8)
    w = torch.clamp(gmm.weights[safe], min=1e-30)
    x = feats[:, None, :]
    ll_k = (
        torch.log(w)
        - 0.5 * (D * LOG_2PI + torch.log(var).sum(-1))
        - 0.5 * ((x - mu) ** 2 / var).sum(-1)
    )
    return ll_k, valid, mu, var


def component_posteriors(gmm: GmmSet, feats: torch.Tensor, labels: torch.Tensor):
    """-> (gamma [N, K], mu, var): within-state component posteriors, 0 on
    padding frames."""
    ll_k, valid, mu, var = component_loglik(gmm, feats, labels)
    gamma = torch.softmax(ll_k, dim=-1)
    return torch.where(valid[:, None], gamma, torch.zeros_like(gamma)), mu, var


def gather_bytes(gmm: GmmSet) -> int:
    """Bytes a frame's gathered [K, D] operands and their temporaries take."""
    _S, K, D = gmm.means.shape
    return 6 * K * D * 4


def state_sums(
    per_frame: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    n_states: int,
    width: int,
    bytes_per_frame: int,
) -> torch.Tensor:
    """[n_states, width] sums over frames grouped by label, in a fixed order.

    ``per_frame(idx)`` gives the [len(idx), width] values of the frames
    ``idx``. The labelled frames are sorted by label once (a stable sort, so
    each state keeps its frames in position order); each chunk of the sorted
    frames then covers a contiguous run of states, which one
    ``torch.segment_reduce`` sums and adds into that run's rows. With one
    chunk this is ``utils.segment.index_sum``; either way the order of every
    sum is fixed, on the card as on the CPU. Padding frames (label < 0) are
    never read.
    """
    labels = labels.to(torch.int64)
    dev = labels.device
    idx = torch.nonzero(labels >= 0).reshape(-1)
    order = idx[torch.argsort(labels[idx], stable=True)]
    lab = labels[order]
    out = None
    for a, b in frame_chunks(int(order.shape[0]), bytes_per_frame + 4 * width):
        vals = per_frame(order[a:b])
        if out is None:
            out = torch.zeros((n_states, width), dtype=vals.dtype, device=dev)
        lo, hi = int(lab[a]), int(lab[b - 1])
        lengths = torch.bincount(lab[a:b] - lo, minlength=hi - lo + 1)
        out[lo: hi + 1] += torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)
    if out is None:
        out = torch.zeros((n_states, width), dtype=torch.float32, device=dev)
    return out

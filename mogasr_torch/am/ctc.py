"""Connectionist Temporal Classification: alignment-free training and every
CTC decode path, the port of mogasr/am/ctc.py.

The loss. ``ctc_loss`` is the per-utterance negative log-likelihood over the
blank-interleaved label sequence z = (b, y1, b, ..., yL, b). On the card it
runs kernel K3 (K3f, K3b and their combine, ``decoder.fb_cuda``): each row's
z is written as a chain graph (``ctc_label_graphs``: no loop arc, so K3's
chain arm, with its CTC skip arm for the y(k-1) -> y(k) transitions over an
optional blank), and ``am.nn_seq.FbLoglik`` carries the gradient by the
posterior identity d loglik / d log p = the unit occupancies. On the CPU, or
with ``use_kernels=False``, it runs the reference's alpha recursion as plain
PyTorch ops under autograd (``ctc_loss_plain``), with the reference's
logaddexp derivative, so that its gradient agrees with ``jax.grad`` also on
rows whose labels cannot fit their frames. The reference computes this loss
in a ``lax.scan``, not in a Pallas kernel; K3 takes the frame loop off the
host (a plain loop on the card launches about ten kernels a frame).

Decoding: greedy best path (``ctc_greedy_decode``, ``make_ctc_frames_fn``:
the argmax on the card, one [B, T] int copy to the host, the collapse there);
the prefix beam on the host (``ctc_prefix_beam_decode``, the reference's
dict walk), in C++ (``ctc_prefix_beam_decode_native``, the copied
``native/ctc_beam_native.cpp``) and on the device
(``ctc_prefix_beam_decode_device``: the reference's jitted scan as plain
PyTorch ops a frame, host-paced, with unit-LM fusion and biasing tables);
``CtcStreamDecoder`` over chunks; and graph decoding over the CTC word loop
(``ctc_decode_graph`` with ``skip_logp``, decoded by K2 through
``pipeline.decode_batch``). The encoders' forwards (``make_ctc_logits_fn``,
``make_ctc_scorer``) run LstmAm and BlstmAm on K4 on the card, ConformerAm
at its 4x-subsampled rate for greedy decoding.

Blank is the last vocabulary index (V - 1) unless given, so unit ids
0..n_phones-1 coincide with lexicon phone ids. Ties in the device beam's
top-K go to the lower index, as ``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mogasr_torch.am.neural import RECURRENT, ConformerAm, spec_augment
from mogasr_torch.am.train_nn import TrainState, apply_update, init_train_state, step_generator, train_logits
from mogasr_torch.config import DecodeConfig, TrainConfig
from mogasr_torch.dist.comm import batch_count
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm.lexicon import Lexicon

NEG_INF = -1e30

Beams = Dict[Tuple[int, ...], Tuple[float, float]]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------


def ctc_expand(labels: torch.Tensor, n_labels: torch.Tensor, blank_id: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blank-interleave labels [B, L] (-1 padding): (z [B, S] int64, skip_ok
    [B, S], valid_s [B, S]) with S = 2L + 1; skip_ok marks the label states
    reachable by the s-2 -> s skip (the previous label differs), valid_s the
    states below each row's 2 n_labels + 1."""
    B, L = labels.shape
    S = 2 * L + 1
    dev = labels.device
    z = torch.full((B, S), blank_id, dtype=torch.int64, device=dev)
    z[:, 1::2] = torch.clamp(labels.long(), min=0)
    s_idx = torch.arange(S, device=dev)
    valid_s = s_idx[None, :] < (2 * n_labels.to(dev).long()[:, None] + 1)
    zm2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64, device=dev), z[:, :-2]], dim=1)
    is_label = (s_idx % 2 == 1)[None, :]
    skip_ok = is_label & (s_idx[None, :] >= 2) & (z != zm2) & valid_s
    return z, skip_ok, valid_s


class _LogAddExp(torch.autograd.Function):
    """logaddexp with ``jnp.logaddexp``'s derivative, exp(x - out): it
    differs from torch's where two NEG_INF-sized operands round into each
    other (a row whose labels cannot fit its frames), and nowhere else."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_lae = _LogAddExp.apply


def ctc_loss_plain(logp: torch.Tensor, n_frames: torch.Tensor, labels: torch.Tensor, n_labels: torch.Tensor,
                   blank_id: int) -> torch.Tensor:
    """The reference's alpha recursion over log posteriors [B, T, V] -> the
    NLL [B]: frames past n_frames carry alpha unchanged, so a row of no
    frames is scored on frame 0, as in the reference."""
    B, T, V = logp.shape
    dev = logp.device
    nf = n_frames.to(dev)
    nl = n_labels.to(dev).long()
    z, skip_ok, valid_s = ctc_expand(labels.to(dev), nl, blank_id)
    S = z.shape[1]
    lp_z = torch.gather(logp, 2, z[:, None, :].expand(B, T, S))  # [B, T, S]
    s_idx = torch.arange(S, device=dev)
    init_ok = (s_idx[None, :] == 0) | ((s_idx[None, :] == 1) & (nl[:, None] >= 1))
    alpha = torch.where(init_ok, lp_z[:, 0], NEG_INF)
    neg1 = torch.full((B, 1), NEG_INF, dtype=logp.dtype, device=dev)
    neg2 = torch.full((B, 2), NEG_INF, dtype=logp.dtype, device=dev)
    lp_t = lp_z.unbind(1)  # one unbind, not a slice a frame (whose backward allocates all of lp_z)
    for t in range(1, T):
        a1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        a2 = torch.where(skip_ok, torch.cat([neg2, alpha[:, :-2]], dim=1), NEG_INF)
        new = _lae(_lae(alpha, a1), a2) + lp_t[t]
        new = torch.where(valid_s, new, NEG_INF)
        alpha = torch.where((t < nf)[:, None], new, alpha)
    last = 2 * nl
    a_blank = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_label = torch.gather(alpha, 1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
    a_label = torch.where(nl > 0, a_label, NEG_INF)
    return -_lae(a_blank, a_label)


def ctc_label_graphs(labels: torch.Tensor, n_labels: torch.Tensor, blank_id: int) -> Dict[str, torch.Tensor]:
    """Each row's z as a K3 chain graph [B, 2L + 1] on the labels' device:
    emit_id z, self and advance log-probs 0, skip 0 where the skip is open,
    init 0 at s = 0 (and s = 1 with a label), final 0 at s = 2 n_labels and
    2 n_labels - 1, no enter or exit arc; the states past a row's own padded
    as ``hmm.graph.batch_graphs`` pads (emit_id 0, every log-prob NEG_INF)."""
    dev = labels.device
    nl = n_labels.to(dev).long()
    z, skip_ok, valid_s = ctc_expand(labels, nl, blank_id)
    s = torch.arange(z.shape[1], device=dev)[None, :]

    def logp(mask: torch.Tensor) -> torch.Tensor:
        return torch.where(mask, 0.0, NEG_INF).to(torch.float32).contiguous()

    never = torch.zeros_like(valid_s)
    last = 2 * nl[:, None]
    return {
        "emit_id": torch.where(valid_s, z, 0).to(torch.int32).contiguous(),
        "self_logp": logp(valid_s),
        "adv_logp": logp(valid_s & (s >= 1)),
        "enter_logp": logp(never),
        "exit_logp": logp(never),
        "init_logp": logp((s == 0) | ((s == 1) & (nl[:, None] >= 1))),
        "final_logp": logp((s == last) | ((s == last - 1) & (nl[:, None] >= 1))),
        "skip_logp": logp(skip_ok),
    }


def frames_needed(labels: torch.Tensor, n_labels: torch.Tensor) -> torch.Tensor:
    """[B] the fewest frames a row's labels fit in: one a label, and one
    blank between two equal neighbours."""
    nl = n_labels.long()
    pos = torch.arange(labels.shape[1], device=labels.device)[None, :]
    repeat = (pos[:, 1:] < nl[:, None]) & (labels[:, 1:] == labels[:, :-1])
    return nl + repeat.sum(dim=1)


def ctc_nll_fb(logp: torch.Tensor, n_frames: torch.Tensor, labels: torch.Tensor, n_labels: torch.Tensor,
               blank_id: int) -> torch.Tensor:
    """The NLL [B] as minus ``am.nn_seq.FbLoglik`` over ``ctc_label_graphs``
    at acoustic scale 1: K3 on the card (the plain forward-backward passes
    on the CPU), its gradient the unit occupancies. A row of no frames is
    scored on frame 0, as the recursion scores it. A row whose labels cannot
    fit its frames (``frames_needed``) keeps K3's loss, about 1e30 as in the
    reference, and gets a gradient of 0: its occupancies, like the
    reference's autodiff of NEG_INF sums there, are no gradient of any
    likelihood. Up to 1024 states (511 labels) a row runs K3's chain arm,
    wider ones its block arm; K3 rejects graphs wider than its MAX_J."""
    from mogasr_torch.am.nn_seq import FbLoglik  # nn_seq imports the pipeline, which imports this module

    dev = logp.device
    graphs = ctc_label_graphs(labels.to(dev), n_labels, blank_id)
    if logp.shape[1] == 0:
        raise ValueError("ctc_loss: a batch of 0 frames")
    nf = torch.clamp(n_frames.to(dev), min=1)
    short = nf < frames_needed(labels.to(dev), n_labels.to(dev))
    logp = torch.where(short[:, None, None], logp.detach(), logp)
    return -FbLoglik.apply(logp, graphs, nf, 1.0)


def ctc_loss(
    logits: torch.Tensor,    # [B, T, V] raw scores (log-softmax applied here)
    n_frames: torch.Tensor,  # [B]
    labels: torch.Tensor,    # [B, L] unit ids, -1 padding
    n_labels: torch.Tensor,  # [B]
    blank_id: Optional[int] = None,
    *,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood -log p(y|x) [B]: K3 on a
    CUDA tensor (``ctc_nll_fb``), the plain recursion on the CPU or with
    ``use_kernels=False``. A row whose labels cannot fit its frames gets
    about 1e30, as in the reference; on K3 its gradient is 0."""
    V = logits.shape[-1]
    bid = V - 1 if blank_id is None else int(blank_id)
    # float32; a float64 input (a float64 check of a gradient) stays float64
    logp = torch.log_softmax(logits if logits.dtype == torch.float64 else logits.to(torch.float32), dim=-1)
    if use_kernels and logp.device.type == "cuda":
        return ctc_nll_fb(logp, n_frames, labels, n_labels, bid)
    return ctc_loss_plain(logp, n_frames, labels, n_labels, bid)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


def masked_mean_objective(nll: torch.Tensor, n_frames: torch.Tensor, n_labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean per-label-normalized loss, mean raw NLL) over the rows with
    frames and labels; the other rows (batch padding) contribute nothing."""
    nf, nl = n_frames.to(nll.device), n_labels.to(nll.device)
    valid = (nf > 0) & (nl > 0)
    nv = batch_count(valid.sum())
    per_label = torch.where(valid, nll / torch.clamp(nl, min=1), 0.0)
    mean_nll = torch.where(valid, nll, 0.0).sum() / nv
    return per_label.sum() / nv, mean_nll


def ctc_objective(model: nn.Module, feats, n_frames, labels, n_labels, blank_id: Optional[int] = None, *,
                  use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward (``am.train_nn.train_logits``) + CTC loss + the
    masked normalization."""
    logits, _aux = train_logits(model, feats, n_frames)
    nll = ctc_loss(logits, n_frames, labels, n_labels, blank_id, use_kernels=use_kernels)
    return masked_mean_objective(nll, n_frames, n_labels)


def init_ctc_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """A fresh state for an initialised ``model`` (``am.params.init_`` or a
    ``from_flax`` state_dict): the CE path's AdamW and schedule."""
    return init_train_state(model, cfg)


def make_ctc_train_step(cfg: TrainConfig, blank_id: Optional[int] = None, spec_aug: bool = False, *,
                        use_kernels: bool = True):
    """(state, feats, n_frames, labels, n_labels) -> (state, metrics): one
    CTC step, the loss the mean per-label-normalized NLL; metrics "loss" and
    "utt_nll" as Python floats. The optimizer and SpecAugment's draws are the
    CE step's (``am.train_nn``)."""

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        model = state.model
        model.train()
        feats_in = spec_augment(feats, n_frames, step_generator(cfg, state.step)) if spec_aug else feats
        with torch.enable_grad():
            loss, mean_nll = ctc_objective(model, feats_in, n_frames, labels, n_labels, blank_id,
                                           use_kernels=use_kernels)
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item(), "utt_nll": mean_nll.item()}

    return train_step


def ctc_labels_from_words(lexicon: Lexicon, words: Sequence[str], include_sil: bool = False) -> List[int]:
    """Phone-id target sequence for CTC training (blank absorbs silence
    unless ``include_sil``)."""
    return lexicon.words_to_phone_ids(words, interword_sil=include_sil, edge_sil=include_sil)


def pack_label_batch(seqs: Sequence[Sequence[int]], pad_to: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """List of id sequences -> (labels [B, L] padded with -1, n_labels [B])."""
    n = np.asarray([len(s) for s in seqs], np.int32)
    L = int(pad_to) if pad_to is not None else max(int(n.max()), 1)
    out = np.full((len(seqs), L), -1, np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, n


# --------------------------------------------------------------------------
# Greedy decoding
# --------------------------------------------------------------------------


def collapse_ctc(frames: Sequence[int], blank_id: int) -> List[int]:
    """Collapse repeats then drop blanks (host-side, tiny)."""
    out: List[int] = []
    prev = -1
    for f in frames:
        if f != prev and f != blank_id:
            out.append(int(f))
        prev = f
    return out


def _collapse_keep_mask(frames: np.ndarray, nf: np.ndarray, bid: int) -> np.ndarray:
    """[B, T] bool: the frames that survive collapse and blank removal within
    each row's valid prefix (the vectorized ``collapse_ctc``)."""
    B = frames.shape[0]
    prev = np.concatenate([np.full((B, 1), -1, frames.dtype), frames[:, :-1]], axis=1)
    valid = np.arange(frames.shape[1])[None, :] < nf[:, None]
    return valid & (frames != prev) & (frames != bid)


def _argmax_frames(logits: torch.Tensor) -> np.ndarray:
    with torch.no_grad():
        return _np(torch.argmax(logits, dim=-1).to(torch.int32))


def ctc_greedy_decode(logits: torch.Tensor, n_frames, blank_id: Optional[int] = None) -> List[List[int]]:
    """Best path: per-frame argmax (on the logits' device), collapse repeats,
    drop blanks."""
    bid = logits.shape[-1] - 1 if blank_id is None else blank_id
    return ctc_collapse_frames(_argmax_frames(logits), n_frames, bid)


def ctc_greedy_decode_with_frames(logits: torch.Tensor, n_frames, blank_id: Optional[int] = None
                                  ) -> List[List[Tuple[int, int]]]:
    """Best path with emission times: per utterance (unit_id, first frame of
    its collapsed run); the units are ``ctc_greedy_decode``'s."""
    bid = logits.shape[-1] - 1 if blank_id is None else blank_id
    frames = _argmax_frames(logits)
    keep = _collapse_keep_mask(frames, _np(n_frames), bid)
    _rows, ts = np.nonzero(keep)
    vals = frames[keep]
    splits = np.cumsum(keep.sum(axis=1))[:-1]
    return [list(zip(vseg.tolist(), tseg.tolist())) for vseg, tseg in zip(np.split(vals, splits),
                                                                            np.split(ts, splits))]


def ctc_collapse_frames(frames, n_frames, blank_id: int) -> List[List[int]]:
    """Host half of greedy decoding over argmax frames [B, T] (a tensor on
    any device or an array)."""
    frames = _np(frames)
    keep = _collapse_keep_mask(frames, _np(n_frames), blank_id)
    vals = frames[keep]
    splits = np.cumsum(keep.sum(axis=1))[:-1]
    return [seg.tolist() for seg in np.split(vals, splits)]


# --------------------------------------------------------------------------
# Prefix beams on the host
# --------------------------------------------------------------------------


def _lse2(a: float, b: float) -> float:
    return float(np.logaddexp(a, b))


def ctc_beam_start() -> Beams:
    """Initial prefix-beam state: the empty prefix, ending 'in blank'."""
    return {(): (0.0, NEG_INF)}


def ctc_beam_step(
    beams: Beams,
    frame: np.ndarray,  # [V] log posteriors of one frame
    beam_size: int,
    blank_id: int,
    ext_score: Optional[Callable[[Tuple[int, ...], int], float]] = None,
    ext_weight: float = 1.0,
    prune_logp: float = -12.0,
) -> Beams:
    """One frame of prefix beam search (the reference's dict walk)."""
    units = np.nonzero(frame > frame.max() + prune_logp)[0]
    new: Beams = {}

    def add(prefix, pb, pnb):
        opb, opnb = new.get(prefix, (NEG_INF, NEG_INF))
        new[prefix] = (_lse2(opb, pb), _lse2(opnb, pnb))

    for prefix, (pb, pnb) in beams.items():
        ptot = _lse2(pb, pnb)
        for u in units:
            lp = float(frame[u])
            if u == blank_id:
                add(prefix, ptot + lp, NEG_INF)
                continue
            last = prefix[-1] if prefix else -1
            ext = prefix + (int(u),)
            if u == last:
                # staying in the label extends p_nb of the same prefix; a new
                # occurrence needs a blank in between (p_b)
                add(prefix, NEG_INF, pnb + lp)
                s = pb + lp
            else:
                s = ptot + lp
            if ext_score is not None:
                s += ext_weight * ext_score(prefix, int(u))
            add(ext, NEG_INF, s)
    return dict(sorted(new.items(), key=lambda kv: -_lse2(*kv[1]))[:beam_size])


def ctc_beam_ranked(beams: Beams) -> List[Tuple[float, List[int]]]:
    return sorted(((_lse2(pb, pnb), list(prefix)) for prefix, (pb, pnb) in beams.items()), key=lambda x: -x[0])


def ctc_prefix_beam_decode(
    logp: np.ndarray,  # [T, V] log posteriors of one utterance (valid frames)
    beam_size: int = 8,
    blank_id: Optional[int] = None,
    ext_score: Optional[Callable[[Tuple[int, ...], int], float]] = None,
    ext_weight: float = 1.0,
    prune_logp: float = -12.0,
) -> List[Tuple[float, List[int]]]:
    """Prefix beam search (Hannun et al. 2014) on the host -> the beam as
    [(total_logp, units)] best first; ``ext_score(prefix, unit)`` adds
    shallow-fusion scores."""
    logp = _np(logp)
    T, V = logp.shape
    bid = V - 1 if blank_id is None else blank_id
    beams = ctc_beam_start()
    for t in range(T):
        beams = ctc_beam_step(beams, logp[t], beam_size, bid, ext_score=ext_score, ext_weight=ext_weight,
                              prune_logp=prune_logp)
    return ctc_beam_ranked(beams)


def ctc_prefix_beam_decode_native(
    logp: np.ndarray,  # [T, V] log posteriors of one utterance
    beam_size: int = 8,
    blank_id: Optional[int] = None,
    prune_logp: float = -12.0,
) -> Optional[List[Tuple[float, List[int]]]]:
    """The prefix beam in C++ (``native/ctc_beam_native.cpp``), equal to
    ``ctc_prefix_beam_decode`` without fusion; None when the library cannot
    be built or loaded."""
    import ctypes

    from mogasr_torch.native import load_ctc_beam_lib

    lib = load_ctc_beam_lib()
    if lib is None:
        return None
    logp = np.ascontiguousarray(_np(logp), np.float32)
    T, V = logp.shape
    bid = V - 1 if blank_id is None else blank_id
    max_len = max(T, 1)
    out_seqs = np.empty((beam_size, max_len), np.int32)
    out_lens = np.empty(beam_size, np.int32)
    out_scores = np.empty(beam_size, np.float64)

    def as_ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.ctc_prefix_beam(
        as_ptr(logp, ctypes.c_float), T, V, beam_size, bid, prune_logp, as_ptr(out_seqs, ctypes.c_int32),
        as_ptr(out_lens, ctypes.c_int32), as_ptr(out_scores, ctypes.c_double), max_len,
    )
    return [(float(out_scores[i]), out_seqs[i, : out_lens[i]].tolist()) for i in range(n)]


def ctc_fusion_matrix(n_units: int, unit_lm, weight: float) -> np.ndarray:
    """[n_units + 1, n_units] shallow-fusion table of the device beam: row u
    the weighted bigram log-probs after unit u, row n_units the
    sentence-initial ones (``lm.unit_ngram.fusion_score``'s numbers)."""
    assert unit_lm.n_units == n_units, (unit_lm.n_units, n_units)
    m = np.zeros((n_units + 1, n_units), np.float32)
    m[:n_units, :] = weight * unit_lm.pair_logp
    m[n_units, :] = weight * unit_lm.init_logp
    return m


# --------------------------------------------------------------------------
# The prefix beam on the device
# --------------------------------------------------------------------------


def _pad_blank(tab: torch.Tensor, blank_id: int) -> torch.Tensor:
    """A table of n_units columns widened to V with a 0 column at blank."""
    zero = torch.zeros(tab.shape[:-1] + (1,), dtype=tab.dtype, device=tab.device)
    return torch.cat([tab[..., :blank_id], zero, tab[..., blank_id:]], dim=-1)


def _lse_fold(x: torch.Tensor, dim: int) -> torch.Tensor:
    """logsumexp over ``dim``, max-shifted, its terms summed in index order
    (the same bits on every device)."""
    m = x.max(dim=dim).values
    s = torch.zeros_like(m)
    for i in range(x.shape[dim]):
        s = s + torch.exp(x.select(dim, i) - m)
    return m + torch.log(s)


def _beam_frame(st, lp, active, blank_id: int, u_cap: int, prune_logp: float, fusion, bias_next, bias_delta):
    """One frame of the batched prefix beam over fixed [B, K, ...] buffers:
    the reference's ``frame_step``."""
    hist, lens, pb, pnb, bnode = st
    B, K, _ = hist.shape
    V = lp.shape[1]
    dev = lp.device
    half = NEG_INF / 2
    unit_ids = torch.arange(V, device=dev)
    cols = torch.arange(u_cap, device=dev)

    keep = lp > (lp.max(dim=1, keepdim=True).values + prune_logp)
    lp_m = torch.where(keep, lp, NEG_INF)
    ptot = torch.logaddexp(pb, pnb)
    alive = ptot > half
    last = torch.where(lens > 0, torch.gather(hist, 2, torch.clamp(lens - 1, min=0)[..., None])[..., 0], -1)

    # the same prefix: blank and repeat paths
    self_pb = ptot + lp_m[:, blank_id][:, None]
    lp_last = torch.gather(lp_m, 1, torch.clamp(last, min=0))
    self_pnb = torch.where(last >= 0, pnb + lp_last, NEG_INF)
    self_pb = torch.where(alive, self_pb, NEG_INF)
    self_pnb = torch.where(alive, self_pnb, NEG_INF)

    # children [B, K, V] (p_nb only)
    base = torch.where(unit_ids[None, None, :] == last[..., None], pb[..., None], ptot[..., None])
    child = base + lp_m[:, None, :]
    if fusion is not None:
        frow = torch.where(last >= 0, last, fusion.shape[0] - 1)
        child = child + _pad_blank(fusion[frow], blank_id)
    if bias_next is not None:
        child = child + _pad_blank(bias_delta[bnode], blank_id)
    child = torch.where(unit_ids[None, None, :] == blank_id, NEG_INF, child)
    child = torch.where(alive[..., None], child, NEG_INF)
    child = torch.where(lens[..., None] >= u_cap, NEG_INF, child)

    # child (i, c) merges into self (j) where prefix j == prefix i + c
    pre_eq = (hist[:, :, None, :] == hist[:, None, :, :]) | (cols[None, None, None, :] >= lens[:, :, None, None])
    rel = ((lens[:, None, :] == lens[:, :, None] + 1) & pre_eq.all(-1) & alive[:, :, None] & alive[:, None, :])
    at_i = torch.clamp(lens, 0, u_cap - 1)[:, :, None, None].expand(B, K, K, 1)
    c_ij = torch.gather(hist[:, None, :, :].expand(B, K, K, u_cap), 3, at_i)[..., 0]  # [B, i, j]
    contrib = torch.where(rel, torch.gather(child, 2, torch.clamp(c_ij, min=0)), NEG_INF)
    self_pnb = torch.logaddexp(self_pnb, _lse_fold(contrib, 1))
    child_used = torch.any(rel[..., None] & (unit_ids[None, None, None, :] == torch.clamp(c_ij, min=0)[..., None]),
                           dim=2)
    child = torch.where(child_used, NEG_INF, child)

    # top K of the K selves and K * V children, ties to the lower index
    self_tot = torch.logaddexp(self_pb, self_pnb)
    child_flat = child.reshape(B, K * V)
    tot = torch.cat([self_tot, child_flat], dim=1)
    top_val, top_idx = torch.sort(tot, dim=1, descending=True, stable=True)
    top_val, top_idx = top_val[:, :K], top_idx[:, :K]
    is_self = top_idx < K
    sidx = torch.where(is_self, top_idx, 0)
    cidx = torch.clamp(top_idx - K, min=0)
    ci, cu = cidx // V, cidx % V
    parent = torch.where(is_self, sidx, ci)
    nhist = torch.gather(hist, 1, parent[..., None].expand(B, K, u_cap))
    plen = torch.gather(lens, 1, parent)
    live = top_val > half
    grow = ~is_self & live
    at = torch.clamp(plen, 0, u_cap - 1)
    nhist = torch.where((cols[None, None, :] == at[..., None]) & grow[..., None], cu[..., None], nhist)
    nlen = plen + grow.long()
    npb = torch.where(is_self, torch.gather(self_pb, 1, sidx), NEG_INF)
    npnb = torch.where(is_self, torch.gather(self_pnb, 1, sidx), torch.gather(child_flat, 1, cidx))
    npb = torch.where(live, npb, NEG_INF)
    npnb = torch.where(live, npnb, NEG_INF)
    nbn = bnode
    if bias_next is not None:
        pnode = torch.gather(bnode, 1, parent)
        nbn = torch.where(grow, bias_next[pnode, cu], pnode)

    def mix(new, old):
        return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

    return mix(nhist, hist), mix(nlen, lens), mix(npb, pb), mix(npnb, pnb), mix(nbn, bnode)


def ctc_prefix_beam_decode_device(
    logp: torch.Tensor,   # [B, T, V] log posteriors on the device that runs the beam
    n_frames,             # [B]
    beam_size: int = 8,
    blank_id: Optional[int] = None,
    u_cap: int = 200,
    prune_logp: float = -12.0,
    fusion: Optional[np.ndarray] = None,      # ctc_fusion_matrix
    bias_next: Optional[np.ndarray] = None,   # CompiledBiaser tables
    bias_delta: Optional[np.ndarray] = None,
) -> List[List[Tuple[float, List[int]]]]:
    """The batched prefix beam over a whole [B, T, V] block, as plain
    PyTorch ops a frame on the device of ``logp`` (the reference's jitted
    scan; no kernel of its own) -> per row the ranked [(total_logp, units)]
    of ``ctc_prefix_beam_decode``. Scores accumulate in float32; a prefix
    stops growing at ``u_cap`` units."""
    with torch.no_grad():
        logp = torch.as_tensor(logp).to(torch.float32)
        dev = logp.device
        B, T, V = logp.shape
        K = int(beam_size)
        bid = V - 1 if blank_id is None else int(blank_id)
        nf = torch.as_tensor(_np(n_frames)).to(dev)
        f_arr = None if fusion is None else torch.as_tensor(np.asarray(fusion, np.float32), device=dev)
        bn_arr = bd_arr = None
        if bias_next is not None:
            bn_arr = torch.as_tensor(np.asarray(bias_next), device=dev).long()
            bd_arr = torch.as_tensor(np.asarray(bias_delta, np.float32), device=dev)
        pb = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
        pb[:, 0] = 0.0
        st = (torch.full((B, K, u_cap), -1, dtype=torch.int64, device=dev),
              torch.zeros((B, K), dtype=torch.int64, device=dev), pb,
              torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev),
              torch.zeros((B, K), dtype=torch.int64, device=dev))
        for t in range(T):
            st = _beam_frame(st, logp[:, t], t < nf, bid, int(u_cap), float(prune_logp), f_arr, bn_arr, bd_arr)
        hist, lens, pb, pnb = (_np(a) for a in st[:4])
    tot = np.logaddexp(pb, pnb)
    out: List[List[Tuple[float, List[int]]]] = []
    for b in range(B):
        row = [(float(tot[b, k]), hist[b, k, : lens[b, k]].tolist()) for k in range(K) if tot[b, k] > NEG_INF / 2]
        row.sort(key=lambda x: -x[0])
        out.append(row)
    return out


def ctc_beam_decode_batch(
    logp,                  # [B, T, V]
    n_frames,              # [B]
    beam_size: int = 8,
    blank_id: Optional[int] = None,
    prune_logp: float = -12.0,
    native: bool = True,
) -> List[List[int]]:
    """Top-1 prefix-beam hypotheses of a batch on the host (C++ when it
    loads)."""
    logp = _np(logp)
    n_frames = _np(n_frames)
    out = []
    for b in range(logp.shape[0]):
        lp = logp[b, : int(n_frames[b])]
        ranked = ctc_prefix_beam_decode_native(lp, beam_size, blank_id, prune_logp) if native else None
        if ranked is None:
            ranked = ctc_prefix_beam_decode(lp, beam_size, blank_id, prune_logp=prune_logp)
        out.append(ranked[0][1] if ranked else [])
    return out


class CtcStreamDecoder:
    """Online CTC decoding over chunked log posteriors: ``mode="greedy"``
    carries the previous frame's argmax across chunks, ``mode="beam"`` runs
    ``ctc_beam_step`` a frame; both equal their offline decodes for any
    chunking. Pairs with ``am.neural.LstmAmStream`` (K4's carry arm)."""

    def __init__(self, blank_id: int, mode: str = "greedy", beam_size: int = 8,
                 ext_score: Optional[Callable[[Tuple[int, ...], int], float]] = None, ext_weight: float = 1.0):
        assert mode in ("greedy", "beam")
        self.blank_id = int(blank_id)
        self.mode = mode
        self.beam_size = beam_size
        self.ext_score = ext_score
        self.ext_weight = ext_weight
        self._prev = -1
        self._tokens: List[int] = []
        self._beams = ctc_beam_start()

    def step(self, logp_chunk) -> List[int]:
        """Consume [Tc, V] log posteriors; returns the current partial hyp."""
        logp_chunk = _np(logp_chunk)
        if self.mode == "greedy":
            for f in np.argmax(logp_chunk, axis=-1):
                f = int(f)
                if f != self._prev and f != self.blank_id:
                    self._tokens.append(f)
                self._prev = f
        else:
            for t in range(logp_chunk.shape[0]):
                self._beams = ctc_beam_step(self._beams, logp_chunk[t], self.beam_size, self.blank_id,
                                            ext_score=self.ext_score, ext_weight=self.ext_weight)
        return self.partial()

    def partial(self) -> List[int]:
        if self.mode == "greedy":
            return list(self._tokens)
        return ctc_beam_ranked(self._beams)[0][1]

    def finalize(self) -> List[int]:
        return self.partial()


# --------------------------------------------------------------------------
# Lexicon-constrained graph decoding (K2 with skip transitions)
# --------------------------------------------------------------------------


def ctc_token_chain(phone_ids: Sequence[int], blank_id: int
                    ) -> Tuple[List[int], List[float], List[bool], List[bool]]:
    """CTC topology of one token, states (b0, y1, b1, ..., yn, bn) ->
    (emit_ids, skip_logp, is_entry, is_exit): unweighted transitions, the
    skip j-2 -> j open where consecutive labels differ, entry at b0 or y1,
    exit from yn or bn."""
    emit: List[int] = []
    skip: List[float] = []
    entry: List[bool] = []
    exits: List[bool] = []
    n = len(phone_ids)
    for k, p in enumerate(phone_ids):
        emit.append(blank_id)
        skip.append(float(NEG_INF))
        entry.append(k == 0)
        exits.append(False)
        emit.append(int(p))
        skip.append(0.0 if (k > 0 and phone_ids[k] != phone_ids[k - 1]) else float(NEG_INF))
        entry.append(k == 0)
        exits.append(k == n - 1)
    emit.append(blank_id)
    skip.append(float(NEG_INF))
    entry.append(False)
    exits.append(True)
    return emit, skip, entry, exits


def ctc_decode_graph(lexicon: Lexicon, dcfg: DecodeConfig, word_logp: Optional[np.ndarray] = None,
                     blank_id: Optional[int] = None) -> gr.Graph:
    """Word-loop decode graph over CTC units (phones + blank) with
    ``skip_logp`` for the optional blanks; chain labels are words, emissions
    index the CTC softmax (blank = n_phones unless given). A word boundary may
    omit the blank, as in compact CTC decoders."""
    bid = lexicon.n_phones if blank_id is None else blank_id
    words = list(lexicon.words)
    if word_logp is None:
        word_logp = np.full(len(words), -np.log(max(len(words), 1)), np.float32)
    emit, selfp, advp, enterp, exitp, skipp, chain = [], [], [], [], [], [], []
    for ci, w in enumerate(words):
        e, sk, en, ex = ctc_token_chain(lexicon.word_phone_ids(w), bid)
        base = float(word_logp[ci]) - dcfg.word_insertion_penalty
        for k in range(len(e)):
            emit.append(e[k])
            selfp.append(0.0)
            advp.append(float(NEG_INF) if k == 0 else 0.0)
            enterp.append(base if en[k] else float(NEG_INF))
            exitp.append(0.0 if ex[k] else float(NEG_INF))
            skipp.append(sk[k])
            chain.append(ci)
    enter = np.asarray(enterp, np.float32)
    exit_ = np.asarray(exitp, np.float32)
    return gr.Graph(
        emit_id=np.asarray(emit, np.int32),
        self_logp=np.asarray(selfp, np.float32),
        adv_logp=np.asarray(advp, np.float32),
        enter_logp=enter,
        exit_logp=exit_,
        init_logp=enter.copy(),
        final_logp=exit_.copy(),
        chain_id=np.asarray(chain, np.int32),
        labels=words,
        skip_logp=np.asarray(skipp, np.float32),
    )


# --------------------------------------------------------------------------
# The encoders' forwards for decoding
# --------------------------------------------------------------------------


def make_ctc_logits_fn(model: nn.Module, use_kernels: bool = True):
    """``(feats, n_frames) -> (logits, n_dec)`` without gradients: ConformerAm
    at its subsampled 25 Hz rate (greedy collapse does not depend on the
    rate), LstmAm and BlstmAm on K4 on the card (their plain recurrence with
    ``use_kernels=False``), the other families at the input rate. ``n_dec``
    is each row's valid length in decode frames."""

    @torch.no_grad()
    def logits_fn(feats, n_frames):
        if type(model) is ConformerAm:
            return model.subsampled(feats, n_frames)
        if isinstance(model, RECURRENT):
            return model(feats, n_frames, use_kernels=use_kernels), n_frames
        return model(feats, n_frames), n_frames

    return logits_fn


def make_ctc_frames_fn(model: nn.Module, use_kernels: bool = True):
    """``(feats, n_frames) -> (argmax frames [B, T'] int32, n_dec)``: the
    argmax on the device after ``make_ctc_logits_fn``'s forward, so greedy
    decoding copies one [B, T'] int tensor to the host
    (``ctc_collapse_frames``)."""
    logits_fn = make_ctc_logits_fn(model, use_kernels)

    def frames_fn(feats, n_frames):
        logits, n_dec = logits_fn(feats, n_frames)
        return torch.argmax(logits, dim=-1).to(torch.int32), n_dec

    return frames_fn


def ctc_logits(model: nn.Module, feats: torch.Tensor, n_frames: torch.Tensor, use_kernels: bool = True
               ) -> torch.Tensor:
    """[B, T, V] logits at the input frame rate without gradients; LstmAm and
    BlstmAm on K4 on the card."""
    with torch.no_grad():
        if isinstance(model, RECURRENT):
            return model(feats, n_frames, use_kernels=use_kernels)
        return model(feats, n_frames)


def make_ctc_scorer(model: nn.Module, use_kernels: bool = True):
    """``fb -> [B, T, V]`` log posteriors at the input frame rate for graph
    decoding (decode with acoustic scale 1: no prior division)."""

    def score(fb):
        return torch.log_softmax(ctc_logits(model, fb.feats, fb.n_frames, use_kernels).to(torch.float32), dim=-1)

    return score

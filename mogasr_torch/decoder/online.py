"""Online (streaming) Viterbi decoding, chunked and exact, with partial
results: the port of mogasr/decoder/online.py.

The offline decoder (``decoder.viterbi``) runs all T frames in one call.
This module runs the same max-plus recursion chunk by chunk, so hypotheses
are available while audio still arrives:

- :func:`chunk_step` is the reference's ``_chunk_step``, the plain version:
  a frame loop of PyTorch ops with its arithmetic and tie rules, carrying
  the [B, J] Viterbi state and the started flags between chunks;
- :class:`OnlineDecoder` runs kernel K2's chunk arm
  (``decoder.viterbi_cuda.chunk_step``), whose 2-bit codes stay in a
  per-stream buffer on the card, and K2's backtrace alone for ``partial()``
  and ``finalize()``: one launch a chunk and one a result, and only the path
  comes back; on the CPU the same wrappers run the plain step (its codes
  packed into the buffer) and the reference's host backtrace;
- ``finalize()`` is bitwise the offline decoder on the same frames: the
  recursion is the same, chunking only cuts it.

Frames are stored at their chunk position: a stream whose chunk has fewer
than Tc valid frames is taken to end there, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mogasr_torch.decoder import viterbi_cuda

NEG_INF = -1e30


def chunk_step(
    delta: torch.Tensor,      # [B, J] carry (NEG_INF rows before the first frame)
    started: torch.Tensor,    # [B] bool: the stream has consumed >= 1 frame
    emit_ll: torch.Tensor,    # [B, Tc, P] this chunk's scores
    n_valid: torch.Tensor,    # [B] valid frames in this chunk
    graphs: Dict[str, torch.Tensor],
    acoustic_scale: float,
    beam: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of the recursion: (delta, started, bps [Tc, B, J] uint8,
    exit_args [Tc, B] int32)."""
    B, Tc, P = emit_ll.shape
    dev = emit_ll.device
    emit_id = graphs["emit_id"].to(torch.int64)
    self_logp, adv_logp = graphs["self_logp"], graphs["adv_logp"]
    enter_logp, exit_logp = graphs["enter_logp"], graphs["exit_logp"]
    skip_logp = graphs.get("skip_logp")
    J = emit_id.shape[1]
    n_valid = n_valid.to(dev)
    emit_graph = torch.gather(emit_ll * acoustic_scale, 2, emit_id[:, None, :].expand(B, Tc, J))
    neg1 = torch.full((B, 1), NEG_INF, dtype=torch.float32, device=dev)
    neg2 = torch.full((B, 2), NEG_INF, dtype=torch.float32, device=dev)
    zero, one, two, three = (torch.tensor(v, dtype=torch.uint8, device=dev) for v in range(4))
    bps, exit_args = [], []
    for t in range(Tc):
        emit_t = emit_graph[:, t]
        # the first valid frame of a stream initializes from init_logp
        init_delta = graphs["init_logp"] + emit_t
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
        bp = torch.where(best == stay, zero, bp)
        new_delta = best + emit_t
        if beam > 0:
            thresh = new_delta.amax(dim=1, keepdim=True) - beam
            new_delta = torch.where(new_delta >= thresh, new_delta, torch.full_like(new_delta, NEG_INF))
        new_delta = torch.where(started[:, None], new_delta, init_delta)
        bp = torch.where(started[:, None], bp, zero)
        active = t < n_valid
        delta = torch.where(active[:, None], new_delta, delta)
        started = started | active
        bps.append(torch.where(active[:, None], bp, zero))
        exit_args.append(exit_arg)
    if not bps:
        return delta, started, torch.zeros((0, B, J), dtype=torch.uint8, device=dev), \
            torch.zeros((0, B), dtype=torch.int32, device=dev)
    return delta, started, torch.stack(bps), torch.stack(exit_args)


class OnlineDecoder:
    """Incremental Viterbi over a shared loop graph for a batch of streams.

    graphs: ``viterbi.graphs_to_torch(batch_graphs(...))``, [B, J] on the
    device the decoder runs on (the card: K2's chunk arm; the CPU: the plain
    step). Feed chunks with process(); read partial() any time; finalize()
    returns the exact full-utterance result. Results are (path [B, frames
    so far] int32, -1 past a stream's frames; entered [B, frames] bool; score
    [B] float32), tensors on the decoder's device.
    """

    def __init__(self, graphs: Dict[str, torch.Tensor], acoustic_scale: float = 1.0, beam: float = 0.0):
        self.graphs = graphs
        self.acoustic_scale = acoustic_scale
        self.beam = beam
        B, J = graphs["emit_id"].shape
        self.B, self.J = B, J
        self.device = graphs["emit_id"].device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"OnlineDecoder: unsupported device {self.device}")
        self.delta = torch.full((B, J), NEG_INF, dtype=torch.float32, device=self.device)
        self.started = torch.zeros((B,), dtype=torch.bool, device=self.device)
        self.n_frames = np.zeros(B, np.int64)
        self.frames = 0                            # chunk positions stored so far
        # code planes and exit argmax of every frame so far
        self._bp, self._xa = viterbi_cuda.code_buffers(B, J, 0, self.device)

    @property
    def buffer_bytes(self) -> int:
        """Bytes the stored codes and exit argmax take (the preallocated
        buffers)."""
        return self._bp.numel() * 4 + self._xa.numel() * 4

    def _reserve(self, frames: int) -> None:
        """Grow the buffers to hold ``frames`` frames, doubling."""
        cap = self._bp.shape[1]
        if frames <= cap:
            return
        self._bp, self._xa = viterbi_cuda.code_buffers(self.B, self.J, max(frames, 2 * cap, 64), self.device,
                                                       keep=(self._bp, self._xa, self.frames))

    def process(self, emit_ll: torch.Tensor, n_valid) -> None:
        """Consume a scored chunk [B, Tc, P]; n_valid: [B] frames valid."""
        n_valid = np.asarray(n_valid)
        Tc = emit_ll.shape[1]
        self._reserve(self.frames + Tc)
        # every stream's chunk at the same offset: the chunk position
        viterbi_cuda.chunk_step(self.delta, self.started, emit_ll, torch.as_tensor(n_valid, dtype=torch.int32),
                                self.graphs, self.acoustic_scale, self.beam, self._bp, self._xa,
                                np.full(self.B, self.frames))
        self.frames += Tc
        self.n_frames += n_valid

    def _result(self, final: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        res = viterbi_cuda.backtrace(self.delta, self.graphs["final_logp"] if final else None,
                                     torch.as_tensor(self.n_frames, dtype=torch.int32), self._bp, self._xa,
                                     self.frames)
        return res.path, res.entered, res.score

    def partial(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Best-so-far (path, entered, score) from the running best state.

        The tail may still change as more audio arrives; prefixes shared by
        all surviving paths are stable."""
        return self._result(final=False)

    def finalize(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Exact end-of-stream result: final_logp applied as by the offline
        decoder, then the backtrace."""
        return self._result(final=True)

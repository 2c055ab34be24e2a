"""Batched streaming session engines, one chain of launches a tick for every
live session: the port of mogasr/serving/engine.py (its GMM, CTC and RNN-T
families).

Sessions live in the slots of fixed [B, ...] state on the card, and one
``tick()`` advances every live session together:

    tick:  [B * F, L] spectral GEMMs -> delta tail -> CMVN -> feature queue
           -> decode stage

The decode stage consumes features finalized by earlier ticks. Two feature
paths (``feature_path``):

- ``"device"``: the spectral chunk, the delta tail, sliding or global CMVN
  and the queue append run on the card (``frontend/device_tail.py``), and the
  decode stage pops its rows off the queue there. Every count is a host
  integer mirror of the tail's emission rule, so a tick reads nothing back
  from the card; the host waits only at ``partials()`` and ``finalize()``.
  Sliding CMVN there is float32 (a ~1e-5 tolerance against the host path,
  equal decisions).
- ``"host"`` (the library default, bit-exact): the host pulls the batched
  spectral output every tick and each slot's ``StreamingFrontend.absorb``
  computes deltas and CMVN in numpy.

Three families share the slot scaffolding (``_BaseSlotEngine``):

- :class:`BatchedSessionEngine`: GMM (or hybrid) scores of one shared word
  loop, decoded by kernel K2's chunk arm with a frame offset per row
  (``decoder.viterbi_cuda.chunk_step``): slot b's codes of its frame f go to
  frame ``n_frames[b] + f`` of the code buffers on the card, and partials and
  finals are K2's backtrace-only launch over them, all sessions in one;
- :class:`BatchedCtcEngine`: the stateful LstmAm (K4's carry arm) over all
  slots at once, idle rows keeping their carries, then a host
  ``am.ctc.CtcStreamDecoder`` per slot.

- :class:`BatchedRnntEngine`: the RNN-T's stateful LSTM encoder over all
  slots (K4's carry arm, ragged n_valid), then one chunk-resumable greedy
  (``am.rnnt``'s frame scan or label loop) advancing every session's
  prediction state together; each tick's emitted symbols are harvested to
  per-slot host lists and the device buffer cleared.

- :class:`BatchedAedEngine`: the chunked streaming AED, one batched
  ``encode_stream_step`` a tick over every slot's encoder caches (atomic
  chunks of 4 chunk_frames frames; idle rows keep their caches by a masked
  merge), CTC-greedy partials from per-slot host decoders, and finals by
  the exact chunk-masked attention beam (joint CTC rescoring on K3) over
  each session's whole feature history.

A session's features, partials and final result are those of a dedicated
per-session pipeline (``StreamingFrontend`` + ``decoder.online.
OnlineDecoder``, or + ``LstmAmStream`` + ``CtcStreamDecoder``): batching
changes when work is launched, not what is computed. Ragged arrival is
handled by per-slot valid-frame counts and per-slot host state.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mogasr_torch.config import DecodeConfig, FrontendConfig
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.decoder import viterbi_cuda
from mogasr_torch.decoder.online import NEG_INF
from mogasr_torch.decoder.viterbi_cuda import to_device
from mogasr_torch.frontend import device_tail as DT
from mogasr_torch.frontend.streaming import StreamingFrontend, make_chunk_kernel
from mogasr_torch.hmm import graph as gr


class _Slot:
    """Host state of one session; its state on the card lives in the
    engine's [B, ...] tensors at this slot's row."""

    def __init__(self, fe: StreamingFrontend, frame_len: int, feat_dim: int):
        self.fe = fe
        self.pend_frames = np.zeros((0, frame_len), np.float32)
        self.pend_energy: Optional[np.ndarray] = None
        self.feat_q = np.zeros((0, feat_dim), np.float32)
        self.n_frames = 0
        self.samples = 0
        self.finishing = False   # end() called: flush the tail when the frames drain
        self.flushed = False     # the tail has been flushed
        self.overflowed = False  # hit the engine's per-session frame cap
        # the device feature path: host mirrors of the tail's emission rule
        # (base rows absorbed, final rows emitted)
        self.t_avail = 0
        self.emitted = 0


class _BaseSlotEngine:
    """The slot and session lifecycle and the batched spectral stage, shared
    by the decode families, which implement the decode-stage hooks."""

    def __init__(
        self,
        fcfg: FrontendConfig,
        capacity: int = 16,
        tick_frames: int = 24,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        feature_path: str = "host",
        device=torch.device("cuda"),
    ):
        if feature_path not in ("device", "host"):
            raise ValueError(f"feature_path must be 'device' or 'host': {feature_path}")
        if feature_path == "device" and fcfg.cmvn not in ("none", "global", "sliding"):
            raise ValueError("feature_path='device' supports cmvn none/global/sliding "
                             f"(got {fcfg.cmvn!r}); use feature_path='host'")
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.fcfg = fcfg
        self.capacity = int(capacity)
        self.tick_frames = int(tick_frames)
        self.cmvn_mean = cmvn_mean
        self.cmvn_istd = cmvn_istd
        self.feature_path = feature_path
        # the batched spectral chunk: [B * F, frame_length] through the
        # single-session streamer's GEMM chain
        self._spec = make_chunk_kernel(fcfg, self.device)
        self._use_energy = fcfg.use_energy and fcfg.feature_type in ("mfcc", "plp")
        self.slots: List[Optional[_Slot]] = [None] * self.capacity
        self._sid_to_slot: Dict[object, int] = {}
        self._reset_pending = np.zeros(self.capacity, bool)
        self._overflow_events: List[object] = []
        self.ticks = 0
        self.frames_decoded = 0
        if feature_path == "device":
            B, F = self.capacity, self.tick_frames
            self._lag = fcfg.delta_order * fcfg.delta_window
            # at most F - 1 rows stay in the queue over a tick, and a step
            # emits at most F + lag
            self._q_cap = 2 * F + self._lag
            self._ft_state = DT.feat_tail_init(fcfg, B, F, self.device)
            self._qbuf = torch.zeros((B, self._q_cap, fcfg.feat_dim), dtype=torch.float32, device=self.device)
            self._q_len = np.zeros(B, np.int64)
            self._g_mean, self._g_istd = DT._stats(fcfg, self.device, cmvn_mean, cmvn_istd)

    # ---- session lifecycle ---------------------------------------------

    @property
    def n_live(self) -> int:
        return len(self._sid_to_slot)

    def has(self, sid) -> bool:
        return sid in self._sid_to_slot

    def audio_seconds(self, sid) -> float:
        s = self.slots[self._sid_to_slot[sid]]
        return s.samples / self.fcfg.sample_rate

    def start(self, sid) -> bool:
        """Give sid a slot; False if sid is live or the engine is full."""
        if sid in self._sid_to_slot:
            return False
        try:
            b = self.slots.index(None)
        except ValueError:
            return False
        fe = StreamingFrontend(self.fcfg, chunk_frames=self.tick_frames, cmvn_mean=self.cmvn_mean,
                               cmvn_istd=self.cmvn_istd, device=self.device)
        self.slots[b] = _Slot(fe, self.fcfg.frame_length, self.fcfg.feat_dim)
        self._sid_to_slot[sid] = b
        self._init_slot(b)
        return True

    def feed(self, sid, pcm: np.ndarray) -> None:
        """Buffer audio: host framing only; the card's work is tick()'s."""
        s = self.slots[self._sid_to_slot[sid]]
        if s.finishing:
            raise ValueError("feed() after end()")
        s.samples += len(pcm)
        frames, energy = s.fe.accept_samples(pcm)
        if frames.shape[0]:
            s.pend_frames = np.concatenate([s.pend_frames, frames])
            if energy is not None:
                s.pend_energy = energy if s.pend_energy is None else np.concatenate([s.pend_energy, energy])

    def end(self, sid) -> None:
        """No more audio; the tail frames flush as later ticks drain (on the
        device feature path the flush is itself a step of the next tick)."""
        s = self.slots[self._sid_to_slot[sid]]
        s.finishing = True
        if self.feature_path == "host" and len(s.pend_frames) == 0 and not s.flushed:
            tail = s.fe.finalize_absorbed()
            if tail.shape[0]:
                s.feat_q = np.concatenate([s.feat_q, tail])
            s.flushed = True

    def _feat_avail(self, b: int) -> int:
        """Final feature rows queued for decoding at slot b."""
        return int(self._q_len[b]) if self.feature_path == "device" else len(self.slots[b].feat_q)

    def drained(self, sid) -> bool:
        b = self._sid_to_slot[sid]
        return self.slots[b].flushed and self._feat_avail(b) == 0

    def overflowed(self, sid) -> bool:
        """True once sid hit the engine's per-session frame cap: its result
        stops at the cap (the frames past it were dropped; the session can
        still drain and finalize)."""
        return self.slots[self._sid_to_slot[sid]].overflowed

    def take_overflow_events(self) -> List[object]:
        """The sids that overflowed since the last call."""
        out, self._overflow_events = self._overflow_events, []
        return out

    def _release(self, sid) -> _Slot:
        b = self._sid_to_slot.pop(sid)
        s = self.slots[b]
        self.slots[b] = None
        self._reset_pending[b] = True
        if self.feature_path == "device":
            # the tail and CMVN rows were reset by the final flush; rows left
            # in the queue expire
            self._q_len[b] = 0
        return s

    def run_to_drain(self, sid):
        """Tick until sid's frames drain, then finalize it."""
        if not self.slots[self._sid_to_slot[sid]].finishing:
            # drained() needs end()'s flush: without it this would tick forever
            raise ValueError("run_to_drain() before end()")
        while not self.drained(sid):
            self.tick()
        return self.finalize(sid)

    def partials(self, sids) -> Dict[object, list]:
        """Best-so-far hypotheses of many sessions."""
        return {sid: self.partial(sid) for sid in sids}

    def _sid_of(self, b: int):
        return next(sid for sid, bb in self._sid_to_slot.items() if bb == b)

    def _truncate(self, b: int, s: _Slot, n: int) -> int:
        """The frames slot b may still decode of n, under the frame cap (the
        session's result freezes at the cap; one overlong client must not
        stop the others)."""
        cap = self._slot_frame_cap()
        if cap is None or s.n_frames + n <= cap:
            return n
        if not s.overflowed:
            s.overflowed = True
            self._overflow_events.append(self._sid_of(b))
        return max(0, cap - s.n_frames)

    # ---- family hooks ----------------------------------------------------

    def _take(self, available: int) -> int:
        """Frames to consume from a slot's queue this tick."""
        return min(available, self.tick_frames)

    def _slot_frame_cap(self) -> Optional[int]:
        """Per-session bound on decoded frames, or None."""
        return None

    def _init_slot(self, b: int) -> None:
        """Host decode state of a new session."""

    def _apply_resets(self, mask: np.ndarray) -> None:
        """Clear the decode state of freed slots before the next launch."""
        raise NotImplementedError

    def _dispatch_decode(self, feats: torch.Tensor, n_valid: np.ndarray):
        """Launch the decode stage; return a handle for _absorb_decode."""
        raise NotImplementedError

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        """Take in the decode stage's results (host state)."""
        raise NotImplementedError

    def finalize(self, sid):
        raise NotImplementedError

    # ---- the batched tick ----------------------------------------------

    def _flush_resets(self) -> None:
        if self._reset_pending.any():
            self._apply_resets(self._reset_pending.copy())
            self._reset_pending[:] = False

    def tick(self) -> None:
        """Advance every live session: one decode stage over all slots'
        final features, one spectral stage over all slots' pending frames.
        The decode stage is launched first, so the card overlaps it with the
        spectral stage."""
        if self.feature_path == "device":
            self._tick_device()
            return
        B, F = self.capacity, self.tick_frames
        L, D = self.fcfg.frame_length, self.fcfg.feat_dim

        # --- the decode stage, on features finalized by earlier ticks
        feats = None
        n_valid = np.zeros(B, np.int32)
        for b, s in enumerate(self.slots):
            if s is None or len(s.feat_q) == 0:
                continue
            n = self._take(len(s.feat_q))
            m = self._truncate(b, s, n)
            if m < n:  # drop the queued rows past the cap so the session still drains
                s.feat_q = s.feat_q[:m]
                n = m
            if n == 0:
                continue
            if feats is None:
                feats = np.zeros((B, F, D), np.float32)
            feats[b, :n] = s.feat_q[:n]
            n_valid[b] = n
        self._flush_resets()
        handle = (self._dispatch_decode(to_device(feats, self.device, torch.float32), n_valid)
                  if feats is not None and n_valid.any() else None)

        # --- the spectral stage over pending (pre-emphasized) frames
        nfr = np.zeros(B, np.int32)
        fr = None
        for b, s in enumerate(self.slots):
            if s is None or len(s.pend_frames) == 0:
                continue
            if fr is None:
                fr = np.zeros((B, F, L), np.float32)
            n = min(len(s.pend_frames), F)
            fr[b, :n] = s.pend_frames[:n]
            nfr[b] = n
        if fr is not None:
            base = self._spec(to_device(fr.reshape(B * F, L), self.device, torch.float32))
            base = base.reshape(B, F, -1).cpu().numpy()

        # --- host bookkeeping
        if handle is not None:
            self._absorb_decode(handle, n_valid)
            for b, s in enumerate(self.slots):
                n = int(n_valid[b])
                if n:
                    s.n_frames += n
                    s.feat_q = s.feat_q[n:]
                    self.frames_decoded += n
        if fr is not None:
            for b, s in enumerate(self.slots):
                n = int(nfr[b])
                if n == 0:
                    continue
                rows = base[b, :n]
                if s.pend_energy is not None:
                    rows = rows.copy()
                    rows[:, 0] = s.pend_energy[:n]
                    s.pend_energy = s.pend_energy[n:]
                s.pend_frames = s.pend_frames[n:]
                out = s.fe.absorb(rows)
                if out.shape[0]:
                    s.feat_q = np.concatenate([s.feat_q, out])
                if s.finishing and len(s.pend_frames) == 0 and not s.flushed:
                    tail = s.fe.finalize_absorbed()
                    if tail.shape[0]:
                        s.feat_q = np.concatenate([s.feat_q, tail])
                    s.flushed = True
        self.ticks += 1

    def _tick_device(self) -> None:
        """The device feature path's tick: the decode stage pops its rows off
        the queue on the card; the spectral chunk, the delta tail, CMVN and
        the queue append follow on the card. The counts are host mirrors of
        the tail's emission rule and every copy to the card is from pinned
        memory without blocking, so nothing here waits for the card."""
        B, F = self.capacity, self.tick_frames
        L = self.fcfg.frame_length
        fc = self.fcfg

        # --- the decode stage, on features finalized by earlier ticks
        take = np.zeros(B, np.int32)
        for b, s in enumerate(self.slots):
            if s is None or self._q_len[b] == 0:
                continue
            n = self._take(int(self._q_len[b]))
            after = self._q_len[b] - n
            m = self._truncate(b, s, n)
            if m < n:  # consume up to the cap, drop the rest of the queue
                n, after = m, 0
            take[b] = n
            self._q_len[b] = after
        self._flush_resets()
        handle = None
        if take.any():
            feats, self._qbuf = DT._q_pop_core(self._qbuf, to_device(take, self.device), F)
            handle = self._dispatch_decode(feats, take)

        # --- spectral chunk, delta tail, CMVN, queue append
        nfr = np.zeros(B, np.int32)
        final = np.zeros(B, bool)
        emit = np.zeros(B, np.int64)
        fr = np.zeros((B, F, L), np.float32)
        energy = np.zeros((B, F), np.float32)
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            n = min(len(s.pend_frames), F)
            if n:
                fr[b, :n] = s.pend_frames[:n]
                s.pend_frames = s.pend_frames[n:]
                if s.pend_energy is not None:
                    energy[b, :n] = s.pend_energy[:n]
                    s.pend_energy = s.pend_energy[n:]
                nfr[b] = n
            fin = s.finishing and len(s.pend_frames) == 0 and not s.flushed
            if n or fin:
                s.t_avail += n
                new_emitted = s.t_avail if fin else max(s.t_avail - self._lag, s.emitted)
                emit[b] = new_emitted - s.emitted
                s.emitted = new_emitted
            if fin:
                final[b] = True
                s.flushed = True
        if nfr.any() or final.any():
            dev = self.device
            base = self._spec(to_device(fr.reshape(B * F, L), dev, torch.float32)).reshape(B, F, -1)
            if self._use_energy:
                base[:, :, 0] = to_device(energy, dev, torch.float32)
            self._ft_state, out, n_out = DT._feat_tail_core(
                self._ft_state, base, to_device(nfr, dev), to_device(final, dev, torch.bool),
                delta_order=fc.delta_order, delta_window=fc.delta_window, cmvn=fc.cmvn,
                cmvn_window=fc.cmvn_window, cmvn_norm_var=fc.cmvn_norm_var, cmvn_mean=self._g_mean,
                cmvn_istd=self._g_istd)
            self._qbuf = DT._q_append_core(self._qbuf, to_device(self._q_len, dev, torch.int64), out, n_out)
            self._q_len += emit
            if int(self._q_len.max(initial=0)) > self._q_cap:
                raise RuntimeError("device feature queue overflow: the queue's sizing rule is broken")

        # --- decode-stage bookkeeping (no feature reads)
        if handle is not None:
            self._absorb_decode(handle, take)
            for b, s in enumerate(self.slots):
                n = int(take[b])
                if n:
                    s.n_frames += n
                    self.frames_decoded += n
        self.ticks += 1


# ---------------------------------------------------------------------------
# The GMM (or hybrid) family: one shared word loop, exact Viterbi on K2
# ---------------------------------------------------------------------------

class BatchedSessionEngine(_BaseSlotEngine):
    """Slot-batched streaming recognizer, GMM or hybrid family.

    graph:    ONE shared decode loop graph (``pipeline.word_decode_graph``)
    score_fn: stateless scorer, feats [B, F, D] on the device -> [B, F, S]
              float32 (``pipeline.score_batch`` over a GmmSet: K1)
    fcfg:     a streaming front-end config (snip_edges; cmvn none, global or
              sliding)

    history="device" (default) keeps every session's codes on the card in
    ``viterbi_cuda.code_buffers(capacity, J, max_frames)`` (2-bit planes,
    ``code_frame_bytes(J)`` a frame and slot), written by K2's chunk arm at
    each slot's own frame count; a session is bounded at max_frames frames
    (30 s at a 10 ms hop by default) and truncated there. history="host"
    keeps per-slot host lists of each tick's codes (unbounded sessions, one
    [F, B, J] read-back a tick and a host backtrace per result).
    """

    def __init__(
        self,
        graph,
        score_fn: Callable[[torch.Tensor], torch.Tensor],
        fcfg: FrontendConfig,
        dcfg: Optional[DecodeConfig] = None,
        capacity: int = 16,
        tick_frames: int = 24,
        beam: float = 0.0,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        history: str = "device",
        max_frames: int = 3000,
        feature_path: str = "host",
        device=torch.device("cuda"),
    ):
        super().__init__(fcfg, capacity, tick_frames, cmvn_mean, cmvn_istd, feature_path=feature_path,
                         device=device)
        dcfg = dcfg or DecodeConfig()
        if history not in ("device", "host"):
            raise ValueError(f"history must be 'device' or 'host': {history}")
        self.graph = graph
        self.score_fn = score_fn
        self.acoustic_scale = float(dcfg.acoustic_scale)
        self.beam = float(beam)
        self.history = history
        self.max_frames = int(max_frames)
        B = self.capacity
        self.graphs = vit.graphs_to_torch(gr.batch_graphs([graph] * B), self.device)
        self.J = int(self.graphs["emit_id"].shape[1])
        self.delta = torch.full((B, self.J), NEG_INF, dtype=torch.float32, device=self.device)
        self.started = torch.zeros((B,), dtype=torch.bool, device=self.device)
        # device history: every session's frames; host history: one tick's, read back
        frames = self.max_frames if history == "device" else self.tick_frames
        self.bp, self.exit_arg = viterbi_cuda.code_buffers(B, self.J, frames, self.device)
        # (tick, final) -> backtrace result: the state changes only in tick()
        self._bt_cache: Dict[Tuple[int, bool], tuple] = {}
        self._bp_hist: List[List[np.ndarray]] = [[] for _ in range(B)]
        self._exit_hist: List[List[np.ndarray]] = [[] for _ in range(B)]

    # -- hooks --

    def _init_slot(self, b: int) -> None:
        # the device history needs no reset: a reused row rewrites frames
        # 0 .. n-1 in order and the backtrace reads only t < n
        self._bp_hist[b] = []
        self._exit_hist[b] = []

    def _n_frames_vec(self) -> np.ndarray:
        return np.array([s.n_frames if s is not None else 0 for s in self.slots], np.int32)

    def _apply_resets(self, mask: np.ndarray) -> None:
        m = to_device(mask, self.device, torch.bool)
        self.delta.masked_fill_(m[:, None], NEG_INF)
        self.started.logical_and_(~m)

    def _slot_frame_cap(self) -> Optional[int]:
        # the device history holds max_frames frames a slot: tick() cuts a
        # session there, so the launch is never asked to write past them
        return self.max_frames if self.history == "device" else None

    def _dispatch_decode(self, feats: torch.Tensor, n_valid: np.ndarray):
        scores = self.score_fn(feats)
        frame0 = self._n_frames_vec() if self.history == "device" else 0
        viterbi_cuda.chunk_step(self.delta, self.started, scores, torch.from_numpy(n_valid), self.graphs,
                                self.acoustic_scale, self.beam, self.bp, self.exit_arg, frame0)
        return self.history == "host"

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        if not handle:
            return  # the device history stays on the card
        codes = viterbi_cuda.unpack_codes(self.bp, slice(0, self.tick_frames), self.J).cpu().numpy()  # [F, B, J]
        exits = self.exit_arg.cpu().numpy()                                                            # [B, F]
        for b in range(self.capacity):
            n = int(n_valid[b])
            if n:
                self._bp_hist[b].append(codes[:n, b].copy())
                self._exit_hist[b].append(exits[b, :n].copy())

    # -- results --

    def _slot_backtrace(self, b: int, n: int, j_last: int):
        """The host walk over slot b's per-tick code lists, in reverse,
        without concatenating them (the reference's)."""
        path = np.full(n, -1, np.int64)
        entered = np.zeros(n, bool)
        if n == 0:
            return path, entered
        chunks_bp = self._bp_hist[b]
        chunks_ex = self._exit_hist[b]
        j = int(j_last)
        ci = len(chunks_bp) - 1
        start = sum(len(c) for c in chunks_bp) - len(chunks_bp[ci])
        for t in range(n - 1, 0, -1):
            while t < start:
                ci -= 1
                start -= len(chunks_bp[ci])
            local = t - start
            path[t] = j
            code = chunks_bp[ci][local, j]
            entered[t] = code == 2
            if code == 1:
                j -= 1
            elif code == 3:
                j -= 2
            elif code == 2:
                j = int(chunks_ex[ci][local])
        path[0] = j
        entered[0] = True
        return path, entered

    def _words_of(self, path: np.ndarray, entered: np.ndarray) -> List[str]:
        return gr.path_words(self.graph, path, entered)

    def _device_backtrace_all(self, final: bool):
        """K2's backtrace of every slot in one launch, its [B, frames] path
        read back; cached per (tick, final)."""
        key = (self.ticks, final)
        hit = self._bt_cache.get(key)
        if hit is not None:
            return hit
        n = self._n_frames_vec()
        res = viterbi_cuda.backtrace(self.delta, self.graphs["final_logp"] if final else None, torch.from_numpy(n),
                                     self.bp, self.exit_arg, int(n.max(initial=0)))
        out = (res.path.cpu().numpy(), res.entered.cpu().numpy())
        if next(iter(self._bt_cache), (self.ticks,))[0] != self.ticks:
            self._bt_cache.clear()   # a stale tick's entries
        self._bt_cache[key] = out
        return out

    def partial(self, sid, delta_np: Optional[np.ndarray] = None) -> List[str]:
        """Best-so-far words. With the host history, pass ``delta_np =
        engine.delta.cpu().numpy()`` to read delta once for many sessions
        (the device history: use partials())."""
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        if s.n_frames == 0:
            return []
        if self.history == "device":
            path, entered = self._device_backtrace_all(final=False)
            return self._words_of(path[b, : s.n_frames], entered[b, : s.n_frames])
        row = delta_np[b] if delta_np is not None else self.delta[b].cpu().numpy()
        path, entered = self._slot_backtrace(b, s.n_frames, int(row.argmax()))
        return self._words_of(path, entered)

    def partials(self, sids) -> Dict[object, list]:
        """Partials of many sessions from one backtrace launch (device
        history) or one read of delta (host history)."""
        sids = list(sids)
        if not sids:
            return {}
        if self.history == "device":
            path, entered = self._device_backtrace_all(final=False)
            out: Dict[object, list] = {}
            for sid in sids:
                b = self._sid_to_slot[sid]
                n = self.slots[b].n_frames
                out[sid] = self._words_of(path[b, :n], entered[b, :n]) if n else []
            return out
        deltas = self.delta.cpu().numpy()
        return {sid: self.partial(sid, delta_np=deltas) for sid in sids}

    def finalize(self, sid) -> Tuple[List[str], float]:
        """The exact result (final_logp applied); frees the slot. All of the
        session's frames must have drained (tick() until drained(sid))."""
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        if not self.drained(sid):
            raise ValueError("finalize() before drained()")
        audio_s = s.samples / self.fcfg.sample_rate
        if s.n_frames == 0:
            words: List[str] = []
        elif self.history == "device":
            path, entered = self._device_backtrace_all(final=True)
            words = self._words_of(path[b, : s.n_frames], entered[b, : s.n_frames])
        else:
            final = (self.delta[b] + self.graphs["final_logp"][b]).cpu().numpy()
            path, entered = self._slot_backtrace(b, s.n_frames, int(final.argmax()))
            words = self._words_of(path, entered)
        self._release(sid)
        return words, audio_s

    def finalize_many(self, sids) -> Dict[object, Tuple[List[str], float]]:
        """Finalize many drained sessions from one backtrace launch (device
        history; the host history loops). Frees their slots."""
        sids = [sid for sid in sids if sid in self._sid_to_slot]
        if self.history != "device" or not sids:
            return {sid: self.finalize(sid) for sid in sids}
        path, entered = self._device_backtrace_all(final=True)
        out: Dict[object, Tuple[List[str], float]] = {}
        for sid in sids:
            b = self._sid_to_slot[sid]
            s = self.slots[b]
            if not self.drained(sid):
                raise ValueError("finalize() before drained()")
            n = s.n_frames
            out[sid] = (self._words_of(path[b, :n], entered[b, :n]) if n else [],
                        s.samples / self.fcfg.sample_rate)
            self._release(sid)
        return out


# ---------------------------------------------------------------------------
# The neural CTC family: stateful LstmAm + streaming CTC decoding
# ---------------------------------------------------------------------------

class BatchedCtcEngine(_BaseSlotEngine):
    """Slot-batched streaming recognizer, neural CTC family (``serve --ctc``):
    the stateful LstmAm scores every slot's chunk in one pass (K4's carry arm
    with ragged n_valid; a row at 0 keeps its carries), then each slot's host
    ``am.ctc.CtcStreamDecoder`` (greedy, or the prefix beam with biasing)
    decodes its log posteriors.

    stream_model: ``am.neural.LstmAmStream`` (the offline LstmAm's
                  parameters), on the engine's device
    make_decoder: () -> ``am.ctc.CtcStreamDecoder``
    defer_absorb: keep each tick's log posteriors on the card and read them
                  back at the next partial() or finalize(), one wait for the
                  backlog (at most 64 ticks); False reads them every tick
    """

    def __init__(
        self,
        stream_model,
        make_decoder: Callable[[], object],
        fcfg: FrontendConfig,
        capacity: int = 16,
        tick_frames: int = 24,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        feature_path: str = "host",
        defer_absorb: bool = True,
        device=torch.device("cuda"),
    ):
        super().__init__(fcfg, capacity, tick_frames, cmvn_mean, cmvn_istd, feature_path=feature_path,
                         device=device)
        from mogasr_torch.am.neural import lstm_stream_init

        self.model = stream_model
        self.make_decoder = make_decoder
        self.carries = lstm_stream_init(stream_model, self.capacity, self.device)
        self._decoders: List[Optional[object]] = [None] * self.capacity
        self.defer_absorb = bool(defer_absorb)
        self._pending: List[tuple] = []

    # -- hooks --

    def _init_slot(self, b: int) -> None:
        self._decoders[b] = self.make_decoder()

    def _apply_resets(self, mask: np.ndarray) -> None:
        m = to_device(mask, self.device, torch.bool)[:, None]
        self.carries = [(torch.where(m, 0.0, c), torch.where(m, 0.0, h)) for c, h in self.carries]

    @torch.no_grad()
    def _dispatch_decode(self, feats: torch.Tensor, n_valid: np.ndarray):
        logits, self.carries = self.model(feats, self.carries, to_device(n_valid, self.device))
        return torch.log_softmax(logits, dim=-1)

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        self._pending.append((handle, n_valid.copy()))
        # bound the backlog on the card: [B, F, V] buffers must not pile up
        if not self.defer_absorb or len(self._pending) >= 64:
            self._flush_pending()

    def _flush_pending(self) -> None:
        """Read back every queued tick's log posteriors (the first read waits
        for the card) and replay the per-slot decoders. Slots are reassigned
        only through finalize, which flushes first, so pending rows belong to
        the decoders installed now."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for logp, n_valid in pending:
            logp_np = logp.cpu().numpy()
            for b in range(self.capacity):
                n = int(n_valid[b])
                if n:
                    self._decoders[b].step(logp_np[b, :n])

    # -- results --

    def partial(self, sid) -> List[int]:
        """Best-so-far unit ids (replays the backlog)."""
        self._flush_pending()
        return list(self._decoders[self._sid_to_slot[sid]].partial())

    def finalize(self, sid) -> Tuple[List[int], float]:
        self._flush_pending()
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        if not self.drained(sid):
            raise ValueError("finalize() before drained()")
        audio_s = s.samples / self.fcfg.sample_rate
        units = list(self._decoders[b].finalize())
        self._decoders[b] = None
        self._release(sid)
        return units, audio_s


# ---------------------------------------------------------------------------
# The RNN-T family: stateful LSTM encoder + the chunk-resumable device greedy
# ---------------------------------------------------------------------------

def _merge_rows(mask: torch.Tensor, new, old):
    """A nest (dict, tuple, list) of [B, ...] tensors: rows where mask [B]
    is True from ``new``, the others from ``old``."""
    if isinstance(new, dict):
        return {k: _merge_rows(mask, new[k], old[k]) for k in new}
    if isinstance(new, (tuple, list)):
        return type(new)(_merge_rows(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _clear_hyp(state):
    """Empty the per-tick hypothesis buffer (its symbols are harvested)."""
    carry, pred, hyp, lens = state
    return carry, pred, torch.full_like(hyp, -1), torch.zeros_like(lens)


class BatchedRnntEngine(_BaseSlotEngine):
    """Slot-batched streaming recognizer, RNN-T family (``serve --rnnt``).

    One tick = the stateful LSTM encoder over all slots (K4's carry arm;
    a slot at n_valid 0 keeps its carries) + one chunk-resumable greedy
    (``greedy_impl`` "frame_scan" or "label_loop") advancing every
    session's prediction state together; frames at or past a slot's valid
    count are inert, so ragged arrival is exact. The emitted symbols are
    harvested to per-slot host lists and the device buffer cleared, so the
    buffer holds one tick's worst case (tick_frames x max_symbols_per_frame)
    and sessions are unbounded.

    model: ``am.rnnt.RnntModel`` (encoder_arch "lstm"), trained, on the
           engine's device
    defer_absorb: keep each tick's hypothesis buffer on the card and read
                  the backlog at the next partial() or finalize() (at most
                  64 ticks); False reads it every tick
    """

    def __init__(
        self,
        model,
        fcfg: FrontendConfig,
        capacity: int = 16,
        tick_frames: int = 24,
        max_symbols_per_frame: int = 4,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        greedy_impl: str = "frame_scan",
        feature_path: str = "host",
        defer_absorb: bool = True,
        device=torch.device("cuda"),
    ):
        super().__init__(fcfg, capacity, tick_frames, cmvn_mean, cmvn_istd, feature_path=feature_path,
                         device=device)
        from mogasr_torch.am.rnnt import _chunk_greedy_fn, make_rnnt_stream_encoder

        if model.encoder_arch != "lstm":
            raise ValueError("streaming needs the lstm encoder")
        B = self.capacity
        self.model = model
        self._enc_step, self.enc_carries = make_rnnt_stream_encoder(model, B)
        u_cap = self.tick_frames * int(max_symbols_per_frame)
        init_state, self._consume = _chunk_greedy_fn(model, u_cap, int(max_symbols_per_frame), greedy_impl)
        self.dec_state = init_state(B)
        # pristine rows (SOS-stepped carry and prediction, an empty buffer) for slot resets
        self._dec_state0 = self.dec_state
        self._enc_carries0 = self.enc_carries
        self._units: List[List[int]] = [[] for _ in range(B)]
        self.defer_absorb = bool(defer_absorb)
        self._pending: List[tuple] = []

    # -- hooks --

    def _init_slot(self, b: int) -> None:
        self._units[b] = []

    def _apply_resets(self, mask: np.ndarray) -> None:
        m = to_device(mask, self.device, torch.bool)
        self.enc_carries = _merge_rows(m, self._enc_carries0, self.enc_carries)
        self.dec_state = _merge_rows(m, self._dec_state0, self.dec_state)

    def _dispatch_decode(self, feats: torch.Tensor, n_valid: np.ndarray):
        nv = to_device(n_valid, self.device)
        self.enc_carries, enc = self._enc_step(self.enc_carries, feats, nv)
        self.dec_state = self._consume(self.dec_state, enc, nv)
        hyp, lens = self.dec_state[2], self.dec_state[3]
        # the harvest handle holds the tick's buffer; the next tick starts empty
        self.dec_state = _clear_hyp(self.dec_state)
        return hyp, lens

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        self._pending.append(handle)
        if not self.defer_absorb or len(self._pending) >= 64:
            self._flush_pending()

    def _flush_pending(self) -> None:
        """Harvest every queued tick's hypothesis buffer (the first read
        waits for the card). Slots are reassigned only through finalize,
        which flushes first, so pending buffers belong to the current
        sessions."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for hyp, lens in pending:
            hyp_np, lens_np = hyp.cpu().numpy(), lens.cpu().numpy()
            for b in range(self.capacity):
                n = int(lens_np[b])
                if n:
                    self._units[b].extend(hyp_np[b, :n].tolist())

    # -- results --

    def partial(self, sid) -> List[int]:
        """Best-so-far unit ids (harvests the backlog)."""
        self._flush_pending()
        return list(self._units[self._sid_to_slot[sid]])

    def finalize(self, sid) -> Tuple[List[int], float]:
        self._flush_pending()
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        if not self.drained(sid):
            raise ValueError("finalize() before drained()")
        audio_s = s.samples / self.fcfg.sample_rate
        units = list(self._units[b])
        self._units[b] = []
        self._release(sid)
        return units, audio_s


# ---------------------------------------------------------------------------
# The AED family: the chunked streaming encoder + an exact attention final
# ---------------------------------------------------------------------------

AED_FINAL_BUCKET = 256  # the finals' padding: a multiple of this many frames


def aed_final_max_tokens(t_frames: int) -> int:
    """The finals' token budget from the (bucketed) frame count; the engine
    and the per-session server share it, so their finals are equal."""
    return max(8, 2 + t_frames // 4)


def _cast_floats(state, dtype: torch.dtype):
    """A nest of tensors with its floating tensors cast to ``dtype``."""
    if isinstance(state, dict):
        return {k: _cast_floats(v, dtype) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_cast_floats(v, dtype) for v in state)
    return state.to(dtype) if state.is_floating_point() else state


class BatchedAedEngine(_BaseSlotEngine):
    """Slot-batched streaming recognizer, chunked AED family (``serve --aed
    --engine``).

    The streaming encoder consumes atomic chunks of 4 chunk_frames feature
    frames, so a tick advances each slot by one chunk or not at all: one
    batched ``encode_stream_step`` carries every slot's per-block caches in
    shared [B, ...] rows, and a masked merge keeps the caches of the slots
    that had no chunk. CTC-greedy partials come from the chunk's CTC head
    through per-slot host ``am.ctc.CtcStreamDecoder``s; ``finalize`` runs
    the exact chunk-masked attention beam over the session's whole feature
    history (the same encoder, so one checkpoint serves both).

    Finals pad each history to a multiple of ``final_bucket`` frames (the
    encoder masks by n_frames, so padding changes nothing) and take the
    token budget from the bucketed length (``aed_final_max_tokens``), as the
    per-session server does, so engine finals equal per-session finals; the
    beam stops once every hypothesis has ended (``early_exit``).
    ``finalize_many`` decodes the sessions of one bucket in one call, N
    rounded up to a power of two with one-frame dummy rows.

    model: ``am.aed.AedModel`` with chunk_frames > 0, trained, on the
           engine's device
    defer_absorb: keep each tick's log posteriors (and on the device feature
                  path the consumed feature rows) on the card and read them
                  back at the next partial() or finalize(), one wait for the
                  backlog (at most 64 ticks); False reads them every tick
    stream_precision: "bfloat16" runs the chunk step on a bf16 copy of the
                  model, the master caches kept in float32 (cast in and out
                  a step); finals stay float32, so only partials can move
    """

    def __init__(
        self,
        model,
        fcfg: FrontendConfig,
        capacity: int = 8,
        beam: int = 4,
        ctc_weight: float = 0.3,
        final_bucket: int = AED_FINAL_BUCKET,
        cmvn_mean: Optional[np.ndarray] = None,
        cmvn_istd: Optional[np.ndarray] = None,
        defer_absorb: bool = True,
        feature_path: str = "host",
        stream_precision: str = "float32",
        device=torch.device("cuda"),
    ):
        from mogasr_torch.am.aed import aed_stream_init

        raw_per = 4 * model.chunk_frames
        if raw_per <= 0:
            raise ValueError("streaming AED needs chunk_frames > 0")
        super().__init__(fcfg, capacity, raw_per, cmvn_mean, cmvn_istd, feature_path=feature_path, device=device)
        if stream_precision not in ("float32", "bfloat16"):
            raise ValueError(f"stream_precision: {stream_precision}")
        self.stream_precision = stream_precision
        self.model = model
        self.beam = int(beam)
        self.ctc_weight = float(ctc_weight)
        self.final_bucket = int(final_bucket)
        self.defer_absorb = bool(defer_absorb)
        self._pending: List[tuple] = []
        B = self.capacity
        self.enc_state = aed_stream_init(model, B, fcfg.feat_dim, self.device)
        self._state0 = self.enc_state  # the pristine caches for slot resets (steps make new tensors)
        self._m16 = copy.deepcopy(model).to(torch.bfloat16) if stream_precision == "bfloat16" else None
        self._decoders: List[Optional[object]] = [None] * B
        self._feats_hist: List[List[np.ndarray]] = [[] for _ in range(B)]
        self._final_decoders: Dict[int, Callable] = {}

    @torch.no_grad()
    def _step(self, state, feats: torch.Tensor, live: torch.Tensor):
        if self._m16 is not None:
            _enc, ctc_logits, new = self._m16.encode_stream_step(feats.to(torch.bfloat16),
                                                                 _cast_floats(state, torch.bfloat16))
            new = _cast_floats(new, torch.float32)
        else:
            _enc, ctc_logits, new = self.model.encode_stream_step(feats, state)
        return torch.log_softmax(ctc_logits.to(torch.float32), dim=-1), _merge_rows(live, new, state)

    # -- hooks --

    def _take(self, available: int) -> int:
        return self.tick_frames if available >= self.tick_frames else 0

    def _init_slot(self, b: int) -> None:
        from mogasr_torch.am.ctc import CtcStreamDecoder

        self._decoders[b] = CtcStreamDecoder(blank_id=self.model.n_units, mode="greedy")
        self._feats_hist[b] = []

    def _apply_resets(self, mask: np.ndarray) -> None:
        self.enc_state = _merge_rows(to_device(mask, self.device, torch.bool), self._state0, self.enc_state)

    def _dispatch_decode(self, feats: torch.Tensor, n_valid: np.ndarray):
        logp, self.enc_state = self._step(self.enc_state, feats, to_device(n_valid > 0, self.device, torch.bool))
        return logp, feats

    def _absorb_decode(self, handle, n_valid: np.ndarray) -> None:
        logp, feats = handle
        if self.feature_path == "host":
            # the consumed rows are still at the head of each slot's host queue
            for b, s in enumerate(self.slots):
                n = int(n_valid[b])
                if n:
                    self._feats_hist[b].append(s.feat_q[:n].copy())
            feats = None
        self._pending.append((logp, feats, n_valid.copy()))
        # bound the backlog on the card: [B, chunk, V] buffers must not pile up
        if not self.defer_absorb or len(self._pending) >= 64:
            self._flush_pending()

    def _flush_pending(self) -> None:
        """Read back every queued tick's log posteriors (and on the device
        feature path its consumed feature rows, for the finals' history) and
        replay the per-slot decoders. Slots are reassigned only through
        finalize, which flushes first, so pending rows belong to the
        sessions installed now."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for logp, feats, n_valid in pending:
            logp_np = logp.cpu().numpy()
            feats_np = feats.cpu().numpy() if feats is not None else None
            for b in range(self.capacity):
                n = int(n_valid[b])
                if n:
                    self._decoders[b].step(logp_np[b])
                    if feats_np is not None:
                        self._feats_hist[b].append(feats_np[b, :n].copy())

    # -- results --

    def drained(self, sid) -> bool:
        """The sub-chunk tail of the features is the final's, not the
        streaming stage's."""
        b = self._sid_to_slot[sid]
        return self.slots[b].flushed and self._feat_avail(b) < self.tick_frames

    def _leftover_rows(self, b: int, s: _Slot) -> List[np.ndarray]:
        """The queued rows that no chunk consumed, for the final."""
        if self.feature_path == "device":
            n = int(self._q_len[b])
            return [self._qbuf[b, :n].cpu().numpy()] if n else []
        return [s.feat_q] if len(s.feat_q) else []

    def partial(self, sid) -> List[int]:
        """Best-so-far CTC-greedy unit ids (replays the backlog)."""
        self._flush_pending()
        return list(self._decoders[self._sid_to_slot[sid]].partial())

    def _final_decoder(self, t_bucket: int):
        from mogasr_torch.am.aed import make_aed_decoder

        dec = self._final_decoders.get(t_bucket)
        if dec is None:
            dec = make_aed_decoder(self.model, beam=self.beam, max_tokens=aed_final_max_tokens(t_bucket),
                                   ctc_weight=self.ctc_weight)
            self._final_decoders[t_bucket] = dec
        return dec

    def _history(self, sid) -> Tuple[int, np.ndarray, float]:
        b = self._sid_to_slot[sid]
        s = self.slots[b]
        if not self.drained(sid):
            raise ValueError("finalize() before drained()")
        parts = self._feats_hist[b] + self._leftover_rows(b, s)
        fa = np.concatenate(parts, axis=0) if parts else np.zeros((0, self.fcfg.feat_dim), np.float32)
        return b, fa, s.samples / self.fcfg.sample_rate

    def _retire(self, sid, b: int) -> None:
        self._decoders[b] = None
        self._feats_hist[b] = []
        self._release(sid)

    def finalize(self, sid) -> Tuple[List[int], float]:
        return self.finalize_many([sid])[sid]

    def finalize_many(self, sids) -> Dict[object, Tuple[List[int], float]]:
        """Finalize many drained sessions with one beam call per bucket of
        padded length (``finalize`` is this with one session): N rounded up
        to a power of two with one-frame dummy rows. Beam rows are
        independent, so the hypotheses equal per-session finals."""
        self._flush_pending()
        out: Dict[object, Tuple[List[int], float]] = {}
        groups: Dict[int, list] = {}
        for sid in [sid for sid in sids if sid in self._sid_to_slot]:
            b, fa, audio_s = self._history(sid)
            if fa.shape[0] == 0:
                out[sid] = ([], audio_s)
                self._retire(sid, b)
                continue
            Tb = -(-fa.shape[0] // self.final_bucket) * self.final_bucket
            groups.setdefault(Tb, []).append((sid, b, fa, audio_s))
        for Tb, items in groups.items():
            nb = 1 << (len(items) - 1).bit_length()
            padded = np.zeros((nb, Tb, self.fcfg.feat_dim), np.float32)
            nf = np.ones((nb,), np.int64)  # dummy rows: one zero frame
            for i, (_sid, _b, fa, _a) in enumerate(items):
                padded[i, : fa.shape[0]] = fa
                nf[i] = fa.shape[0]
            toks, n_toks, _ = self._final_decoder(Tb)(to_device(padded, self.device, torch.float32),
                                                      to_device(nf, self.device))
            toks, n_toks = toks.cpu().numpy(), n_toks.cpu().numpy()
            for i, (sid, b, _fa, audio_s) in enumerate(items):
                out[sid] = ([int(t) for t in toks[i, : n_toks[i]]], audio_s)
                self._retire(sid, b)
        return out

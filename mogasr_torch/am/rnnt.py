"""RNN-Transducer (RNN-T): the port of mogasr/am/rnnt.py.

The model: an encoder (``am.neural.LstmAm``, or BlstmAm for offline use,
its head the encoder features [B, T, H_enc]); a prediction network over the
blank-free label history (embedding + an LSTM run over the padding, as
flax's ``nn.RNN`` without ``seq_lengths``, or the stateless embedding ->
tanh -> Dense), [B, U] -> [B, U+1, H_pred] with position 0 the <sos>; and
the joint, tanh(enc_proj(enc) + pred_proj(pred)) -> V = n_labels + 1 logits
over the [B, T, U+1] lattice, blank last.

The loss is the Graves lattice DP,

    alpha[t, u] = lse(alpha[t-1, u] + blank(t-1, u), alpha[t, u-1] + emit(t, u-1)),

which the reference runs as a scan over frames with an inner scan over
labels (T x U steps). The port computes the same cells by anti-diagonals:
the cells with t + u = d depend only on diagonal d - 1, so the DP is T + U
steps of a few batched ops, each cell the same ``logaddexp`` of the same
two operands as the reference's (with its derivative, ``am.ctc._lae``).
Frames at or past n_frames do not change the result: the final term reads
alpha[max(n_frames - 1, 0), n_labels] + blank there, as the reference's
frozen rows give. The gradient comes from autograd; ``am.rnnt_pruned``
takes its band from the gradient of this very function.

On the card the encoder's recurrence runs on kernel K4 (``am.lstm_cuda``)
in every forward without gradients: ``rnnt_encode`` and the streaming
encoder, whose chunks go through K4's carry arm (``am.neural.
LstmAmStream``). Training runs the plain recurrence under autograd (K4 has
no backward) and adds the auxiliary CTC loss (``am.ctc.ctc_loss``: K3's
chain arm with skips on the card). The prediction net and the joint are
plain PyTorch ops, as the reference leaves them to XLA.

Decoders: the host greedy (``rnnt_greedy_decode``); the device greedy as a
frame scan (``max_symbols_per_frame`` masked sub-steps a frame, no host
sync) or as the label loop (the reference's ``lax.while_loop`` over
emissions: its condition is read every ``LABEL_LOOP_CHECK`` rounds, rounds
past it are exact no-ops, and the rounds are bounded by the reference's own
cap); the streaming chunk greedy (``RnntDeviceStream``); the per-utterance
and batched host beams; and the device beam, the reference's scan with
prefix merging, shallow fusion and biasing tables, as plain ops a frame.
Ties in its top-K and merges go to the lower index (a stable sort), as
``jax.lax.top_k`` breaks them. MWER fine-tuning (``rnnt_mwer_objective``)
uses the transducer forward marginal as the sequence log-probability.

Weights: ``am.params.from_flax`` converts the reference's parameter tree,
``am.params.init_`` draws fresh ones. Unlike flax, the model needs its
input width when built (``feat_dim``).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mogasr_torch.am import fast_lstm
from mogasr_torch.am.ctc import _lae, _np, ctc_loss, masked_mean_objective
from mogasr_torch.am.neural import BlstmAm, LstmAm, LstmLayer, lstm_stream_apply, lstm_stream_init
from mogasr_torch.am.train_nn import TrainState, apply_update, init_train_state
from mogasr_torch.config import TrainConfig
from mogasr_torch.dist.comm import batch_count

NEG_INF = -1e30
LABEL_LOOP_CHECK = 8  # label-loop rounds between reads of its condition

Carry = Tuple[torch.Tensor, ...]  # the prediction net's (c, h), or () for the stateless net


def _dev_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on(x, dev: torch.device) -> torch.Tensor:
    """A tensor (moved without a host round trip) or an array on ``dev``."""
    return x.to(dev) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x)).to(dev)


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------


def _with_sos(labels: torch.Tensor, sos: int) -> torch.Tensor:
    B = labels.shape[0]
    first = torch.full((B, 1), sos, dtype=torch.int64, device=labels.device)
    return torch.cat([first, torch.clamp(labels.long(), min=0)], dim=1)


class RnntPrediction(nn.Module):
    """Label-history network: embed + LSTM over the blank-free labels."""

    def __init__(self, n_labels: int, hidden: int = 256, embed: int = 128):
        super().__init__()
        self.n_labels, self.hidden, self.embed = n_labels, hidden, embed
        self.embedding = nn.Embedding(n_labels + 1, embed)
        self.cell = LstmLayer(embed, hidden)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        """labels [B, U] (-1 padding) -> [B, U+1, H]: position u conditions
        on labels[:u] (<sos> = n_labels first); the LSTM runs over the
        padding too, as the reference's."""
        x = self.embedding(_with_sos(labels, self.n_labels))
        n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        return fast_lstm.lstm_layer(self.cell.input_gates(x, "float32"), self.cell.w_rec, n)

    def initial_carry(self, batch: int, device: torch.device) -> Carry:
        zero = torch.zeros((batch, self.hidden), dtype=torch.float32, device=device)
        return (zero, zero)

    def step(self, label: torch.Tensor, carry: Carry) -> Tuple[Carry, torch.Tensor]:
        """One step: (label [B], (c, h)) -> ((c, h), out [B, H])."""
        x = self.embedding(label.long())[:, None, :]
        c, h = carry
        n = torch.ones((x.shape[0],), dtype=torch.int32, device=x.device)
        out, (h2, c2) = fast_lstm.lstm_layer(self.cell.input_gates(x, "float32"), self.cell.w_rec, n, h0=h, c0=c,
                                             return_carry=True)
        return (c2, h2), out[:, 0]


class RnntPredictionStateless(nn.Module):
    """Stateless (last-label-only) prediction network: the output at
    position u depends only on label u-1 (embed -> tanh -> Dense), the
    low-data regularizer the reference trains by default."""

    def __init__(self, n_labels: int, hidden: int = 256, embed: int = 128):
        super().__init__()
        self.n_labels, self.hidden, self.embed = n_labels, hidden, embed
        self.embedding = nn.Embedding(n_labels + 1, embed)
        self.dense = nn.Linear(embed, hidden)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.dense(torch.tanh(self.embedding(_with_sos(labels, self.n_labels))))

    def initial_carry(self, batch: int, device: torch.device) -> Carry:
        return ()

    def step(self, label: torch.Tensor, carry: Carry) -> Tuple[Carry, torch.Tensor]:
        return carry, self.dense(torch.tanh(self.embedding(label.long())))


class RnntPredictionStep(RnntPrediction):
    """The step form of RnntPrediction on its parameters: (label [B],
    (c, h)) -> ((c, h), out [B, H])."""

    def forward(self, label: torch.Tensor, carry: Carry) -> Tuple[Carry, torch.Tensor]:  # type: ignore[override]
        return self.step(label, carry)


class RnntPredictionStatelessStep(RnntPredictionStateless):
    """The step form of RnntPredictionStateless (the carry passes through)."""

    def forward(self, label: torch.Tensor, carry: Carry) -> Tuple[Carry, torch.Tensor]:  # type: ignore[override]
        return self.step(label, carry)


class RnntJoint(nn.Module):
    """Joint network: enc [B, T, He] x pred [B, U1, Hp] -> [B, T, U1, V]."""

    def __init__(self, n_labels: int, enc_dim: int, pred_dim: int, hidden: int = 256):
        super().__init__()
        self.n_labels, self.hidden = n_labels, hidden
        self.enc_proj = nn.Linear(enc_dim, hidden)
        self.pred_proj = nn.Linear(pred_dim, hidden)
        self.out = nn.Linear(hidden, n_labels + 1)

    def forward(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        e = self.enc_proj(enc)[:, :, None, :]
        p = self.pred_proj(pred)[:, None, :, :]
        return self.out(torch.tanh(e + p))

    def project_enc(self, enc: torch.Tensor) -> torch.Tensor:
        """The prediction-independent half: [B, T, He] -> [B, T, Hj]."""
        return self.enc_proj(enc)

    def logits_vs_frames(self, e_proj: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """One prediction state [B, Hp] against all frames of the projected
        encoder [B, T, Hj] -> [B, T, V]."""
        return self.out(torch.tanh(e_proj + self.pred_proj(pred)[:, None, :]))

    def banded(self, enc: torch.Tensor, pred: torch.Tensor, u_start: torch.Tensor, band: int) -> torch.Tensor:
        """Logits on the band u in [u_start[t], u_start[t] + band) only:
        [B, T, band, V]; the prediction rows are projected once and gathered
        a frame."""
        B, T, _ = enc.shape
        e = self.enc_proj(enc)[:, :, None, :]
        p_all = self.pred_proj(pred)
        U1, Hj = p_all.shape[1], p_all.shape[2]
        idx = torch.clamp(u_start.long()[:, :, None] + torch.arange(band, device=enc.device)[None, None, :], 0, U1 - 1)
        p = torch.gather(p_all[:, None, :, :].expand(B, T, U1, Hj), 2, idx[..., None].expand(B, T, band, Hj))
        return self.out(torch.tanh(e + p))


class RnntModel(nn.Module):
    """Encoder + prediction + joint. Blank id = n_labels (last)."""

    def __init__(self, n_labels: int, feat_dim: int, enc_hidden: int = 256, enc_layers: int = 2,
                 pred_hidden: int = 256, joint_hidden: int = 256, encoder_arch: str = "lstm",
                 pred_arch: str = "lstm", aux_ctc: bool = False, simple_heads: bool = False):
        super().__init__()
        self.n_labels, self.feat_dim = n_labels, feat_dim
        self.enc_hidden, self.enc_layers = enc_hidden, enc_layers
        self.pred_hidden, self.joint_hidden = pred_hidden, joint_hidden
        self.encoder_arch, self.pred_arch = encoder_arch, pred_arch
        self.aux_ctc, self.simple_heads = aux_ctc, simple_heads
        if encoder_arch not in ("lstm", "blstm"):
            raise ValueError(f"unknown encoder_arch {encoder_arch!r}")
        cls = LstmAm if encoder_arch == "lstm" else BlstmAm
        self.encoder = cls(enc_hidden, feat_dim, hidden=enc_hidden, layers=enc_layers)
        pred_cls = RnntPrediction if pred_arch == "lstm" else RnntPredictionStateless
        self.prediction = pred_cls(n_labels, hidden=pred_hidden)
        self.joint = RnntJoint(n_labels, enc_hidden, pred_hidden, hidden=joint_hidden)
        if aux_ctc:
            self.ctc_head = nn.Linear(enc_hidden, n_labels + 1)
        if simple_heads:
            # the factored joint of pruned training: am[t, v] + lm[u, v]
            self.simple_am = nn.Linear(enc_hidden, n_labels + 1)
            self.simple_lm = nn.Linear(pred_hidden, n_labels + 1)

    def encode(self, feats, n_frames, use_kernels: bool = True) -> torch.Tensor:
        return self.encoder(feats, n_frames, use_kernels=use_kernels)

    def forward(self, feats, n_frames, labels, use_kernels: bool = True) -> torch.Tensor:
        return self.joint(self.encode(feats, n_frames, use_kernels), self.prediction(labels))

    def forward_aux(self, feats, n_frames, labels, use_kernels: bool = True):
        """(joint logits, CTC-head logits): the auxiliary-CTC training path."""
        enc = self.encode(feats, n_frames, use_kernels)
        return self.joint(enc, self.prediction(labels)), self.ctc_head(enc)

    def forward_simple(self, feats, n_frames, labels, use_kernels: bool = True):
        """(am [B,T,V], lm [B,U+1,V], enc, pred, ctc_logits | None): the
        cheap pass of pruned training."""
        enc = self.encode(feats, n_frames, use_kernels)
        pred = self.prediction(labels)
        ctc_logits = self.ctc_head(enc) if self.aux_ctc else None
        return self.simple_am(enc), self.simple_lm(pred), enc, pred, ctc_logits

    def joint_banded(self, enc, pred, u_start, band: int) -> torch.Tensor:
        return self.joint.banded(enc, pred, u_start, band)


def build_rnnt_model(n_labels: int, tcfg: TrainConfig, feat_dim: int, encoder_arch: str = "lstm",
                     pred_arch: str = "stateless", aux_ctc: bool = True, simple_heads: bool = False) -> RnntModel:
    """The reference's TrainConfig -> RnntModel sizes (encoder nn_hidden x
    max(nn_layers - 1, 1), prediction max(nn_hidden // 4, 16), joint
    max(nn_hidden // 2, 32)) with the input width given; weights
    uninitialised (``am.params.init_`` or a ``from_flax`` state_dict)."""
    return RnntModel(n_labels, feat_dim, enc_hidden=tcfg.nn_hidden, enc_layers=max(tcfg.nn_layers - 1, 1),
                     pred_hidden=max(tcfg.nn_hidden // 4, 16), joint_hidden=max(tcfg.nn_hidden // 2, 32),
                     encoder_arch=encoder_arch, pred_arch=pred_arch, aux_ctc=aux_ctc, simple_heads=simple_heads)


# --------------------------------------------------------------------------
# Loss: the lattice DP by anti-diagonals
# --------------------------------------------------------------------------


def _skew(grid: torch.Tensor, D: int, width: int) -> torch.Tensor:
    """[B, T, W] -> [B, D, T]: out[b, d, t] = grid[b, t, d - t] where
    0 <= d - t < W, else 0."""
    B, T, W = grid.shape
    dev = grid.device
    if W == 0:
        return torch.zeros((B, D, T), dtype=grid.dtype, device=dev)
    u = torch.arange(D, device=dev)[:, None] - torch.arange(T, device=dev)[None, :]
    ok = (u >= 0) & (u < W)
    g = torch.gather(grid.transpose(1, 2), 1, torch.clamp(u, 0, W - 1)[None].expand(B, D, T))
    return torch.where(ok, g, torch.zeros((), dtype=grid.dtype, device=dev))


def _alpha_diagonals(blank: torch.Tensor, emit: torch.Tensor, cell_ok: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The forward variables of the lattice [B, T, U+1] on its T + U
    anti-diagonals: [B, D, T] with entry (d, t) = alpha[t, d - t] (NEG_INF
    off the lattice). ``cell_ok`` [B, T, U+1] (the pruned band) forces the
    other cells to NEG_INF. Every cell is computed from its two neighbours
    as the reference's scans compute it: alpha[0, u] = lse(NEG_INF, emit
    edge), alpha[t, 0] = blank edge, else lse(blank edge, emit edge)."""
    B, T, U1 = blank.shape
    U = U1 - 1
    D = T + U
    dev = blank.device
    BL = _skew(blank, D, U1)
    EM = _skew(emit, D, U)
    u = torch.arange(D, device=dev)[:, None] - torch.arange(T, device=dev)[None, :]  # [D, T]
    inside = (u >= 0) & (u <= U)
    ok = inside[None].expand(B, D, T)
    if cell_ok is not None:
        ok = ok & _skew(cell_ok.to(torch.uint8), D, U1).bool()
    # one unbind each (its backward is one stack), not a slice a step
    bl, em, oks = BL.unbind(1), EM.unbind(1), ok.unbind(1)
    neg = torch.full((B, 1), NEG_INF, dtype=blank.dtype, device=dev)
    a = torch.full((B, T), NEG_INF, dtype=blank.dtype, device=dev)
    a[:, 0] = 0.0
    alphas = [a]
    for d in range(1, D):
        vert = torch.cat([neg, (a + bl[d - 1])[:, :-1]], dim=1)
        horiz = a + em[d - 1]
        new = torch.where(u[d] == 0, vert, _lae(vert, horiz))
        a = torch.where(oks[d], new, NEG_INF)
        alphas.append(a)
    return torch.stack(alphas, dim=1)


def rnnt_dp_nll(blank: torch.Tensor, emit: torch.Tensor, n_frames: torch.Tensor, n_labels: torch.Tensor
                ) -> torch.Tensor:
    """The Graves lattice DP on pre-gathered grids -> the NLL [B].

    blank [B, T, U+1] log P(blank | t, u), emit [B, T, U] log P(y_{u+1} |
    t, u). Differentiable (autograd), so the pruning bounds come from its
    gradient (the arc occupancies)."""
    dev = blank.device
    alpha = _alpha_diagonals(blank, emit)
    rows = torch.arange(blank.shape[0], device=dev)
    tl = torch.clamp(n_frames.to(dev).long() - 1, min=0)
    nl = n_labels.to(dev).long()
    return -(alpha[rows, tl + nl, tl] + blank[rows, tl, nl])


def rnnt_loss(
    logits: torch.Tensor,    # [B, T, U+1, V] joint outputs (log-softmax applied here)
    n_frames: torch.Tensor,  # [B]
    labels: torch.Tensor,    # [B, U] (-1 padding), blank-free
    n_labels: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Per-utterance transducer NLL -log p(y|x) [B]. Blank = V-1."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    blank = logp[..., V - 1]
    safe = torch.clamp(labels.to(logp.device).long(), min=0)
    emit = torch.gather(logp[:, :, :U, :], 3, safe[:, None, :, None].expand(B, T, U, 1))[..., 0]
    return rnnt_dp_nll(blank, emit, n_frames, n_labels)


def rnnt_loss_np(logp: np.ndarray, labels: Sequence[int]) -> float:
    """Independent NumPy oracle: -log p(y|x) for ONE utterance.

    logp: [T, U+1, V] log-softmaxed joint outputs; blank = V-1.
    """
    T, U1, V = logp.shape
    U = len(labels)
    assert U1 >= U + 1
    alpha = np.full((T, U + 1), -np.inf)
    for t in range(T):
        for u in range(U + 1):
            cands = []
            if t == 0 and u == 0:
                cands.append(0.0)
            if t > 0:
                cands.append(alpha[t - 1, u] + logp[t - 1, u, V - 1])
            if u > 0:
                cands.append(alpha[t, u - 1] + logp[t, u - 1, labels[u - 1]])
            alpha[t, u] = np.logaddexp.reduce(cands) if cands else -np.inf
    return float(-(alpha[T - 1, U] + logp[T - 1, U, V - 1]))


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


RnntTrainState = TrainState


def init_rnnt_train_state(model: RnntModel, cfg: TrainConfig) -> TrainState:
    """A fresh state for an initialised ``model``: the CE path's AdamW and
    schedule (``am.train_nn``)."""
    return init_train_state(model, cfg)


def rnnt_objective(model: RnntModel, feats, n_frames, labels, n_labels, ctc_weight: float = 1.0, *,
                   use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward (the encoder on its plain recurrence) + transducer
    loss (+ ``ctc_weight`` x the auxiliary CTC loss when model.aux_ctc, on
    K3 on the card unless ``use_kernels`` is False), each through
    ``masked_mean_objective`` -> (loss, mean transducer NLL)."""
    dev = feats.device
    labels, n_labels = labels.to(dev), n_labels.to(dev)
    if model.aux_ctc:
        logits, ctc_logits = model.forward_aux(feats, n_frames, labels, use_kernels=False)
    else:
        logits = model(feats, n_frames, labels, use_kernels=False)
    nll = rnnt_loss(logits, n_frames, labels, n_labels)
    loss, mean_nll = masked_mean_objective(nll, n_frames, n_labels)
    if model.aux_ctc:
        ctc_nll = ctc_loss(ctc_logits, n_frames, labels, n_labels, use_kernels=use_kernels)
        ctc_mean, _ = masked_mean_objective(ctc_nll, n_frames, n_labels)
        loss = loss + ctc_weight * ctc_mean
    return loss, mean_nll


def make_rnnt_train_step(model: RnntModel, cfg: TrainConfig, ctc_weight: float = 1.0, *, use_kernels: bool = True):
    """(state, feats, n_frames, labels, n_labels) -> (state, {"loss",
    "utt_nll"} as Python floats): one transducer step, L = L_rnnt + w L_ctc
    with the auxiliary head."""

    def train_step(state: TrainState, feats, n_frames, labels, n_labels):
        state.model.train()
        with torch.enable_grad():
            loss, mean_nll = rnnt_objective(state.model, feats, n_frames, labels, n_labels, ctc_weight,
                                            use_kernels=use_kernels)
            loss.backward()
        apply_update(state, cfg)
        return state, {"loss": loss.item(), "utt_nll": mean_nll.item()}

    return train_step


# --------------------------------------------------------------------------
# Decoding
# --------------------------------------------------------------------------


def rnnt_encode(model: RnntModel, feats, n_frames, use_kernels: bool = True) -> torch.Tensor:
    """The encoder forward without gradients: its recurrence on K4 on the
    card, on the model's device."""
    dev = _dev_of(model)
    with torch.no_grad():
        return model.encode(_on(feats, dev).to(torch.float32), _on(n_frames, dev), use_kernels)


class RnntDecoderFns(NamedTuple):
    """Prediction/joint closures shared by greedy, beam, streaming."""

    pred_of: Any   # (hist [B, U_cap] -1-padded, lens [B]) -> [B, Hp]
    joint_of: Any  # (enc_t [B, He], pred_t [B, Hp]) -> [B, V] logits
    blank: int


def make_rnnt_decoder_fns(model: RnntModel) -> RnntDecoderFns:
    dev = _dev_of(model)

    @torch.no_grad()
    def pred_of(hist, lens):
        """The prediction output at each row's own position (len(history))."""
        hist = torch.as_tensor(_np(hist)).to(dev)
        lens = torch.as_tensor(_np(lens)).to(dev).long()
        out = model.prediction(hist)
        return torch.gather(out, 1, lens[:, None, None].expand(-1, 1, out.shape[2]))[:, 0]

    @torch.no_grad()
    def joint_of(enc_t, pred_t):
        return model.joint(enc_t[:, None, :], pred_t[:, None, :])[:, 0, 0, :]

    return RnntDecoderFns(pred_of, joint_of, model.n_labels)


class RnntGreedyState:
    """Host greedy decode state for a batch of streams, its history in a
    fixed [B, u_cap] buffer."""

    def __init__(self, fns: RnntDecoderFns, batch: int, u_cap: int):
        self.fns = fns
        self.u_cap = u_cap
        self.hyps: List[List[int]] = [[] for _ in range(batch)]
        self.u_hist = np.full((batch, u_cap), -1, np.int32)
        self.frames_done = np.zeros(batch, np.int64)
        self._pred = None

    def _pred_now(self):
        lens = np.asarray([len(h) for h in self.hyps], np.int32)
        return self.fns.pred_of(self.u_hist, lens)

    def consume(self, enc_chunk, n_valid, max_symbols_per_frame: int = 4):
        """enc_chunk [B, Tc, He]; n_valid [B] valid frames in this chunk."""
        if self._pred is None:
            self._pred = self._pred_now()
        n_valid = _np(n_valid)
        Tc = enc_chunk.shape[1]
        for t in range(Tc):
            active = n_valid > t
            if not active.any():
                break
            for _ in range(max_symbols_per_frame):
                logits = _np(self.fns.joint_of(enc_chunk[:, t], self._pred))
                best = logits.argmax(-1)
                emit = active & (best != self.fns.blank) & np.asarray([len(h) < self.u_cap for h in self.hyps])
                if not emit.any():
                    break
                for b in np.nonzero(emit)[0]:
                    self.u_hist[b, len(self.hyps[b])] = int(best[b])
                    self.hyps[b].append(int(best[b]))
                self._pred = self._pred_now()
        self.frames_done += n_valid

    def partial(self) -> List[List[int]]:
        return [list(h) for h in self.hyps]


def rnnt_greedy_decode(model: RnntModel, feats, n_frames, max_symbols_per_frame: int = 4,
                       max_symbols: Optional[int] = None) -> List[List[int]]:
    """Frame-synchronous greedy decode, a host loop over frames: at each
    frame emit argmax labels until blank wins or the per-frame cap hits."""
    enc = rnnt_encode(model, feats, n_frames)
    B, T = enc.shape[0], enc.shape[1]
    u_cap = int(max_symbols) if max_symbols is not None else min(2 * T, 400)
    state = RnntGreedyState(make_rnnt_decoder_fns(model), B, u_cap)
    state.consume(enc, _np(n_frames), max_symbols_per_frame)
    return state.partial()


def _mix(mask: torch.Tensor, new, old):
    """Row-select (mask [B]) between two tensors or two tuples of tensors."""
    if isinstance(new, tuple):
        return tuple(_mix(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


GreedyState = Tuple[Carry, torch.Tensor, torch.Tensor, torch.Tensor]  # (carry, pred, hyp, lens)


def _greedy_init_state(model: RnntModel, batch: int, u_cap: int) -> GreedyState:
    """The state before any frame: the prediction net stepped on <sos>, an
    empty [B, u_cap] hypothesis buffer."""
    dev = _dev_of(model)
    with torch.no_grad():
        pred_net = model.prediction
        carry, pred = pred_net.step(torch.full((batch,), model.n_labels, dtype=torch.int64, device=dev),
                                    pred_net.initial_carry(batch, dev))
    return (carry, pred, torch.full((batch, u_cap), -1, dtype=torch.int64, device=dev),
            torch.zeros((batch,), dtype=torch.int64, device=dev))


def _device_greedy_chunk_fn(model: RnntModel, u_cap: int, max_symbols_per_frame: int):
    """(init_state(batch), consume(state, enc_chunk, n_valid)): the frame
    scan, ``max_symbols_per_frame`` masked sub-steps a frame; the state
    (prediction carry and output, hypothesis buffer, lengths) goes in and
    out, so consecutive chunks continue where the last stopped."""
    blank = sos = model.n_labels
    R = int(max_symbols_per_frame)

    def init_state(batch: int) -> GreedyState:
        return _greedy_init_state(model, batch, u_cap)

    @torch.no_grad()
    def consume(state: GreedyState, enc_chunk: torch.Tensor, n_valid) -> GreedyState:
        carry, pred, hyp, lens = state
        dev = hyp.device
        nv = _on(n_valid, dev)
        cols = torch.arange(u_cap, device=dev)[None, :]
        for t in range(enc_chunk.shape[1]):
            active = t < nv
            enc_t = enc_chunk[:, t, None, :]
            for _ in range(R):
                logits = model.joint(enc_t, pred[:, None, :])[:, 0, 0, :]
                best = torch.argmax(logits, dim=-1)
                emit = active & (best != blank) & (lens < u_cap)
                new_carry, new_pred = model.prediction.step(torch.where(emit, best, sos), carry)
                carry = _mix(emit, new_carry, carry)
                pred = _mix(emit, new_pred, pred)
                hyp = torch.where(emit[:, None] & (cols == lens[:, None]), best[:, None], hyp)
                lens = lens + emit.long()
        return carry, pred, hyp, lens

    return init_state, consume


def _label_loop_chunk_fn(model: RnntModel, u_cap: int, max_symbols_per_frame: int):
    """The frame scan's (init_state, consume) contract with the label loop
    inside: each round scores the current prediction state against every
    frame of the chunk (the encoder projection computed once), jumps each
    row to its first emitting frame and emits one label there, honouring
    the per-frame cap; the frame cursor restarts at 0 each chunk. The
    hypotheses equal the frame scan's. The loop's condition is read every
    ``LABEL_LOOP_CHECK`` rounds (a host sync), never every round: a round
    after it turned false changes nothing. At most min(u_cap, Tc x cap) + 1
    rounds can change anything, the bound of the loop."""
    blank = sos = model.n_labels
    cap = int(max_symbols_per_frame)

    def init_state(batch: int) -> GreedyState:
        return _greedy_init_state(model, batch, u_cap)

    @torch.no_grad()
    def consume(state: GreedyState, enc_chunk: torch.Tensor, n_valid) -> GreedyState:
        carry, pred, hyp, lens = state
        dev = hyp.device
        B, Tc = enc_chunk.shape[:2]
        n = _on(n_valid, dev).long()
        e_proj = model.joint.project_enc(enc_chunk)
        cols = torch.arange(u_cap, device=dev)[None, :]
        idxT = torch.arange(Tc, device=dev)[None, :]
        t = torch.zeros((B,), dtype=torch.int64, device=dev)
        syms = torch.zeros_like(t)
        for it in range(min(u_cap, Tc * cap) + 1):
            if it % LABEL_LOOP_CHECK == 0 and not bool(torch.any((t < n) & (lens < u_cap))):
                break
            best = torch.argmax(model.joint.logits_vs_frames(e_proj, pred), dim=-1)  # [B, Tc]
            at_cap = (idxT == t[:, None]) & (syms[:, None] >= cap)
            cand = (best != blank) & (idxT >= t[:, None]) & (idxT < n[:, None]) & ~at_cap
            has = torch.any(cand, dim=1)
            f = torch.argmax(cand.to(torch.uint8), dim=1)  # the first emitting frame
            active = (t < n) & (lens < u_cap)
            emit = active & has
            label = torch.where(emit, torch.gather(best, 1, f[:, None])[:, 0], sos)
            new_carry, new_pred = model.prediction.step(label, carry)
            carry = _mix(emit, new_carry, carry)
            pred = _mix(emit, new_pred, pred)
            hyp = torch.where(emit[:, None] & (cols == lens[:, None]), label[:, None], hyp)
            lens = lens + emit.long()
            syms = torch.where(emit, torch.where(f == t, syms + 1, 1), syms)
            # emitting rows park at their emission frame; active rows with
            # nothing left to emit finish
            t = torch.where(emit, f, torch.where(active, n, t))
        return carry, pred, hyp, lens

    return init_state, consume


def _chunk_greedy_fn(model: RnntModel, u_cap: int, cap: int, impl: str = "frame_scan"):
    """The chunk-resumable greedy, impl "frame_scan" or "label_loop": the
    same (init_state, consume) contract and the same hypotheses."""
    if impl == "label_loop":
        return _label_loop_chunk_fn(model, u_cap, cap)
    if impl != "frame_scan":
        raise ValueError(f"unknown chunk greedy impl {impl!r}")
    return _device_greedy_chunk_fn(model, u_cap, cap)


def make_rnnt_device_greedy(model: RnntModel, u_cap: int = 200, max_symbols_per_frame: int = 4,
                            impl: str = "label_loop"):
    """decode(enc [B, T, He], n_frames) -> (hyp [B, u_cap] -1-padded, lens
    [B]) on the device: the label loop (the default, as the reference's) or
    the frame scan, the same hypotheses as the host greedy at equal caps."""
    init_state, consume = _chunk_greedy_fn(model, int(u_cap), int(max_symbols_per_frame), impl)

    def decode(enc, n_frames):
        _, _, hyp, lens = consume(init_state(int(enc.shape[0])), enc, n_frames)
        return hyp, lens

    return decode


def _hyp_lists(hyp, lens) -> List[List[int]]:
    hyp, lens = _np(hyp), _np(lens)
    return [hyp[b, : lens[b]].tolist() for b in range(hyp.shape[0])]


def rnnt_greedy_decode_device(model: RnntModel, feats, n_frames, max_symbols_per_frame: int = 4,
                              max_symbols: Optional[int] = None, impl: str = "label_loop") -> List[List[int]]:
    """The device greedy with the host greedy's interface."""
    enc = rnnt_encode(model, feats, n_frames)
    u_cap = int(max_symbols) if max_symbols is not None else min(2 * enc.shape[1], 400)
    return _hyp_lists(*make_rnnt_device_greedy(model, u_cap, max_symbols_per_frame, impl)(enc, n_frames))


def _rnnt_stream_carries(model: RnntModel, batch: int, device: Optional[torch.device] = None):
    """Fresh zero encoder carries for a batch of streams."""
    return lstm_stream_init(model.encoder, batch, _dev_of(model) if device is None else device)


def make_rnnt_stream_encoder(model: RnntModel, batch: int):
    """Chunked stateful encoder (lstm encoder_arch only) -> (step, carries):
    ``carries, enc_chunk = step(carries, feats[, n_valid])`` on the offline
    encoder's parameters, each layer on K4's carry arm on the card, so any
    chunking gives the offline encoder's valid frames."""
    if model.encoder_arch != "lstm":
        raise ValueError("streaming needs the lstm encoder")

    @torch.no_grad()
    def step(carries, feats, n_valid=None):
        nv = None if n_valid is None else _on(n_valid, feats.device)
        enc, new = lstm_stream_apply(model.encoder, feats, carries, nv)
        return new, enc

    return step, _rnnt_stream_carries(model, batch)


def make_rnnt_stream_shared(model: RnntModel, u_cap: int = 200, max_symbols_per_frame: int = 4,
                            impl: str = "frame_scan"):
    """(enc_step, init_state, consume) shared by many RnntDeviceStreams."""
    enc_step, _ = make_rnnt_stream_encoder(model, 1)
    init_state, consume = _chunk_greedy_fn(model, int(u_cap), int(max_symbols_per_frame), impl)
    return enc_step, init_state, consume


class RnntDeviceStream:
    """Online RNN-T: stateful encoder chunks (K4's carry arm) -> the
    chunk-resumable greedy; partials at any time; the final equals the
    offline device greedy."""

    def __init__(self, model: RnntModel, batch: int, u_cap: int = 200, max_symbols_per_frame: int = 4,
                 shared=None, impl: str = "frame_scan"):
        if shared is None:
            shared = make_rnnt_stream_shared(model, u_cap, max_symbols_per_frame, impl)
        self.enc_step, init_state, self.consume_fn = shared
        self.enc_carries = _rnnt_stream_carries(model, batch)
        self.state = init_state(batch)

    def consume(self, feats_chunk: torch.Tensor, n_valid) -> List[List[int]]:
        """feats_chunk [B, Tc, D] on the model's device; n_valid [B] valid
        frames. Returns the partials."""
        self.enc_carries, enc = self.enc_step(self.enc_carries, feats_chunk)
        self.state = self.consume_fn(self.state, enc, n_valid)
        return self.partial()

    def partial(self) -> List[List[int]]:
        return _hyp_lists(self.state[2], self.state[3])


# --------------------------------------------------------------------------
# Host beams
# --------------------------------------------------------------------------


def rnnt_beam_decode(model: RnntModel, feats, n_frames, beam_size: int = 4, max_symbols_per_frame: int = 4,
                     u_cap: int = 200, ext_score=None, ext_weight: float = 1.0) -> List[Tuple[float, List[int]]]:
    """Monotonic RNN-T beam search for ONE utterance (the first row), the
    reference's dict walk: every live hypothesis expands over {blank,
    labels} a round, blank finishes the frame, labels stay in it up to the
    per-frame cap, identical prefixes merge by logaddexp. ``ext_score(prefix,
    unit)`` adds a shallow-fusion term once per label extension. Returns
    [(logp, labels)] best-first."""
    fns = make_rnnt_decoder_fns(model)
    enc = rnnt_encode(model, feats, n_frames)
    T = int(_np(n_frames)[0])
    blank = fns.blank
    beams: Dict[Tuple[int, ...], float] = {(): 0.0}

    def batch_pred(prefixes):
        H = len(prefixes)
        hist = np.full((H, u_cap), -1, np.int32)
        lens = np.zeros(H, np.int32)
        for i, p in enumerate(prefixes):
            hist[i, : len(p)] = p
            lens[i] = len(p)
        return fns.pred_of(hist, lens)

    for t in range(T):
        A = dict(beams)
        done: Dict[Tuple[int, ...], float] = {}
        for _round in range(max_symbols_per_frame + 1):
            if not A:
                break
            prefixes = list(A.keys())
            scores = np.asarray([A[p] for p in prefixes])
            pred = batch_pred(prefixes)
            enc_t = enc[0, t][None, :].expand(len(prefixes), enc.shape[2])
            logp = _np(torch.log_softmax(fns.joint_of(enc_t, pred), dim=-1))
            for i, p in enumerate(prefixes):
                s = scores[i] + logp[i, blank]
                done[p] = np.logaddexp(done[p], s) if p in done else s
            if _round == max_symbols_per_frame:
                break
            new_A: Dict[Tuple[int, ...], float] = {}
            for i, p in enumerate(prefixes):
                if len(p) >= u_cap:
                    continue
                for v in range(blank):
                    s = scores[i] + logp[i, v]
                    if ext_score is not None:
                        s += ext_weight * ext_score(p, v)
                    q = p + (v,)
                    new_A[q] = np.logaddexp(new_A[q], s) if q in new_A else s
            if done:
                thresh = max(done.values())
                new_A = {p: s for p, s in new_A.items() if s > thresh - 10.0}
            A = dict(sorted(new_A.items(), key=lambda kv: -kv[1])[:beam_size])
        beams = dict(sorted(done.items(), key=lambda kv: -kv[1])[:beam_size])
    return sorted(((s, list(p)) for p, s in beams.items()), key=lambda x: -x[0])


def rnnt_beam_decode_batch(model: RnntModel, feats, n_frames, beam_size: int = 4, max_symbols_per_frame: int = 4,
                           u_cap: int = 200) -> List[List[Tuple[float, List[int]]]]:
    """The monotonic beam for a batch: each frame's expansion round of every
    utterance in one (prediction -> joint -> log_softmax) call over a
    [B * beam] row buffer, the candidates handled on the host (per-row
    top-K, exact: within a round every child is distinct), scores in
    float64. The same hypotheses as ``rnnt_beam_decode`` per row."""
    blank = model.n_labels
    dev = _dev_of(model)

    @torch.no_grad()
    def round_logp(enc, hist, lens, row_b, t):
        out = model.prediction(torch.as_tensor(hist).to(dev))
        ln = torch.as_tensor(lens).to(dev).long()
        pred_t = torch.gather(out, 1, ln[:, None, None].expand(-1, 1, out.shape[2]))[:, 0]
        enc_rows = enc[torch.as_tensor(row_b).to(dev).long(), t]
        return torch.log_softmax(model.joint(enc_rows[:, None, :], pred_t[:, None, :])[:, 0, 0, :], dim=-1)

    enc = rnnt_encode(model, feats, n_frames)
    B = enc.shape[0]
    nf = _np(n_frames)
    T = int(nf.max()) if B else 0
    H_pad = B * beam_size
    beams: List[Dict[Tuple[int, ...], float]] = [{(): 0.0} for _ in range(B)]
    hist = np.full((H_pad, u_cap), -1, np.int32)
    lens = np.zeros(H_pad, np.int32)
    row_b = np.zeros(H_pad, np.int32)
    for t in range(T):
        active = [b for b in range(B) if t < nf[b]]
        A: Dict[int, Dict[Tuple[int, ...], float]] = {b: dict(beams[b]) for b in active}
        done: Dict[int, Dict[Tuple[int, ...], float]] = {b: {} for b in active}
        for _round in range(max_symbols_per_frame + 1):
            flat = [(b, p) for b in active for p in A[b]]
            if not flat:
                break
            H = len(flat)
            hist[:H] = -1
            for i, (b, p) in enumerate(flat):
                hist[i, : len(p)] = p
                lens[i] = len(p)
                row_b[i] = b
            logp = _np(round_logp(enc, hist, lens, row_b, t))[:H].astype(np.float64)
            scores = np.asarray([A[b][p] for b, p in flat], np.float64)
            bl = scores + logp[:, blank]
            for i, (b, p) in enumerate(flat):
                d = done[b]
                d[p] = np.logaddexp(d[p], bl[i]) if p in d else bl[i]
            if _round == max_symbols_per_frame:
                break
            lab = scores[:, None] + logp[:, :blank]
            K = min(beam_size, blank)
            top_idx = np.argpartition(-lab, K - 1, axis=1)[:, :K]
            top_val = np.take_along_axis(lab, top_idx, axis=1)
            new_A: Dict[int, Dict[Tuple[int, ...], float]] = {b: {} for b in active}
            for i, (b, p) in enumerate(flat):
                if len(p) >= u_cap:
                    continue
                na = new_A[b]
                for v, s in zip(top_idx[i], top_val[i]):
                    na[p + (int(v),)] = float(s)
            for b in active:
                cands = new_A[b]
                if done[b]:
                    thresh = max(done[b].values())
                    cands = {p: s for p, s in cands.items() if s > thresh - 10.0}
                A[b] = dict(sorted(cands.items(), key=lambda kv: -kv[1])[:beam_size])
        for b in active:
            beams[b] = dict(sorted(done[b].items(), key=lambda kv: -kv[1])[:beam_size])
    return [sorted(((s, list(p)) for p, s in beams[b].items()), key=lambda x: -x[0]) for b in range(B)]


# --------------------------------------------------------------------------
# The beam on the device
# --------------------------------------------------------------------------


def rnnt_fusion_matrix(model: RnntModel, unit_lm, weight: float) -> np.ndarray:
    """[V + 1, V] shallow-fusion table of the device beam: row u the
    weighted unit-bigram log-probs after label u, row V the
    sentence-initial ones; blank is not a column (fusion applies once per
    label extension)."""
    V = model.n_labels
    assert unit_lm.n_units == V, f"unit LM vocabulary ({unit_lm.n_units}) != RNN-T labels ({V})"
    m = np.zeros((V + 1, V), np.float32)
    m[:V, :] = weight * unit_lm.pair_logp
    m[V, :] = weight * unit_lm.init_logp
    return m


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index (as
    ``jax.lax.top_k``)."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _make_beam_device_core(model: RnntModel, beam_size: int, max_symbols_per_frame: int, u_cap: int,
                           has_fusion: bool, has_bias: bool):
    """The reference's one-dispatch monotonic beam for a whole batch, as
    plain ops a frame on the model's device: the in-frame hypotheses in
    fixed [B, K, ...] buffers (history, length, score, prediction carry and
    output, biasing node; dead rows at NEG_INF); each of the R + 1 rounds
    one batched joint over all B x K hypotheses, blank children merged into
    a [B, K (R + 1)] done buffer by exact prefix compare + logaddexp (one
    candidate slot at a time, as the reference), label children a global
    top-K of the K x V candidates pruned against the merged done maximum
    - 10, the prediction net stepped once for the winners; frame end takes
    the top K of done. Rows past n_frames carry their state through. Scores
    accumulate in float32. Returns decode(feats, n_frames, fusion, bn, bd)
    -> (hists [B, K, u_cap], lens [B, K], scores [B, K]) best-first; rows
    at or below NEG_INF / 2 are dead."""
    K = int(beam_size)
    R = int(max_symbols_per_frame)
    V = model.n_labels
    blank = sos = V
    Kd = K * (R + 1)
    NEG_HALF = NEG_INF / 2

    def insert_done(done, ch, cl, cs, cp, cc, cb, cols):
        dh, dl, ds, dcnt, dp, dc, db = done
        B = ch.shape[0]
        valid_slot = ds > NEG_HALF
        same = (dh == ch[:, None, :]) | (cols[None, None, :] >= cl[:, None, None])
        eq = (dl == cl[:, None]) & valid_slot & same.all(-1)
        has = eq.any(1)
        pos = torch.where(has, torch.argmax(eq.to(torch.uint8), dim=1), dcnt)
        cvalid = cs > NEG_HALF
        onehot = (torch.arange(Kd, device=ch.device)[None, :] == pos[:, None]) & cvalid[:, None]
        merged = torch.where(has, torch.logaddexp(torch.gather(ds, 1, pos[:, None])[:, 0], cs), cs)
        ds = torch.where(onehot, merged[:, None], ds)
        dh = torch.where(onehot[..., None], ch[:, None, :], dh)
        dl = torch.where(onehot, cl[:, None], dl)
        dp = torch.where(onehot[..., None], cp[:, None, :], dp)
        dc = tuple(torch.where(onehot.reshape((B, Kd) + (1,) * (c.dim() - 1)), c[:, None], d) for d, c in zip(dc, cc))
        if has_bias:
            db = torch.where(onehot, cb[:, None], db)
        dcnt = dcnt + (cvalid & ~has).long()
        return dh, dl, ds, dcnt, dp, dc, db

    @torch.no_grad()
    def decode(feats, n_frames, fusion_arr=None, bn_arr=None, bd_arr=None):
        enc = rnnt_encode(model, feats, n_frames)
        B, T = enc.shape[0], enc.shape[1]
        dev = enc.device
        nf = _on(n_frames, dev)
        cols = torch.arange(u_cap, device=dev)
        hist = torch.full((B, K, u_cap), -1, dtype=torch.int64, device=dev)
        lens = torch.zeros((B, K), dtype=torch.int64, device=dev)
        score = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
        score[:, 0] = 0.0
        pred_net = model.prediction
        carry, pred = pred_net.step(torch.full((B * K,), sos, dtype=torch.int64, device=dev),
                                    pred_net.initial_carry(B * K, dev))
        bnode = torch.zeros((B, K), dtype=torch.int64, device=dev)
        Hp = pred.shape[-1]
        rows = torch.arange(B, device=dev)[:, None] * K
        for t in range(T):
            hist_in, lens_in, score_in, carry_in, pred_in, bnode_in = hist, lens, score, carry, pred, bnode
            active = t < nf
            done = (torch.full((B, Kd, u_cap), -1, dtype=torch.int64, device=dev),
                    torch.zeros((B, Kd), dtype=torch.int64, device=dev),
                    torch.full((B, Kd), NEG_INF, dtype=torch.float32, device=dev),
                    torch.zeros((B,), dtype=torch.int64, device=dev),
                    torch.zeros((B, Kd, Hp), dtype=torch.float32, device=dev),
                    tuple(torch.zeros((B, Kd) + x.shape[1:], dtype=x.dtype, device=dev) for x in carry),
                    torch.zeros((B, Kd), dtype=torch.int64, device=dev))
            enc_rep = torch.repeat_interleave(enc[:, t], K, dim=0)[:, None, :]
            for r in range(R + 1):
                logits = model.joint(enc_rep, pred[:, None, :])[:, 0, 0, :].reshape(B, K, V + 1)
                logp = torch.log_softmax(logits, dim=-1)
                bl = score + logp[..., blank]
                pred_bk = pred.reshape(B, K, Hp)
                carry_bk = tuple(x.reshape((B, K) + x.shape[1:]) for x in carry)
                for k in range(K):
                    done = insert_done(done, hist[:, k], lens[:, k], bl[:, k], pred_bk[:, k],
                                       tuple(x[:, k] for x in carry_bk), bnode[:, k], cols)
                if r == R:
                    break
                lab = score[..., None] + logp[..., :V]
                if has_fusion:
                    last = torch.where(lens > 0, torch.gather(hist, 2, torch.clamp(lens - 1, min=0)[..., None])[..., 0],
                                       V)
                    lab = lab + fusion_arr[last]
                if has_bias:
                    lab = lab + bd_arr[bnode]
                lab = torch.where(lens[..., None] >= u_cap, NEG_INF, lab)
                lab = torch.where(score[..., None] < NEG_HALF, NEG_INF, lab)
                top_val, top_idx = _topk_stable(lab.reshape(B, K * V), K)
                dmax = done[2].max(dim=1).values
                top_val = torch.where(top_val > dmax[:, None] - 10.0, top_val, NEG_INF)
                parent = top_idx // V
                lab_id = top_idx % V
                live = top_val > NEG_HALF
                hist = torch.gather(hist, 1, parent[..., None].expand(B, K, u_cap))
                plen = torch.gather(lens, 1, parent)
                at = torch.clamp(plen, 0, u_cap - 1)
                hist = torch.where((cols[None, None, :] == at[..., None]) & live[..., None], lab_id[..., None], hist)
                lens = plen + live.long()
                flat_parent = (rows + parent).reshape(-1)
                carry = tuple(x[flat_parent] for x in carry)
                carry, pred = pred_net.step(torch.where(live, lab_id, sos).reshape(-1), carry)
                score = top_val
                if has_bias:
                    bnode = bn_arr[torch.gather(bnode, 1, parent), lab_id]
            # frame end: the next A is the top K of the merged done set
            dh, dl, ds, _dcnt, dp, dc, db = done
            nsc, nidx = _topk_stable(ds, K)
            nhist = torch.gather(dh, 1, nidx[..., None].expand(B, K, u_cap))
            nlen = torch.gather(dl, 1, nidx)
            npred = torch.gather(dp, 1, nidx[..., None].expand(B, K, Hp))
            ncarry = tuple(torch.gather(x, 1, nidx.reshape((B, K) + (1,) * (x.dim() - 2)).expand((B, K) + x.shape[2:]))
                           .reshape((B * K,) + x.shape[2:]) for x in dc)
            nbn = torch.gather(db, 1, nidx) if has_bias else bnode
            a_flat = torch.repeat_interleave(active, K)
            hist, lens, score = _mix(active, nhist, hist_in), _mix(active, nlen, lens_in), _mix(active, nsc, score_in)
            carry = _mix(a_flat, ncarry, carry_in)
            pred = _mix(a_flat, npred.reshape(B * K, Hp), pred_in)
            bnode = _mix(active, nbn, bnode_in)
        return hist, lens, score

    return decode


def make_rnnt_beam_device(model: RnntModel, beam_size: int = 4, max_symbols_per_frame: int = 4, u_cap: int = 200,
                          fusion: Optional[np.ndarray] = None, bias_next: Optional[np.ndarray] = None,
                          bias_delta: Optional[np.ndarray] = None):
    """Bind the fusion/bias tables over the device beam -> decode(feats,
    n_frames) -> (hists, lens, scores)."""
    fn = _make_beam_device_core(model, int(beam_size), int(max_symbols_per_frame), int(u_cap),
                                fusion is not None, bias_next is not None)
    dev = _dev_of(model)
    f_arr = None if fusion is None else torch.as_tensor(np.asarray(fusion, np.float32), device=dev)
    bn_arr = None if bias_next is None else torch.as_tensor(np.asarray(bias_next), device=dev).long()
    bd_arr = None if bias_delta is None else torch.as_tensor(np.asarray(bias_delta, np.float32), device=dev)

    def decode(feats, n_frames):
        return fn(feats, n_frames, f_arr, bn_arr, bd_arr)

    return decode


def rnnt_beam_decode_device(model: RnntModel, feats, n_frames, beam_size: int = 4, max_symbols_per_frame: int = 4,
                            u_cap: int = 200, fusion: Optional[np.ndarray] = None,
                            bias_next: Optional[np.ndarray] = None, bias_delta: Optional[np.ndarray] = None
                            ) -> List[List[Tuple[float, List[int]]]]:
    """The device beam with ``rnnt_beam_decode_batch``'s return shape: per
    utterance [(logp, labels)] best-first."""
    dec = make_rnnt_beam_device(model, beam_size, max_symbols_per_frame, u_cap, fusion=fusion,
                                bias_next=bias_next, bias_delta=bias_delta)
    hist, lens, score = (_np(a) for a in dec(feats, n_frames))
    out: List[List[Tuple[float, List[int]]]] = []
    for b in range(hist.shape[0]):
        out.append([(float(score[b, k]), [int(x) for x in hist[b, k, : lens[b, k]]])
                    for k in range(hist.shape[1]) if score[b, k] > NEG_INF / 2])
    return out


# --------------------------------------------------------------------------
# MWER fine-tuning: expected edit distance over the beam N-best, the
# sequence log-probability the transducer forward marginal
# --------------------------------------------------------------------------


def rnnt_seq_logprob(model: RnntModel, feats, n_frames, hyps, n_hyp, enc: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """log P(hyp | x) over all alignments: -rnnt_loss of the hypothesis as
    the label sequence. feats [R, T, D] rows pair with hyps [R, U]
    (-1-padded), n_hyp [R] -> [R]. ``enc`` replaces the encoder pass
    (training: the plain recurrence under autograd)."""
    if enc is None:
        enc = model.encode(feats, n_frames, use_kernels=False)
    logits = model.joint(enc, model.prediction(hyps))
    return -rnnt_loss(logits, n_frames, hyps, n_hyp)


def rnnt_mwer_objective(model: RnntModel, feats, n_frames, hyps, n_hyp, hyp_mask, risks, labels, n_labels,
                        anchor_weight: float = 0.1, ctc_weight: float = 1.0, *, use_kernels: bool = True
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expected risk over the renormalized N-best (hyps [B, N, U]
    -1-padded, n_hyp [B, N], hyp_mask [B, N], risks [B, N]) minus its
    per-utterance mean, plus anchor_weight x ``rnnt_objective`` on the
    references. The encoder runs once per utterance and its output is
    repeated for the N hypotheses (the reference repeats the features)."""
    dev = feats.device
    hyps, n_hyp = hyps.to(dev), n_hyp.to(dev)
    hyp_mask, risks = hyp_mask.to(dev), risks.to(dev, torch.float32)
    B, N, U = hyps.shape
    nf = n_frames.to(dev)
    enc = torch.repeat_interleave(model.encode(feats, nf, use_kernels=False), N, dim=0)
    nfr = torch.repeat_interleave(nf, N, dim=0)
    seq_lp = rnnt_seq_logprob(model, None, nfr, hyps.reshape(B * N, U), n_hyp.reshape(B * N), enc=enc).reshape(B, N)
    seq_lp = torch.where(hyp_mask, seq_lp, NEG_INF)
    phat = torch.softmax(seq_lp, dim=1)
    n_valid = torch.clamp(hyp_mask.sum(dim=1), min=1)
    masked_risk = torch.where(hyp_mask, risks, 0.0)
    rbar = masked_risk.sum(dim=1) / n_valid
    row_risk = (phat * masked_risk).sum(dim=1)
    row_ok = (nf > 0) & hyp_mask.any(dim=1)
    denom = batch_count(row_ok.sum())
    mwer = torch.where(row_ok, row_risk - rbar, 0.0).sum() / denom
    exp_risk = torch.where(row_ok, row_risk, 0.0).sum() / denom
    metrics = {"mwer": mwer, "expected_risk": exp_risk}
    loss = mwer
    if anchor_weight > 0.0:
        anchor, _ = rnnt_objective(model, feats, nf, labels, n_labels, ctc_weight, use_kernels=use_kernels)
        loss = loss + anchor_weight * anchor
        metrics["anchor"] = anchor
    metrics["loss"] = loss
    return loss, metrics


def make_rnnt_mwer_step(model: RnntModel, cfg: TrainConfig, anchor_weight: float = 0.1, ctc_weight: float = 1.0,
                        *, use_kernels: bool = True):
    """(state, feats, n_frames, hyps, n_hyp, hyp_mask, risks, labels,
    n_labels) -> (state, metrics as Python floats): one MWER step; the
    N-best and the risks come from the host (``pipeline.
    finetune_rnnt_mwer``)."""

    def step(state: TrainState, feats, n_frames, hyps, n_hyp, hyp_mask, risks, labels, n_labels):
        state.model.train()
        with torch.enable_grad():
            loss, metrics = rnnt_mwer_objective(state.model, feats, n_frames, hyps, n_hyp, hyp_mask, risks, labels,
                                                n_labels, anchor_weight=anchor_weight, ctc_weight=ctc_weight,
                                                use_kernels=use_kernels)
            loss.backward()
        apply_update(state, cfg)
        return state, {k: v.item() for k, v in metrics.items()}

    return step

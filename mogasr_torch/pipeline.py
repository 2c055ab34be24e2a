"""Pipeline in PyTorch: the port of the serving and GMM training paths of
mogasr/pipeline.py.

Decoding: featurize -> score_batch -> Viterbi -> path_to_tokens -> WER, on
padded length-bucketed batches (``data.batching``). ``decode_corpus`` runs
the whole path over a corpus, as ``bench.py`` does for the reference. The
hybrid NN-HMM path scores with a neural frame classifier instead
(``make_nn_scorer``: prior-scaled log-posteriors) and decodes the same way;
the CTC path (``train_ctc``, ``train_ctc_bpe``, ``train_ctc_units``,
``distill_ctc_units``, ``make_ctc_scorer``; ``am.ctc``) trains on K3 and
decodes the CTC word loop on K2's skip arm; the RNN-T (``train_rnnt*``,
``finetune_rnnt_mwer``; ``am.rnnt``) and the attention encoder-decoder
(``train_aed``, ``train_aed_bpe``, ``train_aed_units``,
``finetune_aed_mwer``; ``am.aed``) train with their auxiliary CTC loss on
K3. Beyond the 1-best loop decode: ``decode_batch_lattices`` (the bigram LM
decode of ``decoder.lm_viterbi`` with its one-pass word lattices, for the
host's rescoring, N-best and confusion networks), and
``decode_batch_with_confidence`` / ``decode_batch_nbest`` (Viterbi and
forward-backward over the same loop graph: per-word posterior confidence
and alternatives).

Training: ``train_gmm`` runs EM over featurized batches, each utterance
against its align graph: Viterbi EM (forced alignment, hard statistics) or
Baum-Welch EM (forward-backward, soft statistics), with the reference's
mixture-splitting schedule, optional transition re-estimation and resume
from an EM checkpoint (``utils.checkpoint``); ``flat_start`` gives the first
model, ``evaluate`` the held-out WER. The tied-triphone recipe:
``collect_cd_stats`` (per-triphone-state statistics from a monophone
alignment), then ``train_triphone`` (tying, the one-component CD model, CD
EM).

Device dispatch is by the tensor: on a CUDA device the scorer (K1, or K1w
with ``layout="wide"``, or K5 with ``compute_dtype="int8"``), the Viterbi
decoder, forward-backward and the LSTM recurrence are the hand-written
kernels (``am.gmm_cuda``, ``decoder.viterbi_cuda``, ``decoder.fb_cuda``,
``am.lstm_cuda``); on the CPU they are the plain versions.
``decode_corpus``, ``decode_batch``, ``decode_batch_with_confidence``,
``decode_batch_nbest``, ``make_nn_scorer``, ``align_batch`` and
``batch_stats`` take ``use_kernels=False`` to run the plain versions on any
device, which is how the kernel path is checked against them on the card.
The LM decoder has no kernel: it runs as plain PyTorch ops on the device of
its scores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mogasr_torch.am import em
from mogasr_torch.am.gmm import GmmSet, gmm_from_numpy, gmm_loglik
from mogasr_torch.am.gmm_cuda import Params, gmm_loglik_batched, kernel_params
from mogasr_torch.am.neural import posteriors_to_loglik
from mogasr_torch.am.quantize import make_quantized_logits
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TrainConfig
from mogasr_torch.data.batching import Batch, make_batches
from mogasr_torch.decoder import fb_cuda
from mogasr_torch.decoder import forward_backward as fbd
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.decoder import viterbi_cuda
from mogasr_torch.eval.wer import corpus_wer
from mogasr_torch.frontend.torch_frontend import make_frontend
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm.lexicon import Lexicon
from mogasr_torch.hmm.topology import Topology
from mogasr_torch.utils import checkpoint as ckpt

Utterance = Tuple[str, np.ndarray, List[str]]  # (id, wave, words)
Frontend = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
DecodeGraphs = Tuple[Dict[str, np.ndarray], Dict[str, torch.Tensor]]  # batch_graphs, on the device
Scorer = Callable[["FeatBatch"], torch.Tensor]  # FeatBatch -> [B, T, P] float32 log-likelihoods
DROP_TOKENS = ("<sil>", "sil")
STAGES = ("host", "frontend", "scoring", "viterbi", "tokens")
# One EM iteration: graphs, batching and copies; K1; K2 (Viterbi EM) or
# K3f/K3b (Baum-Welch EM); the E-step's statistics; the M-step.
TRAIN_STAGES = ("host", "scoring", "align", "stats", "m_step")


class StageClock:
    """Wall seconds per stage of the decode path (``STAGES``) or of one EM
    iteration (``TRAIN_STAGES``).

    ``with clock("scoring"): ...`` adds the block's time to that stage; the
    device is synchronised at the end of each block, so a stage's time
    includes the device work it queued.
    """

    def __init__(self, device: torch.device, stages: Sequence[str] = STAGES):
        self.device = device
        self.seconds = dict.fromkeys(stages, 0.0)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] += time.perf_counter() - t0


def _stage(clock: Optional[StageClock], name: str):
    return clock(name) if clock is not None else contextlib.nullcontext()


@dataclasses.dataclass
class FeatBatch:
    utt_ids: List[str]
    feats: torch.Tensor     # [B, T, D]
    n_frames: torch.Tensor  # [B] int32
    words: List[List[str]]

    @property
    def size(self) -> int:
        return len(self.utt_ids)


def live_rows(fb: FeatBatch) -> FeatBatch:
    """The batch without its dummy rows (the zero-length rows past
    ``fb.size`` that fill a batch to its size): every decode is per row, so
    the live rows decode as they do in the full batch."""
    if fb.feats.shape[0] == fb.size:
        return fb
    return dataclasses.replace(fb, feats=fb.feats[: fb.size], n_frames=fb.n_frames[: fb.size],
                               words=fb.words[: fb.size])


def frontend_for(fcfg: FrontendConfig, max_samples: int, device: torch.device) -> Frontend:
    """The front end of one bucket width (samples). ``fcfg.add_pitch``
    appends the (POV, centered log-f0, delta log-f0) pitch triple
    (``frontend/pitch.py``) frame-aligned to the spectral stream; feat_dim
    already counts it."""
    if not fcfg.add_pitch:
        return make_frontend(fcfg, max_samples, device)
    from mogasr_torch.frontend.pitch import PitchConfig, features_with_pitch

    if not fcfg.snip_edges:
        raise NotImplementedError(
            "add_pitch requires snip_edges=True (extract_pitch mirrors the snip_edges frame-count formula)"
        )
    spectral = make_frontend(dataclasses.replace(fcfg, add_pitch=False), max_samples, device)
    # pitch frames share the spectral grid, whatever it is
    pcfg = PitchConfig(window_ms=fcfg.frame_length_ms, shift_ms=fcfg.frame_shift_ms)

    def extract(waves: torch.Tensor, num_samples: torch.Tensor):
        feats, n_frames = spectral(waves, num_samples)
        waves = waves.to(device=device, dtype=torch.float32)
        feats = features_with_pitch(feats, n_frames, waves, num_samples.to(device), cfg=pcfg,
                                    sample_rate=fcfg.sample_rate)
        return feats, n_frames

    return extract


def frontends_for(batches: Sequence[Batch], fcfg: FrontendConfig, device: torch.device) -> Dict[int, Frontend]:
    """One front end per bucket width (samples) among ``batches``."""
    return {w: frontend_for(fcfg, w, device) for w in sorted({b.waves.shape[1] for b in batches})}


def featurize_batch(
    batch: Batch, frontend: Frontend, device: torch.device, clock: Optional[StageClock] = None
) -> FeatBatch:
    """Copy one padded batch to ``device`` ("host") and run its front end."""
    with _stage(clock, "host"):
        waves = torch.as_tensor(batch.waves).to(device)
        num_samples = torch.as_tensor(batch.num_samples).to(device)
    with _stage(clock, "frontend"):
        feats, n_frames = frontend(waves, num_samples)
    return FeatBatch(batch.utt_ids, feats, n_frames, batch.words)


def featurize(
    utts: Sequence[Utterance], fcfg: FrontendConfig, bcfg: BatchConfig, device: torch.device
) -> List[FeatBatch]:
    """Batch + run the front end on ``device``, one FeatBatch per bucket batch."""
    return list(featurize_iter(utts, fcfg, bcfg, device))


def featurize_iter(
    utts: Sequence[Utterance], fcfg: FrontendConfig, bcfg: BatchConfig, device: torch.device
) -> Iterator[FeatBatch]:
    """Lazy generator behind ``featurize``: one FeatBatch per bucket batch,
    produced on demand (compose with ``data.prefetch.prefetch`` to overlap
    host staging with device work). One front end per bucket width."""
    frontends: Dict[int, Frontend] = {}
    for batch in make_batches(utts, bcfg, fcfg):
        w = batch.waves.shape[1]
        if w not in frontends:
            frontends[w] = frontend_for(fcfg, w, device)
        yield featurize_batch(batch, frontends[w], device)


def featurize_streaming(
    utts: Sequence[Utterance],
    fcfg: FrontendConfig,
    bcfg: BatchConfig,
    device: torch.device,
    chunk_samples: int = 8000,
) -> List[FeatBatch]:
    """Featurize through the chunked streaming front end
    (``frontend/streaming.py``, its spectral chunk on ``device``).

    Each utterance is fed chunk by chunk to a StreamingFrontend; sliding CMVN
    runs online in it, per-utterance CMVN after finalize (it is acausal).
    The results batch into ``featurize``'s FeatBatch shape, bucketed by frame
    count as ``make_batches`` buckets, and match it numerically."""
    from mogasr_torch.frontend.numpy_ref import cmvn_np
    from mogasr_torch.frontend.streaming import StreamingFrontend

    stream_cfg = fcfg if fcfg.cmvn == "sliding" else dataclasses.replace(fcfg, cmvn="none")
    per_utt = []
    for utt_id, wave, words in utts:
        sf = StreamingFrontend(stream_cfg, device=device)
        outs = [sf.process(wave[i : i + chunk_samples]) for i in range(0, len(wave), chunk_samples)]
        outs.append(sf.finalize())
        feats = np.concatenate(outs)
        if fcfg.cmvn == "utterance" and feats.shape[0] > 0:
            feats = cmvn_np(feats, fcfg.cmvn_norm_var).astype(np.float32)
        per_utt.append((utt_id, feats, words))

    if bcfg.sort_by_length:
        per_utt.sort(key=lambda it: it[1].shape[0])
    out: List[FeatBatch] = []
    group: List = []
    group_bucket = 0

    def emit(group, bucket):
        B = bcfg.batch_size
        arr = np.zeros((B, bucket, fcfg.feat_dim), np.float32)
        nf = np.zeros(B, np.int32)
        for i, (_utt_id, feats, _words) in enumerate(group):
            arr[i, : feats.shape[0]] = feats
            nf[i] = feats.shape[0]
        words_out = [list(w) for _u, _f, w in group] + [[]] * (B - len(group))
        return FeatBatch([u for u, _f, _w in group], torch.as_tensor(arr, device=device),
                         torch.as_tensor(nf, device=device), words_out)

    for item in per_utt:
        b = next((fb for fb in bcfg.bucket_boundaries if item[1].shape[0] <= fb), None)
        if b is None:
            continue  # overlong: dropped, like make_batches
        if group and (b != group_bucket or len(group) >= bcfg.batch_size):
            out.append(emit(group, group_bucket))
            group = []
        group.append(item)
        group_bucket = b
    if group:
        out.append(emit(group, group_bucket))
    return out


def compute_global_cmvn(batches: Sequence[FeatBatch]) -> Tuple[np.ndarray, np.ndarray]:
    """Corpus-level (mean, inv_std) float32 over valid frames: the stats that
    streaming global CMVN (``frontend/streaming.py``) applies frame-wise.
    Sums in float64 on the host, as the reference's."""
    total = total_sq = None
    count = 0.0
    for fb in batches:
        feats = fb.feats.cpu().numpy()
        mask = (np.arange(feats.shape[1])[None, :] < fb.n_frames.cpu().numpy()[:, None]).astype(np.float64)[:, :, None]
        s = (feats * mask).sum((0, 1))
        sq = (feats ** 2 * mask).sum((0, 1))
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
        count += mask.sum()
    mean = total / max(count, 1.0)
    var = np.maximum(total_sq / max(count, 1.0) - mean ** 2, 1e-10)
    return mean.astype(np.float32), (1.0 / np.sqrt(var)).astype(np.float32)


def score_batch(
    feats: torch.Tensor,
    gmm: GmmSet,
    use_kernels: bool = True,
    compute_dtype: str = "float32",
    mode: str = "sum",
    params: Optional[Params] = None,
    layout: str = "chunked",
) -> torch.Tensor:
    """[B, T, D] -> [B, T, S]: the CUDA kernel on the card, the plain scorer
    on the CPU or with ``use_kernels=False``. compute_dtype "float32",
    "bfloat16" or "int8" (sum mode only); layout "chunked" (K1) or "wide"
    (K1w). ``params`` is the GMM in the kernel's layout
    (``gmm_cuda.kernel_params``), made per call when not given."""
    if use_kernels:
        return gmm_loglik_batched(feats, gmm, compute_dtype=compute_dtype, mode=mode, params=params,
                                  layout=layout)
    B, T, D = feats.shape
    return gmm_loglik(
        feats.reshape(B * T, D), gmm, mode=mode, compute_dtype=compute_dtype
    ).reshape(B, T, -1)


def word_decode_graph(
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    word_logp: Optional[np.ndarray] = None,
    multi_pron: bool = False,
) -> gr.Graph:
    """Word-loop decode graph over the full vocabulary + a silence chain.

    multi_pron: one chain per pronunciation variant (:func:`word_decode_graph_multi`).
    """
    if multi_pron:
        return word_decode_graph_multi(lexicon, topo, dcfg, word_logp)[0]
    tokens = [(w, lexicon.word_phone_ids(w)) for w in lexicon.words]
    tokens.append(("<sil>", [lexicon.sil_id]))
    if word_logp is None:
        word_logp = np.full(len(tokens), -np.log(len(lexicon.words) + 1), np.float32)
    return gr.loop_graph(
        topo, tokens=tokens, token_logp=word_logp,
        insertion_penalty=dcfg.word_insertion_penalty,
    )


def word_decode_graph_multi(
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    word_logp: Optional[np.ndarray] = None,
) -> Tuple[gr.Graph, np.ndarray]:
    """Multi-pronunciation word-loop graph -> (graph, pron_logp).

    One chain per pronunciation variant, labelled with its word; each
    variant's entry carries the word prior plus a uniform log pronunciation
    prior, so a word's total entry mass is unchanged. pron_logp[c] is that
    log pronunciation prior of chain c (0 for single-pronunciation words and
    silence), for a decoder whose LM replaces the word prior.
    """
    words = list(lexicon.words) + ["<sil>"]
    if word_logp is None:
        word_logp = np.full(len(words), -np.log(len(words)), np.float32)
    tokens: List[Tuple[str, List[int]]] = []
    tok_logp: List[float] = []
    pron_logp: List[float] = []
    for wi, w in enumerate(lexicon.words):
        variants = lexicon.word_variant_phone_ids(w)
        lp = -np.log(len(variants))
        for pids in variants:
            tokens.append((w, pids))
            tok_logp.append(float(word_logp[wi]) + lp)
            pron_logp.append(lp)
    tokens.append(("<sil>", [lexicon.sil_id]))
    tok_logp.append(float(word_logp[len(lexicon.words)]))
    pron_logp.append(0.0)
    g = gr.loop_graph(
        topo, tokens=tokens, token_logp=np.asarray(tok_logp, np.float32),
        insertion_penalty=dcfg.word_insertion_penalty,
    )
    return g, np.asarray(pron_logp, np.float32)


def decode_graphs(graph: gr.Graph, batch_size: int, device: torch.device) -> DecodeGraphs:
    """A shared loop graph stacked for a batch: numpy arrays and tensors on ``device``."""
    graphs_np = gr.batch_graphs([graph] * batch_size)
    return graphs_np, vit.graphs_to_torch(graphs_np, device)


def make_nn_scorer(
    model: torch.nn.Module,
    log_priors,
    precision: str = "float32",
    use_kernels: bool = True,
) -> Scorer:
    """Hybrid NN-HMM scorer: ``scorer(fb) -> [B, T, n_pdfs]`` prior-scaled
    log-posteriors, log p(s|x) - log p(s), of a frame classifier
    (``am.neural``) on ``fb.feats``.

    precision "float32", "bfloat16" (any family) or "int8" (MlpAm, LstmAm)
    (``am.quantize``); the log-softmax and prior scaling stay float32.
    ``log_priors`` [n_pdfs] goes to the model's device. LstmAm and BlstmAm
    run K4 on the card; ``use_kernels=False`` runs their plain recurrence.
    """
    logits_fn = make_quantized_logits(model, precision, use_kernels)
    dev = next(model.parameters()).device
    lp = torch.as_tensor(np.asarray(log_priors, np.float32), device=dev)

    def scorer(fb: FeatBatch) -> torch.Tensor:
        with torch.no_grad():
            return posteriors_to_loglik(logits_fn(fb.feats, fb.n_frames), lp)

    return scorer


def make_ctc_scorer(model: torch.nn.Module, use_kernels: bool = True) -> Scorer:
    """``am.ctc.make_ctc_scorer``: ``fb -> [B, T, V]`` CTC log posteriors for
    graph decoding (``am.ctc.ctc_decode_graph``, acoustic scale 1)."""
    from mogasr_torch.am.ctc import make_ctc_scorer as _m

    return _m(model, use_kernels)


def train_ctc(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    tcfg: TrainConfig,
    arch: str = "mlp",
    steps: Optional[int] = None,
    spec_augment: bool = False,
    include_sil: bool = False,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    logger=None,
    *,
    use_kernels: bool = True,
):
    """Alignment-free CTC training on (features, phone sequence) pairs: the
    vocabulary is the lexicon's phones + blank (last) -> (model, state_dict).
    Decode with ``am.ctc.ctc_decode_graph`` + ``decode_batch`` or greedily."""
    from mogasr_torch.am.ctc import ctc_labels_from_words

    return train_ctc_units(
        batches, lambda words: ctc_labels_from_words(lexicon, words, include_sil), lexicon.n_phones, tcfg,
        arch=arch, steps=steps, spec_augment=spec_augment, init_params=init_params, logger=logger,
        use_kernels=use_kernels,
    )


def train_ctc_bpe(
    batches: Sequence[FeatBatch],
    bpe,
    tcfg: TrainConfig,
    arch: str = "mlp",
    steps: Optional[int] = None,
    spec_augment: bool = False,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    logger=None,
    *,
    use_kernels: bool = True,
):
    """Lexicon-free CTC on BPE units (``data.bpe``) -> (model, state_dict);
    decode greedily or with a prefix beam and join with ``bpe.decode``."""
    return train_ctc_units(batches, bpe.encode, bpe.n_units, tcfg, arch=arch, steps=steps,
                           spec_augment=spec_augment, init_params=init_params, logger=logger,
                           use_kernels=use_kernels)


def _ctc_model(arch: str, n_units: int, tcfg: TrainConfig, batches: Sequence[FeatBatch]) -> torch.nn.Module:
    """A fresh ``arch`` model over n_units + blank, its weights drawn from
    ``tcfg.seed``, on the batches' device."""
    from mogasr_torch.am.neural import build_model
    from mogasr_torch.am.params import init_

    fb0 = batches[0]
    model = build_model(arch, n_units + 1, tcfg, int(fb0.feats.shape[-1]))
    return init_(model, torch.Generator().manual_seed(tcfg.seed)).to(fb0.feats.device)


def train_ctc_units(
    batches: Sequence[FeatBatch],
    encode_fn: Callable[[List[str]], List[int]],  # words -> unit ids
    n_units: int,                                  # vocabulary without blank (blank = n_units)
    tcfg: TrainConfig,
    arch: str = "mlp",
    steps: Optional[int] = None,
    spec_augment: bool = False,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    logger=None,
    *,
    use_kernels: bool = True,
):
    """Alignment-free CTC over any unit inventory -> (model, state_dict).

    init_params: a warm-start state_dict, e.g. an MPC-pretrained encoder
    (``am.pretrain``): every entry whose name and shape this model shares is
    copied in (``transfer_pretrained``), the head keeps its fresh weights.
    The loss runs on K3 on the card (``am.ctc.ctc_loss``)."""
    from mogasr_torch.am.ctc import init_ctc_train_state, make_ctc_train_step

    model = _ctc_model(arch, n_units, tcfg, batches)
    if init_params is not None:
        from mogasr_torch.am.pretrain import transfer_pretrained

        merged, copied, total = transfer_pretrained(init_params, model.state_dict())
        if copied == 0:
            raise ValueError(f"init_params shares no (name, shape)-compatible entries with the {arch} CTC model "
                             "-- arch/hidden/layers mismatch?")
        model.load_state_dict(merged)
        if logger is not None:
            logger.log({"stage": "ctc_warm_start", "leaves_copied": copied, "leaves_total": total})
    state = init_ctc_train_state(model, tcfg)
    step_fn = make_ctc_train_step(tcfg, spec_aug=spec_augment, use_kernels=use_kernels)
    labeled = _pack_ctc_targets(batches, encode_fn)
    total_steps = steps if steps is not None else tcfg.num_nn_steps
    i = 0
    while i < total_steps:
        for fb, labels, n_labels in labeled:
            state, m = step_fn(state, fb.feats, fb.n_frames, labels, n_labels)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "train_ctc", "step": i, "loss": m["loss"]})
            if i >= total_steps:
                break
    return model, model.state_dict()


def _pack_ctc_targets(batches: Sequence[FeatBatch], encode_fn
                      ) -> List[Tuple[FeatBatch, torch.Tensor, torch.Tensor]]:
    """[(fb, labels [rows, L], n_labels [rows])] on the batches' device, one
    shared pad length, zero-length rows for the batch padding."""
    from mogasr_torch.am.ctc import pack_label_batch

    seqs_all = [[encode_fn(fb.words[b]) for b in range(fb.size)] for fb in batches]
    l_max = max((len(s) for seqs in seqs_all for s in seqs), default=1)
    labeled = []
    for fb, seqs in zip(batches, seqs_all):
        rows = int(fb.feats.shape[0])
        labels, n_labels = pack_label_batch(seqs + [[] for _ in range(rows - fb.size)], pad_to=l_max)
        dev = fb.feats.device
        labeled.append((fb, torch.as_tensor(labels, device=dev), torch.as_tensor(n_labels, device=dev)))
    return labeled


def distill_ctc_units(
    batches: Sequence[FeatBatch],
    teacher_model: torch.nn.Module,
    encode_fn: Callable[[List[str]], List[int]],  # words -> unit ids (the teacher's inventory)
    n_units: int,                                  # vocabulary without blank (blank = n_units)
    tcfg: TrainConfig,
    student_arch: str = "lstm",
    alpha: float = 0.5,
    temperature: float = 2.0,
    steps: Optional[int] = None,
    spec_augment: bool = False,
    logger=None,
    *,
    use_kernels: bool = True,
):
    """Distill a trained CTC teacher (the module with its weights) into a
    ``student_arch`` student over the same units (``am.distill``) ->
    (model, state_dict): a drop-in CTC model of that architecture."""
    from mogasr_torch.am.ctc import init_ctc_train_state
    from mogasr_torch.am.distill import make_distill_train_step

    model = _ctc_model(student_arch, n_units, tcfg, batches)
    state = init_ctc_train_state(model, tcfg)
    step_fn = make_distill_train_step(teacher_model, tcfg, alpha=alpha, temperature=temperature,
                                      spec_aug=spec_augment, use_kernels=use_kernels)
    labeled = _pack_ctc_targets(batches, encode_fn)
    total_steps = steps if steps is not None else tcfg.num_nn_steps
    i = 0
    while i < total_steps:
        for fb, labels, n_labels in labeled:
            state, m = step_fn(state, fb.feats, fb.n_frames, labels, n_labels)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "distill_ctc", "step": i, "loss": m["loss"], "kl": m["kl"], "ctc": m["ctc"]})
            if i >= total_steps:
                break
    return model, model.state_dict()


def train_rnnt(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    tcfg: TrainConfig,
    encoder_arch: str = "lstm",
    pred_arch: str = "stateless",
    aux_ctc: bool = True,
    ctc_weight: float = 1.0,
    steps: Optional[int] = None,
    include_sil: bool = False,
    pruned_band: int = 0,
    logger=None,
    *,
    use_kernels: bool = True,
):
    """RNN-Transducer training on (features, phone sequence) pairs ->
    (model, state_dict). The defaults are the reference's low-data recipe: a
    stateless prediction net and an auxiliary CTC loss on the encoder."""
    from mogasr_torch.am.ctc import ctc_labels_from_words

    return train_rnnt_units(
        batches, lambda words: ctc_labels_from_words(lexicon, words, include_sil), lexicon.n_phones, tcfg,
        encoder_arch=encoder_arch, pred_arch=pred_arch, aux_ctc=aux_ctc, ctc_weight=ctc_weight, steps=steps,
        pruned_band=pruned_band, logger=logger, use_kernels=use_kernels,
    )


def train_rnnt_bpe(batches: Sequence[FeatBatch], bpe, tcfg: TrainConfig, logger=None, **kwargs):
    """Lexicon-free RNN-T on BPE units; greedy decode + ``bpe.decode`` gives
    words."""
    return train_rnnt_units(batches, bpe.encode, bpe.n_units, tcfg, logger=logger, **kwargs)


def rnnt_model_for(n_units: int, tcfg: TrainConfig, batches: Sequence[FeatBatch], encoder_arch: str = "lstm",
                   pred_arch: str = "stateless", aux_ctc: bool = True, simple_heads: bool = False):
    """A fresh ``am.rnnt.build_rnnt_model`` over n_units + blank, its weights
    drawn from ``tcfg.seed``, on the batches' device."""
    from mogasr_torch.am.params import init_
    from mogasr_torch.am.rnnt import build_rnnt_model

    fb0 = batches[0]
    model = build_rnnt_model(n_units, tcfg, int(fb0.feats.shape[-1]), encoder_arch=encoder_arch,
                             pred_arch=pred_arch, aux_ctc=aux_ctc, simple_heads=simple_heads)
    return init_(model, torch.Generator().manual_seed(tcfg.seed)).to(fb0.feats.device)


def train_rnnt_units(
    batches: Sequence[FeatBatch],
    encode_fn: Callable[[List[str]], List[int]],  # words -> unit ids
    n_units: int,                                  # vocabulary without blank (blank = n_units)
    tcfg: TrainConfig,
    encoder_arch: str = "lstm",
    pred_arch: str = "stateless",
    aux_ctc: bool = True,
    ctc_weight: float = 1.0,
    steps: Optional[int] = None,
    pruned_band: int = 0,
    logger=None,
    *,
    use_kernels: bool = True,
):
    """Alignment-free RNN-T over any unit inventory -> (model, state_dict).
    ``pruned_band > 0`` trains with the pruned loss (``am.rnnt_pruned``),
    and the model gains the factored simple heads (decode with
    ``--rnnt-pruned``). The encoder runs its plain recurrence under
    autograd; the auxiliary CTC loss runs on K3 on the card."""
    from mogasr_torch.am import rnnt as R

    model = rnnt_model_for(n_units, tcfg, batches, encoder_arch, pred_arch, aux_ctc, pruned_band > 0)
    state = R.init_rnnt_train_state(model, tcfg)
    if pruned_band > 0:
        from mogasr_torch.am.rnnt_pruned import make_rnnt_pruned_train_step

        step_fn = make_rnnt_pruned_train_step(model, tcfg, band=pruned_band, ctc_weight=ctc_weight,
                                              use_kernels=use_kernels)
    else:
        step_fn = R.make_rnnt_train_step(model, tcfg, ctc_weight=ctc_weight, use_kernels=use_kernels)
    labeled = _pack_ctc_targets(batches, encode_fn)
    total = steps if steps is not None else tcfg.num_nn_steps
    i = 0
    while i < total:
        for fb, labels, n_labels in labeled:
            state, m = step_fn(state, fb.feats, fb.n_frames, labels, n_labels)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "train_rnnt", "step": i, "loss": m["loss"]})
            if i >= total:
                break
    model.eval()
    return model, model.state_dict()


def finetune_rnnt_mwer(
    model: torch.nn.Module,
    batches: Sequence[FeatBatch],
    encode_fn: Callable[[List[str]], List[int]],
    tcfg: TrainConfig,
    n_hyps: int = 4,
    anchor_weight: float = 0.1,
    steps: Optional[int] = None,
    logger=None,
    *,
    use_kernels: bool = True,
):
    """On-policy MWER fine-tuning of a trained RNN-T, in place: each step
    the device beam's N-best (``am.rnnt.rnnt_beam_decode_device``, width
    n_hyps) against the current weights, host edit-distance risks, one
    ``make_rnnt_mwer_step``. Returns (state_dict, history of the expected
    risk a step)."""
    from mogasr_torch.am import rnnt as R
    from mogasr_torch.eval.wer import edit_counts

    seqs_all = [[encode_fn(fb.words[b]) for b in range(fb.size)] for fb in batches]
    l_max = max((len(s) for seqs in seqs_all for s in seqs), default=1)
    u_max = l_max + 4
    labeled = [(fb, seqs, labels, n_labels)
               for (fb, labels, n_labels), seqs in zip(_pack_ctc_targets(batches, encode_fn), seqs_all)]
    state = R.init_rnnt_train_state(model, tcfg)
    step_fn = R.make_rnnt_mwer_step(model, tcfg, anchor_weight=anchor_weight, use_kernels=use_kernels)
    total = steps if steps is not None else tcfg.num_nn_steps
    history: List[float] = []
    i = 0
    while i < total:
        for fb, seqs, labels, n_labels in labeled:
            rows = int(fb.feats.shape[0])
            hyps = np.full((rows, n_hyps, u_max), -1, np.int64)
            n_h = np.zeros((rows, n_hyps), np.int64)
            h_mask = np.zeros((rows, n_hyps), bool)
            risks = np.zeros((rows, n_hyps), np.float32)
            model.eval()
            nbest_all = R.rnnt_beam_decode_device(model, fb.feats, fb.n_frames, beam_size=n_hyps, u_cap=u_max)
            for b in range(fb.size):
                seen = set()
                for n, (_lp, h) in enumerate(nbest_all[b][:n_hyps]):
                    h = tuple(h)
                    if h in seen or len(h) > u_max:
                        continue
                    seen.add(h)
                    hyps[b, n, : len(h)] = h
                    n_h[b, n] = len(h)
                    h_mask[b, n] = True
                    risks[b, n] = edit_counts(seqs[b], list(h)).errors
            dev = fb.feats.device
            state, m = step_fn(state, fb.feats, fb.n_frames, *(torch.as_tensor(a, device=dev)
                                                               for a in (hyps, n_h, h_mask, risks)), labels, n_labels)
            history.append(m["expected_risk"])
            i += 1
            if logger is not None and i % 10 == 0:
                logger.log({"stage": "rnnt_mwer", "step": i, "expected_risk": history[-1]})
            if i >= total:
                break
    model.eval()
    return model.state_dict(), history


def train_aed(batches: Sequence[FeatBatch], lexicon: Lexicon, tcfg: TrainConfig, include_sil: bool = False,
              logger=None, **kwargs):
    """The attention encoder-decoder (``am.aed``) on (features, phone
    sequence) pairs -> (model, state_dict); decode with
    ``am.aed.aed_decode_batch``."""
    from mogasr_torch.am.ctc import ctc_labels_from_words

    return train_aed_units(batches, lambda words: ctc_labels_from_words(lexicon, words, include_sil),
                           lexicon.n_phones, tcfg, logger=logger, **kwargs)


def train_aed_bpe(batches: Sequence[FeatBatch], bpe, tcfg: TrainConfig, logger=None, **kwargs):
    """Lexicon-free AED on BPE units (words via ``bpe.decode``)."""
    return train_aed_units(batches, bpe.encode, bpe.n_units, tcfg, logger=logger, **kwargs)


def aed_model_for(n_units: int, tcfg: TrainConfig, feat_dim: int, device, chunk_frames: int = 0,
                  left_chunks: int = 1):
    """A fresh ``am.aed.build_aed_model``, its weights drawn from
    ``tcfg.seed``, on ``device``."""
    from mogasr_torch.am.aed import build_aed_model
    from mogasr_torch.am.params import init_

    model = build_aed_model(n_units, tcfg, feat_dim, chunk_frames=chunk_frames, left_chunks=left_chunks)
    return init_(model, torch.Generator().manual_seed(tcfg.seed)).to(device)


def train_aed_units(
    batches: Sequence[FeatBatch],
    encode_fn: Callable[[List[str]], List[int]],  # words -> unit ids
    n_units: int,
    tcfg: TrainConfig,
    ctc_weight: float = 0.3,
    smoothing: float = 0.1,
    steps: Optional[int] = None,
    chunk_frames: int = 0,
    left_chunks: int = 1,
    spec_augment: bool = False,
    logger=None,
):
    """The AED over any unit inventory -> (model, state_dict): ``steps``
    (default ``tcfg.num_nn_steps``) of ``am.aed.make_aed_train_step`` over
    the batches in turn, the auxiliary CTC loss on K3 on the card.
    ``chunk_frames > 0`` trains the streaming-capable chunked encoder."""
    from mogasr_torch.am import aed as A

    fb0 = batches[0]
    model = aed_model_for(n_units, tcfg, int(fb0.feats.shape[-1]), fb0.feats.device, chunk_frames, left_chunks)
    state = A.init_aed_train_state(model, tcfg)
    step_fn = A.make_aed_train_step(model, tcfg, ctc_weight=ctc_weight, smoothing=smoothing,
                                    spec_augment=spec_augment)
    labeled = _pack_ctc_targets(batches, encode_fn)
    total = steps if steps is not None else tcfg.num_nn_steps
    i = 0
    while i < total:
        for fb, labels, n_labels in labeled:
            state, m = step_fn(state, fb.feats, fb.n_frames, labels, n_labels)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "train_aed", "step": i, "loss": float(m["loss"])})
            if i >= total:
                break
    model.eval()
    return model, model.state_dict()


def finetune_aed_mwer(
    model: torch.nn.Module,
    batches: Sequence[FeatBatch],
    encode_fn: Callable[[List[str]], List[int]],
    tcfg: TrainConfig,
    n_hyps: int = 4,
    ce_weight: float = 0.1,
    steps: Optional[int] = None,
    logger=None,
):
    """On-policy MWER fine-tuning of a trained AED, in place: each step the
    beam's n_hyps-best (``am.aed.make_aed_decoder(return_all=True)``, a
    token budget of the longest reference + 2) against the current weights,
    host edit-distance risks (a repeated hypothesis counted once), one
    ``make_aed_mwer_step``. Returns (state_dict, history of the expected
    risk a step)."""
    from mogasr_torch.am import aed as A
    from mogasr_torch.eval.wer import edit_counts

    seqs_all = [[encode_fn(fb.words[b]) for b in range(fb.size)] for fb in batches]
    l_max = max((len(s) for seqs in seqs_all for s in seqs), default=1)
    u_max = l_max + 2
    labeled = [(fb, seqs, labels, n_labels)
               for (fb, labels, n_labels), seqs in zip(_pack_ctc_targets(batches, encode_fn), seqs_all)]
    dec = A.make_aed_decoder(model, beam=n_hyps, max_tokens=u_max, return_all=True)
    state = A.init_aed_train_state(model, tcfg)
    step_fn = A.make_aed_mwer_step(model, tcfg, ce_weight=ce_weight)
    total = steps if steps is not None else tcfg.num_nn_steps
    history: List[float] = []
    i = 0
    while i < total:
        for fb, seqs, labels, n_labels in labeled:
            model.eval()
            toks, n_toks, _sc = dec(fb.feats, fb.n_frames)
            toks, n_toks = toks.cpu().numpy(), n_toks.cpu().numpy()
            rows, N = toks.shape[0], toks.shape[1]
            hyps = np.full((rows, N, u_max), -1, np.int64)
            n_h = np.zeros((rows, N), np.int64)
            h_mask = np.zeros((rows, N), bool)
            risks = np.zeros((rows, N), np.float32)
            for b in range(fb.size):
                seen = set()
                for n in range(N):
                    h = tuple(int(t) for t in toks[b, n, : n_toks[b, n]])
                    if h in seen:
                        continue
                    seen.add(h)
                    hyps[b, n, : len(h)] = h
                    n_h[b, n] = len(h)
                    h_mask[b, n] = True
                    risks[b, n] = edit_counts(seqs[b], list(h)).errors
            dev = fb.feats.device
            state, m = step_fn(state, fb.feats, fb.n_frames, *(torch.as_tensor(a, device=dev)
                                                               for a in (hyps, n_h, h_mask, risks)), labels, n_labels)
            history.append(m["expected_risk"])
            i += 1
            if logger is not None and i % 10 == 0:
                logger.log({"stage": "mwer", "step": i, "expected_risk": history[-1]})
            if i >= total:
                break
    model.eval()
    return model.state_dict(), history


def decode_batch(
    fb: FeatBatch,
    scores: torch.Tensor,
    graph: gr.Graph,
    dcfg: DecodeConfig,
    drop_tokens: Tuple[str, ...] = DROP_TOKENS,
    *,
    use_kernels: bool = True,
    graphs: Optional[DecodeGraphs] = None,
    clock: Optional[StageClock] = None,
) -> List[List[str]]:
    """Viterbi-decode scored frames against a shared loop graph -> the token
    sequence of each utterance, ``drop_tokens`` left out: the reference's
    signature and return value. ``decode_batch_scored`` also returns the
    Viterbi scores."""
    return decode_batch_scored(fb, scores, graph, dcfg, drop_tokens, use_kernels=use_kernels, graphs=graphs,
                               clock=clock)[0]


def decode_batch_scored(
    fb: FeatBatch,
    scores: torch.Tensor,
    graph: gr.Graph,
    dcfg: DecodeConfig,
    drop_tokens: Tuple[str, ...] = DROP_TOKENS,
    *,
    use_kernels: bool = True,
    graphs: Optional[DecodeGraphs] = None,
    clock: Optional[StageClock] = None,
) -> Tuple[List[List[str]], List[float]]:
    """``decode_batch`` -> (token sequences, the Viterbi score of each
    utterance). K2 decodes, graphs with skip transitions included, unless
    ``use_kernels`` is False. ``graphs`` is ``decode_graphs(graph, B,
    scores.device)``, made per call when not given."""
    graphs_np, graphs_t = graphs or decode_graphs(graph, scores.shape[0], scores.device)
    decode = viterbi_cuda.viterbi if use_kernels else vit.viterbi
    with _stage(clock, "viterbi"):
        res = decode(scores, graphs_t, fb.n_frames, acoustic_scale=dcfg.acoustic_scale, beam=dcfg.beam)
    with _stage(clock, "tokens"):
        toks = vit.path_to_tokens(res, graph.labels, graphs_np["chain_id"])
        res_scores = res.score[: fb.size].tolist()
    return [[t for t in seq if t not in drop_tokens] for seq in toks[: fb.size]], res_scores


def decode_batch_lattices(
    fb: FeatBatch,
    scores: torch.Tensor,
    graph: gr.Graph,
    lm,
    dcfg: DecodeConfig,
    chain_entry_logp: Optional[np.ndarray] = None,
    prune_beam: Optional[float] = None,
):
    """First-pass LM decode + word-lattice materialization: the reference's
    signature and return value, (lattices, LmViterbiResult).

    ``decoder.lm_viterbi.viterbi_lm(..., with_lattice=True)`` runs on the
    device of ``scores``; its three [B, T, C] lattice arrays come to the host
    for ``decoder.lattice.lattices_from_pass``. Feed the lattices to
    ``lattice_nbest`` / ``rescore_lattice`` for N-best output or second-pass
    (e.g. trigram) rescoring."""
    from mogasr_torch.decoder.lattice import lattices_from_pass
    from mogasr_torch.decoder.lm_viterbi import viterbi_lm

    res, lattice = viterbi_lm(
        scores, graph, lm, fb.n_frames, acoustic_scale=dcfg.acoustic_scale,
        insertion_penalty=dcfg.word_insertion_penalty, chain_entry_logp=chain_entry_logp, with_lattice=True,
    )
    lat_sc, lat_st, lat_ba = (a.cpu().numpy() for a in lattice)
    lats = lattices_from_pass(lat_sc, lat_st, lat_ba, fb.n_frames.cpu().numpy(), graph.labels,
                              prune_beam=prune_beam)
    return lats[: fb.size], res


def _word_spans_and_posteriors(fb: FeatBatch, scores: torch.Tensor, graph: gr.Graph, dcfg: DecodeConfig,
                               use_kernels: bool):
    """The device work of ``decode_batch_with_confidence`` and
    ``decode_batch_nbest``: Viterbi (K2) and forward-backward (K3f/K3b) over
    the same loop graph, chain posteriors per frame. Returns, per utterance,
    the (chain, start frame, end frame) span of each word of the 1-best path
    (end exclusive), and the [B, T, C] chain posteriors on the host."""
    n_chains = int(np.max(graph.chain_id)) + 1
    _graphs_np, graphs = decode_graphs(graph, scores.shape[0], scores.device)
    decode = viterbi_cuda.viterbi if use_kernels else vit.viterbi
    posteriors = fb_cuda.forward_backward if use_kernels else fbd.forward_backward
    res = decode(scores, graphs, fb.n_frames, acoustic_scale=dcfg.acoustic_scale, beam=dcfg.beam)
    fbr = posteriors(scores, graphs, fb.n_frames, acoustic_scale=dcfg.acoustic_scale)
    chain_post = fbd.state_posteriors_to_pdf(fbr.log_gamma, graphs["chain_id"], n_chains).cpu().numpy()
    del fbr
    path = res.path.cpu().numpy()
    entered = res.entered.cpu().numpy()
    nf = fb.n_frames.cpu().numpy()
    spans: List[List[Tuple[int, int, int]]] = []
    for b in range(fb.size):
        row: List[Tuple[int, int, int]] = []
        for t in range(int(nf[b])):
            if entered[b, t]:
                if row:
                    row[-1] = (row[-1][0], row[-1][1], t)
                row.append((int(graph.chain_id[path[b, t]]), t, int(nf[b])))
        spans.append(row)
    return spans, chain_post


def decode_batch_with_confidence(
    fb: FeatBatch,
    scores: torch.Tensor,
    graph: gr.Graph,
    dcfg: DecodeConfig,
    drop_tokens: Tuple[str, ...] = DROP_TOKENS,
    with_times: bool = False,
    *,
    use_kernels: bool = True,
):
    """Viterbi decode + per-word posterior confidence: the reference's
    signature and return value.

    Confidence of a decoded word = its chain's posterior mass (from
    forward-backward over the SAME decode graph), averaged over the word's
    Viterbi time span. Returns [(word, confidence)] per utterance, or
    [(word, confidence, start_frame, end_frame)] with ``with_times=True``
    (end exclusive). K2 and K3f/K3b run unless ``use_kernels`` is False."""
    spans, chain_post = _word_spans_and_posteriors(fb, scores, graph, dcfg, use_kernels)
    out: List[List[tuple]] = []
    for b, row in enumerate(spans):
        words: List[tuple] = []
        for c, t0, t1 in row:
            label = graph.labels[c]
            if label in drop_tokens:
                continue
            conf = float(chain_post[b, t0:t1, c].mean()) if t1 > t0 else 0.0
            # f32 posteriors can overshoot 1 by ~1e-3
            conf = round(min(max(conf, 0.0), 1.0), 4)
            words.append((label, conf, t0, t1) if with_times else (label, conf))
        out.append(words)
    return out


def decode_batch_nbest(
    fb: FeatBatch,
    scores: torch.Tensor,
    graph: gr.Graph,
    dcfg: DecodeConfig,
    n_best: int = 5,
    min_posterior: float = 0.01,
    drop_tokens: Tuple[str, ...] = DROP_TOKENS,
    *,
    use_kernels: bool = True,
):
    """Confusion-network-style word alternatives per Viterbi time span: the
    reference's signature and return value.

    For each word span of the 1-best path, ranks all vocabulary chains by
    their average forward-backward posterior over the span. Returns per
    utterance: [{"best": word, "span": (t0, t1), "alternatives": [(word,
    posterior), ...]}]. K2 and K3f/K3b run unless ``use_kernels`` is False."""
    spans, chain_post = _word_spans_and_posteriors(fb, scores, graph, dcfg, use_kernels)
    out = []
    for b, row in enumerate(spans):
        words = []
        for c, t0, t1 in row:
            label = graph.labels[c]
            if label in drop_tokens or t1 <= t0:
                continue
            avg = chain_post[b, t0:t1].mean(axis=0)  # [C]
            order = np.argsort(-avg)[: max(n_best, 1)]
            alts = [
                (graph.labels[int(ci)], round(float(min(avg[ci], 1.0)), 4))
                for ci in order
                if avg[ci] >= min_posterior and graph.labels[int(ci)] not in drop_tokens
            ]
            words.append({"best": label, "span": (t0, t1), "alternatives": alts})
        out.append(words)
    return out


@dataclasses.dataclass
class CorpusResult:
    wer: float
    hyps: List[List[str]]          # lower-cased words per utterance, in batch order
    scores: List[float]            # Viterbi score per utterance, in batch order
    n_utts: int
    audio_seconds: float
    seconds: float                 # wall time of the whole decode
    stage_seconds: Dict[str, float]


def decode_corpus(
    utts: Sequence[Utterance],
    gmm: Union[GmmSet, Scorer],
    graph: gr.Graph,
    fcfg: FrontendConfig,
    dcfg: DecodeConfig,
    bcfg: BatchConfig,
    device: torch.device,
    compute_dtype: str = "bfloat16",
    use_kernels: bool = True,
    mode: str = "max",
    layout: str = "chunked",
) -> CorpusResult:
    """Decode a corpus and score its WER: the path ``bench.py`` times.

    Batches by length bucket, then per batch: front end, GMM scoring, Viterbi
    over the shared loop graph (with ``dcfg.beam``), ``path_to_tokens``.
    Scoring is in ``mode`` "max" by default (best component only: on the
    headline bundle it decodes exactly as the full mixture does,
    bench.py:42-48), or "sum"; ``compute_dtype`` "float32", "bfloat16" or
    "int8" (sum mode only, K5); ``layout`` "chunked" (K1) or "wide" (K1w):
    the port's form of bench.py's MOGASR_GMM_MODE / MOGASR_GMM_LAYOUT.
    Silence tokens are dropped and words lower-cased before ``corpus_wer``. Stage times (:class:`StageClock`):
    "host" is batching, building the front ends, graphs and kernel
    parameters, and copies to the device; "tokens" is ``path_to_tokens``,
    reading the scores back, and the WER.

    ``gmm`` may be a scorer (``make_nn_scorer``) instead: the hybrid path,
    whose "scoring" stage is the network; ``compute_dtype`` is then unused
    (the scorer has its precision) and ``use_kernels`` picks the Viterbi.
    """
    scorer = gmm if callable(gmm) else None
    clock = StageClock(device)
    start = time.perf_counter()
    with clock("host"):
        batches = list(make_batches(utts, bcfg, fcfg))
        frontends = frontends_for(batches, fcfg, device)
        graphs = decode_graphs(graph, bcfg.batch_size, device)
        params = (kernel_params(gmm, compute_dtype, layout, mode=mode)
                  if use_kernels and scorer is None else None)

    refs, hyps, scores = [], [], []
    for batch in batches:
        fb = featurize_batch(batch, frontends[batch.waves.shape[1]], device, clock)
        with clock("scoring"):
            if scorer is not None:
                ll = scorer(fb)
            else:
                ll = score_batch(fb.feats, gmm, use_kernels, compute_dtype, mode, params, layout)
        toks, batch_scores = decode_batch_scored(fb, ll, graph, dcfg, use_kernels=use_kernels, graphs=graphs,
                                                 clock=clock)
        with clock("tokens"):
            refs += [[w.lower() for w in words] for words in batch.words[: fb.size]]
            hyps += [[w.lower() for w in seq] for seq in toks]
            scores += batch_scores
    with clock("tokens"):
        wer, _counts = corpus_wer(refs, hyps)
    return CorpusResult(
        wer=wer, hyps=hyps, scores=scores, n_utts=len(refs),
        audio_seconds=sum(len(u[1]) for u in utts) / fcfg.sample_rate,
        seconds=time.perf_counter() - start, stage_seconds=clock.seconds,
    )


# --------------------------------------------------------------- GMM training


def build_align_graphs(
    batch_words: List[List[str]],
    lexicon: Lexicon,
    topo: Topology,
    j_bucket: int = 64,
    align_fn=None,
) -> Dict[str, np.ndarray]:
    """Batch align graphs, J padded up to a multiple of ``j_bucket``.

    align_fn(phone_ids) -> Graph overrides the monophone expansion (e.g. the
    context-dependent ``hmm.triphone.align_graph_cd``). Rows with no words
    (a batch's dummy rows) get a silence graph."""
    if align_fn is None:
        align_fn = lambda pids: gr.align_graph(topo, pids)  # noqa: E731
    gs = [
        align_fn(lexicon.words_to_phone_ids(w, oov="sil")) if w else align_fn([lexicon.sil_id])
        for w in batch_words
    ]
    j_max = max(g.n_states for g in gs)
    j_max = -(-j_max // j_bucket) * j_bucket
    return gr.batch_graphs(gs, j_max=j_max)


def align_batch(
    fb: FeatBatch,
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    acoustic_scale: float = 1.0,
    align_fn=None,
    use_kernels: bool = True,
    params: Optional[Params] = None,
    clock: Optional[StageClock] = None,
) -> Tuple[vit.ViterbiResult, torch.Tensor, Dict[str, torch.Tensor]]:
    """Force-align a featurized batch -> (result, pdf labels [B, T], graphs).

    Scoring is K1 in float32/sum mode (``params`` from
    ``gmm_cuda.kernel_params(gmm, "float32")``), alignment K2."""
    dev = fb.feats.device
    with _stage(clock, "host"):
        graphs = vit.graphs_to_torch(
            build_align_graphs(fb.words, lexicon, topo, align_fn=align_fn), dev)
    with _stage(clock, "scoring"):
        ll = score_batch(fb.feats, gmm, use_kernels, "float32", "sum", params)
    with _stage(clock, "align"):
        if use_kernels:  # K2 writes the pdfs in its backtrace
            res, labels = viterbi_cuda.align(ll, graphs, fb.n_frames, acoustic_scale=acoustic_scale)
        else:
            res = vit.viterbi(ll, graphs, fb.n_frames, acoustic_scale=acoustic_scale)
            labels = vit.path_to_pdfs(res, graphs)
    return res, labels, graphs


def flat_start(batches: Sequence[FeatBatch], lexicon: Lexicon, topo: Topology) -> GmmSet:
    """Uniform-alignment single-component init over monophone align graphs."""
    all_feats, all_labels = [], []
    for fb in batches:
        feats = fb.feats.cpu().numpy()
        nf = fb.n_frames.cpu().numpy()
        for b in range(fb.size):
            g = gr.align_graph(
                topo,
                lexicon.words_to_phone_ids(fb.words[b], oov="sil") if fb.words[b] else [lexicon.sil_id],
            )
            t = int(nf[b])
            if t == 0:
                continue
            all_feats.append(feats[b, :t])
            all_labels.append(em.uniform_alignment_labels(g.emit_id, g.n_states, t))
    return em.init_from_labels(np.concatenate(all_feats), np.concatenate(all_labels),
                               topo.n_pdfs, device=batches[0].feats.device)


def batch_stats(
    fb: FeatBatch,
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    mode: str = "viterbi",
    align_fn=None,
    n_pdfs: Optional[int] = None,
    use_kernels: bool = True,
    params: Optional[Params] = None,
    clock: Optional[StageClock] = None,
):
    """One batch's E-step -> (GmmStats, the alignment result, pdf labels).

    "viterbi": forced alignment (``align_batch``), then hard statistics; the
    result is a ViterbiResult and labels the [B, T] pdf per frame.
    "baum-welch": K1 float32/sum scores, forward-backward (K3f/K3b) over the
    align graphs, pdf posteriors (``n_pdfs`` of them), soft statistics with the
    forward log-likelihood of the rows that have frames; the result is an
    FBResult and labels None.
    """
    flat_feats = fb.feats.reshape(-1, fb.feats.shape[-1])
    if mode == "viterbi":
        res, labels, _ = align_batch(fb, gmm, lexicon, topo, align_fn=align_fn,
                                     use_kernels=use_kernels, params=params, clock=clock)
        with _stage(clock, "stats"):
            return em.accumulate_stats(gmm, flat_feats, labels.reshape(-1)), res, labels
    if mode != "baum-welch":
        raise ValueError(f"unknown EM mode {mode!r}")
    npdf = n_pdfs if n_pdfs is not None else topo.n_pdfs
    dev = fb.feats.device
    with _stage(clock, "host"):
        graphs = vit.graphs_to_torch(build_align_graphs(fb.words, lexicon, topo, align_fn=align_fn), dev)
    with _stage(clock, "scoring"):
        ll = score_batch(fb.feats, gmm, use_kernels, "float32", "sum", params)
    with _stage(clock, "align"):
        res = (fb_cuda.forward_backward if use_kernels else fbd.forward_backward)(ll, graphs, fb.n_frames)
    with _stage(clock, "stats"):
        post = fbd.state_posteriors_to_pdf(res.log_gamma, graphs["emit_id"], npdf)
        s = em.accumulate_stats_soft(gmm, flat_feats, post.reshape(-1, npdf))
        # dummy padding rows (n_frames == 0) have no forward loglik
        has_frames = fb.n_frames.to(dev) > 0
        s = s._replace(loglik=torch.where(has_frames, res.loglik, torch.zeros_like(res.loglik)).sum())
    return s, res, None


@dataclasses.dataclass
class TrainGmmResult:
    """Unpacks like a (gmm, history) pair. topo carries re-estimated
    transitions when reestimate_transitions=True; ``seconds`` and
    ``stage_seconds`` are the wall time of each EM iteration that ran (not
    those restored from a checkpoint) and its split over ``TRAIN_STAGES``;
    ``setup_seconds`` the host work before the first of them ("flat_start",
    "restore"; ``train_triphone`` adds "cd_stats", "tie" and "cd_init")."""

    gmm: GmmSet
    history: List[float]
    topo: Topology
    seconds: List[float] = dataclasses.field(default_factory=list)
    stage_seconds: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    setup_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iter__(self):
        return iter((self.gmm, self.history))


def em_fingerprint(gcfg: GmmConfig, mode: str) -> np.ndarray:
    """What an EM checkpoint must have been written for: [n_states,
    n_components, 0 for Viterbi EM or 1 for Baum-Welch]."""
    return np.asarray([gcfg.n_states, gcfg.n_components, 0 if mode == "viterbi" else 1])


def train_gmm(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    topo: Topology,
    gcfg: GmmConfig,
    tcfg: TrainConfig,
    logger=None,
    gmm: Optional[GmmSet] = None,
    mode: str = "viterbi",
    reestimate_transitions: bool = False,
    ckpt_dir: Optional[str] = None,
    align_fn=None,
    n_pdfs: Optional[int] = None,
) -> TrainGmmResult:
    """EM training with realignment and the mixture-splitting schedule.

    mode "viterbi": hard EM on forced-alignment labels (K1 float32/sum, K2);
    "baum-welch": soft EM on forward-backward posteriors (K1 float32/sum,
    K3f/K3b). Components double at the start of every 2nd iteration until
    ``gcfg.n_components`` (occupancy-gated by ``gcfg.min_split_occ``), so
    reaching K needs num_em_iters >= 2*ceil(log2(K)) + 1; a shorter schedule
    warns and returns fewer components. ``n_pdfs`` is the pdf count of the
    posteriors (the tied-triphone count with a CD ``align_fn``). The GMM goes
    to the kernel's layout once per iteration.

    ``ckpt_dir``: after each iteration the GMM, the history, K, the
    per-phone self-loop probabilities (all -1 when none were estimated) and
    ``em_fingerprint`` are saved there as step ``it + 1``
    (``utils.checkpoint``); a call that finds a step resumes after it (the
    ``gmm`` argument unused), applying the saved transitions, and raises
    ValueError if the step was written for another fingerprint. As in the
    reference, the occupancies that gate a split are not saved: a split in
    the first iteration after a resume is ungated.
    """
    if mode not in ("viterbi", "baum-welch"):
        raise ValueError(f"unknown EM mode {mode!r}")
    device = batches[0].feats.device
    history: List[float] = []
    setup: Dict[str, float] = {}
    start_it = 0
    last = ckpt.latest_step(ckpt_dir) if ckpt_dir is not None else None
    if last is not None:
        # preemption resume: the latest EM iteration saved (written atomically)
        t0 = time.perf_counter()
        state = ckpt.restore_checkpoint(ckpt_dir, step=last)
        fp, want = np.asarray(state.get("fingerprint", [-1, -1, -1])), em_fingerprint(gcfg, mode)
        if fp.size == 3 and not np.array_equal(fp, want):
            raise ValueError(
                f"EM checkpoint in {ckpt_dir} was written for a different config (saved "
                f"n_states/n_components/mode={fp.tolist()}, requested {want.tolist()}); use a fresh ckpt_dir")
        start_it = last
        history = [float(x) for x in state["history"]]
        g = state["gmm"]
        gmm = gmm_from_numpy(g["weights"], g["means"], g["vars"], device)
        probs = np.asarray(state.get("per_phone_self_prob", [-1.0]))
        if probs.size and float(probs.min()) >= 0.0:
            topo = topo.with_transitions(probs)
        setup["restore"] = time.perf_counter() - t0
        if logger:
            logger.log({"stage": "em_resume", "ckpt_dir": ckpt_dir, "step": last, "K": gmm.n_components,
                        "avg_loglik": history[-1]})
    elif gmm is None:
        t0 = time.perf_counter()
        gmm = flat_start(batches, lexicon, topo)
        setup["flat_start"] = time.perf_counter() - t0
    need = 2 * math.ceil(math.log2(max(gcfg.n_components, 1))) + 1
    if gcfg.n_components > gmm.n_components and tcfg.num_em_iters < need:
        msg = (f"num_em_iters={tcfg.num_em_iters} cannot reach n_components="
               f"{gcfg.n_components} (needs >= {need}); the final model will have fewer components")
        if logger:
            logger.log({"stage": "em_warning", "message": msg})
        else:
            warnings.warn(msg)
    npdf = n_pdfs if n_pdfs is not None else topo.n_pdfs
    pdf_to_phone = topo.pdf_to_phone()
    result = TrainGmmResult(gmm, history, topo, setup_seconds=setup)
    # state occupancies of the previous E-step, for gated splits; None on the
    # first iteration of a call (fresh or resumed)
    last_state_occ = None
    for it in range(start_it, tcfg.num_em_iters):
        clock = StageClock(device, TRAIN_STAGES)
        start = time.perf_counter()
        with clock("m_step"):
            if it > 0 and it % 2 == 0 and gmm.n_components < gcfg.n_components:
                gmm = em.split_components(gmm, perturb=gcfg.split_perturb, seed=it,
                                          state_occ=last_state_occ,
                                          min_frames_per_comp=gcfg.min_split_occ)
                if gmm.n_components > gcfg.n_components:
                    gmm = GmmSet(*(a[:, : gcfg.n_components] for a in gmm))
        with clock("host"):
            params = kernel_params(gmm, "float32")
        stats = None
        trans_paths, trans_pdfs = [], []
        for fb in batches:
            s, res, labels = batch_stats(fb, gmm, lexicon, topo, mode, align_fn, npdf,
                                         params=params, clock=clock)
            if reestimate_transitions and labels is not None:
                with clock("host"):
                    trans_paths.append(res.path.cpu().numpy())
                    trans_pdfs.append(labels.cpu().numpy())
            with clock("stats"):
                stats = s if stats is None else em.add_stats(stats, s)
        with clock("m_step"):
            gmm = em.m_step(gmm, stats, var_floor=gcfg.var_floor, weight_floor=gcfg.weight_floor)
            last_state_occ = stats.occ.sum(-1)
            avg_ll = float(stats.loglik) / max(float(stats.n_frames), 1.0)
        history.append(avg_ll)
        if reestimate_transitions and trans_paths:
            with clock("host"):
                # batches come from different T buckets: right-pad to the widest
                # with -1 (estimate_transitions stops at the first -1 per row)
                t_max = max(p.shape[1] for p in trans_paths)
                pad = lambda arrs: np.concatenate([  # noqa: E731
                    np.pad(a, ((0, 0), (0, t_max - a.shape[1])), constant_values=-1) for a in arrs])
                self_probs, _counts = em.estimate_transitions(
                    pad(trans_paths), pad(trans_pdfs), pdf_to_phone, lexicon.n_phones)
                topo = topo.with_transitions(self_probs)
        if logger:
            logger.log({"stage": "em", "iter": it, "K": gmm.n_components, "avg_loglik": avg_ll})
        if ckpt_dir is not None:
            with clock("host"):
                ckpt.save_checkpoint(ckpt_dir, {
                    "gmm": gmm._asdict(),
                    "history": history,
                    "K": gmm.n_components,
                    # float64, so that a resumed run rebuilds the same graphs
                    "per_phone_self_prob": (np.asarray(topo.per_phone_self_prob, np.float64)
                                            if topo.per_phone_self_prob
                                            else np.full(lexicon.n_phones, -1.0)),
                    "fingerprint": em_fingerprint(gcfg, mode),
                }, step=it + 1)
        result.seconds.append(time.perf_counter() - start)
        result.stage_seconds.append(clock.seconds)
    result.gmm, result.topo = gmm, topo
    return result


def evaluate(
    batches: Sequence[FeatBatch],
    gmm: Optional[GmmSet],
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    scorer: Optional[Scorer] = None,
    graph: Optional[gr.Graph] = None,
) -> Dict[str, float]:
    """Decode featurized batches and score their WER: the reference's
    signature.

    scorer: ``fb -> [B, T, n_pdfs]`` log-likelihoods (e.g. ``make_nn_scorer``)
    in place of the GMM, which may then be None; by default the GMM scores
    in float32/sum mode (K1 on the card). graph: a decode-graph override,
    e.g. the tied-triphone word loop (``hmm.triphone.word_loop_graph_cd``);
    the monophone word loop by default. Decoding is ``decode_batch``.
    """
    if graph is None:
        graph = word_decode_graph(lexicon, topo, dcfg)
    params = kernel_params(gmm, "float32") if scorer is None else None
    refs, hyps = [], []
    for fb in batches:
        if scorer is not None:
            scores = scorer(fb)
        else:
            scores = score_batch(fb.feats, gmm, compute_dtype="float32", mode="sum", params=params)
        out = decode_batch(fb, scores, graph, dcfg)
        refs += [[w.lower() for w in fb.words[b]] for b in range(fb.size)]
        hyps += [[w.lower() for w in seq] for seq in out]
    wer, counts = corpus_wer(refs, hyps)
    return {
        "wer": wer,
        "sub": counts.substitutions,
        "del": counts.deletions,
        "ins": counts.insertions,
        "ref_words": counts.ref_words,
        "n_utts": len(refs),
    }


# --------------------------------------------------------- tied triphones


def collect_cd_stats(
    batches: Sequence[FeatBatch],
    gmm_mono: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
) -> Dict[tuple, Tuple[float, np.ndarray, np.ndarray]]:
    """Monophone alignment -> {(l, c, r, k): (occ, sum_x, sum_xx)} per
    triphone state, float64, keyed in the order the states are first seen
    (batch, utterance, frame), as the reference's dict is:
    ``hmm.triphone.tie_states`` groups in that order.

    The alignment runs through ``align_batch`` (K1 float32/sum, then K2 on
    the card); only the [B, T] paths come back. The sums are ``np.add.at``
    over each batch's frames in frame order, which adds in index order, so
    they equal the reference's frame-by-frame sums bit for bit.
    """
    from mogasr_torch.hmm.triphone import contexts_of

    keys: Dict[tuple, int] = {}
    occ = np.zeros(0)
    sx = sxx = None
    params = kernel_params(gmm_mono, "float32")
    for fb in batches:
        res, _labels, _graphs = align_batch(fb, gmm_mono, lexicon, topo, params=params)
        paths = res.path.cpu().numpy()
        feats = fb.feats.cpu().numpy()
        nf = fb.n_frames.cpu().numpy()
        idx_parts, x_parts = [], []
        for b in range(fb.size):
            words = fb.words[b]
            pids = lexicon.words_to_phone_ids(words, oov="sil") if words else [lexicon.sil_id]
            g = gr.align_graph(topo, pids)
            ctxs = contexts_of(pids, lexicon.sil_id)
            # first graph state of each chain (phone instance)
            chain_start = np.zeros(len(pids), np.int64)
            new_chain = np.nonzero(g.chain_id[1:] != g.chain_id[:-1])[0] + 1
            chain_start[g.chain_id[new_chain]] = new_chain
            path = paths[b, : int(nf[b])]
            states, first = np.unique(path, return_index=True)
            key_of_state = np.full(g.n_states, -1, np.int64)
            for j in states[np.argsort(first)]:  # first-seen order
                ci = g.chain_id[j]
                key = (*ctxs[ci], int(j - chain_start[ci]))
                key_of_state[j] = keys.setdefault(key, len(keys))
            idx_parts.append(key_of_state[path])
            x_parts.append(feats[b, : int(nf[b])])
        if not idx_parts:
            continue
        if len(keys) > len(occ):
            grow = len(keys) - len(occ)
            D = feats.shape[-1]
            occ = np.concatenate([occ, np.zeros(grow)])
            sx = np.concatenate([sx if sx is not None else np.zeros((0, D)), np.zeros((grow, D))])
            sxx = np.concatenate([sxx if sxx is not None else np.zeros((0, D)), np.zeros((grow, D))])
        idx = np.concatenate(idx_parts)
        x = np.concatenate(x_parts).astype(np.float64)
        np.add.at(occ, idx, 1.0)
        np.add.at(sx, idx, x)
        np.add.at(sxx, idx, x ** 2)
    return {key: (float(occ[i]), sx[i], sxx[i]) for key, i in keys.items()}


def train_triphone(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    topo: Topology,
    gcfg: GmmConfig,
    tcfg: TrainConfig,
    gmm_mono: GmmSet,
    target_pdfs: int = 200,
    min_occ: float = 10.0,
    logger=None,
    mode: str = "viterbi",
):
    """Triphone recipe: mono align -> tie states -> init CD GMM -> CD EM.

    Returns (TiedTriphones, TrainGmmResult), the reference's pair; the
    result's ``setup_seconds`` holds "cd_stats" (``collect_cd_stats``), "tie"
    (``hmm.triphone.tie_states``) and "cd_init" (the one-component CD
    model). Decode with ``hmm.triphone.word_loop_graph_cd``.
    """
    from mogasr_torch.hmm import triphone as tri

    t0 = time.perf_counter()
    raw = collect_cd_stats(batches, gmm_mono, lexicon, topo)
    t1 = time.perf_counter()
    mean_stats = {k: (occ, (sx / max(occ, 1e-8)).astype(np.float64)) for k, (occ, sx, _sxx) in raw.items()}
    tied = tri.tie_states(topo, mean_stats, target_pdfs, min_occ=min_occ)
    t2 = time.perf_counter()

    # init 1-comp CD GMM from tied stats (unseen pdfs -> global stats)
    D = batches[0].feats.shape[-1]
    occ = np.zeros(tied.n_pdfs)
    sx = np.zeros((tied.n_pdfs, D))
    sxx = np.zeros((tied.n_pdfs, D))
    for (l, c, r, k), (o, s, ss) in raw.items():
        pdf = tied.pdf_of(l, c, r, k)
        occ[pdf] += o
        sx[pdf] += s
        sxx[pdf] += ss
        # backoff pdfs also absorb all their contexts' stats
        if c != lexicon.sil_id:
            bo = tied.backoff[(c, k)]
            if bo != pdf:
                occ[bo] += o
                sx[bo] += s
                sxx[bo] += ss
    g_occ = max(occ.sum(), 1e-8)
    g_mean = sx.sum(0) / g_occ
    g_var = np.maximum(sxx.sum(0) / g_occ - g_mean ** 2, gcfg.var_floor)
    means = np.where(occ[:, None] >= 1.0, sx / np.maximum(occ[:, None], 1e-8), g_mean)
    varis = np.where(
        occ[:, None] >= 2.0,
        np.maximum(sxx / np.maximum(occ[:, None], 1e-8) - means ** 2, gcfg.var_floor),
        g_var,
    )
    gmm_cd = gmm_from_numpy(np.ones((tied.n_pdfs, 1)), means[:, None, :], varis[:, None, :],
                            batches[0].feats.device)
    t3 = time.perf_counter()

    result = train_gmm(
        batches, lexicon, topo, dataclasses.replace(gcfg, n_states=tied.n_pdfs), tcfg, logger=logger,
        gmm=gmm_cd, mode=mode, align_fn=lambda pids: tri.align_graph_cd(tied, pids), n_pdfs=tied.n_pdfs,
    )
    result.setup_seconds.update(cd_stats=t1 - t0, tie=t2 - t1, cd_init=t3 - t2)
    return tied, result


# ------------------------------------------------------- speaker adaptation
#
# The adaptation half of the reference's pipeline: two-pass decoding with
# per-speaker fMLLR, MLLR or VTLN, speaker-adaptive training, semi-tied
# covariance, splice + LDA (+ MLLT), i-vector features. Every decode and
# alignment is ``decode_batch`` / ``align_batch`` (K1 float32/sum, then K2's
# word-loop arm or its chain arm on the card; ``use_kernels=False`` runs the
# plain versions); the statistics accumulate on the device of the features
# (``am.aligned``), the transforms are solved on the host. Beyond the
# reference's arguments the two-pass decodes take, keyword-only, the decode
# ``graph`` and the ``align_fn`` of the hypothesis alignment (defaults: the
# monophone word loop and align graphs, as the reference builds them; a
# tied-triphone system passes ``hmm.triphone.word_loop_graph_cd`` and
# ``align_graph_cd``), ``use_kernels``, and ``report``: a dict they fill
# with the pass-1 hypotheses ("hyps1"), each utterance's pass-1 alignment
# ("labels1", numpy pdfs of its frames) and the wall seconds of each pass
# ("seconds": pass1, align, estimate, pass2; VTLN also "loglik", each
# speaker's aligned log-likelihood at each warp).


def _default_speaker_of(uid: str) -> str:
    """The reference's default: the utt-id prefix before the first '-'."""
    return uid.split("-")[0] if "-" in uid else "global"


def _wall(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _rows_by_speaker(fb: FeatBatch, speaker_of) -> Dict[str, List[int]]:
    by_spk: Dict[str, List[int]] = {}
    for b in range(fb.size):
        by_spk.setdefault(speaker_of(fb.utt_ids[b]), []).append(b)
    return by_spk


def _hyp_batch(fb: FeatBatch, hyps: Dict[str, List[str]]) -> FeatBatch:
    """``fb`` with its pass-1 hypotheses as transcripts (empty hypotheses
    align to silence)."""
    hyp_words = [hyps.get(uid, []) for uid in fb.utt_ids]
    hyp_words += [[]] * (len(fb.words) - len(hyp_words))
    return FeatBatch(fb.utt_ids, fb.feats, fb.n_frames, hyp_words)


def _first_pass(batches, gmm, lexicon, topo, dcfg, graph, align_fn, use_kernels, report):
    """Pass 1 (decode) and the alignment of its hypotheses -> (hyps1,
    [labels [B, T] per batch])."""
    dev = batches[0].feats.device
    params = kernel_params(gmm, "float32") if use_kernels else None
    t0 = _wall(dev)
    hyps1: Dict[str, List[str]] = {}
    for fb in batches:
        scores = score_batch(fb.feats, gmm, use_kernels, params=params)
        out = decode_batch(fb, scores, graph, dcfg, use_kernels=use_kernels)
        for b in range(fb.size):
            hyps1[fb.utt_ids[b]] = out[b]
    t1 = _wall(dev)
    labels_per_batch = []
    for fb in batches:
        _res, labels, _ = align_batch(_hyp_batch(fb, hyps1), gmm, lexicon, topo, align_fn=align_fn,
                                      use_kernels=use_kernels, params=params)
        labels_per_batch.append(labels)
    t2 = _wall(dev)
    if report is not None:
        report["hyps1"] = hyps1
        report["labels1"] = {}
        for fb, labels in zip(batches, labels_per_batch):
            lab, nf = labels.cpu().numpy(), fb.n_frames.cpu().numpy()
            for b in range(fb.size):
                report["labels1"][fb.utt_ids[b]] = lab[b, : int(nf[b])]
        report["seconds"] = {"pass1": t1 - t0, "align": t2 - t1}
    return hyps1, labels_per_batch


def _speaker_stats(batches, labels_per_batch, speaker_of, accumulate, add):
    """{speaker: statistics}, one ``accumulate(feats [N, D], labels [N])``
    per (batch, speaker) group of rows, summed over batches in order."""
    stats_by_spk: Dict[str, object] = {}
    for fb, labels in zip(batches, labels_per_batch):
        D = fb.feats.shape[-1]
        for spk, rows in _rows_by_speaker(fb, speaker_of).items():
            idx = torch.as_tensor(rows, device=fb.feats.device)
            s = accumulate(fb.feats[idx].reshape(-1, D), labels.to(fb.feats.device)[idx].reshape(-1))
            prev = stats_by_spk.get(spk)
            stats_by_spk[spk] = s if prev is None else add(prev, s)
    return stats_by_spk


def decode_with_fmllr(
    batches: Sequence[FeatBatch],
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    speaker_of=None,
    n_sweeps: int = 8,
    si_gmm: Optional[GmmSet] = None,
    *,
    graph: Optional[gr.Graph] = None,
    align_fn=None,
    use_kernels: bool = True,
    report: Optional[dict] = None,
):
    """Unsupervised two-pass decoding with per-speaker fMLLR adaptation: the
    reference's signature and return value, (hyps_pass2, {speaker: W}).

    Pass 1 decodes with the speaker-independent model; the hypotheses are
    force-aligned to get frame labels; per-speaker fMLLR statistics
    accumulate on the device (``am.fmllr``), one call per (batch, speaker)
    group, and the transforms are solved on the host; pass 2 re-decodes the
    adapted features (one batched product per batch, the identity for
    padding rows). speaker_of(utt_id) groups utterances (default: the
    utt-id prefix before the first '-'; one group if absent). With a SAT
    model (``train_sat``) pass ``si_gmm`` = the speaker-independent model:
    pass 1 and the hypothesis alignment use it, the transforms and pass 2
    target ``gmm``.
    """
    from mogasr_torch.am import fmllr as fm

    speaker_of = speaker_of or _default_speaker_of
    first = si_gmm if si_gmm is not None else gmm
    graph = graph if graph is not None else word_decode_graph(lexicon, topo, dcfg)
    dev = batches[0].feats.device

    hyps1, labels_per_batch = _first_pass(batches, first, lexicon, topo, dcfg, graph, align_fn, use_kernels, report)
    t0 = _wall(dev)
    stats_by_spk = _speaker_stats(batches, labels_per_batch, speaker_of,
                                  lambda x, y: fm.accumulate_fmllr_stats(gmm, x, y), fm.add_fmllr_stats)
    transforms = {spk: fm.solve_fmllr(st, n_sweeps=n_sweeps) for spk, st in stats_by_spk.items()}
    t1 = _wall(dev)

    params = kernel_params(gmm, "float32") if use_kernels else None
    hyps2: Dict[str, List[str]] = {}
    for fb in batches:
        fb2 = _apply_fmllr_batch(fb, transforms, speaker_of)
        scores = score_batch(fb2.feats, gmm, use_kernels, params=params)
        out = decode_batch(fb2, scores, graph, dcfg, use_kernels=use_kernels)
        for b in range(fb.size):
            hyps2[fb.utt_ids[b]] = out[b]
    if report is not None:
        report["seconds"].update(estimate=t1 - t0, pass2=_wall(dev) - t1)
    return hyps2, transforms


def _apply_fmllr_batch(fb: FeatBatch, transforms, speaker_of):
    """Per-utterance affine feature transform in one batched product; rows
    past fb.size (batch padding) and speakers without a transform get the
    identity."""
    D = fb.feats.shape[-1]
    eye = np.concatenate([np.eye(D, dtype=np.float32), np.zeros((D, 1), np.float32)], axis=1)
    Wb = np.stack([
        np.asarray(transforms.get(speaker_of(fb.utt_ids[bi]), eye), np.float32) if bi < fb.size else eye
        for bi in range(fb.feats.shape[0])
    ])  # [B, D, D+1]
    Wt = torch.as_tensor(Wb, device=fb.feats.device)
    feats_t = torch.einsum("btd,bed->bte", fb.feats, Wt[:, :, :-1]) + Wt[:, None, :, -1]
    return FeatBatch(fb.utt_ids, feats_t, fb.n_frames, fb.words)


def train_sat(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    topo: Topology,
    gcfg: GmmConfig,
    gmm: GmmSet,
    speaker_of=None,
    n_iters: int = 4,
    n_sweeps: int = 8,
    align_fn=None,
    logger=None,
    *,
    use_kernels: bool = True,
):
    """Speaker-adaptive training (SAT): fMLLR inside the EM loop. Returns
    (gmm, transforms, history), the reference's triple.

    Each iteration (1) force-aligns the speaker-transformed features with the
    current model (K1 float32/sum, K2's chain arm), (2) re-estimates
    per-speaker fMLLR transforms from those alignments against the RAW
    features, (3) runs one EM step (``em.accumulate_stats``, sorted segment
    sums) on the re-transformed features. The monitored log-likelihood is
    the raw-feature likelihood under (model, transform): the alignment score
    in the transformed space plus log|det A| per frame. On the card two runs
    give the same transforms bit for bit.
    """
    from mogasr_torch.am import fmllr as fm

    speaker_of = speaker_of or _default_speaker_of
    transforms: Dict[str, np.ndarray] = {}
    history: List[float] = []
    for it in range(n_iters):
        labels_per_batch = []
        loglik_sum, frames_sum = 0.0, 0
        logdet = {spk: float(np.linalg.slogdet(np.asarray(W)[:, :-1])[1]) for spk, W in transforms.items()}
        params = kernel_params(gmm, "float32") if use_kernels else None
        for fb in batches:
            fb_t = _apply_fmllr_batch(fb, transforms, speaker_of)
            res, labels, _ = align_batch(fb_t, gmm, lexicon, topo, align_fn=align_fn, use_kernels=use_kernels,
                                         params=params)
            labels_per_batch.append(labels)
            nf = fb.n_frames.cpu().numpy()
            valid = nf > 0
            loglik_sum += float(res.score.cpu().numpy()[valid].sum())
            loglik_sum += sum(logdet.get(speaker_of(uid), 0.0) * int(n) for uid, n in zip(fb.utt_ids, nf))
            frames_sum += int(nf[valid].sum())
        history.append(loglik_sum / max(frames_sum, 1))

        stats_by_spk = _speaker_stats(batches, labels_per_batch, speaker_of,
                                      lambda x, y: fm.accumulate_fmllr_stats(gmm, x, y), fm.add_fmllr_stats)
        transforms = {spk: fm.solve_fmllr(st, n_sweeps=n_sweeps) for spk, st in stats_by_spk.items()}

        stats = None
        for fb, labels in zip(batches, labels_per_batch):
            fb_t = _apply_fmllr_batch(fb, transforms, speaker_of)
            s = em.accumulate_stats(gmm, fb_t.feats.reshape(-1, fb_t.feats.shape[-1]), labels.reshape(-1))
            stats = s if stats is None else em.add_stats(stats, s)
        gmm = em.m_step(gmm, stats, var_floor=gcfg.var_floor, weight_floor=gcfg.weight_floor)
        if logger:
            logger.log({"stage": "sat", "iter": it, "avg_loglik": history[-1]})
    return gmm, transforms, history


def estimate_stc_batches(
    batches: Sequence[FeatBatch],
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    n_iters: int = 10,
    *,
    align_fn=None,
    use_kernels: bool = True,
):
    """A global semi-tied covariance transform from forced alignments of the
    batches (``am.stc``): the reference's (A, vars_y, gmm_y,
    transform_batches), where gmm_y scores the A-transformed features and
    transform_batches maps FeatBatches into that space."""
    from mogasr_torch.am import stc as st
    from mogasr_torch.am.fmllr import apply_fmllr

    params = kernel_params(gmm, "float32") if use_kernels else None
    stats = None
    for fb in batches:
        _res, labels, _ = align_batch(fb, gmm, lexicon, topo, align_fn=align_fn, use_kernels=use_kernels,
                                      params=params)
        D = fb.feats.shape[-1]
        s = st.accumulate_stc_stats(gmm, fb.feats.reshape(-1, D), labels.reshape(-1))
        stats = s if stats is None else st.add_stc_stats(stats, s)
    A, vars_y = st.solve_stc(gmm, stats, n_iters=n_iters)
    gmm_y = st.apply_stc(gmm, A, vars_y)
    W = st.stc_feature_transform(A)

    def transform_batches(bs: Sequence[FeatBatch]) -> List[FeatBatch]:
        return [FeatBatch(fb.utt_ids, apply_fmllr(fb.feats, W), fb.n_frames, fb.words) for fb in bs]

    return A, vars_y, gmm_y, transform_batches


@dataclasses.dataclass
class LdaMlltResult:
    """A trained LDA(+MLLT)-space system: ``gmm`` scores features produced by
    splicing base (delta-free) features +-context frames and applying the
    single affine ``transform`` [lda_dim, (2*context+1)*base_dim + 1]."""

    gmm: GmmSet
    transform: np.ndarray
    context: int
    base_fcfg: FrontendConfig
    history: List[float]
    topo: Topology

    def transform_featbatches(self, bs: Sequence[FeatBatch]) -> List[FeatBatch]:
        from mogasr_torch.am import lda as ld
        from mogasr_torch.am.fmllr import apply_fmllr

        return [
            FeatBatch(fb.utt_ids, apply_fmllr(ld.splice_frames(fb.feats, fb.n_frames, self.context),
                                              self.transform), fb.n_frames, fb.words)
            for fb in bs
        ]

    def featurize(self, utts: Sequence[Utterance], bcfg: BatchConfig) -> List[FeatBatch]:
        """The system's features on the device of its GMM."""
        return self.transform_featbatches(featurize(utts, self.base_fcfg, bcfg, self.gmm.means.device))


def train_lda_mllt(
    utts: Sequence[Utterance],
    lexicon: Lexicon,
    topo: Topology,
    fcfg: FrontendConfig,
    bcfg: BatchConfig,
    gcfg: GmmConfig,
    tcfg: TrainConfig,
    boot_gmm: GmmSet,
    boot_fcfg: Optional[FrontendConfig] = None,
    context: int = 3,
    lda_dim: int = 40,
    mllt: bool = True,
    mllt_iters: int = 8,
    mode: str = "viterbi",
    logger=None,
    *,
    use_kernels: bool = True,
) -> LdaMlltResult:
    """Kaldi tri2b-shaped recipe: splice -> LDA -> GMM EM (-> MLLT), on the
    device of ``boot_gmm``.

    ``boot_gmm`` (trained on ``boot_fcfg`` features, default ``fcfg``)
    supplies forced-alignment class labels; LDA statistics are the
    class-conditional scatters of the spliced delta-free base features; a
    fresh GMM trains from flat start in the projected space (``train_gmm``);
    optional MLLT (``estimate_stc_batches``) re-rotates it, composes into the
    single returned affine transform, and 2 EM iterations refit the model in
    the rotated space.
    """
    from mogasr_torch.am import lda as ld
    from mogasr_torch.am.fmllr import apply_fmllr

    dev = boot_gmm.means.device
    boot_fcfg = boot_fcfg or fcfg
    base_fcfg = dataclasses.replace(fcfg, delta_order=0)
    batches_boot = featurize(utts, boot_fcfg, bcfg, dev)
    batches_base = featurize(utts, base_fcfg, bcfg, dev)

    n_classes = boot_gmm.means.shape[0]
    params = kernel_params(boot_gmm, "float32") if use_kernels else None
    stats = None
    spliced_all: List[torch.Tensor] = []
    for fb_boot, fb_base in zip(batches_boot, batches_base):
        if fb_boot.utt_ids != fb_base.utt_ids:
            raise RuntimeError("boot/base featurization batch order diverged")
        _res, labels, _ = align_batch(fb_boot, boot_gmm, lexicon, topo, use_kernels=use_kernels, params=params)
        spliced = ld.splice_frames(fb_base.feats, fb_base.n_frames, context)
        spliced_all.append(spliced)
        ds = spliced.shape[-1]
        s = ld.accumulate_lda_stats(spliced.reshape(-1, ds), labels.reshape(-1), n_classes)
        stats = s if stats is None else ld.add_lda_stats(stats, s)
    w_lda = ld.solve_lda(stats, lda_dim)

    lda_batches = [FeatBatch(fb.utt_ids, apply_fmllr(spl, w_lda), fb.n_frames, fb.words)
                   for fb, spl in zip(batches_base, spliced_all)]
    res = train_gmm(lda_batches, lexicon, topo, gcfg, tcfg, logger=logger, mode=mode)
    gmm_lda, history, topo_out = res.gmm, res.history, res.topo

    transform = w_lda
    gmm_out = gmm_lda
    if mllt:
        from mogasr_torch.am.stc import stc_feature_transform

        a_mllt, _vars_y, gmm_y, tb = estimate_stc_batches(lda_batches, gmm_lda, lexicon, topo_out,
                                                          n_iters=mllt_iters, use_kernels=use_kernels)
        transform = ld.compose_affine(stc_feature_transform(a_mllt), w_lda)
        # refit means/weights in the rotated space (the scatter-derived
        # variances alone are noisy on small data)
        res2 = train_gmm(tb(lda_batches), lexicon, topo_out,
                         dataclasses.replace(gcfg, n_components=gmm_y.n_components),
                         dataclasses.replace(tcfg, num_em_iters=2), gmm=gmm_y, logger=logger, mode=mode)
        gmm_out = res2.gmm
        history = history + res2.history
    return LdaMlltResult(gmm_out, transform, context, base_fcfg, history, topo_out)


def _aligned_loglik_sum(gmm: GmmSet, feats: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum over valid frames of log p(x_t | pdf label_t): the VTLN warp
    selection objective (labels == -1 rows are padding), in frame chunks."""
    from mogasr_torch.am.aligned import component_loglik, frame_chunks, gather_bytes

    labels = labels.to(feats.device)
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for a, b in frame_chunks(feats.shape[0], gather_bytes(gmm)):
        ll_k, valid, _mu, _var = component_loglik(gmm, feats[a:b], labels[a:b])
        ll = torch.logsumexp(ll_k, dim=-1)
        total += torch.where(valid, ll, torch.zeros_like(ll)).sum()
    return total


def decode_with_vtln(
    utts: Sequence[Utterance],   # (id, wave, words)
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    fcfg: FrontendConfig,
    bcfg: BatchConfig,
    dcfg: DecodeConfig,
    warps: Sequence[float] = (0.88, 0.92, 0.96, 1.0, 1.04, 1.08, 1.12),
    speaker_of=None,
    *,
    graph: Optional[gr.Graph] = None,
    align_fn=None,
    use_kernels: bool = True,
    report: Optional[dict] = None,
):
    """Unsupervised two-pass decoding with per-speaker VTLN warp selection,
    on the device of ``gmm``: the reference's signature and return value,
    (hyps_pass2, {speaker: warp}).

    Pass 1 decodes unwarped; hypotheses are force-aligned to frame labels;
    for each candidate warp the audio is featurized again through the warped
    mel filterbank (framing is warp-invariant, so the labels transfer) and
    each speaker's aligned log-likelihood summed; each speaker takes its
    argmax warp for the pass-2 decode.
    """
    speaker_of = speaker_of or _default_speaker_of
    graph = graph if graph is not None else word_decode_graph(lexicon, topo, dcfg)
    dev = gmm.means.device
    base_batches = featurize(utts, fcfg, bcfg, dev)
    _hyps1, labels_per_batch = _first_pass(base_batches, gmm, lexicon, topo, dcfg, graph, align_fn, use_kernels,
                                           report)
    labels_by_utt: Dict[str, torch.Tensor] = {}
    for fb, labels in zip(base_batches, labels_per_batch):
        for b in range(fb.size):
            labels_by_utt[fb.utt_ids[b]] = labels[b]

    t0 = _wall(dev)
    ll_by_spk: Dict[str, Dict[float, float]] = {}
    for warp in warps:
        wcfg = dataclasses.replace(fcfg, vtln_warp=float(warp))
        for fb in featurize(utts, wcfg, bcfg, dev):
            D = fb.feats.shape[-1]
            for spk, rows in _rows_by_speaker(fb, speaker_of).items():
                idx = torch.as_tensor(rows, device=dev)
                labs = torch.stack([labels_by_utt[fb.utt_ids[b]] for b in rows]).reshape(-1)
                ll = float(_aligned_loglik_sum(gmm, fb.feats[idx].reshape(-1, D), labs))
                ll_by_spk.setdefault(spk, {})
                ll_by_spk[spk][warp] = ll_by_spk[spk].get(warp, 0.0) + ll
    best_warp = {spk: max(lls, key=lls.get) for spk, lls in ll_by_spk.items()}
    t1 = _wall(dev)

    params = kernel_params(gmm, "float32") if use_kernels else None
    hyps2: Dict[str, List[str]] = {}
    for warp in sorted(set(best_warp.values())):
        wcfg = dataclasses.replace(fcfg, vtln_warp=float(warp))
        w_utts = [u for u in utts if best_warp[speaker_of(u[0])] == warp]
        for fb in featurize(w_utts, wcfg, bcfg, dev):
            out = decode_batch(fb, score_batch(fb.feats, gmm, use_kernels, params=params), graph, dcfg,
                               use_kernels=use_kernels)
            for b in range(fb.size):
                hyps2[fb.utt_ids[b]] = out[b]
    if report is not None:
        report["loglik"] = ll_by_spk
        report["seconds"].update(estimate=t1 - t0, pass2=_wall(dev) - t1)
    return hyps2, best_warp


def decode_with_mllr(
    batches: Sequence[FeatBatch],
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    speaker_of=None,
    min_occ: float = 1.0,
    *,
    graph: Optional[gr.Graph] = None,
    align_fn=None,
    use_kernels: bool = True,
    report: Optional[dict] = None,
):
    """Unsupervised two-pass decoding with per-speaker mean-MLLR adaptation:
    the reference's signature and return value, (hyps_pass2, {speaker: W}).

    Pass 1 decodes with the speaker-independent GMM, hypotheses are
    force-aligned, a global mean transform mu' = A mu + b is solved in closed
    form per speaker (``am.mllr``: statistics on the device, solve on the
    host), and pass 2 re-decodes with each speaker's adapted model: as in the
    reference, one scoring and one decode of the whole batch per (batch,
    speaker in it), the other speakers' rows discarded.
    """
    from mogasr_torch.am import mllr as ml

    speaker_of = speaker_of or _default_speaker_of
    graph = graph if graph is not None else word_decode_graph(lexicon, topo, dcfg)
    dev = batches[0].feats.device

    _hyps1, labels_per_batch = _first_pass(batches, gmm, lexicon, topo, dcfg, graph, align_fn, use_kernels, report)
    t0 = _wall(dev)
    stats_by_spk = _speaker_stats(batches, labels_per_batch, speaker_of,
                                  lambda x, y: ml.accumulate_mllr_stats(gmm, x, y), ml.add_mllr_stats)
    transforms = {spk: ml.solve_mllr(gmm, st, min_occ=min_occ) for spk, st in stats_by_spk.items()}
    adapted = {spk: ml.apply_mllr(gmm, W) for spk, W in transforms.items()}
    params = {spk: kernel_params(g, "float32") if use_kernels else None for spk, g in adapted.items()}
    t1 = _wall(dev)

    hyps2: Dict[str, List[str]] = {}
    for fb in batches:
        graphs = decode_graphs(graph, fb.feats.shape[0], dev)
        for spk, rows in _rows_by_speaker(fb, speaker_of).items():
            scores = score_batch(fb.feats, adapted[spk], use_kernels, params=params[spk])
            out = decode_batch(fb, scores, graph, dcfg, use_kernels=use_kernels, graphs=graphs)
            for b in rows:
                hyps2[fb.utt_ids[b]] = out[b]
    if report is not None:
        report["seconds"].update(estimate=t1 - t0, pass2=_wall(dev) - t1)
    return hyps2, transforms


def append_ivectors(
    batches: Sequence[FeatBatch],
    extractor,
    length_norm: bool = True,
) -> List[FeatBatch]:
    """Speaker-aware features: each utterance's i-vector
    (``am.ivector.IvectorExtractor``) concatenated to every frame (feat_dim
    grows by extractor.rank; decode with the same extractor)."""
    from mogasr_torch.am.ivector import utterance_ivectors

    out = []
    for fb in batches:
        vecs = utterance_ivectors(extractor, fb.feats, fb.n_frames, length_norm=length_norm)
        tiled = torch.as_tensor(vecs, device=fb.feats.device)[:, None, :].expand(
            fb.feats.shape[0], fb.feats.shape[1], vecs.shape[-1])
        out.append(dataclasses.replace(fb, feats=torch.cat([fb.feats, tiled], dim=-1)))
    return out

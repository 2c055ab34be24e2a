"""Pipeline in PyTorch: the port of the serving and GMM training paths of
mogasr/pipeline.py.

Decoding: featurize -> score_batch -> Viterbi -> path_to_tokens -> WER, on
padded length-bucketed batches (``data.batching``). ``decode_corpus`` runs
the whole path over a corpus, as ``bench.py`` does for the reference. The
hybrid NN-HMM path scores with a neural frame classifier instead
(``make_nn_scorer``: prior-scaled log-posteriors) and decodes the same way.

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
``decode_corpus``, ``make_nn_scorer``, ``align_batch`` and ``batch_stats``
take ``use_kernels=False`` to run the plain versions on any device, which is
how the kernel path is checked against them on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

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


def frontends_for(batches: Sequence[Batch], fcfg: FrontendConfig, device: torch.device) -> Dict[int, Frontend]:
    """One front end per bucket width (samples) among ``batches``."""
    if fcfg.add_pitch:
        raise NotImplementedError("add_pitch is not ported to mogasr_torch yet")
    return {w: make_frontend(fcfg, w, device) for w in sorted({b.waves.shape[1] for b in batches})}


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
    batches = list(make_batches(utts, bcfg, fcfg))
    frontends = frontends_for(batches, fcfg, device)
    return [featurize_batch(b, frontends[b.waves.shape[1]], device) for b in batches]


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

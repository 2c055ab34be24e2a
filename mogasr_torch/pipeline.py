"""Decode pipeline in PyTorch: the port of the serving path of mogasr/pipeline.py.

featurize -> score_batch -> Viterbi -> path_to_tokens -> WER, on padded
length-bucketed batches (``mogasr.data.batching``). ``decode_corpus`` runs
the whole path over a corpus, as ``bench.py`` does for the reference.

Device dispatch is by the tensor: on a CUDA device the scorer and the
decoder are the hand-written kernels (``am.gmm_cuda``,
``decoder.viterbi_cuda``); on the CPU they are the plain versions.
``use_kernels=False`` runs the plain versions on any device, which is how
the kernel path is checked against them on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mogasr.config import BatchConfig, DecodeConfig, FrontendConfig
from mogasr.data.batching import Batch, make_batches
from mogasr.eval.wer import corpus_wer
from mogasr.hmm import graph as gr
from mogasr.hmm.lexicon import Lexicon
from mogasr.hmm.topology import Topology
from mogasr_torch.am.gmm import GmmSet, gmm_loglik
from mogasr_torch.am.gmm_cuda import KernelParams, gmm_loglik_batched, kernel_params
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.decoder import viterbi_cuda
from mogasr_torch.frontend.torch_frontend import make_frontend

Utterance = Tuple[str, np.ndarray, List[str]]  # (id, wave, words)
Frontend = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
DecodeGraphs = Tuple[Dict[str, np.ndarray], Dict[str, torch.Tensor]]  # batch_graphs, on the device
DROP_TOKENS = ("<sil>", "sil")
STAGES = ("host", "frontend", "scoring", "viterbi", "tokens")


class StageClock:
    """Wall seconds per stage of the decode path.

    ``with clock("scoring"): ...`` adds the block's time to that stage; the
    device is synchronised at the end of each block, so a stage's time
    includes the device work it queued.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = dict.fromkeys(STAGES, 0.0)

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
    params: Optional[KernelParams] = None,
) -> torch.Tensor:
    """[B, T, D] -> [B, T, S]: the CUDA kernel on the card, the plain scorer
    on the CPU or with ``use_kernels=False``. ``params`` is the GMM in the
    kernel's layout (``gmm_cuda.kernel_params``), made per call when not given."""
    if use_kernels:
        return gmm_loglik_batched(feats, gmm, compute_dtype=compute_dtype, mode=mode, params=params)
    B, T, D = feats.shape
    return gmm_loglik(
        feats.reshape(B * T, D), gmm, mode=mode, compute_dtype=compute_dtype
    ).reshape(B, T, -1)


def word_decode_graph(
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    word_logp: Optional[np.ndarray] = None,
) -> gr.Graph:
    """Word-loop decode graph over the full vocabulary + a silence chain."""
    tokens = [(w, lexicon.word_phone_ids(w)) for w in lexicon.words]
    tokens.append(("<sil>", [lexicon.sil_id]))
    if word_logp is None:
        word_logp = np.full(len(tokens), -np.log(len(lexicon.words) + 1), np.float32)
    return gr.loop_graph(
        topo, tokens=tokens, token_logp=word_logp,
        insertion_penalty=dcfg.word_insertion_penalty,
    )


def decode_graphs(graph: gr.Graph, batch_size: int, device: torch.device) -> DecodeGraphs:
    """A shared loop graph stacked for a batch: numpy arrays and tensors on ``device``."""
    graphs_np = gr.batch_graphs([graph] * batch_size)
    return graphs_np, vit.graphs_to_torch(graphs_np, device)


def decode_batch(
    fb: FeatBatch,
    scores: torch.Tensor,
    graph: gr.Graph,
    dcfg: DecodeConfig,
    use_kernels: bool = True,
    drop_tokens: Tuple[str, ...] = DROP_TOKENS,
    graphs: Optional[DecodeGraphs] = None,
    clock: Optional[StageClock] = None,
) -> Tuple[List[List[str]], List[float]]:
    """Viterbi-decode scored frames against a shared loop graph.

    Returns the token sequences and the Viterbi score of each utterance.
    ``graphs`` is ``decode_graphs(graph, B, scores.device)``, made per call
    when not given.
    """
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
    gmm: GmmSet,
    graph: gr.Graph,
    fcfg: FrontendConfig,
    dcfg: DecodeConfig,
    bcfg: BatchConfig,
    device: torch.device,
    compute_dtype: str = "bfloat16",
    use_kernels: bool = True,
) -> CorpusResult:
    """Decode a corpus and score its WER: the path ``bench.py`` times.

    Batches by length bucket, then per batch: front end, GMM scoring in
    max mode (best component only: on the headline bundle it decodes exactly
    as the full mixture does, bench.py:42-48), Viterbi over the shared loop
    graph, ``path_to_tokens``. Silence tokens are dropped and words
    lower-cased before ``corpus_wer``. Stage times (:class:`StageClock`):
    "host" is batching, building the front ends, graphs and kernel
    parameters, and copies to the device; "tokens" is ``path_to_tokens``,
    reading the scores back, and the WER.
    """
    clock = StageClock(device)
    start = time.perf_counter()
    with clock("host"):
        batches = list(make_batches(utts, bcfg, fcfg))
        frontends = frontends_for(batches, fcfg, device)
        graphs = decode_graphs(graph, bcfg.batch_size, device)
        params = kernel_params(gmm, compute_dtype) if use_kernels else None

    refs, hyps, scores = [], [], []
    for batch in batches:
        fb = featurize_batch(batch, frontends[batch.waves.shape[1]], device, clock)
        with clock("scoring"):
            ll = score_batch(fb.feats, gmm, use_kernels, compute_dtype, mode="max", params=params)
        toks, batch_scores = decode_batch(fb, ll, graph, dcfg, use_kernels, graphs=graphs, clock=clock)
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

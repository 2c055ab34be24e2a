"""Shared CLI plumbing for the port's entry points: corpus loading (the
synthetic corpora, a JSONL manifest, a LibriSpeech-layout directory),
waveform augmentation, run directories, the device, the GMM, the hybrid NN,
the CTC model, the RNN-T and the AED of the decode CLIs, and the prefix
beams' biasing and fusion. The twin of the reference's cli/common.py (and
of ``load_or_random_gmm`` in cli/score.py).
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from mogasr_torch.hmm.lexicon import Lexicon, load_lexicon, synthetic_lexicon
from mogasr_torch.utils.metrics import RunLogger


def add_corpus_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--librispeech-root", help="LibriSpeech root directory")
    p.add_argument("--split", default="dev-clean", help="corpus split name")
    p.add_argument(
        "--synthetic", type=int, default=0, metavar="N",
        help="use N synthetic utterances instead of a real corpus",
    )
    p.add_argument("--synthetic-seed", type=int, default=0)
    p.add_argument(
        "--synthetic-v2", type=int, default=0, metavar="N",
        help="use N v2 (coarticulated multi-speaker noisy, 300-word phrase "
             "language) synthetic utterances: the corpus the headline "
             "bundle is trained on",
    )
    p.add_argument("--manifest", metavar="FILE",
                   help="JSONL manifest corpus: one {'audio': PATH, 'text': WORDS[, 'id': ID]} per line; relative "
                        "audio paths resolve against the manifest dir; wav + flac (data/manifest.py); requires "
                        "--lexicon")
    p.add_argument("--lexicon", help="Kaldi-style lexicon.txt (word phone...)")
    p.add_argument("--max-utts", type=int, default=0, help="limit corpus size")


def add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--run-dir", default="runs/default", help="metrics/ckpt dir")
    p.add_argument("--profile", action="store_true",
                   help="record a torch.profiler trace into <run-dir>/profile")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; the CPU only when asked for)")


def add_augment_args(p: argparse.ArgumentParser) -> None:
    """Training-time waveform augmentation (data/augment.py)."""
    p.add_argument("--speed-perturb", action="store_true",
                   help="Kaldi-style 3-way speed perturbation (0.9/1.0/1.1): triples the training corpus")
    p.add_argument("--aug-snr", metavar="LO,HI",
                   help="additive white noise at a per-utterance SNR drawn uniformly from [LO, HI] dB")
    p.add_argument("--aug-gain", metavar="LO,HI",
                   help="random volume perturbation, gain drawn uniformly from [LO, HI] dB")


def apply_augmentation(corpus, args):
    """Expand/perturb the corpus per the add_augment_args flags."""
    if not (getattr(args, "speed_perturb", False) or args.aug_snr or args.aug_gain):
        return corpus
    from mogasr_torch.data.augment import augment_corpus

    def _range(s):
        lo, hi = (float(x) for x in s.split(","))
        return (lo, hi)

    return augment_corpus(
        corpus,
        speed_factors=(0.9, 1.0, 1.1) if args.speed_perturb else (1.0,),
        snr_db_range=_range(args.aug_snr) if args.aug_snr else None,
        gain_db_range=_range(args.aug_gain) if args.aug_gain else None,
        seed=getattr(args, "synthetic_seed", 0),
    )


def load_corpus(args) -> Tuple[List[Tuple[str, np.ndarray, List[str]]], Lexicon]:
    """Returns ([(utt_id, wave, words)], lexicon)."""
    if getattr(args, "synthetic_v2", 0) > 0:
        from mogasr_torch.data.synthetic import extended_lexicon, make_corpus_v2
        from mogasr_torch.hmm.lexicon import make_lexicon

        wl = extended_lexicon()
        utts = make_corpus_v2(args.synthetic_v2, lexicon=wl, seed=args.synthetic_seed)
        corpus = [(u.utt_id, u.wave, u.words) for u in utts]
        lex = make_lexicon(wl)
    elif args.synthetic > 0:
        from mogasr_torch.data.synthetic import make_corpus

        utts = make_corpus(args.synthetic, seed=args.synthetic_seed)
        corpus = [(u.utt_id, u.wave, u.words) for u in utts]
        lex = synthetic_lexicon()
    elif getattr(args, "manifest", None):
        from mogasr_torch.data.manifest import read_manifest

        corpus = read_manifest(args.manifest, max_utts=getattr(args, "max_utts", 0) or 0)
        if args.lexicon:
            lex = load_lexicon(args.lexicon)
        else:
            raise SystemExit("--lexicon is required with --manifest")
    elif args.librispeech_root:
        from mogasr_torch.data.librispeech import LibriSpeech

        ls = LibriSpeech(args.librispeech_root, args.split)
        corpus = [(utt_id, wave, text.lower().split()) for utt_id, wave, text in ls]
        if args.lexicon:
            lex = load_lexicon(args.lexicon)
        else:
            raise SystemExit("--lexicon is required with --librispeech-root")
    else:
        raise SystemExit("pass --synthetic N, --synthetic-v2 N, --manifest FILE, or --librispeech-root DIR")
    if args.max_utts:
        corpus = corpus[: args.max_utts]
    return corpus, lex


HYBRID_ARCHS = ["mlp", "lstm", "blstm", "tdnn", "conformer", "moe"]


def add_nn_args(p: argparse.ArgumentParser) -> None:
    """The hybrid acoustic model of the decode CLIs: ``--am`` and its
    checkpoint and sizes, which must match training (``cli.train_nn``)."""
    p.add_argument("--am", default="gmm", choices=["gmm"] + HYBRID_ARCHS,
                   help="acoustic model: gmm (default) or a trained hybrid frame classifier (needs --nn-ckpt)")
    p.add_argument("--nn-ckpt", help="hybrid NN checkpoint dir (the port's format, <run-dir>/nn_<arch> of "
                                     "cli.train_nn)")
    p.add_argument("--nn-precision", default="float32", choices=["float32", "bfloat16", "int8"],
                   help="hybrid-AM inference precision (am/quantize.py; int8 for mlp and lstm)")
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    p.add_argument("--nn-experts", type=int, default=4, help="with --am moe: expert count; must match training")


def load_nn_scorer(args, n_pdfs: int, feat_dim: int, device: torch.device):
    """``pipeline.make_nn_scorer`` of the ``--am`` model in ``--nn-ckpt``
    (its latest step: ``{"params": state_dict, "log_priors"}``) at
    ``--nn-precision``, on ``device``; a checkpoint of other sizes raises."""
    from mogasr_torch.am.neural import build_model
    from mogasr_torch.config import TrainConfig
    from mogasr_torch.pipeline import make_nn_scorer
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    tcfg = TrainConfig(nn_arch=args.am, nn_hidden=args.nn_hidden, nn_layers=args.nn_layers,
                       nn_experts=args.nn_experts)
    model = build_model(args.am, n_pdfs, tcfg, feat_dim)
    ck = restore_checkpoint(args.nn_ckpt)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in ck["params"].items()})
    model.to(device).eval()
    return make_nn_scorer(model, ck["log_priors"], precision=args.nn_precision)


def load_ctc_model(arch: str, n_units: int, hidden: int, layers: int, feat_dim: int, ckpt_dir: str,
                   device: torch.device) -> torch.nn.Module:
    """The ``arch`` CTC model over n_units + blank in ``ckpt_dir`` (its latest
    step, ``{"params": state_dict}`` as ``cli.train_nn --objective ctc``
    writes it), in eval mode on ``device``; a checkpoint of other sizes
    raises."""
    from mogasr_torch.am.neural import build_model
    from mogasr_torch.config import TrainConfig
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    model = build_model(arch, n_units + 1, TrainConfig(nn_arch=arch, nn_hidden=hidden, nn_layers=layers), feat_dim)
    ck = restore_checkpoint(ckpt_dir)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in ck["params"].items()})
    return model.to(device).eval()


def add_rnnt_args(p: argparse.ArgumentParser, beam: bool = True) -> None:
    """The RNN-T checkpoint's configuration (must match training) and, with
    ``beam``, the beam width."""
    p.add_argument("--rnnt-pred", default="stateless", choices=["stateless", "lstm"],
                   help="prediction-network architecture of the RNN-T checkpoint (must match training)")
    p.add_argument("--rnnt-plain", action="store_true",
                   help="the RNN-T checkpoint was trained without the auxiliary CTC head")
    p.add_argument("--rnnt-pruned", action="store_true",
                   help="the RNN-T checkpoint was trained with the pruned loss (train_nn --rnnt-pruned-band): "
                        "it has the factored simple heads")
    if beam:
        p.add_argument("--rnnt-beam", type=int, default=0, metavar="N",
                       help="with --rnnt: the device beam of width N (0: the device greedy)")


def load_rnnt_model(args, arch: str, n_units: int, feat_dim: int, device: torch.device) -> torch.nn.Module:
    """The RNN-T over n_units + blank in ``--nn-ckpt`` (its latest step,
    ``{"params": state_dict}`` as ``cli.train_nn --objective rnnt`` writes
    it), the ``arch`` encoder at ``--nn-hidden/--nn-layers`` and
    ``--rnnt-pred/--rnnt-plain/--rnnt-pruned``, in eval mode on
    ``device``; a checkpoint of another configuration raises."""
    from mogasr_torch.am.rnnt import build_rnnt_model
    from mogasr_torch.config import TrainConfig
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    if arch not in ("lstm", "blstm"):
        raise SystemExit("--rnnt needs an lstm/blstm encoder")
    model = build_rnnt_model(n_units, TrainConfig(nn_hidden=args.nn_hidden, nn_layers=args.nn_layers), feat_dim,
                             encoder_arch=arch, pred_arch=args.rnnt_pred, aux_ctc=not args.rnnt_plain,
                             simple_heads=args.rnnt_pruned)
    ck = restore_checkpoint(args.nn_ckpt)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in ck["params"].items()})
    return model.to(device).eval()


def add_aed_args(p: argparse.ArgumentParser, chunk: Optional[int] = 0, ctc_weight: bool = True,
                 max_tokens: Optional[int] = 64) -> None:
    """The AED beam's width and, as the reference's CLI has them, its joint
    CTC weight, token budget, and the chunked encoder's configuration (must
    match training; ``chunk`` the default of --aed-chunk, None: no such
    options)."""
    p.add_argument("--aed-beam", type=int, default=4, help="beam width of the AED decoder")
    if ctc_weight:
        p.add_argument("--aed-ctc-weight", type=float, default=0.3,
                       help="joint decoding: rescore the final AED beams with the encoder's CTC head at this weight "
                            "(0: attention only)")
    if max_tokens is not None:
        p.add_argument("--aed-max-tokens", type=int, default=max_tokens, help="token budget of the AED beam search")
    if chunk is not None:
        p.add_argument("--aed-chunk", type=int, default=chunk, metavar="C",
                       help="the checkpoint's chunked streaming encoder (train_nn --aed-chunk C): subsampled frames a "
                            "chunk; must match training")
        p.add_argument("--aed-left-chunks", type=int, default=1, help="left-context chunks (must match training)")


def load_aed_model(args, n_units: int, feat_dim: int, device: torch.device) -> torch.nn.Module:
    """The AED over n_units in ``--nn-ckpt`` (its latest step, ``{"params":
    state_dict}`` as ``cli.train_nn --objective aed`` writes it) at
    ``--nn-hidden/--nn-layers`` and ``--aed-chunk/--aed-left-chunks`` where
    the CLI has them, in eval mode on ``device``; a checkpoint of another
    configuration raises."""
    from mogasr_torch.am.aed import build_aed_model
    from mogasr_torch.config import TrainConfig
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    model = build_aed_model(n_units, TrainConfig(nn_hidden=args.nn_hidden, nn_layers=args.nn_layers), feat_dim,
                            chunk_frames=getattr(args, "aed_chunk", 0), left_chunks=getattr(args, "aed_left_chunks", 1))
    ck = restore_checkpoint(args.nn_ckpt)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in ck["params"].items()})
    return model.to(device).eval()


def add_ctc_beam_args(p: argparse.ArgumentParser, with_fusion: bool = True) -> None:
    """Contextual biasing and unit-LM shallow fusion of the CTC prefix beam
    (with ``--ctc --bpe``)."""
    p.add_argument("--bias", metavar="FILE",
                   help="with --ctc --bpe, or --rnnt --rnnt-beam N: contextual biasing, one phrase a line, boosted "
                        "inside the beam (decoder/biasing.py)")
    p.add_argument("--bias-weight", type=float, default=2.0, help="per-unit boost of --bias")
    p.add_argument("--bias-beam", type=int, default=8, help="prefix beam width used with --bias/--fusion-lm")
    if with_fusion:
        p.add_argument("--fusion-lm", metavar="FILE",
                       help="with --ctc --bpe or --rnnt --rnnt-beam N: unit-bigram shallow fusion in the beam (train_lm "
                            "--unit-ngram writes unit_lm.npz); composes with --bias")
        p.add_argument("--fusion-weight", type=float, default=0.5, help="LM weight of --fusion-lm")


def ctc_beam_tables(args, bpe) -> Tuple:
    """(fusion, bias_next, bias_delta) of the device prefix beam from
    ``--fusion-lm`` and ``--bias`` (None where not given)."""
    from mogasr_torch.am.ctc import ctc_fusion_matrix

    fusion = bias_next = bias_delta = None
    if args.bias:
        from mogasr_torch.decoder.biasing import CompiledBiaser, biaser_from_bpe, load_phrases

        comp = CompiledBiaser(biaser_from_bpe(bpe, load_phrases(args.bias), weight=args.bias_weight), bpe.n_units)
        bias_next, bias_delta = comp.next_state, comp.delta
    if args.fusion_lm:
        from mogasr_torch.lm.unit_ngram import load_unit_lm

        fusion = ctc_fusion_matrix(bpe.n_units, load_unit_lm(args.fusion_lm), args.fusion_weight)
    return fusion, bias_next, bias_delta


def ctc_ext_score(args, bpe):
    """The host beam's ``ext_score`` from ``--bias`` and ``--fusion-lm``
    (``lm.unit_ngram.compose_ext_scores``), None when neither is given."""
    if not (args.bias or args.fusion_lm):
        return None
    from mogasr_torch.lm.unit_ngram import compose_ext_scores

    exts = []
    if args.bias:
        from mogasr_torch.decoder.biasing import biaser_from_bpe, load_phrases

        exts.append(biaser_from_bpe(bpe, load_phrases(args.bias), weight=args.bias_weight).score)
    if args.fusion_lm:
        from mogasr_torch.lm.unit_ngram import fusion_score, load_unit_lm

        exts.append(fusion_score(load_unit_lm(args.fusion_lm), args.fusion_weight))
    return compose_ext_scores(exts)


def make_logger(args) -> RunLogger:
    return RunLogger(args.run_dir)


def device_of(name: str) -> torch.device:
    """A ``--device`` value as a torch.device; a CUDA device that is not
    there stops the program rather than falling back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available (pass --device cpu to run on the CPU)")
    return dev


def load_or_random_gmm(args, feat_dim: int, device: torch.device):
    """The GMM of ``--gmm-ckpt`` (the port's checkpoint format, as
    ``cli.train_gmm`` writes it), or else a random one of ``--num-states`` x
    ``--num-components`` drawn from numpy seed 0 exactly as the reference's
    cli/score.py draws it."""
    from mogasr_torch.am.gmm import gmm_from_numpy

    if args.gmm_ckpt:
        from mogasr_torch.utils.checkpoint import restore_checkpoint

        raw = restore_checkpoint(args.gmm_ckpt)
        return gmm_from_numpy(raw["weights"], raw["means"], raw["vars"], device)
    rng = np.random.default_rng(0)
    S, K = args.num_states, args.num_components
    return gmm_from_numpy(
        rng.dirichlet(np.ones(K), size=S).astype(np.float32),
        rng.standard_normal((S, K, feat_dim)).astype(np.float32),
        (0.5 + rng.random((S, K, feat_dim))).astype(np.float32),
        device,
    )

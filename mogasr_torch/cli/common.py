"""Shared CLI plumbing for the port's entry points: corpus loading, run
directories, the device, the GMM of the decode CLIs. The twin of the
reference's cli/common.py (and of ``load_or_random_gmm`` in cli/score.py).

The synthetic corpora (``--synthetic``, ``--synthetic-v2``) load as in the
reference. Real corpora (``--manifest``, ``--librispeech-root``) and the
augmentation flags need the data modules that are not ported yet
(``data/{manifest,librispeech,audio,kaldi_io,augment}.py``; ROADMAP item 16):
they raise NotImplementedError.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from mogasr_torch.hmm.lexicon import Lexicon, synthetic_lexicon
from mogasr_torch.utils.metrics import RunLogger

_NOT_PORTED = "is not ported to mogasr_torch yet (ROADMAP item 16: data/{}.py)"


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
                   help="JSONL manifest corpus (not ported yet: raises)")
    p.add_argument("--lexicon", help="Kaldi-style lexicon.txt (word phone...)")
    p.add_argument("--max-utts", type=int, default=0, help="limit corpus size")


def add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--run-dir", default="runs/default", help="metrics/ckpt dir")
    p.add_argument("--profile", action="store_true",
                   help="record a torch.profiler trace into <run-dir>/profile")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; the CPU only when asked for)")


def add_augment_args(p: argparse.ArgumentParser) -> None:
    """Training-time waveform augmentation flags (not ported yet: raise)."""
    p.add_argument("--speed-perturb", action="store_true",
                   help="Kaldi-style 3-way speed perturbation (0.9/1.0/1.1)")
    p.add_argument("--aug-snr", metavar="LO,HI",
                   help="additive white noise at a per-utterance SNR in [LO, HI] dB")
    p.add_argument("--aug-gain", metavar="LO,HI",
                   help="random volume perturbation, gain in [LO, HI] dB")


def apply_augmentation(corpus, args):
    """The corpus unchanged when no augmentation flag is set."""
    if getattr(args, "speed_perturb", False) or args.aug_snr or args.aug_gain:
        raise NotImplementedError("waveform augmentation " + _NOT_PORTED.format("augment"))
    return corpus


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
        raise NotImplementedError("--manifest " + _NOT_PORTED.format("{manifest,audio}"))
    elif args.librispeech_root:
        raise NotImplementedError("--librispeech-root " + _NOT_PORTED.format("{librispeech,audio,kaldi_io}"))
    else:
        raise SystemExit("pass --synthetic N or --synthetic-v2 N")
    if args.max_utts:
        corpus = corpus[: args.max_utts]
    return corpus, lex


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

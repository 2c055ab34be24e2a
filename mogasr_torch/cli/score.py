"""Batched diagonal-GMM scoring on the card: the twin of the reference's
cli/score.py.

    python -m mogasr_torch.cli.score --manifest corpus.jsonl --lexicon lexicon.txt \\
        [--gmm-ckpt DIR | --num-states S --num-components K] [--out loglik.npz] [--device cpu]

Scores the padded feature batches of a corpus against a GMM through K1
(``csrc/gmm_score.cu``, float32 in sum mode) and reports frames/s;
``--out`` writes each utterance's [T, S] log-likelihoods to an .npz under
its id, as the reference does. ``--gmm-ckpt`` reads the port's checkpoint
format (``cli.train_gmm`` writes it), not orbax; without it the GMM is drawn
at random from numpy seed 0 as the reference draws it (1000 x 256 by
default). ``--compute-dtype`` is accepted and, as in the reference, never
read. Records go to <run-dir>/metrics.jsonl and are printed. Runs on
``--device`` (default cuda). ``--add-pitch`` appends the pitch triple
(``frontend/pitch.py``) to the features.
"""

from __future__ import annotations

import argparse

import numpy as np

from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.cli.common import (
    add_corpus_args, add_run_args, device_of, load_corpus, load_or_random_gmm, make_logger,
)
from mogasr_torch.config import BatchConfig, FrontendConfig
from mogasr_torch.pipeline import featurize, score_batch
from mogasr_torch.utils.metrics import Timer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple (POV, centered log-f0, delta log-f0) to the features")
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--num-states", type=int, default=1000)
    p.add_argument("--num-components", type=int, default=256)
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="accepted as the reference accepts it; unused (K1 scores in float32)")
    p.add_argument("--out", help="write loglik matrices to this .npz")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = device_of(args.device)
    corpus, _lex = load_corpus(args)
    fcfg = FrontendConfig(add_pitch=args.add_pitch)
    logger = make_logger(args)
    batches = featurize(corpus, fcfg, BatchConfig(), device)
    gmm = load_or_random_gmm(args, fcfg.feat_dim, device)
    params = kernel_params(gmm, "float32")

    score_batch(batches[0].feats, gmm, params=params)  # warm-up: the kernel's first launch loads it
    with Timer() as t:
        outs = [score_batch(fb.feats, gmm, params=params) for fb in batches]
    frames = int(sum(int(fb.n_frames.sum()) for fb in batches))
    logger.log({
        "stage": "score", "frames": frames, "wall_sec": t.seconds,
        "frames_per_sec": frames / t.seconds, "S": gmm.n_states, "K": gmm.n_components,
    })
    if args.out:
        dump = {}
        for fb, ll in zip(batches, outs):
            nf, arr = fb.n_frames.cpu().numpy(), ll.cpu().numpy()
            for i, utt_id in enumerate(fb.utt_ids):
                dump[utt_id] = arr[i, : nf[i]]
        np.savez_compressed(args.out, **dump)
        print(f"wrote loglik for {len(dump)} utterances to {args.out}")


if __name__ == "__main__":
    main()

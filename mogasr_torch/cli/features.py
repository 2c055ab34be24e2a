"""Feature extraction on the card: the twin of the reference's cli/features.py.

    python -m mogasr_torch.cli.features --manifest corpus.jsonl --lexicon lexicon.txt \\
        [--feature-type mfcc|fbank|plp] [--check-parity] [--out feats.npz] [--write-ark feats.ark] [--device cpu]

Extracts MFCC, fbank or PLP features (CMVN included) for a corpus through the
batched front end on ``--device`` (default cuda). ``--check-parity`` holds
every utterance to the NumPy oracle (``frontend/numpy_ref.py``) at the
reference's fp32 tolerance and logs the result; ``--out`` writes the
features to an .npz, ``--write-ark`` as a Kaldi text archive
(``data/kaldi_io.py``). Records go to <run-dir>/metrics.jsonl and are
printed. ``--add-pitch`` is not ported yet (ROADMAP item 10) and raises
NotImplementedError.
"""

from __future__ import annotations

import argparse

import numpy as np

from mogasr_torch.cli.common import (
    add_corpus_args, add_run_args, device_of, load_corpus, make_logger, refuse_unported,
)
from mogasr_torch.config import BatchConfig, FrontendConfig
from mogasr_torch.pipeline import featurize
from mogasr_torch.utils.metrics import Timer

PARITY_ATOL = 2e-3  # the reference CLI's fp32 tolerance


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--out", help="write features to this .npz")
    p.add_argument("--write-ark", help="write features as a Kaldi text archive (ark,t) to this path")
    p.add_argument("--check-parity", action="store_true", help="compare vs the NumPy oracle (fp32 tolerance)")
    p.add_argument("--feature-type", default="mfcc", choices=["mfcc", "fbank", "plp"])
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple to the features (not ported yet: raises)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported([("--add-pitch", args.add_pitch, "10: frontend/pitch.py")])
    device = device_of(args.device)
    corpus, _lex = load_corpus(args)
    fcfg = FrontendConfig(feature_type=args.feature_type)
    logger = make_logger(args)

    with Timer() as t:
        batches = featurize(corpus, fcfg, BatchConfig(), device)
    n_frames_total = int(sum(int(fb.n_frames.sum()) for fb in batches))
    audio_sec = sum(len(w) for _, w, _ in corpus) / fcfg.sample_rate
    logger.log({
        "stage": "features", "utts": len(corpus), "frames": n_frames_total,
        "wall_sec": t.seconds, "rtf": t.seconds / max(audio_sec, 1e-9),
    })
    if not (args.check_parity or args.out or args.write_ark):
        return
    feats_of = {}
    for fb in batches:
        feats, nf = fb.feats.cpu().numpy(), fb.n_frames.cpu().numpy()
        for i, utt_id in enumerate(fb.utt_ids):
            feats_of[utt_id] = feats[i, : nf[i]]

    if args.check_parity:
        from mogasr_torch.frontend.numpy_ref import extract_features_np

        worst = 0.0
        for utt_id, wave, _words in corpus:
            ref = extract_features_np(wave, fcfg)
            worst = max(worst, float(np.abs(feats_of[utt_id][:, : ref.shape[1]] - ref).max()))
        logger.log({"stage": "parity", "max_abs_err": worst, "pass": worst < PARITY_ATOL})

    if args.out:
        np.savez_compressed(args.out, **feats_of)
        print(f"wrote {len(feats_of)} utterances to {args.out}")
    if args.write_ark:
        from mogasr_torch.data.kaldi_io import write_ark_t

        write_ark_t(args.write_ark, sorted(feats_of.items()))
        print(f"wrote {len(feats_of)} utterances to {args.write_ark} (ark,t)")


if __name__ == "__main__":
    main()

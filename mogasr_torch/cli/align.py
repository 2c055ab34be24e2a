"""Monophone GMM-HMM forced alignment on the card: the twin of the reference's
cli/align.py.

    python -m mogasr_torch.cli.align --manifest corpus.jsonl --lexicon lexicon.txt \\
        [--gmm-ckpt DIR] [--acoustic-scale A] [--out ali.jsonl] [--device cpu]

featurize -> K1 (float32, sum mode) -> K2's chain arm over each
utterance's align graph (``pipeline.align_batch``; the backtrace writes the
pdf of every frame) -> one JSON line per utterance with its frame pdfs, their
phones and the Viterbi score, as the reference writes them. ``--gmm-ckpt``
reads the port's checkpoint format, not orbax; without it a random GMM of
``--num-states`` (default: the topology's pdfs) x ``--num-components`` is
drawn as the reference draws it. Records go to <run-dir>/metrics.jsonl and
are printed. Runs on ``--device`` (default cuda). ``--add-pitch`` appends
the pitch triple (``frontend/pitch.py``) to the features.
"""

from __future__ import annotations

import argparse
import json

from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.cli.common import (
    add_corpus_args, add_run_args, device_of, load_corpus, load_or_random_gmm, make_logger,
)
from mogasr_torch.config import BatchConfig, FrontendConfig, TopologyConfig
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import align_batch, featurize
from mogasr_torch.utils.metrics import Timer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple (POV, centered log-f0, delta log-f0) to the features")
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--num-states", type=int, default=0, help="0 = topo pdfs")
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--out", help="write alignments (jsonl)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = device_of(args.device)
    corpus, lex = load_corpus(args)
    fcfg = FrontendConfig(add_pitch=args.add_pitch)
    topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    logger = make_logger(args)
    batches = featurize(corpus, fcfg, BatchConfig(), device)
    gmm = load_or_random_gmm(args, fcfg.feat_dim, device)
    params = kernel_params(gmm, "float32")
    pdf_to_phone = topo.pdf_to_phone()

    out_f = open(args.out, "w") if args.out else None
    audio_sec = sum(len(w) for _, w, _ in corpus) / fcfg.sample_rate
    with Timer() as t:
        for fb in batches:
            res, labels, _ = align_batch(fb, gmm, lex, topo, args.acoustic_scale, params=params)
            if out_f:
                labels_np, nf, scores = labels.cpu().numpy(), fb.n_frames.cpu().numpy(), res.score.tolist()
                for i, utt_id in enumerate(fb.utt_ids):
                    pdfs = labels_np[i, : nf[i]].tolist()
                    out_f.write(json.dumps({
                        "utt_id": utt_id, "pdfs": pdfs, "phones": [lex.phones[pdf_to_phone[x]] for x in pdfs],
                        "score": float(scores[i]),
                    }) + "\n")
    if out_f:
        out_f.close()
    logger.log({
        "stage": "align", "utts": len(corpus), "wall_sec": t.seconds,
        "rtf": t.seconds / max(audio_sec, 1e-9),
    })


if __name__ == "__main__":
    main()

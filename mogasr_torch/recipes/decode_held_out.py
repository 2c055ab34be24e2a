"""Decode the held-out corpus of the reference's bench.py with a bundle on the
card and print its WER.

    python -m mogasr_torch.recipes.decode_held_out --bundle DIR [--utts 768] [--device cpu]

The corpus and decode are bench.py's: v2 utterances of seed 999 (3-9 words,
the bundle's speakers), batches of 256 in buckets (250, 350, 450, 600), the
bundle's decode settings, the tied-triphone word loop, K1 in bfloat16/max
then K2 (``pipeline.decode_corpus``). Prints one JSON line: WER, utterances,
utt/s and the stage seconds, with the device it ran on.
"""

from __future__ import annotations

import argparse
import json

import torch

from mogasr_torch import pipeline as pipe
from mogasr_torch.cli.common import device_of
from mogasr_torch.config import BatchConfig, DecodeConfig
from mogasr_torch.data import synthetic as syn
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.utils.bundle import load_system

BCFG = BatchConfig(batch_size=256, bucket_boundaries=(250, 350, 450, 600))


def held_out_corpus(topo, meta, n_utts):
    """bench.py's held-out v2 utterances (seed 999, 3-9 words)."""
    word_lex = {w: list(topo.lexicon.prons[w]) for w in topo.lexicon.words}
    utts = syn.make_corpus_v2(n_utts, lexicon=word_lex, speakers=syn.make_speakers(meta.get("speakers", 20)),
                              style=syn.CorpusStyle(), seed=999, words_per_utt=(3, 9))
    return [(u.utt_id, u.wave, u.words) for u in utts]


def decode_bundle(path: str, device: torch.device, n_utts: int = 768) -> pipe.CorpusResult:
    gmm, topo, fcfg, tied, meta = load_system(path, device)
    dmeta = meta.get("decode", {})
    dcfg = DecodeConfig(acoustic_scale=dmeta.get("acoustic_scale", 1.0),
                        word_insertion_penalty=dmeta.get("word_insertion_penalty", 2.0))
    graph = tri.word_loop_graph_cd(tied, insertion_penalty=dcfg.word_insertion_penalty)
    return pipe.decode_corpus(held_out_corpus(topo, meta, n_utts), gmm, graph, fcfg, dcfg, BCFG, device,
                              compute_dtype="bfloat16")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bundle", required=True)
    p.add_argument("--utts", type=int, default=768)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = device_of(args.device)
    r = decode_bundle(args.bundle, dev, args.utts)
    print(json.dumps({"bundle": args.bundle, "wer": r.wer, "n_utts": r.n_utts, "utt_per_s": r.n_utts / r.seconds,
                      "stage_seconds": r.stage_seconds,
                      "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}))


if __name__ == "__main__":
    main()

"""Keyword spotting on the card: the twin of the reference's cli/search.py on
its GMM path.

    python -m mogasr_torch.cli.search --synthetic 8 --terms 'cat,dog fish' [--gmm-ckpt DIR] [--device cpu]

decode -> word lattices -> posterior term detection. Searches every
utterance for the given terms (comma-separated; multi-word phrases use
spaces) and writes JSONL hits with time spans and posteriors. The device
does one LM-Viterbi lattice pass per batch (K1 float32/sum, then
``pipeline.decode_batch_lattices``); the term search is host-side
(``decoder.kws``). Runs on ``--device`` (default cuda). ``--gmm-ckpt``
reads the port's checkpoint format. ``--ctc --nn-ckpt DIR`` (``cli.train_nn
--objective ctc``; ``--nn-arch/--nn-hidden/--nn-layers`` as trained) scores
with the CTC model's log posteriors (LstmAm and BlstmAm on K4) over the CTC
word loop (``am.ctc.ctc_decode_graph``).
"""

from __future__ import annotations

import argparse
import json

from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.cli.common import (
    add_corpus_args, add_run_args, device_of, load_corpus, load_or_random_gmm, make_logger,
)
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import decode_batch_lattices, featurize, score_batch, word_decode_graph
from mogasr_torch.utils.metrics import Timer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--ctc", action="store_true",
                   help="search with a CTC acoustic model (train_nn --objective ctc checkpoint via --nn-ckpt) through "
                        "the CTC-topology word graph")
    p.add_argument("--nn-ckpt", help="CTC checkpoint dir (with --ctc)")
    p.add_argument("--nn-arch", default="mlp", choices=["mlp", "lstm", "blstm", "tdnn", "conformer"])
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    p.add_argument("--terms", required=True, help="comma-separated terms; spaces make phrases (e.g. 'cat,dog fish')")
    p.add_argument("--threshold", type=float, default=0.3, help="posterior threshold for a hit")
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--out", help="write hits (jsonl)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = device_of(args.device)
    corpus, lex = load_corpus(args)
    fcfg = FrontendConfig()
    topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(acoustic_scale=args.acoustic_scale, word_insertion_penalty=args.insertion_penalty)
    logger = make_logger(args)
    batches = featurize(corpus, fcfg, BatchConfig(), device)
    if args.ctc:
        if not args.nn_ckpt:
            raise SystemExit("--ctc requires --nn-ckpt")
        from mogasr_torch.am.ctc import ctc_decode_graph, make_ctc_scorer
        from mogasr_torch.cli.common import load_ctc_model

        scorer = make_ctc_scorer(load_ctc_model(args.nn_arch, lex.n_phones, args.nn_hidden, args.nn_layers,
                                                fcfg.feat_dim, args.nn_ckpt, device))
        graph = ctc_decode_graph(lex, dcfg)
    else:
        gmm = load_or_random_gmm(args, fcfg.feat_dim, device)
        params = kernel_params(gmm, "float32")

        def scorer(fb):
            return score_batch(fb.feats, gmm, params=params)

        graph = word_decode_graph(lex, topo, dcfg)

    from mogasr_torch.decoder.kws import keyword_search
    from mogasr_torch.lm.ngram import estimate_bigram

    terms = [t.strip().split() for t in args.terms.split(",") if t.strip()]
    transcripts = [fb.words[b] for fb in batches for b in range(fb.size)]
    lm = estimate_bigram(transcripts, sorted(set(graph.labels)))

    frame_shift_sec = fcfg.frame_shift_ms / 1000.0
    records = []
    n_hits = 0
    with Timer() as t:
        for fb in batches:
            lats, _ = decode_batch_lattices(fb, scorer(fb), graph, lm, dcfg)
            for b in range(fb.size):
                hits = keyword_search(lats[b], lm, terms, threshold=args.threshold)
                n_hits += len(hits)
                records.append({
                    "utt_id": fb.utt_ids[b],
                    "hits": [
                        {
                            "term": h.term,
                            "start_sec": round(h.start * frame_shift_sec, 3),
                            "end_sec": round((h.end + 1) * frame_shift_sec, 3),
                            "posterior": round(h.posterior, 4),
                        }
                        for h in hits
                    ],
                })
    logger.log({"stage": "kws", "utts": len(records), "terms": len(terms), "hits": n_hits, "wall_sec": t.seconds})
    if args.out:
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    else:
        for r in records:
            print(json.dumps(r))


if __name__ == "__main__":
    main()

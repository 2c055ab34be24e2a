"""The evaluation sweep on the card: decode + WER + throughput, the twin of
the reference's cli/eval.py on its GMM paths.

    python -m mogasr_torch.cli.eval --manifest corpus.jsonl --lexicon lexicon.txt --bundle benchmarks/headline \\
        [--consensus] [--run-dir DIR] [--profile] [--device cpu]

featurize -> K1 (float32, sum mode) -> K2 over the word-loop graph (the
bundle's context-dependent loop with ``--bundle``), or with ``--consensus``
the lattice pass (``pipeline.decode_batch_lattices`` over a bigram of the
corpus transcripts) then confusion-network consensus decoding on the host
-> WER, utterances/s and RTF. The GMM is the bundle's
(``utils/bundle.load_system``: GMM, lexicon, topology, tied triphones,
front-end config), ``--gmm-ckpt``'s (the port's checkpoint format) or a
random one drawn as the reference draws it. Hypotheses are appended to
<run-dir>/eval_hyps.jsonl batch by batch: a sweep started again skips every
batch whose utterances are all there, and where an interrupted batch left an
utterance twice the first line wins. The reference spreads batches of 16 a
chip over its device mesh; the twin runs on one card (``n_chips`` 1, batches
of 16). Records go to <run-dir>/metrics.jsonl and are printed; ``--profile``
records a ``torch.profiler`` trace of the sweep into <run-dir>/profile. Runs
on ``--device`` (default cuda).

Not ported yet, and raising NotImplementedError naming the ROADMAP item that
ports them: ``--add-pitch``, ``--streaming`` and ``--chunk-ms`` (item 10),
``--fmllr``, ``--mllr`` and ``--vtln`` (item 11), ``--am`` other than gmm and
``--nn-ckpt`` (item 12), ``--ctc``, ``--rnnt``, ``--aed`` and ``--bpe`` (item
13). The options that only those paths read are left out.
"""

from __future__ import annotations

import argparse
import json
import os

from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.cli.common import (
    add_corpus_args, add_run_args, device_of, load_corpus, load_or_random_gmm, make_logger, refuse_unported,
)
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.eval.wer import corpus_wer
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import decode_batch, featurize, score_batch, word_decode_graph
from mogasr_torch.utils.metrics import Timer, trace

N_CHIPS = 1  # one card; the reference's batch is 16 a chip


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple to the features (not ported yet: raises)")
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--bundle", metavar="DIR",
                   help="trained-system bundle dir (e.g. benchmarks/headline): loads GMM + lexicon + topology + "
                        "tied triphones + frontend config; decodes with the CD word-loop graph")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--consensus", action="store_true",
                   help="confusion-network consensus (MBR) decoding instead of Viterbi 1-best: bigram lattice "
                        "pass -> CN -> argmax per slot")
    # the unported paths' primary flags, accepted as the reference's are; they raise
    p.add_argument("--fmllr", action="store_true", help="per-speaker fMLLR adaptation (not ported yet: raises)")
    p.add_argument("--mllr", action="store_true", help="per-speaker MLLR adaptation (not ported yet: raises)")
    p.add_argument("--vtln", action="store_true", help="per-speaker VTLN warps (not ported yet: raises)")
    p.add_argument("--ctc", action="store_true", help="BPE-CTC neural AM (not ported yet: raises)")
    p.add_argument("--rnnt", action="store_true", help="BPE-RNNT checkpoint (not ported yet: raises)")
    p.add_argument("--aed", action="store_true", help="BPE-AED checkpoint (not ported yet: raises)")
    p.add_argument("--bpe", metavar="FILE", help="bpe.json (not ported yet: raises)")
    p.add_argument("--am", default="gmm", choices=["gmm", "mlp", "lstm", "blstm", "tdnn", "conformer", "moe"],
                   help="acoustic model (only gmm is ported: the others raise)")
    p.add_argument("--nn-ckpt", help="neural checkpoint dir (not ported yet: raises)")
    p.add_argument("--streaming", action="store_true",
                   help="the chunked streaming front end (not ported yet: raises)")
    p.add_argument("--chunk-ms", type=float, help="streaming chunk size in milliseconds (not ported yet: raises)")
    return p.parse_args(argv)


def read_hyps(path: str):
    """(refs, hyps) from eval_hyps.jsonl, lowercased; the first line of an
    utterance wins (a batch interrupted mid-write is decoded again in full)."""
    refs, hyps, seen = [], [], set()
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["utt_id"] in seen:
                continue
            seen.add(rec["utt_id"])
            refs.append([w.lower() for w in rec["ref"]])
            hyps.append([w.lower() for w in rec["hyp"]])
    return refs, hyps


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported((
        ("--ctc", args.ctc, "13: am/ctc.py"),
        ("--rnnt", args.rnnt, "13: am/rnnt.py"),
        ("--aed", args.aed, "13: am/aed.py"),
        ("--bpe", args.bpe, "13: data/bpe.py"),
        (f"--am {args.am}", args.am != "gmm", "12: neural checkpoints"),
        ("--nn-ckpt", args.nn_ckpt, "12: neural checkpoints"),
        ("--fmllr", args.fmllr, "11: am/fmllr.py"),
        ("--mllr", args.mllr, "11: am/mllr.py"),
        ("--vtln", args.vtln, "11: pipeline.decode_with_vtln"),
        ("--streaming", args.streaming, "10: frontend/streaming.py"),
        ("--chunk-ms", args.chunk_ms is not None, "10: frontend/streaming.py"),
        ("--add-pitch", args.add_pitch, "10: frontend/pitch.py"),
    ))
    device = device_of(args.device)
    bundle = None
    if args.bundle:
        from mogasr_torch.utils.bundle import load_system

        bundle = load_system(args.bundle, device)
    corpus, lex = load_corpus(args)
    if bundle is not None:
        _gmm_b, topo, fcfg, _tied_b, _bmeta = bundle
        lex = topo.lexicon
    else:
        fcfg = FrontendConfig()
        topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(acoustic_scale=args.acoustic_scale, word_insertion_penalty=args.insertion_penalty)
    logger = make_logger(args)
    batches = featurize(corpus, fcfg, BatchConfig(batch_size=16 * N_CHIPS), device)
    gmm = bundle[0] if bundle is not None else load_or_random_gmm(args, fcfg.feat_dim, device)
    if bundle is not None and bundle[3] is not None:
        from mogasr_torch.hmm.triphone import word_loop_graph_cd

        graph = word_loop_graph_cd(bundle[3], insertion_penalty=dcfg.word_insertion_penalty)
    else:
        graph = word_decode_graph(lex, topo, dcfg)
    params = kernel_params(gmm, "float32")

    resume_path = os.path.join(args.run_dir, "eval_hyps.jsonl")
    done = set()
    if os.path.exists(resume_path):
        with open(resume_path) as f:
            done = {json.loads(line)["utt_id"] for line in f}

    audio_sec = sum(len(w) for _, w, _ in corpus) / fcfg.sample_rate
    prof_dir = os.path.join(args.run_dir, "profile") if args.profile else None
    with trace(prof_dir), Timer() as t:
        if args.consensus:
            from mogasr_torch.decoder.confusion import confusion_network, consensus_decode
            from mogasr_torch.lm.ngram import estimate_bigram
            from mogasr_torch.pipeline import decode_batch_lattices

            transcripts = [fb.words[b] for fb in batches for b in range(fb.size)]
            cn_lm = estimate_bigram(transcripts, sorted(set(graph.labels)))
        with open(resume_path, "a") as out_f:
            for fb in batches:
                if all(u in done for u in fb.utt_ids):
                    continue
                scores = score_batch(fb.feats, gmm, params=params)
                if args.consensus:
                    lats, _ = decode_batch_lattices(fb, scores, graph, cn_lm, dcfg)
                    out = [consensus_decode(confusion_network(lat, cn_lm))[0] for lat in lats]
                else:
                    out = decode_batch(fb, scores, graph, dcfg)
                for b in range(fb.size):
                    out_f.write(json.dumps({"utt_id": fb.utt_ids[b], "ref": fb.words[b], "hyp": out[b]}) + "\n")
                out_f.flush()

    refs, hyps = read_hyps(resume_path)
    wer, counts = corpus_wer(refs, hyps)
    logger.log({
        "stage": "eval", "split": args.split, "n_chips": N_CHIPS,
        "utts": len(refs), "wer": wer,
        "sub": counts.substitutions, "dels": counts.deletions, "ins": counts.insertions,
        "wall_sec": t.seconds,
        "utts_per_sec_per_chip": len(refs) / t.seconds / N_CHIPS,
        "rtf": t.seconds / max(audio_sec, 1e-9),
    })


if __name__ == "__main__":
    main()

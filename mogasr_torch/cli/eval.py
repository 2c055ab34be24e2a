"""The evaluation sweep on the card: decode + WER + throughput, the twin of
the reference's cli/eval.py on its GMM paths.

    python -m mogasr_torch.cli.eval --manifest corpus.jsonl --lexicon lexicon.txt --bundle benchmarks/headline \\
        [--consensus | --fmllr | --mllr | --vtln] [--streaming [--chunk-ms MS]] [--add-pitch] [--run-dir DIR] \\
        [--profile] [--device cpu]

featurize (or, with ``--streaming``, the chunked streaming front end,
``pipeline.featurize_streaming``, in chunks of ``--chunk-ms``) -> K1
(float32, sum mode) -> K2 over the word-loop graph (the
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

``--add-pitch`` appends the pitch triple (``frontend/pitch.py``) to the
features. ``--fmllr``, ``--mllr`` and ``--vtln`` decode in two passes with
per-speaker adaptation (``pipeline.decode_with_{fmllr,mllr,vtln}``: pass 1,
the alignment of its hypotheses, K1 and K2 on the card; the transforms or
warps per speaker, the utterance-id prefix before the first '-'), the
reference's semantics: the sweep is resumed as a whole (a transform depends
on all of its speaker's utterances), so a started-again sweep skips the
two-pass decode once every utterance is in eval_hyps.jsonl. With
``--bundle`` the two passes decode the bundle's CD word loop and align with
its CD align graphs, as the 1-best sweep decodes (the reference's two-pass
functions take no graph and use the monophone loop there).

``--am mlp|lstm|blstm|tdnn|conformer|moe --nn-ckpt DIR`` sweeps with a
trained hybrid model (``cli.train_nn``'s checkpoint; ``--nn-hidden/
--nn-layers/--nn-experts`` as trained, ``--nn-precision`` float32,
bfloat16 or int8; LstmAm and BlstmAm on K4) in place of the GMM, over the
word loop of the corpus lexicon, as the reference does. Each batch's dummy
rows are left out before scoring.

``--ctc --bpe FILE --nn-ckpt DIR`` sweeps a BPE-CTC model (``cli.train_nn
--objective ctc --bpe-merges``; ``--nn-arch/--nn-hidden/--nn-layers`` as
trained) with lexicon-free greedy word decoding: the argmax on the card
(``am.ctc.make_ctc_frames_fn``; LstmAm and BlstmAm on K4, ConformerAm at its
subsampled rate), one [B, T] int copy to the host, the collapse and
``bpe.decode`` there. As in the reference, ``--ctc`` needs ``--bpe`` and
``--nn-ckpt``. ``--rnnt --bpe FILE --nn-ckpt DIR`` sweeps a BPE-RNN-T
(``cli.train_nn --objective rnnt --bpe-merges``; ``--nn-arch lstm|blstm``,
``--rnnt-pred/--rnnt-plain/--rnnt-pruned`` as trained): the encoder on K4,
the device greedy (the label loop), or with ``--rnnt-beam N`` the device
beam. ``--aed --bpe FILE --nn-ckpt DIR`` sweeps a BPE-AED (``cli.train_nn
--objective aed --bpe-merges``; ``--nn-hidden/--nn-layers`` as trained) with
the attention beam search (``am.aed.make_aed_decoder``, width
``--aed-beam``, ``--aed-max-tokens`` tokens, no CTC rescoring, as the
reference sweeps it).
"""

from __future__ import annotations

import argparse
import json
import os

from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.cli.common import (
    add_corpus_args, add_nn_args, add_run_args, device_of, load_corpus, load_nn_scorer, load_or_random_gmm,
    add_aed_args, add_rnnt_args, make_logger,
)
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.eval.wer import corpus_wer
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import (
    decode_batch, featurize, featurize_streaming, live_rows, score_batch, word_decode_graph,
)
from mogasr_torch.utils.metrics import Timer, trace

N_CHIPS = 1  # one card; the reference's batch is 16 a chip


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple (POV, centered log-f0, delta log-f0) to the features")
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
    p.add_argument("--fmllr", action="store_true",
                   help="unsupervised two-pass per-speaker fMLLR adaptation (resumed as a whole sweep: the "
                        "transforms depend on all of a speaker's utterances)")
    p.add_argument("--mllr", action="store_true",
                   help="unsupervised two-pass per-speaker MLLR (model-space mean) adaptation; same resume "
                        "granularity as --fmllr")
    p.add_argument("--vtln", action="store_true",
                   help="unsupervised two-pass per-speaker VTLN warp estimation (grid search over warped mel "
                        "front ends)")
    p.add_argument("--ctc", action="store_true",
                   help="evaluate a BPE-CTC neural AM (lexicon-free greedy word decoding) instead of the GMM "
                        "system: requires --bpe and --nn-ckpt")
    p.add_argument("--rnnt", action="store_true",
                   help="evaluate a BPE-RNNT checkpoint (train_nn --objective rnnt --bpe-merges): the device greedy, "
                        "or the device beam with --rnnt-beam; requires --bpe and --nn-ckpt")
    add_rnnt_args(p)
    p.add_argument("--aed", action="store_true",
                   help="evaluate a BPE-AED checkpoint (train_nn --objective aed --bpe-merges): the batched beam "
                        "search; requires --bpe and --nn-ckpt")
    add_aed_args(p, chunk=None, ctc_weight=False, max_tokens=48)
    p.add_argument("--bpe", metavar="FILE", help="bpe.json (with --ctc/--rnnt/--aed)")
    p.add_argument("--nn-arch", default="lstm", choices=["mlp", "lstm", "blstm", "tdnn", "conformer"],
                   help="with --ctc: the CTC model's architecture; with --rnnt: the encoder (lstm/blstm)")
    add_nn_args(p)
    p.add_argument("--streaming", action="store_true",
                   help="extract features through the chunked streaming front end instead of the offline batch path")
    p.add_argument("--chunk-ms", type=float, default=500.0, help="streaming chunk size in milliseconds")
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


def two_pass_sweep(args, corpus, batches, gmm, lex, topo, fcfg, bcfg, dcfg, graph, bundle, done, resume_path):
    """``--fmllr``/``--mllr``/``--vtln``: the whole corpus in two passes
    (skipped when every utterance is already in ``resume_path``), then the
    hypotheses of the utterances not yet there appended."""
    from mogasr_torch.pipeline import decode_with_fmllr, decode_with_mllr, decode_with_vtln

    if {u for fb in batches for u in fb.utt_ids} <= done:
        return
    align_fn = None
    if bundle is not None and bundle[3] is not None:
        from mogasr_torch.hmm.triphone import align_graph_cd

        align_fn = lambda pids: align_graph_cd(bundle[3], pids)  # noqa: E731
    if args.vtln:
        hyp_map, _warps = decode_with_vtln(corpus, gmm, lex, topo, fcfg, bcfg, dcfg, graph=graph, align_fn=align_fn)
    else:
        two_pass = decode_with_fmllr if args.fmllr else decode_with_mllr
        hyp_map, _transforms = two_pass(batches, gmm, lex, topo, dcfg, graph=graph, align_fn=align_fn)
    with open(resume_path, "a") as out_f:
        for fb in batches:
            for b in range(fb.size):
                uid = fb.utt_ids[b]
                if uid not in done:
                    out_f.write(json.dumps({"utt_id": uid, "ref": fb.words[b], "hyp": hyp_map[uid]}) + "\n")
        out_f.flush()


def main(argv=None) -> None:
    args = parse_args(argv)
    adapt = args.fmllr or args.mllr or args.vtln
    lexicon_free = [f for f, on in (("--ctc", args.ctc), ("--rnnt", args.rnnt), ("--aed", args.aed)) if on]
    if lexicon_free and (adapt or args.consensus or args.bundle):
        raise SystemExit(f"{lexicon_free[0]} is lexicon-free decoding: incompatible with GMM "
                         "adaptation/consensus/bundle")
    if args.am != "gmm":
        if adapt:
            raise SystemExit("--fmllr/--mllr/--vtln are GMM adaptation: incompatible with a hybrid --am")
        if not args.nn_ckpt:
            raise SystemExit("--am mlp/lstm/... requires --nn-ckpt")
        if args.bundle:
            raise SystemExit("--bundle carries a GMM system: incompatible with a hybrid --am")
        if lexicon_free:
            raise SystemExit("--ctc/--rnnt/--aed are lexicon-free sweeps: use them without --am")
    if len(lexicon_free) > 1:
        raise SystemExit(f"pick one of {'/'.join(lexicon_free)}")
    if lexicon_free and not (args.bpe and args.nn_ckpt):
        raise SystemExit(f"{lexicon_free[0]} requires --bpe and --nn-ckpt")
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
        fcfg = FrontendConfig(add_pitch=args.add_pitch)
        topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(acoustic_scale=args.acoustic_scale, word_insertion_penalty=args.insertion_penalty)
    logger = make_logger(args)
    bcfg = BatchConfig(batch_size=16 * N_CHIPS)
    if args.streaming:
        chunk = int(fcfg.sample_rate * args.chunk_ms / 1000.0)
        batches = featurize_streaming(corpus, fcfg, bcfg, device, chunk_samples=chunk)
    else:
        batches = featurize(corpus, fcfg, bcfg, device)
    neural = None
    if args.ctc:
        from mogasr_torch.am.ctc import ctc_collapse_frames, make_ctc_frames_fn
        from mogasr_torch.cli.common import load_ctc_model
        from mogasr_torch.data.bpe import load_bpe

        bpe = load_bpe(args.bpe)
        frames_fn = make_ctc_frames_fn(load_ctc_model(args.nn_arch, bpe.n_units, args.nn_hidden, args.nn_layers,
                                                      fcfg.feat_dim, args.nn_ckpt, device))

        def neural(fb):
            frames, n_dec = frames_fn(fb.feats, fb.n_frames)
            return [bpe.decode(seq) for seq in ctc_collapse_frames(frames, n_dec, bpe.n_units)]

        gmm = params = hybrid = None
    elif args.rnnt:
        from mogasr_torch.am.rnnt import rnnt_beam_decode_device, rnnt_greedy_decode_device
        from mogasr_torch.cli.common import load_rnnt_model
        from mogasr_torch.data.bpe import load_bpe

        bpe = load_bpe(args.bpe)
        rnnt_model = load_rnnt_model(args, args.nn_arch, bpe.n_units, fcfg.feat_dim, device)

        def neural(fb):
            if args.rnnt_beam > 0:
                ranked = rnnt_beam_decode_device(rnnt_model, fb.feats, fb.n_frames, beam_size=args.rnnt_beam)
                seqs = [r[0][1] if r else [] for r in ranked]
            else:
                seqs = rnnt_greedy_decode_device(rnnt_model, fb.feats, fb.n_frames)
            return [bpe.decode(seq) for seq in seqs]

        gmm = params = hybrid = None
    elif args.aed:
        from mogasr_torch.am.aed import make_aed_decoder
        from mogasr_torch.cli.common import load_aed_model
        from mogasr_torch.data.bpe import load_bpe

        bpe = load_bpe(args.bpe)
        aed_dec = make_aed_decoder(load_aed_model(args, bpe.n_units, fcfg.feat_dim, device), beam=args.aed_beam,
                                   max_tokens=args.aed_max_tokens)

        def neural(fb):
            toks, n_toks, _ = aed_dec(fb.feats, fb.n_frames)
            toks, n_toks = toks.cpu().numpy(), n_toks.cpu().numpy()
            return [bpe.decode([int(t) for t in toks[b, : n_toks[b]]]) for b in range(fb.size)]

        gmm = params = hybrid = None
    elif args.am == "gmm":
        gmm = bundle[0] if bundle is not None else load_or_random_gmm(args, fcfg.feat_dim, device)
        params, hybrid = kernel_params(gmm, "float32"), None
    else:
        gmm = params = None
        hybrid = load_nn_scorer(args, topo.n_pdfs, fcfg.feat_dim, device)
    if bundle is not None and bundle[3] is not None:
        from mogasr_torch.hmm.triphone import word_loop_graph_cd

        graph = word_loop_graph_cd(bundle[3], insertion_penalty=dcfg.word_insertion_penalty)
    else:
        graph = word_decode_graph(lex, topo, dcfg)

    resume_path = os.path.join(args.run_dir, "eval_hyps.jsonl")
    done = set()
    if os.path.exists(resume_path):
        with open(resume_path) as f:
            done = {json.loads(line)["utt_id"] for line in f}

    audio_sec = sum(len(w) for _, w, _ in corpus) / fcfg.sample_rate
    prof_dir = os.path.join(args.run_dir, "profile") if args.profile else None
    with trace(prof_dir), Timer() as t:
        if args.fmllr or args.mllr or args.vtln:
            two_pass_sweep(args, corpus, batches, gmm, lex, topo, fcfg, bcfg, dcfg, graph, bundle, done,
                           resume_path)
        else:
            if args.consensus:
                from mogasr_torch.decoder.confusion import confusion_network, consensus_decode
                from mogasr_torch.lm.ngram import estimate_bigram
                from mogasr_torch.pipeline import decode_batch_lattices

                transcripts = [fb.words[b] for fb in batches for b in range(fb.size)]
                cn_lm = estimate_bigram(transcripts, sorted(set(graph.labels)))
            with open(resume_path, "a") as out_f:
                for fb in map(live_rows, batches):
                    if all(u in done for u in fb.utt_ids):
                        continue
                    if neural is not None:
                        out = neural(fb)
                    else:
                        scores = hybrid(fb) if hybrid is not None else score_batch(fb.feats, gmm, params=params)
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

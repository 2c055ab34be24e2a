"""Free decode (word loop or phone loop) with the GMM on the card: the twin of
the reference's cli/decode.py on its GMM paths.

    python -m mogasr_torch.cli.decode --synthetic-v2 48 --bundle benchmarks/headline \\
        [--bigram-lm | --grammar FILE] [--lm-smoothing kn] [--trigram-rescore [--arpa FILE]] \\
        [--nbest N] [--consensus cn|mbr] [--lattice-out FILE] [--out hyps.jsonl] [--device cpu]

featurize -> K1 (float32, sum mode) -> one of: K2 over the loop graph; the
LM Viterbi (``decoder.lm_viterbi``) with a bigram or grammar LM; or the
lattice pass (``pipeline.decode_batch_lattices``) then trigram rescoring,
N-best, confusion-network or N-best MBR decoding on the host -> hypotheses
and WER (or PER in phone mode). The LM estimation and the order of the
branches are the reference's. Records go to <run-dir>/metrics.jsonl and are
printed. Runs on ``--device`` (default cuda).

``--gmm-ckpt`` reads the port's checkpoint format (``cli.train_gmm`` writes
it), not orbax. Not ported yet, and raising NotImplementedError: the neural
and end-to-end acoustic models (``--am`` other than gmm, ``--nn-ckpt``,
``--ctc``, ``--rnnt``, ``--aed``), ``--ivector-ckpt``, ``--bias``,
``--fusion-lm``, ``--nnlm-rescore`` and ``--add-pitch``; each message names
the ROADMAP item that ports it.
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
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import decode_batch, featurize, score_batch, word_decode_graph
from mogasr_torch.utils.metrics import Timer, trace


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple to the features (not ported yet: raises)")
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--bundle", metavar="DIR",
                   help="trained-system bundle dir (utils/bundle.py, e.g. benchmarks/headline): loads GMM + "
                        "lexicon + topology + tied triphones + frontend config, overriding "
                        "--gmm-ckpt/--lexicon/--num-*")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--am", default="gmm", choices=["gmm", "mlp", "lstm", "blstm", "tdnn", "conformer", "moe"],
                   help="acoustic model (only gmm is ported: the others raise)")
    # the neural and end-to-end families' primary flags, accepted as the reference's are; they raise
    p.add_argument("--nn-ckpt", help="neural checkpoint dir (not ported yet: raises)")
    p.add_argument("--ctc", action="store_true", help="CTC model (not ported yet: raises)")
    p.add_argument("--rnnt", action="store_true", help="RNN-transducer (not ported yet: raises)")
    p.add_argument("--aed", action="store_true", help="attention encoder-decoder (not ported yet: raises)")
    p.add_argument("--ivector-ckpt", metavar="DIR", help="i-vector extractor (not ported yet: raises)")
    p.add_argument("--bias", metavar="FILE", help="contextual biasing (not ported yet: raises)")
    p.add_argument("--fusion-lm", metavar="FILE", help="unit-bigram shallow fusion (not ported yet: raises)")
    p.add_argument("--mode", default="word", choices=["word", "phone"])
    p.add_argument("--bigram-lm", action="store_true",
                   help="decode with a bigram word LM estimated from the corpus transcripts (word mode only)")
    p.add_argument("--grammar", metavar="FILE",
                   help="command-grammar decoding: FILE has one allowed word sequence per line (word mode only)")
    p.add_argument("--multi-pron", action="store_true",
                   help="one decode chain per pronunciation variant (lexicons with WORD(2) alternates)")
    p.add_argument("--trigram-rescore", action="store_true",
                   help="bigram first pass -> word lattice -> exact trigram second pass (word mode only)")
    p.add_argument("--nbest", type=int, default=0,
                   help="emit the top-N word sequences per utterance from the lattice into --out "
                        "(implies a lattice pass)")
    p.add_argument("--arpa", help="read the second-pass rescoring LM from an ARPA file (with --trigram-rescore)")
    p.add_argument("--write-arpa", help="export the estimated LM (trigram if --trigram-rescore, else bigram)")
    p.add_argument("--errors-out", metavar="FILE",
                   help="write an sclite-style error report: per-utterance REF/HYP alignments + confusions")
    p.add_argument("--ci", action="store_true",
                   help="report a bootstrap 95%% confidence interval for the corpus WER")
    p.add_argument("--lattice-out", metavar="FILE",
                   help="write the word lattices as a text archive (decoder.lattice.write_lattices); implies "
                        "the lattice pass (word mode)")
    p.add_argument("--consensus", default="off", choices=["off", "cn", "mbr"],
                   help="minimum-Bayes-risk decoding over the word lattice: cn = confusion-network consensus, "
                        "mbr = N-best MBR; implies a lattice pass")
    p.add_argument("--nnlm-rescore", metavar="DIR", help="neural-LM rescoring (not ported yet: raises)")
    p.add_argument("--lm-smoothing", default="addalpha", choices=["addalpha", "kn"],
                   help="n-gram estimation: add-alpha or interpolated Kneser-Ney")
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--beam", type=float, default=0.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--out", help="write hypotheses (jsonl)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported((
        ("--ctc", args.ctc, "13: am/ctc.py"),
        ("--rnnt", args.rnnt, "13: am/rnnt.py"),
        ("--aed", args.aed, "13: am/aed.py"),
        ("--nnlm-rescore", args.nnlm_rescore, "13: lm/neural.py"),
        ("--bias", args.bias, "13: decoder/biasing.py"),
        ("--fusion-lm", args.fusion_lm, "13: lm/unit_ngram.py"),
        (f"--am {args.am}", args.am != "gmm", "12: neural checkpoints"),
        ("--nn-ckpt", args.nn_ckpt, "12: neural checkpoints"),
        ("--ivector-ckpt", args.ivector_ckpt, "11: am/ivector.py"),
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
        missing = sorted({w.lower() for _id, _w, ws in corpus for w in ws} - set(lex.words))
        if missing:
            raise SystemExit(f"corpus words not in the bundle lexicon: {missing[:8]} ...")
    else:
        fcfg = FrontendConfig(add_pitch=args.add_pitch)
        topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(acoustic_scale=args.acoustic_scale, beam=args.beam,
                        word_insertion_penalty=args.insertion_penalty)
    logger = make_logger(args)

    needs_lattice = args.trigram_rescore or args.nbest > 0 or args.consensus != "off" or bool(args.lattice_out)
    if (needs_lattice or args.multi_pron) and args.mode != "word":
        raise SystemExit("--multi-pron/--trigram-rescore/--nbest/--consensus require --mode word")

    run_dir = os.path.abspath(args.run_dir)
    with trace(os.path.join(run_dir, "profile") if args.profile else None):
        batches = featurize(corpus, fcfg, BatchConfig(), device)
        gmm = bundle[0] if bundle is not None else load_or_random_gmm(args, fcfg.feat_dim, device)

        pron_logp = None
        if args.mode == "word" and args.multi_pron:
            from mogasr_torch.pipeline import word_decode_graph_multi

            graph, pron_logp = word_decode_graph_multi(lex, topo, dcfg)
        elif args.mode == "word" and bundle is not None and bundle[3] is not None:
            from mogasr_torch.hmm.triphone import word_loop_graph_cd

            # context-dependent decode graph matching the bundle's tied pdfs
            graph = word_loop_graph_cd(bundle[3], insertion_penalty=dcfg.word_insertion_penalty)
        elif args.mode == "word":
            graph = word_decode_graph(lex, topo, dcfg)
        else:
            graph = gr.loop_graph(topo)
        lm = trigram = None
        if args.grammar:
            if args.mode != "word":
                raise SystemExit("--grammar requires --mode word")
            from mogasr_torch.lm.ngram import grammar_bigram

            with open(args.grammar) as f:
                sentences = [line.split() for line in f if line.split()]
            lm = grammar_bigram([[w.lower() for w in s] for s in sentences], tokens=sorted(set(graph.labels)))
        elif args.bigram_lm or needs_lattice:
            if args.mode != "word":
                raise SystemExit("--bigram-lm requires --mode word")
            from mogasr_torch.lm.ngram import (
                estimate_bigram, estimate_bigram_kn, estimate_trigram, estimate_trigram_kn,
            )

            lm_tokens = sorted(set(graph.labels))
            transcripts = [fb.words[b] for fb in batches for b in range(fb.size)]
            est_bi = estimate_bigram_kn if args.lm_smoothing == "kn" else estimate_bigram
            est_tri = estimate_trigram_kn if args.lm_smoothing == "kn" else estimate_trigram
            lm = est_bi(transcripts, lm_tokens)
            if args.trigram_rescore:
                if args.arpa:
                    from mogasr_torch.lm.arpa import read_arpa_trigram

                    trigram = read_arpa_trigram(args.arpa, tokens=lm_tokens)
                else:
                    trigram = est_tri(transcripts, lm_tokens)
            if args.write_arpa:
                from mogasr_torch.lm.arpa import write_arpa

                write_arpa(args.write_arpa, trigram if trigram is not None else lm)

        params = kernel_params(gmm, "float32")
        refs, hyps, ids, nbest_lists = [], [], [], []
        wrote_lattices = False
        audio_sec = sum(len(w) for _, w, _ in corpus) / fcfg.sample_rate
        with Timer() as t:
            for fb in batches:
                scores = score_batch(fb.feats, gmm, params=params)
                if needs_lattice:
                    from mogasr_torch.decoder.lattice import lattice_nbest, rescore_lattice
                    from mogasr_torch.pipeline import decode_batch_lattices

                    lats, _ = decode_batch_lattices(fb, scores, graph, lm, dcfg, chain_entry_logp=pron_logp)
                    if args.lattice_out:
                        from mogasr_torch.decoder.lattice import write_lattices

                        write_lattices(args.lattice_out, [(fb.utt_ids[b], lats[b]) for b in range(fb.size)],
                                       append=wrote_lattices)
                        wrote_lattices = True
                    second = trigram if trigram is not None else lm
                    if args.consensus == "cn":
                        from mogasr_torch.decoder.confusion import confusion_network, consensus_decode

                        out = [consensus_decode(confusion_network(lat, second))[0] for lat in lats]
                    elif args.consensus == "mbr":
                        from mogasr_torch.decoder.confusion import mbr_nbest_decode

                        out = [mbr_nbest_decode(lat, second, n=max(args.nbest, 16))[0] for lat in lats]
                    else:
                        out = [rescore_lattice(lat, second)[0] for lat in lats]
                    if args.nbest > 0:
                        nbest_lists.extend(
                            [{"hyp": [w.lower() for w in h], "logp": s}
                             for h, s in lattice_nbest(lat, second, args.nbest)]
                            for lat in lats
                        )
                elif lm is not None:
                    from mogasr_torch.decoder.lm_viterbi import path_to_tokens_lm, viterbi_lm

                    res = viterbi_lm(scores, graph, lm, fb.n_frames, acoustic_scale=args.acoustic_scale,
                                     insertion_penalty=args.insertion_penalty, chain_entry_logp=pron_logp)
                    toks = path_to_tokens_lm(res, graph)
                    out = [[w for w in h if w not in ("<sil>", "sil")] for h in toks]
                else:
                    out = decode_batch(fb, scores, graph, dcfg)
                for b in range(fb.size):
                    ids.append(fb.utt_ids[b])
                    refs.append([w.lower() for w in fb.words[b]])
                    hyps.append([w.lower() for w in out[b]])
        rec = {
            "stage": "decode", "mode": args.mode, "utts": len(ids),
            "wall_sec": t.seconds, "rtf": t.seconds / max(audio_sec, 1e-9),
            "utts_per_sec": len(ids) / t.seconds,
        }
        if any(refs) and args.mode == "word":
            wer, counts = corpus_wer(refs, hyps)
            rec.update(wer=wer, sub=counts.substitutions, dels=counts.deletions, ins=counts.insertions)
            if args.ci:
                from mogasr_torch.eval.wer import wer_bootstrap_ci

                _w, lo, hi = wer_bootstrap_ci(refs, hyps)
                rec.update(wer_ci95=[round(lo, 4), round(hi, 4)])
            if args.errors_out:
                from mogasr_torch.eval.wer import error_report

                with open(args.errors_out, "w") as f:
                    f.write(error_report(refs, hyps, ids))
        elif any(refs) and args.mode == "phone":
            # phone error rate: expand reference words to phones (no silences)
            phone_refs = [
                [lex.phones[p] for p in lex.words_to_phone_ids(r, interword_sil=False, edge_sil=False, oov="skip")]
                for r in refs
            ]
            per, counts = corpus_wer(phone_refs, hyps)
            rec.update(per=per, sub=counts.substitutions, dels=counts.deletions, ins=counts.insertions)
        logger.log(rec)
    if args.out:
        with open(args.out, "w") as f:
            for i, (utt_id, hyp) in enumerate(zip(ids, hyps)):
                rec_out = {"utt_id": utt_id, "hyp": hyp}
                if nbest_lists:
                    rec_out["nbest"] = nbest_lists[i]
                f.write(json.dumps(rec_out) + "\n")


if __name__ == "__main__":
    main()

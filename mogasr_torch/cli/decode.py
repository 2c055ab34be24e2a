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
it), not orbax. ``--am mlp|lstm|blstm|tdnn|conformer|moe --nn-ckpt DIR``
scores with a trained hybrid model instead (``cli.train_nn``'s checkpoint;
``--nn-hidden/--nn-layers/--nn-experts`` as trained, ``--nn-precision``
float32, bfloat16 or int8; LstmAm and BlstmAm on K4), and
``--ivector-ckpt`` appends the extractor's i-vectors to its features. Each
batch's dummy rows are left out before scoring.

``--ctc`` with ``--am <arch> --nn-ckpt <run-dir>/nn_ctc_<arch>`` (``cli.train_nn
--objective ctc``): log posteriors over phones + blank (LstmAm and BlstmAm on
K4), decoded in word mode over the CTC word loop (``am.ctc.ctc_decode_graph``:
K2's word-loop arm with its skip arm, or the LM decoder with ``--bigram-lm``),
in phone mode greedily; with ``--bpe FILE`` (the run's bpe.json) lexicon-free
words, greedily, or with ``--bias``/``--fusion-lm`` through the prefix beam on
the device (``am.ctc.ctc_prefix_beam_decode_device``, width ``--bias-beam``).

``--rnnt`` with ``--am lstm|blstm --nn-ckpt <run-dir>/nn_rnnt_<arch>``
(``cli.train_nn --objective rnnt``; ``--rnnt-pred/--rnnt-plain/
--rnnt-pruned`` as trained): phones in phone mode, BPE words with ``--bpe``
in word mode, from the device greedy (the encoder on K4), or with
``--rnnt-beam N`` the device beam (``am.rnnt.rnnt_beam_decode_device``),
with ``--fusion-lm`` (a unit bigram over the model's units) and ``--bias``.

``--nnlm-rescore DIR`` (``cli.train_lm``'s <run-dir>/nnlm) re-ranks N-best
lists with the neural word LM (``lm.neural.rescore_nbest_nnlm``, weight
``--nnlm-weight``, depth ``--nnlm-nbest``): those of the word lattice (a
lattice pass), of the CTC prefix beam with ``--ctc --bpe``, and of the RNN-T
beam with ``--rnnt --bpe --rnnt-beam N`` (its N-best, at most N deep).

``--aed --nn-ckpt <run-dir>/nn_aed_<arch>`` (``cli.train_nn --objective
aed``; ``--nn-hidden/--nn-layers`` and ``--aed-chunk/--aed-left-chunks`` as
trained; ``--am`` is not read): the attention encoder-decoder's beam search
(``am.aed.make_aed_decoder``, width ``--aed-beam``, ``--aed-max-tokens``
tokens), its final beams rescored with the CTC head on K3 at
``--aed-ctc-weight``; phones in phone mode, BPE words with ``--bpe`` in word
mode, with ``--fusion-lm`` (a unit bigram over the BPE units) gathered
inside the beam. ``--add-pitch`` appends the pitch triple (``frontend/pitch.py``)
to the features.
"""

from __future__ import annotations

import argparse
import json
import os

from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.cli.common import (
    add_aed_args, add_corpus_args, add_ctc_beam_args, add_nn_args, add_rnnt_args, add_run_args, device_of,
    load_corpus, load_nn_scorer, load_or_random_gmm, make_logger,
)
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.eval.wer import corpus_wer
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import decode_batch, featurize, live_rows, score_batch, word_decode_graph
from mogasr_torch.utils.metrics import Timer, trace


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple (POV, centered log-f0, delta log-f0) to the features")
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--bundle", metavar="DIR",
                   help="trained-system bundle dir (utils/bundle.py, e.g. benchmarks/headline): loads GMM + "
                        "lexicon + topology + tied triphones + frontend config, overriding "
                        "--gmm-ckpt/--lexicon/--num-*")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    add_nn_args(p)
    p.add_argument("--ctc", action="store_true",
                   help="the NN checkpoint is a CTC model (train_nn --objective ctc): posterior scoring over "
                        "phones+blank, CTC-topology decode graph (word mode) or greedy best-path phone decode "
                        "(phone mode)")
    p.add_argument("--bpe", metavar="FILE",
                   help="with --ctc/--rnnt/--aed: the checkpoint was trained on BPE subword units (train_nn "
                        "--bpe-merges; "
                        "FILE is its bpe.json): lexicon-free word decoding")
    p.add_argument("--rnnt", action="store_true",
                   help="the NN checkpoint is an RNN-transducer (train_nn --objective rnnt): device greedy (or "
                        "--rnnt-beam) decoding over phones (--mode phone) or BPE words (--bpe); --am lstm/blstm "
                        "picks the encoder")
    add_rnnt_args(p)
    p.add_argument("--aed", action="store_true",
                   help="the NN checkpoint is an attention encoder-decoder (train_nn --objective aed): beam search "
                        "over the Conformer and decoder (--mode phone, or word with --bpe; --nn-hidden/--nn-layers "
                        "must match training; --am is not read)")
    add_aed_args(p)
    p.add_argument("--ivector-ckpt", metavar="DIR",
                   help="i-vector extractor (cli.train_nn --ivector-dim): append per-utterance i-vectors to the "
                        "hybrid model's features")
    p.add_argument("--ivector-dim", type=int, default=16)
    p.add_argument("--ivector-components", type=int, default=64)
    add_ctc_beam_args(p)
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
    p.add_argument("--nnlm-rescore", metavar="DIR",
                   help="second-pass neural-LM rescoring of N-best lists with the LM of cli.train_lm (DIR is its "
                        "nnlm/ checkpoint): the word lattice's (implies a lattice pass), or the --ctc --bpe / --rnnt "
                        "--bpe --rnnt-beam beam's")
    p.add_argument("--nnlm-weight", type=float, default=0.5,
                   help="log-linear weight of the neural-LM score against the first-pass score")
    p.add_argument("--nnlm-nbest", type=int, default=16, help="N-best depth fed to the neural rescorer")
    p.add_argument("--lm-smoothing", default="addalpha", choices=["addalpha", "kn"],
                   help="n-gram estimation: add-alpha or interpolated Kneser-Ney")
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--beam", type=float, default=0.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--out", help="write hypotheses (jsonl)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.am != "gmm" and not args.nn_ckpt:
        raise SystemExit("--nn-ckpt is required with --am mlp/lstm")
    if args.am != "gmm" and args.bundle:
        raise SystemExit("--bundle carries a GMM system: incompatible with a hybrid --am")
    if args.ivector_ckpt and (args.am == "gmm" or args.aed or args.rnnt):
        raise SystemExit("--ivector-ckpt augments hybrid/CTC neural features: use --am mlp/lstm/blstm/tdnn")
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

    beam_rescore = bool(args.nnlm_rescore) and args.bpe is not None and (args.ctc or args.rnnt)
    needs_lattice = (args.trigram_rescore or args.nbest > 0 or args.consensus != "off" or bool(args.lattice_out)
                     or (bool(args.nnlm_rescore) and not beam_rescore))
    if args.nnlm_rescore and args.consensus != "off":
        raise SystemExit("--nnlm-rescore re-ranks N-best lists: incompatible with --consensus")
    if (needs_lattice or args.multi_pron) and args.mode != "word":
        raise SystemExit("--multi-pron/--trigram-rescore/--nbest/--consensus require --mode word")
    if args.ctc and args.rnnt:
        raise SystemExit("--ctc/--rnnt are different acoustic models")
    if (args.ctc or args.rnnt) and (args.am == "gmm" or args.multi_pron):
        raise SystemExit("--ctc/--rnnt require a neural --am and no --multi-pron")
    if args.rnnt and (needs_lattice or args.bigram_lm or args.grammar):
        raise SystemExit("--rnnt decodes without a graph: incompatible with --bigram-lm/--grammar/lattice passes")
    if args.rnnt and args.mode != ("word" if args.bpe else "phone"):
        raise SystemExit("--rnnt --bpe decodes words (--mode word); without --bpe phones (--mode phone)")
    if args.rnnt and (args.bias or args.nnlm_rescore) and args.rnnt_beam <= 0:
        raise SystemExit("--rnnt --bias/--nnlm-rescore work inside the beam search: add --rnnt-beam N")
    if args.aed and (args.ctc or args.rnnt or args.multi_pron or needs_lattice or args.bigram_lm or args.grammar
                     or args.trigram_rescore):
        raise SystemExit("--aed is direct beam-search decoding: incompatible with "
                         "--ctc/--rnnt/--multi-pron/--bigram-lm/--grammar/lattice passes")
    if args.ctc and args.bpe and (args.mode == "phone" or args.consensus != "off" or args.nbest > 0
                                  or args.bigram_lm or args.trigram_rescore or args.lattice_out):
        raise SystemExit("--ctc --bpe decodes words via the prefix beam: incompatible with --mode phone, "
                         "--consensus, --nbest, --bigram-lm, --trigram-rescore, --lattice-out")
    if args.aed and args.bpe and args.mode != "word":
        raise SystemExit("--aed --bpe decodes words: use --mode word")
    if args.aed and not args.bpe and args.mode != "phone":
        raise SystemExit("--aed without --bpe decodes phones: use --mode phone")
    if args.aed and args.fusion_lm and not args.bpe:
        raise SystemExit("--aed --fusion-lm needs --bpe (the unit LM is over the BPE inventory)")
    if args.aed and not args.nn_ckpt:
        raise SystemExit("--nn-ckpt is required with --am mlp/lstm")

    run_dir = os.path.abspath(args.run_dir)
    with trace(os.path.join(run_dir, "profile") if args.profile else None):
        batches = featurize(corpus, fcfg, BatchConfig(), device)
        ivec_rank = 0
        if args.ivector_ckpt:
            from mogasr_torch.am.ivector import load_extractor
            from mogasr_torch.pipeline import append_ivectors

            extractor = load_extractor(args.ivector_ckpt, device)
            if (extractor.ubm.n_components, extractor.rank) != (args.ivector_components, args.ivector_dim):
                raise SystemExit(f"--ivector-ckpt holds {extractor.ubm.n_components} components of rank "
                                 f"{extractor.rank}: pass --ivector-components and --ivector-dim as trained")
            batches = append_ivectors(batches, extractor)
            ivec_rank = extractor.rank
        bpe = None
        if args.aed:
            from mogasr_torch.cli.common import load_aed_model

            if args.bpe:
                from mogasr_torch.data.bpe import load_bpe

                bpe = load_bpe(args.bpe)
            aed_model = load_aed_model(args, bpe.n_units if bpe is not None else lex.n_phones, fcfg.feat_dim, device)
            scorer = None
        elif args.rnnt:
            from mogasr_torch.cli.common import load_rnnt_model

            if args.bpe:
                from mogasr_torch.data.bpe import load_bpe

                bpe = load_bpe(args.bpe)
            rnnt_model = load_rnnt_model(args, args.am, bpe.n_units if bpe is not None else lex.n_phones,
                                         fcfg.feat_dim, device)
            scorer = None
        elif args.am == "gmm":
            gmm = bundle[0] if bundle is not None else load_or_random_gmm(args, fcfg.feat_dim, device)
            params, scorer = kernel_params(gmm, "float32"), None
        elif args.ctc:
            from mogasr_torch.am.ctc import make_ctc_scorer
            from mogasr_torch.cli.common import load_ctc_model

            if args.bpe:
                from mogasr_torch.data.bpe import load_bpe

                bpe = load_bpe(args.bpe)
            n_units = bpe.n_units if bpe is not None else lex.n_phones
            scorer = make_ctc_scorer(load_ctc_model(args.am, n_units, args.nn_hidden, args.nn_layers,
                                                    fcfg.feat_dim + ivec_rank, args.nn_ckpt, device))
        else:
            scorer = load_nn_scorer(args, topo.n_pdfs, fcfg.feat_dim + ivec_rank, device)

        pron_logp = None
        if args.aed or args.rnnt:
            graph = None  # label-synchronous attention and frame-synchronous transducer decoding need no graph
        elif args.ctc:
            from mogasr_torch.am.ctc import ctc_decode_graph

            # word mode: the CTC word loop; phone mode and --bpe decode without a graph
            graph = ctc_decode_graph(lex, dcfg) if args.mode == "word" and bpe is None else None
        elif args.mode == "word" and args.multi_pron:
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
        elif args.bigram_lm or (needs_lattice and bpe is None):
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
        nnlm = None
        if args.nnlm_rescore:
            from mogasr_torch.lm.neural import load_nnlm

            nnlm = load_nnlm(args.nnlm_rescore, device)  # (model, vocab)
        if args.aed:
            e2e_units = _aed_decoder(args, aed_model, bpe, lex)
        elif args.rnnt:
            e2e_units = _rnnt_decoder(args, rnnt_model, bpe, lex, nnlm)

        refs, hyps, ids, nbest_lists = [], [], [], []
        wrote_lattices = False
        audio_sec = sum(len(w) for _, w, _ in corpus) / fcfg.sample_rate
        with Timer() as t:
            for fb in map(live_rows, batches):
                if args.aed or args.rnnt:
                    out = e2e_units(fb)
                    for b in range(fb.size):
                        ids.append(fb.utt_ids[b])
                        refs.append([w.lower() for w in fb.words[b]])
                        hyps.append([w.lower() for w in out[b]])
                    continue
                scores = scorer(fb) if scorer is not None else score_batch(fb.feats, gmm, params=params)
                if bpe is not None:
                    out = _ctc_bpe_words(args, bpe, scores, fb.n_frames, nnlm)
                elif needs_lattice:
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
                    elif nnlm is not None:
                        from mogasr_torch.lm.neural import rescore_nbest_nnlm

                        depth = max(args.nnlm_nbest, args.nbest)
                        rescored = rescore_nbest_nnlm(nnlm[0], nnlm[1], [lattice_nbest(lat, second, depth)
                                                                         for lat in lats], weight=args.nnlm_weight)
                        out = [lst[0][0] if lst else [] for lst in rescored]
                        if args.nbest > 0:
                            nbest_lists.extend([{"hyp": h, "logp": s} for h, s in lst[: args.nbest]]
                                               for lst in rescored)
                    else:
                        out = [rescore_lattice(lat, second)[0] for lat in lats]
                    if args.nbest > 0 and nnlm is None:
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
                elif args.ctc and args.mode == "phone":
                    from mogasr_torch.am.ctc import ctc_greedy_decode

                    out = [[lex.phones[u] for u in seq] for seq in ctc_greedy_decode(scores, fb.n_frames)]
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


def _nnlm_best(args, nnlm, ranked, bpe):
    """The best words of each row's beam N-best [(score, units)] re-ranked
    by the neural LM (first-pass score = the beam's)."""
    from mogasr_torch.lm.neural import rescore_nbest_nnlm

    nbest = [[(bpe.decode(seq), s) for s, seq in r[: args.nnlm_nbest]] for r in ranked]
    rescored = rescore_nbest_nnlm(nnlm[0], nnlm[1], nbest, weight=args.nnlm_weight)
    return [r[0][0] if r else [] for r in rescored]


def _ctc_bpe_words(args, bpe, logp, n_frames, nnlm):
    """``--ctc --bpe``: each row's words, greedily, or with ``--bias`` /
    ``--fusion-lm`` / ``--nnlm-rescore`` from the device prefix beam (the
    neural LM re-ranking its N-best)."""
    from mogasr_torch.am.ctc import ctc_greedy_decode, ctc_prefix_beam_decode_device

    if not (args.bias or args.fusion_lm or nnlm is not None):
        return [bpe.decode(seq) for seq in ctc_greedy_decode(logp, n_frames)]
    from mogasr_torch.cli.common import ctc_beam_tables

    fusion, bias_next, bias_delta = ctc_beam_tables(args, bpe)
    beam = max(args.bias_beam, args.nnlm_nbest if nnlm is not None else 0)
    ranked = ctc_prefix_beam_decode_device(logp, n_frames, beam_size=beam, u_cap=int(logp.shape[1]),
                                           fusion=fusion, bias_next=bias_next, bias_delta=bias_delta)
    if nnlm is not None:
        return _nnlm_best(args, nnlm, ranked, bpe)
    return [bpe.decode(r[0][1]) for r in ranked]


def _aed_decoder(args, model, bpe, lex):
    """``--aed``: fb -> each row's words (BPE) or phones from the beam
    search, its finals rescored with the CTC head (K3), with ``--fusion-lm``
    the unit bigram inside the beam."""
    from mogasr_torch.am.aed import aed_fusion_matrix, make_aed_decoder

    fusion = None
    if args.fusion_lm:
        from mogasr_torch.lm.unit_ngram import load_unit_lm

        fusion = aed_fusion_matrix(model, load_unit_lm(args.fusion_lm), args.fusion_weight)
    dec = make_aed_decoder(model, beam=args.aed_beam, max_tokens=args.aed_max_tokens, ctc_weight=args.aed_ctc_weight,
                           fusion=fusion)

    def decode(fb):
        toks, n_toks, _ = dec(fb.feats, fb.n_frames)
        toks, n_toks = toks.cpu().numpy(), n_toks.cpu().numpy()
        seqs = [[int(t) for t in toks[b, : n_toks[b]]] for b in range(fb.size)]
        return [bpe.decode(s) for s in seqs] if bpe is not None else [[lex.phones[u] for u in s] for s in seqs]

    return decode


def _rnnt_decoder(args, model, bpe, lex, nnlm):
    """``--rnnt``: fb -> each row's words (BPE) or phones, from the device
    greedy, or with ``--rnnt-beam`` the device beam (fusion and biasing
    tables over the model's units; the neural LM re-ranking its N-best)."""
    from mogasr_torch.am.rnnt import rnnt_beam_decode_device, rnnt_fusion_matrix, rnnt_greedy_decode_device

    n_units = model.n_labels

    def text(seq):
        return bpe.decode(seq) if bpe is not None else [lex.phones[u] for u in seq]

    if args.rnnt_beam <= 0:
        return lambda fb: [text(seq) for seq in rnnt_greedy_decode_device(model, fb.feats, fb.n_frames)]
    fusion = bias_next = bias_delta = None
    if args.fusion_lm:
        from mogasr_torch.lm.unit_ngram import load_unit_lm

        ulm = load_unit_lm(args.fusion_lm)
        if ulm.n_units != n_units:
            raise SystemExit(f"--rnnt --fusion-lm unit mismatch: LM has {ulm.n_units} units, model decodes "
                             f"{n_units} (train_lm --unit-ngram with the matching --bpe, or without it for phones)")
        fusion = rnnt_fusion_matrix(model, ulm, args.fusion_weight)
    if args.bias:
        from mogasr_torch.decoder.biasing import CompiledBiaser, biaser_from_bpe, biaser_from_words, load_phrases

        phrases = load_phrases(args.bias)
        biaser = (biaser_from_bpe(bpe, phrases, weight=args.bias_weight) if bpe is not None
                  else biaser_from_words(lex, phrases, weight=args.bias_weight))
        comp = CompiledBiaser(biaser, n_units)
        bias_next, bias_delta = comp.next_state, comp.delta

    def decode(fb):
        ranked = rnnt_beam_decode_device(model, fb.feats, fb.n_frames, beam_size=args.rnnt_beam, fusion=fusion,
                                         bias_next=bias_next, bias_delta=bias_delta)
        if nnlm is not None:
            return _nnlm_best(args, nnlm, ranked, bpe)
        return [text(r[0][1]) for r in ranked]

    return decode


if __name__ == "__main__":
    main()

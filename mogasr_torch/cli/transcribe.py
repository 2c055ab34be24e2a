"""Transcribe a long recording on the card, VAD segmentation -> decode ->
timestamps: the twin of the reference's cli/transcribe.py on its GMM path.

    python -m mogasr_torch.cli.transcribe (--synthetic-demo | --audio FILE) [--gmm-ckpt DIR] \\
        [--nbest N] [--ctm FILE] [--out FILE] [--max-segment-s 30] [--diarize [--num-speakers N]] \
        [--device cpu]

Energy VAD (``frontend/vad.py``) splits the recording into utterance-sized
segments; each goes through the front end, K1 (float32, sum mode) and
``pipeline.decode_batch_with_confidence`` (K2 over the word loop, then K3's
forward-backward for each word's posterior confidence and its Viterbi time
span); ``--nbest`` adds the top-N word sequences of each segment from its
word lattice under a uniform word LM (``decode_batch_lattices``,
``decoder.lattice.lattice_nbest``). The output is the reference's: one JSON
line per segment (start/end seconds, words, confidences, word times[,
nbest]), and with ``--ctm`` a CTM file. ``--gmm-ckpt`` reads the port's
checkpoint format; without it a random GMM is drawn as the reference draws
it. Records go to <run-dir>/metrics.jsonl. Runs on ``--device`` (default
cuda).

``--diarize`` also diarizes the recording (``diarize.train_diarizer`` on
its own VAD segments, then ``diarize.diarize_wave``: i-vectors on the card,
clustering on the host) and tags every segment with the speaker that
overlaps it most, ``--num-speakers`` (0: found by the clustering's distance
threshold), ``--diarize-components`` and ``--diarize-rank`` as in the
reference.

``--ctc --nn-ckpt DIR`` (``cli.train_nn --objective ctc``; ``--nn-arch/
--nn-hidden/--nn-layers`` as trained) scores each segment with the CTC
model's log posteriors (LstmAm and BlstmAm on K4) and decodes them over the
CTC word loop (``am.ctc.ctc_decode_graph``) the same way, K2's and K3's skip
arms included; with ``--bpe FILE`` lexicon-free words from the greedy best
path, their times from the units' first frames and their confidences the mean
best-path posterior (``am.ctc.ctc_greedy_decode_with_frames``). ``--rnnt
--nn-ckpt DIR`` (``cli.train_nn --objective rnnt``; ``--nn-arch lstm|blstm``,
``--rnnt-pred/--rnnt-plain/--rnnt-pruned`` as trained): each segment's
phones, or words with ``--bpe``, from the device greedy (the encoder on K4),
without confidences or times, as the reference. ``--aed --nn-ckpt DIR``
(``cli.train_nn --objective aed``; ``--nn-hidden/--nn-layers`` and
``--aed-chunk/--aed-left-chunks`` as trained): each segment's phones, or
words with ``--bpe``, from the attention beam (``am.aed.aed_decode_batch``,
width ``--aed-beam``, ``--aed-max-tokens`` tokens, rescored with the CTC
head on K3 at ``--aed-ctc-weight``), with segment times only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.cli.common import (
    add_aed_args, add_rnnt_args, add_run_args, device_of, load_or_random_gmm, make_logger,
)
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.frontend.vad import VadConfig, segment_utterances
from mogasr_torch.hmm.lexicon import load_lexicon, synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import decode_batch_with_confidence, featurize, score_batch, word_decode_graph
from mogasr_torch.utils.metrics import Timer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_run_args(p)
    p.add_argument("--audio", help="wav file to transcribe")
    p.add_argument("--synthetic-demo", action="store_true",
                   help="transcribe a generated long recording instead of a file")
    p.add_argument("--lexicon", help="Kaldi-style lexicon.txt (default: synthetic)")
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--max-segment-s", type=float, default=30.0)
    p.add_argument("--nbest", type=int, default=0,
                   help="also emit the top-N alternative word sequences per segment from a word lattice (uniform "
                        "word LM)")
    p.add_argument("--out", help="write transcript (jsonl)")
    p.add_argument("--ctm", help="also write a CTM file (standard scoring format: utt channel start dur word conf)")
    p.add_argument("--diarize", action="store_true",
                   help="also diarize the recording (per-recording UBM+TV i-vector clustering trained on the "
                        "recording's own VAD speech) and tag every segment with a speaker label")
    p.add_argument("--num-speakers", "--diarize-speakers", dest="num_speakers", type=int, default=0,
                   help="with --diarize: known speaker count (0 = find it by the AHC distance threshold)")
    p.add_argument("--diarize-components", type=int, default=16)
    p.add_argument("--diarize-rank", type=int, default=8)
    p.add_argument("--ctc", action="store_true",
                   help="use a CTC acoustic model (train_nn --objective ctc checkpoint via --nn-ckpt) through the "
                        "CTC-topology word graph, or lexicon-free with --bpe")
    p.add_argument("--rnnt", action="store_true",
                   help="use an RNN-transducer (train_nn --objective rnnt checkpoint via --nn-ckpt): device greedy "
                        "phones, or words with --bpe")
    add_rnnt_args(p, beam=False)
    p.add_argument("--aed", action="store_true",
                   help="use an attention encoder-decoder (train_nn --objective aed checkpoint via --nn-ckpt): beam "
                        "search a VAD segment; phones (or words with --bpe) with segment times, no per-word times "
                        "or confidences")
    add_aed_args(p)
    p.add_argument("--bpe", metavar="FILE",
                   help="with --aed/--rnnt: BPE words; with --ctc: lexicon-free open-vocabulary transcription (a "
                        "--bpe-merges checkpoint), word times from the greedy best path")
    p.add_argument("--nn-ckpt", help="CTC/RNN-T/AED checkpoint dir (with --ctc/--rnnt/--aed)")
    p.add_argument("--nn-arch", default="mlp", choices=["mlp", "lstm", "blstm", "tdnn", "conformer"])
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if sum((args.aed, args.ctc, args.rnnt)) > 1:
        raise SystemExit("--aed/--ctc/--rnnt are different acoustic models")
    if args.rnnt and (args.nbest or args.ctm):
        raise SystemExit("--rnnt has no word lattice/alignment: incompatible with --nbest/--ctm")
    if args.aed and (args.nbest or args.ctm):
        raise SystemExit("--aed has no word lattice/alignment: incompatible with --nbest/--ctm")
    if args.ctc and args.bpe and args.nbest:
        raise SystemExit("--ctc --bpe is lexicon-free greedy decoding (no lattice): incompatible with --nbest")
    device = device_of(args.device)
    fcfg = FrontendConfig()
    if args.synthetic_demo:
        from mogasr_torch.data.synthetic import make_corpus

        utts = make_corpus(4, words_per_utt=(2, 3), seed=5)
        gap = np.zeros(16000, np.float32)
        wave = np.concatenate(sum(([u.wave, gap] for u in utts), [gap]))
    elif args.audio:
        from mogasr_torch.data.audio import read_audio

        wave, _sr = read_audio(args.audio, target_sr=fcfg.sample_rate)
    else:
        raise SystemExit("pass --audio FILE or --synthetic-demo")

    lex = load_lexicon(args.lexicon) if args.lexicon else synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(acoustic_scale=args.acoustic_scale, word_insertion_penalty=args.insertion_penalty)
    bpe = ctc_model = rnnt_model = aed_model = None
    if args.aed:
        if not args.nn_ckpt:
            raise SystemExit("--aed requires --nn-ckpt")
        from mogasr_torch.cli.common import load_aed_model

        if args.bpe:
            from mogasr_torch.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
        aed_model = load_aed_model(args, bpe.n_units if bpe is not None else lex.n_phones, fcfg.feat_dim, device)
    elif args.rnnt:
        if not args.nn_ckpt:
            raise SystemExit("--rnnt requires --nn-ckpt")
        from mogasr_torch.cli.common import load_rnnt_model

        if args.bpe:
            from mogasr_torch.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
        rnnt_model = load_rnnt_model(args, args.nn_arch, bpe.n_units if bpe is not None else lex.n_phones,
                                     fcfg.feat_dim, device)
    elif args.ctc:
        if not args.nn_ckpt:
            raise SystemExit("--ctc requires --nn-ckpt")
        from mogasr_torch.am.ctc import make_ctc_scorer
        from mogasr_torch.cli.common import load_ctc_model

        if args.bpe:
            from mogasr_torch.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
        ctc_model = load_ctc_model(args.nn_arch, bpe.n_units if bpe is not None else lex.n_phones, args.nn_hidden,
                                   args.nn_layers, fcfg.feat_dim, args.nn_ckpt, device)
        ctc_scorer = make_ctc_scorer(ctc_model)
    else:
        gmm = load_or_random_gmm(args, fcfg.feat_dim, device)
        params = kernel_params(gmm, "float32")
    logger = make_logger(args)

    with Timer() as t:
        segments = segment_utterances(wave, fcfg, VadConfig(max_segment_s=args.max_segment_s))
        corpus = [(f"seg-{i:04d}", wave[a:b], []) for i, (a, b) in enumerate(segments)]
        results = []
        if corpus:
            if bpe is not None or args.rnnt or args.aed:
                graph = None
            elif args.ctc:
                from mogasr_torch.am.ctc import ctc_decode_graph

                graph = ctc_decode_graph(lex, dcfg)
            else:
                graph = word_decode_graph(lex, topo, dcfg)
            # bucket ceilings cover max_segment_s, or make_batches would drop
            # segments between the default 20 s ceiling and the VAD cap
            max_frames = int(args.max_segment_s * 1000 / fcfg.frame_shift_ms) + 10
            bcfg = BatchConfig(bucket_boundaries=tuple(sorted({500, 1000, 2000, max_frames})))
            if args.nbest > 0:
                from mogasr_torch.decoder.lattice import lattice_nbest
                from mogasr_torch.lm.ngram import uniform_bigram
                from mogasr_torch.pipeline import decode_batch_lattices

                nbest_lm = uniform_bigram(sorted(set(graph.labels)))
            shift_s = fcfg.frame_shift_ms / 1000.0
            for fb in featurize(corpus, fcfg, bcfg, device):
                if args.aed or args.rnnt:
                    if args.aed:
                        from mogasr_torch.am.aed import aed_decode_batch

                        seqs = aed_decode_batch(aed_model, fb.feats, fb.n_frames, beam=args.aed_beam,
                                                max_tokens=args.aed_max_tokens, ctc_weight=args.aed_ctc_weight)
                    else:
                        from mogasr_torch.am.rnnt import rnnt_greedy_decode_device

                        seqs = rnnt_greedy_decode_device(rnnt_model, fb.feats, fb.n_frames)
                    for b in range(fb.size):
                        a, e = segments[int(fb.utt_ids[b].split("-")[1])]
                        results.append({"start_s": round(a / fcfg.sample_rate, 2),
                                        "end_s": round(e / fcfg.sample_rate, 2),
                                        "words": bpe.decode(seqs[b]) if bpe else [lex.phones[u] for u in seqs[b]]})
                    continue
                if bpe is not None:
                    results.extend(_ctc_bpe_segments(ctc_model, bpe, fb, segments, fcfg))
                    continue
                scores = ctc_scorer(fb) if args.ctc else score_batch(fb.feats, gmm, params=params)
                out = decode_batch_with_confidence(fb, scores, graph, dcfg, with_times=True)
                nbests = None
                if args.nbest > 0:
                    lats, _res = decode_batch_lattices(fb, scores, graph, nbest_lm, dcfg)
                    nbests = [[{"words": h, "logp": s} for h, s in lattice_nbest(lat, nbest_lm, args.nbest)]
                              for lat in lats]
                for b in range(fb.size):
                    a, e = segments[int(fb.utt_ids[b].split("-")[1])]
                    seg_start = a / fcfg.sample_rate
                    rec = {
                        "start_s": round(seg_start, 2),
                        "end_s": round(e / fcfg.sample_rate, 2),
                        "words": [w for w, _c, _t0, _t1 in out[b]],
                        "confidences": [c for _w, c, _t0, _t1 in out[b]],
                        # per-word absolute timestamps from the Viterbi spans
                        "word_times": [[round(seg_start + t0 * shift_s, 2), round(seg_start + t1 * shift_s, 2)]
                                       for _w, _c, t0, t1 in out[b]],
                    }
                    if nbests is not None:
                        rec["nbest"] = nbests[b]
                    results.append(rec)
        if args.diarize and results:
            from mogasr_torch.diarize import diarize_wave, train_diarizer

            seg_utts = [(f"d-{i:04d}", wave[a:b], []) for i, (a, b) in enumerate(segments)]
            ubm, t_mat = train_diarizer(seg_utts, fcfg, n_components=args.diarize_components,
                                        rank=args.diarize_rank, device=device)
            turns = diarize_wave(wave, fcfg, ubm, t_mat, n_speakers=args.num_speakers or None)
            for r in results:
                overlap = {}
                for t0, t1, spk in turns:
                    o = min(r["end_s"], t1) - max(r["start_s"], t0)
                    if o > 0:
                        overlap[spk] = overlap.get(spk, 0.0) + o
                r["speaker"] = max(overlap, key=overlap.get) if overlap else None
    results.sort(key=lambda r: r["start_s"])
    audio_s = len(wave) / fcfg.sample_rate
    logger.log({
        "stage": "transcribe", "audio_s": round(audio_s, 1), "segments": len(segments), "wall_sec": t.seconds,
        "rtf": t.seconds / max(audio_s, 1e-9),
    })
    lines = [json.dumps(r) for r in results]
    if args.ctm:
        with open(args.ctm, "w") as f:
            for r in results:
                for w, c, (t0, t1) in zip(r["words"], r["confidences"], r["word_times"]):
                    f.write(f"rec 1 {t0:.2f} {max(t1 - t0, 0.01):.2f} {w} {c:.3f}\n")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    else:
        print("\n".join(lines))


def _ctc_bpe_segments(model, bpe, fb, segments, fcfg):
    """``--ctc --bpe``: each segment's words from the greedy best path, with
    times from the units' first frames and the mean best-path posterior over
    each word's emission frames as its confidence."""
    import torch

    from mogasr_torch.am.ctc import ctc_greedy_decode_with_frames, ctc_logits

    logits = ctc_logits(model, fb.feats, fb.n_frames)
    maxp = torch.softmax(logits, dim=-1).max(dim=-1).values.cpu().numpy()
    pairs_all = ctc_greedy_decode_with_frames(logits, fb.n_frames)
    shift_s = fcfg.frame_shift_ms / 1000.0
    out = []
    for b in range(fb.size):
        a, e = segments[int(fb.utt_ids[b].split("-")[1])]
        seg_start = a / fcfg.sample_rate
        pairs = pairs_all[b]
        spans = bpe.decode_with_spans([u for u, _ in pairs])
        out.append({
            "start_s": round(seg_start, 2),
            "end_s": round(e / fcfg.sample_rate, 2),
            "words": [w for w, _i0, _i1 in spans],
            "confidences": [round(float(np.mean([maxp[b, pairs[i][1]] for i in range(i0, i1 + 1)])), 3)
                            for _w, i0, i1 in spans],
            "word_times": [[round(seg_start + pairs[i0][1] * shift_s, 2),
                            round(seg_start + (pairs[i1][1] + 1) * shift_s, 2)] for _w, i0, i1 in spans],
        })
    return out


if __name__ == "__main__":
    main()

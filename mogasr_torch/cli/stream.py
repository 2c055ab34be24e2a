"""Online (streaming) recognition on the card, audio chunks in and hypotheses
out: the twin of the reference's cli/stream.py.

    python -m mogasr_torch.cli.stream (--synthetic-demo | --audio FILE) [--gmm-ckpt DIR] \\
        [--chunk-ms 250] [--cmvn-window 600] [--endpoint [--endpoint-trailing-sil S]] [--device cpu]

The causal sliding-window CMVN features of the chunked StreamingFrontend
(``frontend/streaming.py``, its spectral chunk on the card) are scored by K1
(float32, sum mode) and fed to the OnlineDecoder (``decoder/online.py``: K2's
chunk arm) as the audio arrives; a partial hypothesis is printed after every
chunk (K2's backtrace alone) and the exact result at the end. One JSON line
per event, as the reference prints them: {"t_audio_s", "partial"} per chunk
(with "endpoint" when ``--endpoint``'s causal endpointer fires and decoding
stops), then {"final", "rtf"}. ``--gmm-ckpt`` reads the port's checkpoint
format; without it a random GMM is drawn as the reference draws it. Records
go to <run-dir>/metrics.jsonl. Runs on ``--device`` (default cuda).

``--ctc --nn-ckpt <run-dir>/nn_ctc_lstm`` (``cli.train_nn --objective ctc
--arch lstm``; ``--nn-hidden/--nn-layers`` as trained) scores each chunk with
the stateful LstmAm (``am.neural.LstmAmStream``: K4's carry arm) and decodes
its log posteriors with the OnlineDecoder over the CTC word loop
(``am.ctc.ctc_decode_graph``: K2's chunk arm with its skip arm); with ``--bpe
FILE`` lexicon-free words through ``am.ctc.CtcStreamDecoder``, greedy, or the
host prefix beam (width ``--bias-beam``) with ``--bias`` and ``--fusion-lm``.

``--rnnt --nn-ckpt <run-dir>/nn_rnnt_lstm`` (``cli.train_nn --objective rnnt
--arch lstm``; ``--rnnt-pred/--rnnt-plain/--rnnt-pruned`` as trained):
``am.rnnt.RnntDeviceStream``, the stateful encoder on K4's carry arm and the
chunk-resumable device greedy, its hypothesis buffer ``--max-symbols`` long
(0: twice the audio's frames); phone partials, or words with ``--bpe``.

``--aed --nn-ckpt <run-dir>/nn_aed_<arch>`` (``cli.train_nn --objective aed
--aed-chunk C``; ``--aed-chunk/--aed-left-chunks`` and ``--nn-hidden/
--nn-layers`` as trained): the chunked streaming Conformer (``am.aed.
make_aed_stream_step``) over every complete chunk of 4 C feature frames,
CTC-greedy partials from its CTC head, and the final from the exact
chunk-masked attention beam over the whole utterance (width
``--aed-beam``, rescored with the CTC head on K3 at ``--aed-ctc-weight``);
phones, or words with ``--bpe``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mogasr_torch.am.gmm_cuda import kernel_params
from mogasr_torch.cli.common import (
    add_aed_args, add_ctc_beam_args, add_rnnt_args, add_run_args, device_of, load_or_random_gmm, make_logger,
)
from mogasr_torch.config import DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.decoder.online import OnlineDecoder
from mogasr_torch.frontend.streaming import StreamingFrontend
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm.lexicon import load_lexicon, synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import DROP_TOKENS, score_batch, word_decode_graph
from mogasr_torch.utils.metrics import Timer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_run_args(p)
    p.add_argument("--audio", help="wav file to stream")
    p.add_argument("--synthetic-demo", action="store_true", help="stream a generated utterance instead of a file")
    p.add_argument("--lexicon", help="Kaldi-style lexicon.txt (default: synthetic)")
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--chunk-ms", type=float, default=250.0)
    p.add_argument("--cmvn-window", type=int, default=600)
    p.add_argument("--endpoint", action="store_true",
                   help="causal endpointing (frontend/endpoint.py): stop decoding and finalize when a rule fires "
                        "(trailing silence / no speech / max length)")
    p.add_argument("--endpoint-trailing-sil", type=float, default=0.5, help="rule-1 trailing-silence seconds")
    p.add_argument("--ctc", action="store_true",
                   help="neural online CTC: the stateful LSTM (train_nn --objective ctc --arch lstm checkpoint via "
                        "--nn-ckpt) scores chunks; words decode online over the CTC word loop, or lexicon-free "
                        "with --bpe")
    p.add_argument("--rnnt", action="store_true",
                   help="online RNN-transducer: stateful LSTM encoder chunks + the chunk-resumable device greedy "
                        "(phone partials, or words with --bpe; train_nn --objective rnnt checkpoint via --nn-ckpt)")
    add_rnnt_args(p, beam=False)
    p.add_argument("--max-symbols", type=int, default=0,
                   help="with --rnnt: hypothesis-buffer cap (0: twice the audio's frames)")
    p.add_argument("--aed", action="store_true",
                   help="chunked streaming AED (train_nn --objective aed --aed-chunk C checkpoint via --nn-ckpt): "
                        "CTC-head greedy partials a chunk, the exact attention beam at the end")
    add_aed_args(p, chunk=8, max_tokens=None)
    p.add_argument("--nn-ckpt", help="CTC/RNN-T/AED checkpoint dir (with --ctc/--rnnt/--aed)")
    p.add_argument("--bpe", metavar="FILE",
                   help="with --ctc/--rnnt/--aed: the checkpoint uses BPE subword units (FILE is its bpe.json): "
                        "open-vocabulary streaming words")
    add_ctc_beam_args(p)
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.aed and (args.ctc or args.rnnt):
        raise SystemExit("--aed is its own streaming family: drop --ctc/--rnnt")
    device = device_of(args.device)
    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=args.cmvn_window)
    if args.synthetic_demo:
        from mogasr_torch.data.synthetic import make_corpus

        wave = make_corpus(1, words_per_utt=(4, 6), seed=7)[0].wave
        if args.endpoint:  # give rule 1 trailing silence to detect
            wave = np.concatenate([wave, np.zeros(int(2.0 * fcfg.sample_rate), np.float32)])
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
    logger = make_logger(args)
    if args.aed:
        _stream_aed(args, wave, fcfg, lex, logger, device)
        return
    if args.rnnt:
        _stream_rnnt(args, wave, fcfg, lex, logger, device)
        return
    if args.ctc:
        if not args.nn_ckpt:
            raise SystemExit("--ctc requires --nn-ckpt (train_nn --objective ctc --arch lstm)")
        from mogasr_torch.am.ctc import ctc_decode_graph

        bpe = None
        if args.bpe:
            from mogasr_torch.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
        score_chunk = _ctc_chunk_scorer(args, (bpe.n_units if bpe is not None else lex.n_phones) + 1,
                                        fcfg.feat_dim, device)
        if bpe is not None:
            _stream_ctc_bpe(args, wave, fcfg, bpe, score_chunk, logger, device)
            return
        graph = ctc_decode_graph(lex, dcfg)
        score_feats = score_chunk
    else:
        gmm = load_or_random_gmm(args, fcfg.feat_dim, device)
        params = kernel_params(gmm, "float32")
        graph = word_decode_graph(lex, topo, dcfg)

        def score_feats(feats):
            return score_batch(torch.as_tensor(feats[None], device=device), gmm, params=params)

    graphs_np = gr.batch_graphs([graph])
    graphs = vit.graphs_to_torch(graphs_np, device)

    def words_of(path, entered):
        toks = vit.path_to_tokens(vit.ViterbiResult(path, entered, None), graph.labels, graphs_np["chain_id"])[0]
        return [w for w in toks if w not in DROP_TOKENS]

    sf = StreamingFrontend(fcfg, device=device)
    dec = OnlineDecoder(graphs, acoustic_scale=dcfg.acoustic_scale)
    chunk = int(fcfg.sample_rate * args.chunk_ms / 1000.0)
    consumed = 0
    ep = None
    if args.endpoint:
        from mogasr_torch.frontend.endpoint import EndpointConfig, StreamingEndpointer

        ep = StreamingEndpointer(fcfg, EndpointConfig(rule1_trailing_sil_s=args.endpoint_trailing_sil))
    with Timer() as t:
        for i in range(0, len(wave), chunk):
            consumed = min(i + chunk, len(wave))
            feats = sf.process(wave[i : i + chunk])
            if feats.size:
                dec.process(score_feats(feats), np.asarray([feats.shape[0]]))
            path, entered, _score = dec.partial()
            event = {"t_audio_s": round(consumed / fcfg.sample_rate, 2), "partial": words_of(path, entered)}
            if ep is not None and ep.feed(wave[i : i + chunk]):
                event["endpoint"] = ep.rule
                print(json.dumps(event), flush=True)
                break
            print(json.dumps(event), flush=True)
        feats = sf.finalize()
        if feats.size:
            dec.process(score_feats(feats), np.asarray([feats.shape[0]]))
        path, entered, _score = dec.finalize()
    audio_s = consumed / fcfg.sample_rate  # decoded audio (the endpoint may stop early)
    final = words_of(path, entered)
    rec = {"final": final, "rtf": round(t.seconds / max(audio_s, 1e-9), 4)}
    if ep is not None and ep.endpointed:
        rec["endpoint"] = ep.rule
        rec["endpoint_t_s"] = round(ep.endpoint_frame * fcfg.frame_shift_ms / 1000.0, 2)
    print(json.dumps(rec))
    logger.log({
        "stage": "stream", "audio_s": round(audio_s, 2), "wall_sec": t.seconds,
        "rtf": t.seconds / max(audio_s, 1e-9), "final_words": final,
        **({"endpoint": ep.rule} if ep is not None and ep.endpointed else {}),
    })


def _stream_aed(args, wave, fcfg, lex, logger, device: torch.device) -> None:
    """--aed: every complete chunk of 4 --aed-chunk feature frames through
    the chunked encoder, CTC-greedy partials from its CTC head, then the
    attention beam over the whole utterance (the chunk-masked offline
    encoder equals the streamed one, so the final refines the partials with
    the same model)."""
    from mogasr_torch.am import aed as A
    from mogasr_torch.am.ctc import CtcStreamDecoder
    from mogasr_torch.cli.common import load_aed_model

    if not args.nn_ckpt:
        raise SystemExit("--aed requires --nn-ckpt (train_nn --objective aed --aed-chunk C)")
    bpe = None
    if args.bpe:
        from mogasr_torch.data.bpe import load_bpe

        bpe = load_bpe(args.bpe)
    n_units = bpe.n_units if bpe is not None else lex.n_phones
    model = load_aed_model(args, n_units, fcfg.feat_dim, device)
    step = A.make_aed_stream_step(model)
    state = A.aed_stream_init(model, 1, fcfg.feat_dim)
    ctc_dec = CtcStreamDecoder(blank_id=n_units, mode="greedy")
    raw_per = 4 * args.aed_chunk
    sf = StreamingFrontend(fcfg, device=device)
    chunk = int(fcfg.sample_rate * args.chunk_ms / 1000.0)
    buf = np.zeros((0, fcfg.feat_dim), np.float32)
    all_feats: list = []

    def consume(feats):
        nonlocal buf, state
        all_feats.append(feats)
        buf = np.concatenate([buf, feats], axis=0)
        while buf.shape[0] >= raw_per:
            _enc, ctc_logits, state = step(torch.as_tensor(buf[None, :raw_per], device=device), state)
            ctc_dec.step(torch.log_softmax(ctc_logits[0], dim=-1))
            buf = buf[raw_per:]

    def to_text(units):
        return bpe.decode(units) if bpe is not None else [lex.phones[u] for u in units]

    with Timer() as t:
        for i in range(0, len(wave), chunk):
            consumed = min(i + chunk, len(wave))
            feats = sf.process(wave[i : i + chunk])
            if feats.size:
                consume(feats)
            print(json.dumps({"t_audio_s": round(consumed / fcfg.sample_rate, 2),
                              "partial": to_text(ctc_dec.partial())}), flush=True)
        feats = sf.finalize()
        if feats.size:
            consume(feats)
        fa = np.concatenate(all_feats, axis=0) if all_feats else buf
        seqs = A.aed_decode_batch(model, fa[None], np.asarray([fa.shape[0]]), beam=args.aed_beam,
                                  max_tokens=max(8, 2 + fa.shape[0] // 4), ctc_weight=args.aed_ctc_weight)
    audio_s = len(wave) / fcfg.sample_rate
    final = to_text(seqs[0])
    print(json.dumps({"final": final, "rtf": round(t.seconds / audio_s, 4)}))
    logger.log({"stage": "stream_aed", "audio_s": round(audio_s, 2), "wall_sec": t.seconds,
                "rtf": t.seconds / max(audio_s, 1e-9), "final_units": final})


def _ctc_chunk_scorer(args, V: int, feat_dim: int, device: torch.device):
    """feats chunk [Tc, D] -> [1, Tc, V] log posteriors of the stateful
    LstmAm in ``--nn-ckpt`` (K4's carry arm on the card), its carries kept
    across calls."""
    from mogasr_torch.am.neural import LstmAmStream, lstm_stream_init
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    model = LstmAmStream(V, feat_dim, hidden=args.nn_hidden, layers=max(args.nn_layers - 1, 1))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in restore_checkpoint(args.nn_ckpt)["params"].items()})
    model.to(device).eval()
    carries = lstm_stream_init(model, 1, device)

    @torch.no_grad()
    def score(feats):
        nonlocal carries
        logits, carries = model(torch.as_tensor(feats[None], device=device), carries)
        return torch.log_softmax(logits, dim=-1)

    return score


def _stream_ctc_bpe(args, wave, fcfg, bpe, score_chunk, logger, device) -> None:
    """``--ctc --bpe``: open-vocabulary streaming through CtcStreamDecoder
    (greedy, or the prefix beam with ``--bias``/``--fusion-lm``)."""
    from mogasr_torch.am.ctc import CtcStreamDecoder
    from mogasr_torch.cli.common import ctc_ext_score

    ext = ctc_ext_score(args, bpe)
    if ext is not None:
        ctc_dec = CtcStreamDecoder(blank_id=bpe.n_units, mode="beam", beam_size=args.bias_beam, ext_score=ext)
    else:
        ctc_dec = CtcStreamDecoder(blank_id=bpe.n_units, mode="greedy")
    sf = StreamingFrontend(fcfg, device=device)
    chunk = int(fcfg.sample_rate * args.chunk_ms / 1000.0)
    with Timer() as t:
        for i in range(0, len(wave), chunk):
            consumed = min(i + chunk, len(wave))
            feats = sf.process(wave[i : i + chunk])
            if feats.size:
                ctc_dec.step(score_chunk(feats)[0])
            print(json.dumps({"t_audio_s": round(consumed / fcfg.sample_rate, 2),
                              "partial": bpe.decode(ctc_dec.partial())}), flush=True)
        feats = sf.finalize()
        if feats.size:
            ctc_dec.step(score_chunk(feats)[0])
        words = bpe.decode(ctc_dec.finalize())
    audio_s = len(wave) / fcfg.sample_rate
    print(json.dumps({"final": words, "rtf": round(t.seconds / audio_s, 4)}))
    logger.log({"stage": "stream_ctc_bpe", "audio_s": round(audio_s, 2), "wall_sec": t.seconds,
                "rtf": t.seconds / max(audio_s, 1e-9), "final_words": words})


def _stream_rnnt(args, wave, fcfg, lex, logger, device) -> None:
    """``--rnnt``: RnntDeviceStream over the chunks, phone or BPE-word
    partials."""
    from mogasr_torch.am.rnnt import RnntDeviceStream
    from mogasr_torch.cli.common import load_rnnt_model

    if not args.nn_ckpt:
        raise SystemExit("--rnnt requires --nn-ckpt (train_nn --objective rnnt)")
    if args.bpe:
        from mogasr_torch.data.bpe import load_bpe

        bpe = load_bpe(args.bpe)
        n_units, to_text = bpe.n_units, bpe.decode
    else:
        n_units = lex.n_phones

        def to_text(units):
            return [lex.phones[u] for u in units]

    model = load_rnnt_model(args, "lstm", n_units, fcfg.feat_dim, device)
    # the cap scales with the audio's length (about 2 symbols a frame) unless set
    u_cap = args.max_symbols if args.max_symbols > 0 else 2 * (fcfg.num_frames(len(wave)) + 8)
    stream = RnntDeviceStream(model, 1, u_cap=u_cap)
    sf = StreamingFrontend(fcfg, device=device)
    chunk = int(fcfg.sample_rate * args.chunk_ms / 1000.0)
    part: list = []

    def feed(feats):
        return stream.consume(torch.as_tensor(feats[None], device=device), np.asarray([feats.shape[0]]))

    with Timer() as t:
        for i in range(0, len(wave), chunk):
            consumed = min(i + chunk, len(wave))
            feats = sf.process(wave[i : i + chunk])
            if feats.size:
                part = feed(feats)
            print(json.dumps({"t_audio_s": round(consumed / fcfg.sample_rate, 2),
                              "partial": to_text(part[0]) if part else []}), flush=True)
        feats = sf.finalize()
        if feats.size:
            part = feed(feats)
    audio_s = len(wave) / fcfg.sample_rate
    final = to_text(part[0]) if part else []
    print(json.dumps({"final": final, "rtf": round(t.seconds / audio_s, 4)}))
    logger.log({"stage": "stream_rnnt", "audio_s": round(audio_s, 2), "wall_sec": t.seconds,
                "rtf": t.seconds / max(audio_s, 1e-9), "final_phones": final})


if __name__ == "__main__":
    main()

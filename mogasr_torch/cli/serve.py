"""Streaming recognition server on the card: many concurrent sessions over a
line-delimited JSON protocol. The twin of the reference's cli/serve.py.

    python -m mogasr_torch.cli.serve --synthetic-demo-session    # one session, a self-test
    cat events.jsonl | python -m mogasr_torch.cli.serve [--engine] [--device cpu]
    python -m mogasr_torch.cli.serve --tcp 0 --port-file port.txt

Requests, one JSON object a line on stdin (or a TCP connection with --tcp):
  {"type": "start", "session": ID}
  {"type": "audio", "session": ID, "pcm": [float, ...]}   16 kHz mono
  {"type": "end",   "session": ID}
  {"type": "shutdown"}
Responses, one JSON object a line on stdout (or the connection):
  {"session": ID, "event": "ready"}
  {"session": ID, "partial": [words], "t_audio_s": S}     after each audio
  {"session": ID, "final": [words], "audio_s": S}         after end
  {"session": ID, "error": MSG}

Per-session mode (the default): each session has its own StreamingFrontend
and decoder, and each audio event is scored and decoded at once: K1 (float32,
sum mode) and the OnlineDecoder (K2's chunk arm and backtrace) on the GMM
path; with ``--ctc --nn-ckpt DIR --bpe FILE`` the stateful LstmAm (K4's carry
arm) and a host CtcStreamDecoder (greedy, or the prefix beam with ``--bias``
and ``--fusion-lm``). ``--tcp PORT`` serves the same protocol on
127.0.0.1:PORT to many connections at once, each owning the sessions it
started. ``--engine``: the batched session engines of ``serving/engine.py``,
one chain of launches a tick for every live session (GMM: K1 and K2's chunk
arm with a frame offset per slot; ``--ctc``: K4's carry arm; ``--rnnt``:
K4's carry arm and the device greedy), over stdin batches of events.
``--rnnt --nn-ckpt <run-dir>/nn_rnnt_lstm`` (``cli.train_nn --objective
rnnt --arch lstm``; ``--rnnt-pred/--rnnt-plain/--rnnt-pruned`` as trained)
serves phones, or words with ``--bpe``: per session an
``am.rnnt.RnntDeviceStream`` (its buffer ``--max-symbols`` long), or with
``--engine`` the ``BatchedRnntEngine``. ``--gmm-ckpt`` and ``--nn-ckpt``
read the port's checkpoint format; without ``--gmm-ckpt`` a random GMM is
drawn as the reference draws it. Runs on ``--device`` (default cuda).

``--aed --nn-ckpt <run-dir>/nn_aed_<arch>`` (``cli.train_nn --objective aed
--aed-chunk C``; ``--aed-chunk/--aed-left-chunks`` and ``--nn-hidden/
--nn-layers`` as trained) serves the chunked streaming AED: per session the
chunked encoder over every complete chunk of 4 C feature frames and
CTC-greedy partials, then the exact attention beam over the session's whole
history (padded to a multiple of 256 frames, the token budget
``serving.engine.aed_final_max_tokens`` of the padded length, rescored with
the CTC head on K3 at ``--aed-ctc-weight``); with ``--engine`` the
``BatchedAedEngine`` (``--aed-stream-precision bfloat16`` for its chunk
step). Phones, or words with ``--bpe``.
"""

from __future__ import annotations

import argparse
import io
import json
import sys

import numpy as np
import torch

from mogasr_torch.cli.common import (
    add_aed_args, add_ctc_beam_args, add_rnnt_args, add_run_args, ctc_ext_score, device_of, load_or_random_gmm,
    make_logger,
)
from mogasr_torch.config import DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.hmm.lexicon import load_lexicon, synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology


class _Session:
    def __init__(self, frontend, decoder):
        self.frontend = frontend
        self.decoder = decoder
        self.samples = 0


def _read_batches(stream):
    """Batches of input lines: one blocking readline, then whatever is
    already buffered, so that the engine advances many sessions a tick."""
    import select

    while True:
        line = stream.readline()
        if not line:
            return
        lines = [line]
        try:
            fd = stream.fileno()
            while select.select([fd], [], [], 0)[0]:
                more = stream.readline()
                if not more:
                    break
                lines.append(more)
        except (OSError, ValueError, AttributeError, io.UnsupportedOperation):
            pass
        yield lines


def _make_endpointer(args, fcfg):
    """A fresh endpoint detector for a session, or None without --endpoint."""
    if not args.endpoint:
        return None
    from mogasr_torch.frontend.endpoint import EndpointConfig, StreamingEndpointer

    return StreamingEndpointer(fcfg, EndpointConfig(rule1_trailing_sil_s=args.endpoint_trailing_sil,
                                                    rule3_max_utt_s=args.endpoint_max_utt))


def _demo_events(fcfg):
    """The --synthetic-demo-session events: one generated utterance in
    quarter-second audio events."""
    from mogasr_torch.data.synthetic import make_corpus

    utt = make_corpus(1, words_per_utt=(2, 3), seed=7)[0]
    chunk = fcfg.sample_rate // 4
    evs = [{"type": "start", "session": "demo"}]
    evs += [{"type": "audio", "session": "demo", "pcm": utt.wave[i:i + chunk].tolist()}
            for i in range(0, len(utt.wave), chunk)]
    evs.append({"type": "end", "session": "demo"})
    return evs


def _run_engine_loop(args, eng, fcfg, logger, batches=None, to_text=None):
    """The batched server: apply a batch of events, one tick for all
    sessions, partials for the sessions that got audio, then the endings.
    to_text maps an engine hypothesis (words or unit ids) to words. With
    --endpoint a per-session detector ends its session (the final then
    carries the rule that fired)."""
    if to_text is None:
        to_text = lambda toks: toks  # noqa: E731

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def emit_overflows():
        # a session at the engine's frame cap keeps its slot (its result
        # stops at the cap), but its client must hear that audio is dropped
        for sid in eng.take_overflow_events():
            emit({"session": sid, "error": "session exceeded the engine frame cap; hypothesis truncated — end "
                                            "the session"})

    endpointers: dict = {}
    ep_rule: dict = {}
    if batches is None:
        if args.synthetic_demo_session:
            batches = ([json.dumps(e)] for e in _demo_events(fcfg))
        else:
            batches = _read_batches(sys.stdin)
    partial_every = max(int(args.partial_every), 1)
    tick_i = 0
    for lines in batches:
        fed, ending, shutdown = [], [], False
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                emit({"error": f"bad json: {e}"})
                continue
            typ = ev.get("type")
            if typ == "shutdown":
                shutdown = True
                break
            sid = ev.get("session")
            if sid is None:
                emit({"error": "missing session id"})
            elif typ == "start":
                if eng.has(sid):
                    emit({"session": sid, "error": "session exists"})
                elif not eng.start(sid):
                    emit({"session": sid, "error": "too many sessions"})
                else:
                    ep = _make_endpointer(args, fcfg)
                    if ep is not None:
                        endpointers[sid] = ep
                    emit({"session": sid, "event": "ready"})
            elif typ == "audio":
                if not eng.has(sid):
                    emit({"session": sid, "error": "no such session"})
                elif sid in ep_rule:
                    emit({"session": sid, "error": "endpointed"})
                elif sid in ending:
                    # ended earlier in this batch: feed() would raise for every session
                    emit({"session": sid, "error": "session ended"})
                else:
                    pcm = np.asarray(ev.get("pcm", []), np.float32)
                    eng.feed(sid, pcm)
                    fed.append(sid)
                    ep = endpointers.get(sid)
                    if ep is not None:
                        ep.feed(pcm)
                        if ep.endpointed:
                            ep_rule[sid] = ep.rule
                            eng.end(sid)
                            ending.append(sid)
                            emit({"session": sid, "event": "endpoint", "rule": ep.rule})
            elif typ == "end":
                if not eng.has(sid):
                    emit({"session": sid, "error": "no such session"})
                elif sid in ep_rule:
                    emit({"session": sid, "error": "endpointed"})
                elif sid in ending:
                    emit({"session": sid, "error": "session ended"})
                else:
                    eng.end(sid)
                    ending.append(sid)
            else:
                emit({"session": sid, "error": f"unknown type {typ!r}"})
        eng.tick()
        tick_i += 1
        emit_overflows()
        if fed and tick_i % partial_every == 0:
            sids = [s for s in dict.fromkeys(fed) if eng.has(s)]
            parts = eng.partials(sids)
            for sid in sids:
                emit({"session": sid, "partial": to_text(parts[sid]), "t_audio_s": round(eng.audio_seconds(sid), 2)})
        while ending:
            for sid in list(ending):
                if eng.drained(sid):
                    audio_s = eng.audio_seconds(sid)
                    words, _ = eng.finalize(sid)
                    words = to_text(words)
                    final_ev = {"session": sid, "final": words, "audio_s": round(audio_s, 2)}
                    rule = ep_rule.pop(sid, None)
                    endpointers.pop(sid, None)
                    if rule is not None:
                        final_ev["endpoint"] = rule
                    emit(final_ev)
                    logger.log({"stage": "serve_final", "session": sid, "audio_s": round(audio_s, 2),
                                "words": words})
                    ending.remove(sid)
            if ending:
                eng.tick()
                emit_overflows()
        if shutdown:
            return


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_run_args(p)
    p.add_argument("--lexicon", help="Kaldi-style lexicon.txt (default: synthetic)")
    p.add_argument("--gmm-ckpt", help="GMM checkpoint dir (the port's format, from cli.train_gmm)")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--cmvn-window", type=int, default=600)
    p.add_argument("--max-sessions", type=int, default=64, help="reject starts beyond this many live sessions")
    p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                   help="serve the same protocol on 127.0.0.1:PORT (0: an ephemeral port) instead of stdin/stdout: "
                        "many connections, each response to the connection whose event produced it, sessions owned "
                        "by the connection that started them (a dropped client's are reaped)")
    p.add_argument("--port-file", metavar="FILE", help="with --tcp: write the bound port to FILE once listening")
    p.add_argument("--engine", action="store_true",
                   help="the batched session engine (GMM, --ctc, --rnnt or --aed): one chain of launches a tick "
                        "advances every "
                        "live session (serving/engine.py)")
    p.add_argument("--engine-capacity", type=int, default=16, help="engine slots (= most concurrent sessions)")
    p.add_argument("--feature-path", choices=["device", "host"], default="device",
                   help="engine features: 'device' runs the spectral chunk, deltas, CMVN and the feature queue on "
                        "the card (nothing read back a tick; sliding CMVN in float32); 'host' is the bit-exact "
                        "per-slot StreamingFrontend path")
    p.add_argument("--engine-history", choices=["device", "host"], default="device",
                   help="GMM engine codes: on the card (sessions bounded by --engine-max-frames) or host lists "
                        "(unbounded sessions)")
    p.add_argument("--engine-max-frames", type=int, default=3000,
                   help="session bound with --engine-history device (frames; 3000 = 30 s at the 10 ms hop)")
    p.add_argument("--partial-every", type=int, default=1,
                   help="engine mode: partials every N ticks (finals and endpoints are unaffected)")
    p.add_argument("--tick-frames", type=int, default=24, help="frames a session advances an engine tick")
    p.add_argument("--ctc", action="store_true",
                   help="serve a BPE-CTC LstmAm instead of the GMM: stateful LSTM chunks, then streaming greedy or "
                        "prefix-beam decoding to words (needs --nn-ckpt and --bpe)")
    p.add_argument("--nn-ckpt", help="CTC/RNN-T/AED checkpoint dir (with --ctc/--rnnt/--aed; the port's format, "
                                     "cli.train_nn --objective ctc/rnnt --arch lstm, or aed)")
    p.add_argument("--bpe", metavar="FILE", help="bpe.json (with --ctc, or --rnnt/--aed for words)")
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    add_ctc_beam_args(p)
    p.add_argument("--rnnt", action="store_true",
                   help="serve a streaming RNN-T (train_nn --objective rnnt): stateful LSTM encoder chunks -> the "
                        "device greedy (needs --nn-ckpt; phones, or words with --bpe)")
    add_rnnt_args(p, beam=False)
    p.add_argument("--max-symbols", type=int, default=400,
                   help="with --rnnt (per-session mode): the hypothesis buffer's cap a session; the engine harvests "
                        "every tick and has no cap")
    p.add_argument("--aed", action="store_true",
                   help="serve a chunked streaming AED (train_nn --objective aed --aed-chunk): CTC-greedy partials a "
                        "chunk, the exact attention beam as the final (needs --nn-ckpt; phones, or words with --bpe)")
    add_aed_args(p, chunk=8, max_tokens=None)
    p.add_argument("--aed-stream-precision", choices=["float32", "bfloat16"], default="float32",
                   help="the AED engine's chunk-step precision (finals stay float32)")
    p.add_argument("--endpoint", action="store_true",
                   help="server-side endpointing (frontend/endpoint.py): a causal detector a session ends it, with "
                        "an 'endpoint' event and the final carrying the rule")
    p.add_argument("--endpoint-trailing-sil", type=float, default=0.5, help="rule-1 trailing silence (seconds)")
    p.add_argument("--endpoint-max-utt", type=float, default=20.0, help="rule-3 utterance cap (seconds)")
    p.add_argument("--synthetic-demo-session", action="store_true",
                   help="self-test: one generated utterance through the protocol instead of stdin")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if sum((args.aed, args.ctc, args.rnnt)) > 1:
        raise SystemExit("--aed/--ctc/--rnnt are different serving models")
    if args.tcp is not None and args.engine:
        # the engine runs its own tick loop over stdin batches
        raise SystemExit("--tcp serves the per-session mode only (--engine has its own stdin tick loop)")
    device = device_of(args.device)
    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=args.cmvn_window)
    lex = load_lexicon(args.lexicon) if args.lexicon else synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(acoustic_scale=args.acoustic_scale, word_insertion_penalty=args.insertion_penalty)
    logger = make_logger(args)
    if args.aed:
        session = _aed_sessions(args, fcfg, lex, logger, device)
    elif args.ctc:
        session = _ctc_sessions(args, fcfg, logger, device)
    elif args.rnnt:
        session = _rnnt_sessions(args, fcfg, lex, logger, device)
    else:
        session = _gmm_sessions(args, fcfg, lex, topo, dcfg, logger, device)
    if session is not None:
        _serve_sessions(args, fcfg, logger, *session)


def _aed_sessions(args, fcfg, lex, logger, device):
    """--aed: the engine runs here and None comes back; else the
    per-session (make_session, feed, partial_words, final_words)."""
    from mogasr_torch.am import aed as A
    from mogasr_torch.am.ctc import CtcStreamDecoder
    from mogasr_torch.cli.common import load_aed_model
    from mogasr_torch.serving.engine import AED_FINAL_BUCKET, aed_final_max_tokens

    if not args.nn_ckpt:
        raise SystemExit("--aed requires --nn-ckpt")
    bpe = None
    if args.bpe:
        from mogasr_torch.data.bpe import load_bpe

        bpe = load_bpe(args.bpe)
    n_units = bpe.n_units if bpe is not None else lex.n_phones
    model = load_aed_model(args, n_units, fcfg.feat_dim, device)

    def to_text(units):
        return bpe.decode(units) if bpe is not None else [lex.phones[u] for u in units]

    if args.engine:
        from mogasr_torch.serving.engine import BatchedAedEngine

        eng = BatchedAedEngine(model, fcfg, capacity=args.engine_capacity, beam=args.aed_beam,
                               ctc_weight=args.aed_ctc_weight, feature_path=args.feature_path,
                               stream_precision=args.aed_stream_precision, device=device)
        _run_engine_loop(args, eng, fcfg, logger, to_text=to_text)
        return None

    from mogasr_torch.frontend.streaming import StreamingFrontend

    step = A.make_aed_stream_step(model)
    raw_per = 4 * args.aed_chunk

    def make_session():
        s = _Session(StreamingFrontend(fcfg, device=device), CtcStreamDecoder(blank_id=n_units, mode="greedy"))
        s.enc_state = A.aed_stream_init(model, 1, fcfg.feat_dim)
        s.buf = np.zeros((0, fcfg.feat_dim), np.float32)
        s.all_feats = []
        return s

    def feed(s, feats):
        s.all_feats.append(feats)
        s.buf = np.concatenate([s.buf, feats], axis=0)
        while s.buf.shape[0] >= raw_per:
            _e, ctc_logits, s.enc_state = step(torch.as_tensor(s.buf[None, :raw_per], device=device), s.enc_state)
            s.decoder.step(torch.log_softmax(ctc_logits[0], dim=-1))
            s.buf = s.buf[raw_per:]

    def final_words(s):
        # the exact attention final over the whole utterance, padded and
        # budgeted as the engine's finals
        fa = np.concatenate(s.all_feats, axis=0) if s.all_feats else s.buf
        T = fa.shape[0]
        if T == 0:
            return []
        Tb = -(-T // AED_FINAL_BUCKET) * AED_FINAL_BUCKET
        padded = np.zeros((1, Tb, fa.shape[1]), np.float32)
        padded[0, :T] = fa
        seqs = A.aed_decode_batch(model, padded, np.asarray([T]), beam=args.aed_beam,
                                  max_tokens=aed_final_max_tokens(Tb), ctc_weight=args.aed_ctc_weight)
        return to_text(seqs[0])

    return make_session, feed, lambda s: to_text(s.decoder.partial()), final_words


def _ctc_sessions(args, fcfg, logger, device):
    """--ctc: the engine runs here and None comes back; else the per-session
    (make_session, feed, partial_words, final_words)."""
    from mogasr_torch.am.ctc import CtcStreamDecoder
    from mogasr_torch.am.neural import LstmAmStream, lstm_stream_init
    from mogasr_torch.data.bpe import load_bpe
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    if not (args.nn_ckpt and args.bpe):
        raise SystemExit("--ctc requires --nn-ckpt and --bpe")
    bpe = load_bpe(args.bpe)
    V = bpe.n_units + 1
    model = LstmAmStream(V, fcfg.feat_dim, hidden=args.nn_hidden, layers=max(args.nn_layers - 1, 1))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in restore_checkpoint(args.nn_ckpt)["params"].items()})
    model.to(device).eval()
    ext = ctc_ext_score(args, bpe)

    def new_decoder():
        if ext is not None:
            return CtcStreamDecoder(blank_id=V - 1, mode="beam", beam_size=args.bias_beam, ext_score=ext)
        return CtcStreamDecoder(blank_id=V - 1, mode="greedy")

    if args.engine:
        from mogasr_torch.serving.engine import BatchedCtcEngine

        eng = BatchedCtcEngine(model, new_decoder, fcfg, capacity=args.engine_capacity,
                               tick_frames=args.tick_frames, feature_path=args.feature_path, device=device)
        _run_engine_loop(args, eng, fcfg, logger, to_text=bpe.decode)
        return None

    from mogasr_torch.frontend.streaming import StreamingFrontend

    def make_session():
        s = _Session(StreamingFrontend(fcfg, device=device), new_decoder())
        s.carries = lstm_stream_init(model, 1, device)
        return s

    @torch.no_grad()
    def feed(s, feats):
        logits, s.carries = model(torch.as_tensor(feats[None], device=device), s.carries)
        s.decoder.step(torch.log_softmax(logits, dim=-1)[0])

    return (make_session, feed, lambda s: bpe.decode(s.decoder.partial()),
            lambda s: bpe.decode(s.decoder.finalize()))


def _rnnt_sessions(args, fcfg, lex, logger, device):
    """--rnnt: the engine runs here and None comes back; else the
    per-session (make_session, feed, partial_words, final_words), every
    session's RnntDeviceStream on one shared encoder step and greedy."""
    from mogasr_torch.am.rnnt import RnntDeviceStream, make_rnnt_stream_shared
    from mogasr_torch.cli.common import load_rnnt_model

    if not args.nn_ckpt:
        raise SystemExit("--rnnt requires --nn-ckpt (train_nn --objective rnnt)")
    bpe = None
    if args.bpe:
        from mogasr_torch.data.bpe import load_bpe

        bpe = load_bpe(args.bpe)
    model = load_rnnt_model(args, "lstm", bpe.n_units if bpe is not None else lex.n_phones, fcfg.feat_dim, device)

    def to_text(units):
        return bpe.decode(units) if bpe is not None else [lex.phones[u] for u in units]

    if args.engine:
        from mogasr_torch.serving.engine import BatchedRnntEngine

        eng = BatchedRnntEngine(model, fcfg, capacity=args.engine_capacity, tick_frames=args.tick_frames,
                                feature_path=args.feature_path, device=device)
        _run_engine_loop(args, eng, fcfg, logger, to_text=to_text)
        return None

    from mogasr_torch.frontend.streaming import StreamingFrontend

    shared = make_rnnt_stream_shared(model, u_cap=args.max_symbols)

    def make_session():
        s = _Session(StreamingFrontend(fcfg, device=device), None)
        s.stream = RnntDeviceStream(model, 1, u_cap=args.max_symbols, shared=shared)
        s.part = []
        return s

    def feed(s, feats):
        s.part = s.stream.consume(torch.as_tensor(feats[None], device=device), np.asarray([feats.shape[0]]))

    def words(s):
        return to_text(s.part[0]) if s.part else []

    return make_session, feed, words, words


def _gmm_sessions(args, fcfg, lex, topo, dcfg, logger, device):
    """The GMM path: the engine runs here and None comes back; else the
    per-session (make_session, feed, partial_words, final_words)."""
    from mogasr_torch.am.gmm_cuda import kernel_params
    from mogasr_torch.decoder import viterbi as vit
    from mogasr_torch.hmm import graph as gr
    from mogasr_torch.pipeline import score_batch, word_decode_graph

    gmm = load_or_random_gmm(args, fcfg.feat_dim, device)
    params = kernel_params(gmm, "float32")
    graph = word_decode_graph(lex, topo, dcfg)
    if args.engine:
        from mogasr_torch.serving.engine import BatchedSessionEngine

        eng = BatchedSessionEngine(graph, lambda feats: score_batch(feats, gmm, params=params), fcfg, dcfg,
                                   capacity=args.engine_capacity, tick_frames=args.tick_frames,
                                   history=args.engine_history, max_frames=args.engine_max_frames,
                                   feature_path=args.feature_path, device=device)
        _run_engine_loop(args, eng, fcfg, logger)
        return None

    from mogasr_torch.decoder.online import OnlineDecoder
    from mogasr_torch.frontend.streaming import StreamingFrontend

    graphs = vit.graphs_to_torch(gr.batch_graphs([graph]), device)

    def words_of(res):
        path, entered, _score = res
        return gr.path_words(graph, path[0].cpu().numpy(), entered[0].cpu().numpy())

    def make_session():
        return _Session(StreamingFrontend(fcfg, device=device),
                        OnlineDecoder(graphs, acoustic_scale=dcfg.acoustic_scale))

    def feed(s, feats):
        s.decoder.process(score_batch(torch.as_tensor(feats[None], device=device), gmm, params=params),
                          np.asarray([feats.shape[0]]))

    return make_session, feed, lambda s: words_of(s.decoder.partial()), lambda s: words_of(s.decoder.finalize())


def _serve_sessions(args, fcfg, logger, make_session, feed, partial_words, final_words) -> None:
    """The per-session server over stdin, --tcp or the demo session."""
    sessions: dict = {}
    # where responses go: stdout, or (--tcp) the connection whose event is handled
    out = {"fn": lambda obj: print(json.dumps(obj), flush=True)}

    def emit(obj):
        out["fn"](obj)

    def finish(sid, s, rule=None):
        feats = s.frontend.finalize()
        if feats.size:
            feed(s, feats)
        audio_s = s.samples / fcfg.sample_rate
        final = final_words(s)
        final_ev = {"session": sid, "final": final, "audio_s": round(audio_s, 2)}
        if rule is not None:
            final_ev["endpoint"] = rule
        emit(final_ev)
        logger.log({"stage": "serve_final", "session": sid, "audio_s": round(audio_s, 2), "words": final})

    def handle(ev) -> bool:
        """Process one event; False on shutdown."""
        typ = ev.get("type")
        if typ == "shutdown":
            return False
        sid = ev.get("session")
        if sid is None:
            emit({"error": "missing session id"})
            return True
        if typ == "start":
            if sid in sessions:
                emit({"session": sid, "error": "session exists"})
            elif len(sessions) >= args.max_sessions:
                emit({"session": sid, "error": "too many sessions"})
            else:
                sessions[sid] = make_session()
                sessions[sid].ep = _make_endpointer(args, fcfg)
                emit({"session": sid, "event": "ready"})
        elif typ == "audio":
            s = sessions.get(sid)
            if s is None:
                emit({"session": sid, "error": "no such session"})
                return True
            pcm = np.asarray(ev.get("pcm", []), np.float32)
            s.samples += len(pcm)
            feats = s.frontend.process(pcm)
            if feats.size:
                feed(s, feats)
            if s.ep is not None:
                s.ep.feed(pcm)
                if s.ep.endpointed:
                    emit({"session": sid, "event": "endpoint", "rule": s.ep.rule})
                    finish(sid, s, rule=s.ep.rule)
                    del sessions[sid]
                    return True
            emit({"session": sid, "partial": partial_words(s), "t_audio_s": round(s.samples / fcfg.sample_rate, 2)})
        elif typ == "end":
            s = sessions.pop(sid, None)
            if s is None:
                emit({"session": sid, "error": "no such session"})
                return True
            finish(sid, s)
        else:
            emit({"session": sid, "error": f"unknown type {typ!r}"})
        return True

    if args.synthetic_demo_session:
        for ev in _demo_events(fcfg):
            handle(ev)
        return
    if args.tcp is not None:
        _serve_tcp(args, logger, sessions, handle, out)
        return
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError as e:
            emit({"error": f"bad json: {e}"})
            continue
        if not handle(ev):
            break


def _serve_tcp(args, logger, sessions, handle, out) -> None:
    """The selectors server on 127.0.0.1:--tcp: non-blocking connections,
    each response routed to the connection whose event produced it, a
    session owned by the connection that started it, a client that drops or
    stops reading reaped with its sessions."""
    import selectors
    import socket

    sel = selectors.DefaultSelector()
    srv = socket.create_server(("127.0.0.1", args.tcp))
    srv.setblocking(False)
    sel.register(srv, selectors.EVENT_READ, data=None)
    port = srv.getsockname()[1]
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(port))
    print(json.dumps({"event": "listening", "port": port}), flush=True)
    logger.log({"stage": "serve_tcp_listening", "port": port})
    rbufs: dict = {}          # conn -> bytearray in
    wbufs: dict = {}          # conn -> bytearray out, not yet sent
    owner: dict = {}          # session id -> conn
    max_wbuf = 16 << 20       # a client that does not read is dropped past 16 MB queued

    def drop_conn(conn):
        """Reap a client and its sessions (no finals: nobody to send them
        to). Idempotent."""
        if conn not in rbufs:
            return
        for sid in [s for s, c in owner.items() if c is conn]:
            sessions.pop(sid, None)
            owner.pop(sid, None)
        sel.unregister(conn)
        rbufs.pop(conn, None)
        wbufs.pop(conn, None)
        conn.close()

    def flush(conn) -> bool:
        """Send what the socket takes without blocking; False: drop it."""
        buf = wbufs.get(conn)
        if buf is None:
            return False
        try:
            while buf:
                n = conn.send(buf)
                del buf[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            return False
        if len(buf) > max_wbuf:
            return False
        sel.modify(conn, selectors.EVENT_READ | (selectors.EVENT_WRITE if buf else 0), data="conn")
        return True

    def send_to(conn):
        def fn(obj):
            if conn not in wbufs:
                return  # reaped mid-reply
            wbufs[conn] += (json.dumps(obj) + "\n").encode()
            if not flush(conn):
                drop_conn(conn)
        return fn

    running = True
    while running:
        for key, mask in sel.select():
            if key.data is None:
                conn, _addr = srv.accept()
                conn.setblocking(False)
                sel.register(conn, selectors.EVENT_READ, data="conn")
                rbufs[conn] = bytearray()
                wbufs[conn] = bytearray()
                continue
            conn = key.fileobj
            if conn not in rbufs:
                continue  # dropped earlier in this batch
            if mask & selectors.EVENT_WRITE and not flush(conn):
                drop_conn(conn)
                continue
            if not mask & selectors.EVENT_READ:
                continue
            try:
                data = conn.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            if not data:
                drop_conn(conn)
                continue
            buf = rbufs[conn]
            buf += data
            out["fn"] = send_to(conn)
            while b"\n" in buf:
                raw, _, rest = bytes(buf).partition(b"\n")
                buf[:] = rest
                line = raw.decode(errors="replace").strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError as e:
                    out["fn"]({"error": f"bad json: {e}"})
                    continue
                sid, typ = ev.get("session"), ev.get("type")
                if sid is not None and sid in owner and owner[sid] is not conn:
                    out["fn"]({"session": sid, "error": "session owned by another connection"})
                    continue
                if not handle(ev):
                    running = False
                    break
                if typ == "start" and sid in sessions:
                    owner[sid] = conn
                elif sid is not None and sid not in sessions:
                    owner.pop(sid, None)
            if not running:
                break
    for conn in list(rbufs):
        drop_conn(conn)
    srv.close()


if __name__ == "__main__":
    main()

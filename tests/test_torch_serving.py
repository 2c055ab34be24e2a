"""The port's batched session engines (serving/engine.py) on the CPU.

BatchedSessionEngine, for each history (host, device) and feature path
(host, device), against the port's dedicated per-session pipeline
(StreamingFrontend + OnlineDecoder): staggered starts, ragged feeding from a
seeded rng, slot reuse (5 sessions through capacity 4), an empty session;
final words, partials and audio_s equal. The same engine against the
reference's BatchedSessionEngine on the same waves and schedule: the same
final transcripts and the same overflow events for a session past the frame
cap. K2's ragged chunk path on the CPU (``viterbi_cuda.chunk_step`` with an
offset per row) against the plain step run per row, its codes at the
scattered offsets. BatchedCtcEngine with an LstmAm carried over by
``from_flax`` against the reference's BatchedCtcEngine and the port's
dedicated stateful LstmAm + CtcStreamDecoder: the same final units, idle
slots' carries bitwise.

The GMM is estimated in closed form from the synthetic corpus's own phone
segmentation (one Gaussian a pdf), so the engines decode real audio into
words without a training run, and word decisions are not near-ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr_torch import pipeline as pipe
from mogasr_torch.am.gmm import gmm_from_numpy
from mogasr_torch.config import DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.data.synthetic import make_corpus
from mogasr_torch.decoder import online
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.decoder import viterbi_cuda
from mogasr_torch.frontend.streaming import StreamingFrontend
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm.lexicon import synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.serving.engine import BatchedCtcEngine, BatchedSessionEngine

CPU = torch.device("cpu")
CAPACITY, TICK, MAX_FRAMES = 4, 16, 512


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def supervised_gmm(lex, topo, fcfg, utts):
    """One Gaussian a pdf from the utterances' phone segmentation: each
    phone's frames split evenly over its states (numpy arrays)."""
    S, D = topo.n_pdfs, fcfg.feat_dim
    occ, sx, sxx = np.zeros(S), np.zeros((S, D)), np.zeros((S, D))
    for u in utts:
        fe = StreamingFrontend(fcfg, device=CPU)
        f = np.concatenate([fe.process(u.wave), fe.finalize()]).astype(np.float64)
        centers = np.arange(f.shape[0]) * fcfg.frame_shift + fcfg.frame_length // 2
        ph = np.clip(np.searchsorted(u.phone_bounds, centers, side="right") - 1, 0, len(u.phones) - 1)
        for t in range(f.shape[0]):
            ids = topo.phone_pdf_ids(lex.phones.index(u.phones[ph[t]]))
            lo, hi = u.phone_bounds[ph[t]], u.phone_bounds[ph[t] + 1]
            s = ids[min(int((centers[t] - lo) / max(hi - lo, 1) * len(ids)), len(ids) - 1)]
            occ[s] += 1
            sx[s] += f[t]
            sxx[s] += f[t] ** 2
    n = np.maximum(occ, 1)[:, None]
    mean = sx / n
    var = np.where(occ[:, None] >= 2, np.maximum(sxx / n - mean ** 2, 0.05), 1.0)
    return np.ones((S, 1), np.float32), mean[:, None].astype(np.float32), var[:, None].astype(np.float32)


@pytest.fixture(scope="module")
def system():
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    arrays = supervised_gmm(lex, topo, fcfg, make_corpus(12, words_per_utt=(2, 3), seed=42))
    gmm = gmm_from_numpy(*arrays, CPU)
    graph = pipe.word_decode_graph(lex, topo, dcfg)
    utts = make_corpus(5, words_per_utt=(2, 3), seed=77)
    # a session past the frame cap: four utterances back to back
    long_wave = np.concatenate([u.wave for u in make_corpus(4, words_per_utt=(3, 3), seed=9)])
    return {"lex": lex, "topo": topo, "fcfg": fcfg, "dcfg": dcfg, "arrays": arrays, "gmm": gmm, "graph": graph,
            "utts": utts, "long": long_wave}


def _score_fn(system):
    return lambda feats: pipe.score_batch(feats, system["gmm"])


def drive(eng, sessions, seed, partial_every=3, bite=(500, 5000)):
    """Feed (sid, wave) sessions through eng as a server would: admit while
    slots are free, a random bite of audio per live session per tick, end
    each when its audio is out, finalize when drained, partials of every
    live session every partial_every ticks. Returns ({sid: (words,
    audio_s)}, [(sid, frames so far, partial words)], overflow events)."""
    rng = np.random.default_rng(seed)
    pending, cursors, ended, finals, partials, events = list(sessions), {}, set(), {}, [], []
    waves = dict(sessions)
    while len(finals) < len(sessions):
        while pending and eng.n_live < eng.capacity:
            sid, _w = pending.pop(0)
            assert eng.start(sid)
            cursors[sid] = 0
        for sid in list(cursors):
            if sid in ended or sid in finals:
                continue
            off = cursors[sid]
            if off >= len(waves[sid]):
                eng.end(sid)
                ended.add(sid)
                continue
            n = int(rng.integers(*bite))
            eng.feed(sid, waves[sid][off:off + n])
            cursors[sid] = off + n
        eng.tick()
        events += eng.take_overflow_events()
        if eng.ticks % partial_every == 0:
            live = [sid for sid in cursors if eng.has(sid)]
            for sid, words in eng.partials(live).items():
                partials.append((sid, eng.slots[eng._sid_to_slot[sid]].n_frames, words))
        for sid in sorted(ended):
            if eng.drained(sid):
                finals[sid] = eng.finalize(sid)
                ended.discard(sid)
    return finals, partials, events


def dedicated(system, wave, partial_at=()):
    """The port's per-session pipeline: the streaming features, scored and
    decoded by an OnlineDecoder in chunks cut at ``partial_at`` frames.
    Returns (final words, {frames: partial words})."""
    graph = system["graph"]
    fe = StreamingFrontend(system["fcfg"], device=CPU)
    feats = np.concatenate([fe.process(wave), fe.finalize()])
    dec = online.OnlineDecoder(vit.graphs_to_torch(gr.batch_graphs([graph]), CPU), acoustic_scale=1.0)
    parts, done = {}, 0

    def words(res):
        return gr.path_words(graph, res[0][0].numpy(), res[1][0].numpy())

    for cut in sorted(set(partial_at)) + [feats.shape[0]]:
        if cut > done:
            dec.process(_score_fn(system)(torch.from_numpy(feats[None, done:cut])), np.asarray([cut - done]))
            done = cut
        parts[cut] = words(dec.partial())
    return words(dec.finalize()), parts


@pytest.mark.parametrize("feature_path", ["host", "device"])
@pytest.mark.parametrize("history", ["host", "device"])
def test_engine_matches_dedicated_sessions(system, history, feature_path):
    utts = system["utts"]
    sessions = [(u.utt_id, u.wave) for u in utts] + [("empty", np.zeros(0, np.float32))]
    eng = BatchedSessionEngine(system["graph"], _score_fn(system), system["fcfg"], system["dcfg"],
                               capacity=CAPACITY, tick_frames=TICK, history=history, max_frames=MAX_FRAMES,
                               feature_path=feature_path, device=CPU)
    finals, partials, events = drive(eng, sessions, seed=3)
    assert not events and finals["empty"] == ([], 0.0)
    n_words = 0
    for u in utts:
        at = [n for sid, n, _w in partials if sid == u.utt_id]
        want, want_parts = dedicated(system, u.wave, at)
        assert finals[u.utt_id][0] == want
        assert finals[u.utt_id][1] == pytest.approx(len(u.wave) / system["fcfg"].sample_rate)
        assert [w for sid, _n, w in partials if sid == u.utt_id] == [want_parts[n] for n in at]
        n_words += len(want)
    assert n_words >= 8 and len(partials) > 10   # real words decoded, partials taken


@pytest.fixture(scope="module")
def reference_run(system):
    """The reference's BatchedSessionEngine (device history, host features)
    over the 5 sessions and the long one, on the same schedule."""
    from mogasr import pipeline as jpipe
    from mogasr.am.gmm import GmmSet
    from mogasr.config import DecodeConfig as JDecodeConfig, FrontendConfig as JFrontendConfig
    from mogasr.config import TopologyConfig as JTopologyConfig
    from mogasr.hmm.lexicon import synthetic_lexicon as j_lexicon
    from mogasr.hmm.topology import build_topology as j_topology
    from mogasr.serving.engine import BatchedSessionEngine as JEngine

    lex = j_lexicon()
    dcfg = JDecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    graph = jpipe.word_decode_graph(lex, j_topology(lex, JTopologyConfig()), dcfg)
    gmm = GmmSet(*(jnp.asarray(a) for a in system["arrays"]))
    eng = JEngine(graph, lambda feats: jpipe.score_batch(feats, gmm), JFrontendConfig(cmvn="sliding", cmvn_window=300),
                  dcfg, capacity=CAPACITY, tick_frames=TICK, history="device", max_frames=MAX_FRAMES)
    return drive(eng, _ref_sessions(system), seed=5, partial_every=4)


def _ref_sessions(system):
    return [("long", system["long"])] + [(u.utt_id, u.wave) for u in system["utts"]]


def test_engine_matches_reference_engine_and_overflow(system, reference_run):
    """The same finals as the reference engine; the long session overflows
    the 512-frame cap in both, with the same event and its truncated words,
    the others untouched."""
    eng = BatchedSessionEngine(system["graph"], _score_fn(system), system["fcfg"], system["dcfg"],
                               capacity=CAPACITY, tick_frames=TICK, history="device", max_frames=MAX_FRAMES,
                               device=CPU)
    finals, _partials, events = drive(eng, _ref_sessions(system), seed=5, partial_every=4)
    want_finals, _want_partials, want_events = reference_run
    assert events == want_events == ["long"]
    assert {k: v[0] for k, v in finals.items()} == {k: v[0] for k, v in want_finals.items()}
    assert all(finals[k][1] == pytest.approx(want_finals[k][1]) for k in finals)
    assert len(finals["long"][0]) >= 4


def test_engine_refusals(system):
    eng = BatchedSessionEngine(system["graph"], _score_fn(system), system["fcfg"], system["dcfg"], capacity=2,
                               tick_frames=8, device=CPU)
    assert eng.start("a") and eng.start("b")
    assert not eng.start("a")      # a live session
    assert not eng.start("c")      # full
    with pytest.raises(ValueError, match="before end"):
        eng.run_to_drain("a")
    eng.feed("a", system["utts"][0].wave[:4000])
    eng.end("a")
    with pytest.raises(ValueError, match="after end"):
        eng.feed("a", system["utts"][0].wave[:100])
    with pytest.raises(ValueError, match="before drained"):
        eng.finalize("a")
    assert eng.run_to_drain("a")[1] == pytest.approx(0.25)
    assert eng.start("c") and eng.n_live == 2


def test_device_backtrace_cached_per_tick(system, monkeypatch):
    calls = {"n": 0}
    orig = viterbi_cuda.backtrace

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(viterbi_cuda, "backtrace", counting)
    eng = BatchedSessionEngine(system["graph"], _score_fn(system), system["fcfg"], system["dcfg"], capacity=2,
                               tick_frames=8, max_frames=256, device=CPU)
    assert eng.start("a") and eng.start("b")
    eng.feed("a", system["utts"][0].wave[:8000])
    eng.feed("b", system["utts"][1].wave[:8000])
    for _ in range(6):
        eng.tick()
    p_a, p_b = eng.partial("a"), eng.partial("b")
    assert calls["n"] == 1
    assert eng.partials(["a", "b"]) == {"a": p_a, "b": p_b} and calls["n"] == 1
    eng.tick()
    eng.partial("a")
    assert calls["n"] == 2


def _small_loop(seed, B):
    from mogasr_torch.hmm.lexicon import make_lexicon

    lex = make_lexicon({"ab": ["a", "b"], "ba": ["b", "a"], "aa": ["a", "a"]})
    topo = build_topology(lex, TopologyConfig(states_per_phone=2, sil_states=1))
    tokens = [(w, lex.words_to_phone_ids([w])) for w in lex.words]
    g = gr.batch_graphs([gr.loop_graph(topo, tokens=tokens, insertion_penalty=1.0)] * B)
    return vit.graphs_to_torch(g, CPU), topo.n_pdfs


@pytest.mark.parametrize("beam", [0.0, 4.0])
def test_ragged_chunk_path_matches_per_row_steps(beam):
    """chunk_step with a frame offset per row, from garbage-filled buffers:
    each row's valid frames hold the codes and exit argmax of the plain step
    run on that row alone (its start frame excepted), every other frame keeps
    its garbage; delta and started are the plain step's."""
    B, Tc, t_cap = 6, 9, 40
    graphs, P = _small_loop(0, B)
    J = graphs["emit_id"].shape[1]
    rng = np.random.default_rng(1)
    ll = torch.as_tensor((rng.standard_normal((B, Tc, P)) * 2).astype(np.float32))
    started = torch.as_tensor([True, True, False, True, False, True])
    delta = torch.where(started[:, None], torch.as_tensor(rng.standard_normal((B, J)).astype(np.float32)),
                        torch.full((B, J), online.NEG_INF))
    n_valid = torch.as_tensor([9, 4, 7, 0, 0, 1], dtype=torch.int32)
    frame0 = np.asarray([31, 0, 0, 40, 12, 17])       # a row at the end, reused rows at 0
    bp = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, size=(B, t_cap, -(-J // 32), 2)), dtype=torch.int32)
    xa = torch.as_tensor(rng.integers(0, J, size=(B, t_cap)), dtype=torch.int32)
    bp0, xa0 = bp.clone(), xa.clone()
    d, s = delta.clone(), started.clone()
    viterbi_cuda.chunk_step(d, s, ll, n_valid, graphs, 0.8, beam, bp, xa, frame0)
    codes, codes0 = viterbi_cuda.unpack_codes(bp, slice(0, t_cap), J), viterbi_cuda.unpack_codes(bp0, slice(0, t_cap), J)
    for b in range(B):
        row = {k: v[b:b + 1] for k, v in graphs.items()}
        rd, rs, rbp, rxa = online.chunk_step(delta[b:b + 1], started[b:b + 1], ll[b:b + 1], n_valid[b:b + 1], row,
                                             0.8, beam)
        assert torch.equal(d[b], rd[0]) and bool(s[b]) == bool(rs[0])
        lo, n = (0 if bool(started[b]) else 1), int(n_valid[b])
        written = np.zeros(t_cap, bool)
        written[frame0[b] + lo:frame0[b] + n] = True
        for f in range(lo, n):
            assert torch.equal(codes[frame0[b] + f, b], rbp[f, 0])
            assert int(xa[b, frame0[b] + f]) == int(rxa[f, 0])
        assert torch.equal(codes[~torch.as_tensor(written), b], codes0[~torch.as_tensor(written), b])
        assert torch.equal(xa[b, ~torch.as_tensor(written)], xa0[b, ~torch.as_tensor(written)])
    with pytest.raises(ValueError, match="leave the buffers"):
        viterbi_cuda.chunk_step(d, s, ll, n_valid, graphs, 0.8, beam, bp, xa, np.asarray([32, 0, 0, 0, 0, 0]))


def test_codes_pack_round_trip():
    rng = np.random.default_rng(2)
    codes = torch.as_tensor(rng.integers(0, 4, size=(5, 3, 70)), dtype=torch.uint8)
    planes = viterbi_cuda.pack_codes(codes)
    assert planes.shape == (3, 5, 3, 2) and planes.dtype == torch.int32
    assert torch.equal(viterbi_cuda.unpack_codes(planes, slice(0, 5), 70), codes)


# ---------------------------------------------------------------------------
# the CTC family
# ---------------------------------------------------------------------------

V, HIDDEN = 12, 16


@pytest.fixture(scope="module")
def ctc():
    """A 2-layer LstmAm over V outputs (flax init, head scaled so that the
    greedy decode emits units), as the reference's and the port's streams."""
    from mogasr.am import neural as jn
    from mogasr_torch.am import neural as tn
    from mogasr_torch.am.params import from_flax

    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    jstream = jn.LstmAmStream(n_pdfs=V, hidden=HIDDEN, layers=2)
    params = jax.jit(jn.LstmAm(n_pdfs=V, hidden=HIDDEN, layers=2).init)(
        jax.random.key(0), jnp.zeros((1, 4, fcfg.feat_dim)), jnp.asarray([4]))
    params = {"params": dict(params["params"])}
    params["params"]["Dense_0"] = {"kernel": params["params"]["Dense_0"]["kernel"] * 20.0,
                                   "bias": params["params"]["Dense_0"]["bias"]}
    model = tn.LstmAmStream(V, fcfg.feat_dim, hidden=HIDDEN, layers=2)
    model.load_state_dict(from_flax(model, params))
    model.eval()
    utts = make_corpus(3, words_per_utt=(2, 3), seed=5)
    return fcfg, jstream, params, model, utts


def _ctc_engine(model, fcfg, capacity, tick, feature_path="host"):
    from mogasr_torch.am.ctc import CtcStreamDecoder

    return BatchedCtcEngine(model, lambda: CtcStreamDecoder(blank_id=V - 1), fcfg, capacity=capacity,
                            tick_frames=tick, feature_path=feature_path, device=CPU)


def _ctc_units(finals):
    return {sid: units for sid, (units, _a) in finals.items()}


@pytest.mark.parametrize("feature_path", ["host", "device"])
def test_ctc_engine_matches_reference_and_dedicated(ctc, feature_path):
    """3 sessions through capacity 2 (slot reuse resets the carries), ragged
    ticks: the units of the reference's engine, and of the port's dedicated
    stateful LstmAm + CtcStreamDecoder."""
    from mogasr.am.ctc import CtcStreamDecoder as JDecoder
    from mogasr.am.neural import lstm_stream_init as j_init
    from mogasr.config import FrontendConfig as JFrontendConfig
    from mogasr.serving.engine import BatchedCtcEngine as JEngine
    from mogasr_torch.am.ctc import CtcStreamDecoder
    from mogasr_torch.am.neural import lstm_stream_init

    fcfg, jstream, params, model, utts = ctc
    sessions = [(u.utt_id, u.wave) for u in utts]
    finals, _p, _e = drive(_ctc_engine(model, fcfg, 2, TICK, feature_path), sessions, seed=11, bite=(800, 4500))
    got = _ctc_units(finals)
    if feature_path == "host":
        jfcfg = JFrontendConfig(cmvn="sliding", cmvn_window=300)
        jeng = JEngine(jstream, params, lambda: JDecoder(blank_id=V - 1, mode="greedy"),
                       j_init(jstream, 2, fcfg.feat_dim), jfcfg, capacity=2, tick_frames=TICK)
        assert got == _ctc_units(drive(jeng, sessions, seed=11, bite=(800, 4500))[0])
    for u in utts:
        fe = StreamingFrontend(fcfg, device=CPU)
        dec = CtcStreamDecoder(blank_id=V - 1)
        carries = lstm_stream_init(model, 1, CPU)
        for feats in [fe.process(u.wave[i:i + 3100]) for i in range(0, len(u.wave), 3100)] + [fe.finalize()]:
            if feats.size:
                with torch.no_grad():
                    logits, carries = model(torch.from_numpy(feats[None]), carries)
                dec.step(torch.log_softmax(logits, dim=-1)[0])
        assert got[u.utt_id] == list(dec.finalize())
    assert sum(len(v) for v in got.values()) >= 6


def test_ctc_engine_idle_slots_keep_their_carries(ctc):
    """One session's chunk a tick, the other slots idle: an idle slot's
    carries stay bit for bit across the tick."""
    fcfg, _j, _p, model, utts = ctc
    eng = _ctc_engine(model, fcfg, 4, 24)
    for u in utts[:2]:
        assert eng.start(u.utt_id)
    chunks = {u.utt_id: [u.wave[i:i + 4000] for i in range(0, len(u.wave), 4000)] for u in utts[:2]}
    rows = {u.utt_id: eng._sid_to_slot[u.utt_id] for u in utts[:2]}
    checked = 0
    while any(chunks.values()):
        for sid, cs in chunks.items():
            if not cs:
                continue
            eng.feed(sid, cs.pop(0))
            for _ in range(2):
                before = [(c.clone(), h.clone()) for c, h in eng.carries]
                queued = {s: eng._feat_avail(b) for s, b in rows.items()}
                eng.tick()
                for s, b in rows.items():
                    if queued[s] == 0:   # decoded nothing this tick
                        checked += 1
                        for (c0, h0), (c1, h1) in zip(before, eng.carries):
                            assert torch.equal(c0[b], c1[b]) and torch.equal(h0[b], h1[b])
    assert checked >= 4

"""The AED slice as a whole, its engine, and its CLI twins.

``pipeline.train_aed_units`` (the chunked encoder) for three steps on both
packages from the reference's initial parameters carried across by
``from_flax``, then the beam with joint CTC rescoring: the weights to the CE
tests' tolerance and the same tokens; ``finetune_aed_mwer`` for two steps
likewise. ``BatchedAedEngine`` against the reference's engine on both
feature paths and in bfloat16 (finals and partials; ``finalize_many``
against ``finalize``). Then the ``train_nn --objective aed``, ``decode``,
``eval``, ``stream``, ``transcribe`` and ``serve --aed`` twins held to the
pipeline functions they run (in process, on the CPU)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jpipe
from mogasr.am import aed as JA
from mogasr.config import TrainConfig as JTrainConfig
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import aed as A
from mogasr_torch.am.params import from_flax
from mogasr_torch.config import BatchConfig, FrontendConfig, TrainConfig
from mogasr_torch.data.synthetic import make_corpus

CPU = torch.device("cpu")
TINY = dict(nn_hidden=16, nn_layers=2)
RUN = ["--hidden", "16", "--layers", "2"]
MODEL = ["--nn-hidden", "16", "--nn-layers", "2"]
D, N_UNITS = 8, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _encode(ws):
    return [int(w) for w in ws]


def _data():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 40, D)).astype(np.float32)
    nf = np.asarray([40, 29, 13], np.int32)
    words = [["1", "2", "0", "3"], ["3", "1"], []]
    return feats, nf, words


# lr 1e-3: Adam normalises each gradient, so an entry whose gradient is near
# its eps moves by up to ~lr where the packages' float32 sums differ in the
# last bits (test_torch_nn_train's note); at 1e-2 one entry in ~1000 moves
# past the tolerance after three steps.
KW = dict(lr=1e-3, num_nn_steps=60, **TINY)


@pytest.fixture(scope="module")
def trained():
    """Three ``train_aed_units`` steps of the chunked AED on both packages
    from the reference's initial weights (a row without labels among the
    batch): (reference model, its params, the port's model and state_dict,
    the reference's and the port's batch)."""
    feats, nf, words = _data()
    jfb = jpipe.FeatBatch(["a", "b", "c"], jnp.asarray(feats), jnp.asarray(nf), words)
    initial = []
    j_init = JA.init_aed_train_state

    def keep_init(*args, **kwargs):
        state = j_init(*args, **kwargs)
        initial.append(state.params)
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "init_aed_train_state", keep_init)
        jm, jp = jpipe.train_aed_units([jfb], _encode, N_UNITS, JTrainConfig(**KW), steps=3, chunk_frames=4)
        tm = A.build_aed_model(N_UNITS, TrainConfig(**KW), D, chunk_frames=4)
        tm.load_state_dict(from_flax(tm, initial[0]))
        mp.setattr(pipe, "aed_model_for", lambda *args, **kwargs: tm)
        fb = pipe.FeatBatch(["a", "b", "c"], torch.as_tensor(feats), torch.as_tensor(nf), words)
        model, sd = pipe.train_aed_units([fb], _encode, N_UNITS, TrainConfig(**KW), steps=3, chunk_frames=4)
    return jm, jp, model, {k: v.clone() for k, v in sd.items()}, jfb, fb


def _close(sd, want, **tol):
    for name, value in sd.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), err_msg=name, **tol)


def test_train_aed_units_then_decode_matches_jax(trained):
    """The weights after three steps, then the beam (width 2) with joint
    CTC rescoring on them: the same tokens."""
    jm, jp, model, sd, jfb, fb = trained
    _close(sd, from_flax(model, jp), rtol=1e-4, atol=1e-5)
    want = JA.aed_decode_batch(jm, jp, jfb.feats, jfb.n_frames, beam=2, max_tokens=8, ctc_weight=0.3)
    assert sum(map(len, want)) > 0
    assert A.aed_decode_batch(model, fb.feats, fb.n_frames, beam=2, max_tokens=8, ctc_weight=0.3) == want


def test_finetune_aed_mwer_matches_jax(trained):
    """Two steps of ``finetune_aed_mwer`` (the beam's 3-best against the
    current weights, host edit distances) from the trained weights: the
    expected risk of each step and the weights after."""
    jm, jp, model, sd, jfb, fb = trained
    model = copy.deepcopy(model)
    model.load_state_dict(sd)
    cfg = dict(lr=1e-3, num_nn_steps=20, **TINY)
    jp2, jhist = jpipe.finetune_aed_mwer(jm, jp, [jfb], _encode, JTrainConfig(**cfg), n_hyps=3, steps=2)
    sd2, hist = pipe.finetune_aed_mwer(model, [fb], _encode, TrainConfig(**cfg), n_hyps=3, steps=2)
    np.testing.assert_allclose(hist, jhist, rtol=1e-5, atol=1e-6)
    _close(sd2, from_flax(model, jp2), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

ENGINE = dict(d_model=16, enc_blocks=1, dec_blocks=1, heads=2, conv_kernel=7, chunk_frames=4)


@pytest.fixture(scope="module")
def engine_models():
    """A chunked AED over 5 units at the front end's width, every leaf drawn
    at random: (flax model, params, the port's model)."""
    feat_dim = FrontendConfig().feat_dim
    jm = JA.AedModel(n_units=5, **ENGINE)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((2, 32, feat_dim)), jnp.asarray([32, 32]),
                            jnp.zeros((2, 3), jnp.int32))
    rng = np.random.default_rng(21)
    leaves, tdef = jax.tree.flatten(shapes)
    jp = jax.tree.unflatten(tdef, [jnp.asarray(0.3 * rng.standard_normal(x.shape).astype(np.float32))
                                   for x in leaves])
    # eos costs 4 nats more, so that the finals are a few units long
    out = dict(jp["params"]["out"])
    out["bias"] = out["bias"].at[jm.eos].add(-4.0)
    jp = {"params": {**jp["params"], "out": out}}
    tm = A.AedModel(5, feat_dim, **ENGINE)
    tm.load_state_dict(from_flax(tm, jp))
    return jm, jp, tm.eval()


def _sessions():
    return [(u.utt_id, u.wave) for u in make_corpus(3, words_per_utt=(1, 2), seed=5)]


@pytest.mark.parametrize("feature_path,precision", [("host", "float32"), ("device", "float32"),
                                                    ("host", "bfloat16")])
def test_batched_aed_engine_matches_reference_engine(engine_models, feature_path, precision):
    """3 sessions through capacity 2 (slot reuse resets the caches), ragged
    bites, partials every other tick: the reference's BatchedAedEngine's
    finals and partials, and its finals equal the port's per-session
    finals (the padded attention beam on the dedicated stream's
    features)."""
    from mogasr.config import FrontendConfig as JFrontendConfig
    from mogasr.serving.engine import BatchedAedEngine as JEngine
    from mogasr_torch.frontend.streaming import StreamingFrontend
    from mogasr_torch.serving.engine import BatchedAedEngine, aed_final_max_tokens
    from test_torch_serving import drive

    jm, jp, tm = engine_models
    opts = dict(capacity=2, beam=2, ctc_weight=0.3, final_bucket=64, feature_path=feature_path,
                stream_precision=precision)
    sessions = _sessions()
    jeng = JEngine(jm, jp, JFrontendConfig(cmvn="sliding", cmvn_window=300), **opts)
    want, want_parts, _ = drive(jeng, sessions, seed=11, partial_every=2, bite=(800, 4500))
    eng = BatchedAedEngine(tm, FrontendConfig(cmvn="sliding", cmvn_window=300), device=CPU, **opts)
    got, got_parts, _ = drive(eng, sessions, seed=11, partial_every=2, bite=(800, 4500))
    assert sum(len(u) for u, _a in want.values()) > 3
    assert {s: u for s, (u, _a) in got.items()} == {s: u for s, (u, _a) in want.items()}
    assert len(got_parts) == len(want_parts) > 3
    assert got_parts == want_parts
    if feature_path == "host" and precision == "float32":
        for sid, wave in sessions:
            fe = StreamingFrontend(FrontendConfig(cmvn="sliding", cmvn_window=300), device=CPU)
            f = np.concatenate([fe.process(wave), fe.finalize()])
            Tb = -(-f.shape[0] // 64) * 64
            padded = np.zeros((1, Tb, f.shape[1]), np.float32)
            padded[0, : f.shape[0]] = f
            assert A.aed_decode_batch(tm, padded, [f.shape[0]], beam=2, max_tokens=aed_final_max_tokens(Tb),
                                      ctc_weight=0.3)[0] == got[sid][0]


def _drained(eng, sessions):
    for sid, wave in sessions:
        assert eng.start(sid)
        eng.feed(sid, wave)
        eng.end(sid)
    while not all(eng.drained(sid) for sid, _w in sessions):
        eng.tick()


def test_finalize_many_equals_finalize(engine_models):
    """Three sessions of different lengths drained together:
    ``finalize_many`` (one beam call a length bucket, dummy rows up to a
    power of two) equals ``finalize`` one by one, and the reference's
    ``finalize_many``."""
    from mogasr.config import FrontendConfig as JFrontendConfig
    from mogasr.serving.engine import BatchedAedEngine as JEngine
    from mogasr_torch.serving.engine import BatchedAedEngine

    jm, jp, tm = engine_models
    sessions = _sessions()
    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    opts = dict(capacity=4, beam=2, ctc_weight=0.3, final_bucket=64)
    many = BatchedAedEngine(tm, fcfg, device=CPU, **opts)
    _drained(many, sessions)
    got = many.finalize_many([sid for sid, _w in sessions])
    one = BatchedAedEngine(tm, fcfg, device=CPU, **opts)
    _drained(one, sessions)
    assert {sid: one.finalize(sid) for sid, _w in sessions} == got
    jeng = JEngine(jm, jp, JFrontendConfig(cmvn="sliding", cmvn_window=300), **opts)
    _drained(jeng, sessions)
    want = jeng.finalize_many([sid for sid, _w in sessions])
    assert {s: u for s, (u, _a) in got.items()} == {s: u for s, (u, _a) in want.items()}
    assert many.n_live == 0


# ---------------------------------------------------------------------------
# The CLI twins
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One ``train_nn --objective aed --aed-chunk 4 --bpe-merges 12`` run
    (two steps, one MWER step) and a unit bigram over its BPE units, in
    process."""
    from mogasr_torch.cli import train_lm, train_nn

    d = str(tmp_path_factory.mktemp("aed"))
    train_nn.main(["--synthetic", "4", "--objective", "aed", "--arch", "conformer", *RUN, "--steps", "2",
                   "--aed-chunk", "4", "--bpe-merges", "12", "--mwer-steps", "1", "--run-dir", d,
                   "--device", "cpu"])
    train_lm.main(["--synthetic", "12", "--unit-ngram", "--bpe", os.path.join(d, "bpe.json"), "--run-dir", d,
                   "--device", "cpu"])
    return d


def _model(d, bpe):
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    m = A.build_aed_model(bpe.n_units, TrainConfig(**TINY), FrontendConfig().feat_dim, chunk_frames=4)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in restore_checkpoint(os.path.join(d, "nn_aed_conformer"))
                       ["params"].items()})
    return m.eval()


def test_train_nn_aed_matches_the_pipeline(run):
    """The checkpoint is ``train_aed_bpe`` then ``finetune_aed_mwer``'s on
    the same features, units and sizes, bit for bit."""
    from mogasr_torch.cli.common import load_corpus
    from mogasr_torch.data.bpe import load_bpe

    bpe = load_bpe(os.path.join(run, "bpe.json"))
    corpus, _lex = load_corpus(type("A", (), dict(synthetic=4, synthetic_seed=0, synthetic_v2=0, manifest=None,
                                                  librispeech_root=None, max_utts=0))())
    batches = pipe.featurize(corpus, FrontendConfig(), BatchConfig(), CPU)
    tcfg = TrainConfig(nn_arch="conformer", lr=1e-3, num_nn_steps=2, **TINY)
    model, _sd = pipe.train_aed_bpe(batches, bpe, tcfg, chunk_frames=4)
    sd, _hist = pipe.finetune_aed_mwer(model, batches, bpe.encode, tcfg, steps=1)
    got = _model(run, bpe).state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def _hyps(path):
    with open(path) as f:
        return [json.loads(line)["hyp"] for line in f]


def test_decode_and_eval_aed_match_the_pipeline(run, tmp_path):
    """``decode --aed --bpe`` (the joint CTC rescoring at its default 0.3;
    with ``--fusion-lm``) and ``eval --aed --bpe`` (no rescoring, as the
    reference) give the words of ``make_aed_decoder`` on the model they
    load."""
    from mogasr_torch.cli import decode, eval as eval_cli
    from mogasr_torch.data.bpe import load_bpe
    from mogasr_torch.lm.unit_ngram import load_unit_lm

    bpe = load_bpe(os.path.join(run, "bpe.json"))
    model = _model(run, bpe)
    corpus = ["--synthetic", "2", "--synthetic-seed", "3"]
    ck = ["--nn-ckpt", os.path.join(run, "nn_aed_conformer"), *MODEL, "--bpe", os.path.join(run, "bpe.json"),
          "--device", "cpu"]
    base = [*corpus, "--aed", "--aed-chunk", "4", "--aed-beam", "3", "--aed-max-tokens", "12", *ck,
            "--run-dir", str(tmp_path)]
    utts = make_corpus(2, seed=3)
    (fb,) = [pipe.live_rows(b) for b in pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts],
                                                       FrontendConfig(), BatchConfig(), CPU)]

    def words(**opts):
        toks, n, _ = A.make_aed_decoder(model, beam=3, max_tokens=12, **opts)(fb.feats, fb.n_frames)
        return [bpe.decode(toks[b, : n[b]].tolist()) for b in range(fb.size)]

    decode.main([*base, "--out", str(tmp_path / "a.jsonl")])
    assert _hyps(tmp_path / "a.jsonl") == words(ctc_weight=0.3)
    fusion = A.aed_fusion_matrix(model, load_unit_lm(os.path.join(run, "unit_lm.npz")), 0.5)
    decode.main([*base, "--fusion-lm", os.path.join(run, "unit_lm.npz"), "--aed-ctc-weight", "0",
                 "--out", str(tmp_path / "f.jsonl")])
    assert _hyps(tmp_path / "f.jsonl") == words(fusion=fusion)
    eval_cli.main([*corpus, "--aed", "--aed-beam", "3", "--aed-max-tokens", "12", *ck,
                   "--run-dir", str(tmp_path / "ev")])
    with open(tmp_path / "ev" / "eval_hyps.jsonl") as f:
        got = {r["utt_id"]: r["hyp"] for r in map(json.loads, f)}
    # eval's model has the offline encoder (the reference builds it without chunk_frames)
    offline = A.build_aed_model(bpe.n_units, TrainConfig(**TINY), FrontendConfig().feat_dim)
    offline.load_state_dict(model.state_dict())
    toks, n, _ = A.make_aed_decoder(offline.eval(), beam=3, max_tokens=12)(fb.feats, fb.n_frames)
    assert got == {u: bpe.decode(toks[b, : n[b]].tolist()) for b, u in enumerate(fb.utt_ids)}


def _streamed(wave):
    """The streaming features (sliding CMVN, the twins' window) of a wave."""
    from mogasr_torch.frontend.streaming import StreamingFrontend

    fe = StreamingFrontend(FrontendConfig(cmvn="sliding", cmvn_window=600), device=CPU)
    return np.concatenate([fe.process(wave[i:i + 4000]) for i in range(0, len(wave), 4000)] + [fe.finalize()])


def test_stream_serve_and_transcribe_aed_match_the_pipeline(run, tmp_path, capsys):
    """``stream --aed`` (its final: the beam over the utterance's streamed
    features, budget 2 + T/4), ``serve --aed`` per session and ``--engine``
    (the beam over the history padded to 256 frames) and ``transcribe
    --aed`` (a VAD segment's beam) give the pipeline's words."""
    from mogasr_torch.cli import serve, stream, transcribe
    from mogasr_torch.data.bpe import load_bpe
    from mogasr_torch.frontend.vad import VadConfig, segment_utterances
    from mogasr_torch.serving.engine import aed_final_max_tokens

    bpe = load_bpe(os.path.join(run, "bpe.json"))
    model = _model(run, bpe)
    common = ["--aed", "--aed-chunk", "4", "--nn-ckpt", os.path.join(run, "nn_aed_conformer"), *MODEL, "--bpe",
              os.path.join(run, "bpe.json"), "--device", "cpu", "--run-dir", str(tmp_path)]
    stream.main(["--synthetic-demo", *common])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    f = _streamed(make_corpus(1, words_per_utt=(4, 6), seed=7)[0].wave)
    want = A.aed_decode_batch(model, f[None], [f.shape[0]], beam=4, max_tokens=2 + f.shape[0] // 4, ctc_weight=0.3)
    assert [e["final"] for e in lines if "final" in e] == [bpe.decode(want[0])]
    assert sum("partial" in e for e in lines) > 2
    f = _streamed(make_corpus(1, words_per_utt=(2, 3), seed=7)[0].wave)
    padded = np.zeros((1, 256 * -(-f.shape[0] // 256), f.shape[1]), np.float32)
    padded[0, : f.shape[0]] = f
    want = bpe.decode(A.aed_decode_batch(model, padded, [f.shape[0]], beam=4,
                                         max_tokens=aed_final_max_tokens(padded.shape[1]), ctc_weight=0.3)[0])
    for mode in ([], ["--engine", "--feature-path", "host"], ["--engine", "--aed-stream-precision", "bfloat16"]):
        serve.main(["--synthetic-demo-session", *mode, *common])
        finals = [json.loads(line) for line in capsys.readouterr().out.splitlines() if '"final"' in line]
        assert [(e["session"], e["final"]) for e in finals] == [("demo", want)], mode
    transcribe.main(["--synthetic-demo", "--aed-max-tokens", "10", *common])
    segs = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith('{"start_s"')]
    fcfg = FrontendConfig()
    utts = make_corpus(4, words_per_utt=(2, 3), seed=5)
    gap = np.zeros(16000, np.float32)
    wave = np.concatenate(sum(([u.wave, gap] for u in utts), [gap]))
    bounds = segment_utterances(wave, fcfg, VadConfig(max_segment_s=30.0))
    corpus = [(f"seg-{i:04d}", wave[a:b], []) for i, (a, b) in enumerate(bounds)]
    bcfg = BatchConfig(bucket_boundaries=(500, 1000, 2000, 3010))
    want = {}
    for fb in pipe.featurize(corpus, fcfg, bcfg, CPU):
        seqs = A.aed_decode_batch(model, fb.feats, fb.n_frames, beam=4, max_tokens=10, ctc_weight=0.3)
        for uid, seq in zip(fb.utt_ids, seqs):
            want[round(bounds[int(uid.split("-")[1])][0] / fcfg.sample_rate, 2)] = bpe.decode(seq)
    assert len(segs) == len(bounds) >= 2
    assert {s["start_s"]: s["words"] for s in segs} == want


# ---------------------------------------------------------------------------
# A probe for the twins' option handling (the refusal tests of the other
# CLI files show with it that each AED option is read)
# ---------------------------------------------------------------------------


class Probed(Exception):
    """Raised by the probe's stubs once a twin has handed its options on."""


def aed_probe(monkeypatch, n_units: int = 6):
    """Stub the AED twins' model loader, BPE reader, beam, stream step,
    engine and training entry points: each records what it was given; the
    beam, the engine and the training entry points then raise ``Probed``
    (the stream step returns blank-free zero logits, so ``stream --aed``
    reaches its final). Returns the dict of what was recorded."""
    import types

    seen = {}

    def load(args, n, feat_dim, device):
        seen.update(aed_chunk=getattr(args, "aed_chunk", None), aed_left_chunks=getattr(args, "aed_left_chunks", None),
                    n_units=n)
        return types.SimpleNamespace(n_units=n, chunk_frames=getattr(args, "aed_chunk", 0))

    def stop(*_args, **kw):
        seen.update(kw)
        raise Probed

    def step_of(model):
        return lambda feats, state: (None, torch.zeros(1, feats.shape[1] // 4, model.n_units + 1), state)

    bpe = types.SimpleNamespace(n_units=n_units, decode=lambda units: [str(u) for u in units])
    monkeypatch.setattr("mogasr_torch.cli.common.load_aed_model", load)
    monkeypatch.setattr("mogasr_torch.data.bpe.load_bpe", lambda path: bpe)
    monkeypatch.setattr("mogasr_torch.am.aed.make_aed_decoder", stop)
    monkeypatch.setattr("mogasr_torch.am.aed.aed_decode_batch", stop)
    monkeypatch.setattr("mogasr_torch.am.aed.make_aed_stream_step", step_of)
    monkeypatch.setattr("mogasr_torch.am.aed.aed_stream_init", lambda model, batch, n_feats, device=None: {})
    monkeypatch.setattr("mogasr_torch.serving.engine.BatchedAedEngine", stop)
    for name in ("train_aed", "train_aed_bpe"):
        monkeypatch.setattr(f"mogasr_torch.pipeline.{name}", lambda *a, _n=name, **kw: stop(entry=_n, **kw))
    return seen


def test_aed_probe_sees_the_defaults(monkeypatch, tmp_path):
    """The probe itself: ``decode --aed`` hands the beam the reference's
    defaults (beam 4, 64 tokens, CTC weight 0.3, no fusion)."""
    from mogasr_torch.cli import decode

    seen = aed_probe(monkeypatch)
    with pytest.raises(Probed):
        decode.main(["--synthetic", "1", "--aed", "--mode", "phone", "--nn-ckpt", "x", "--device", "cpu",
                     "--run-dir", str(tmp_path)])
    assert seen == dict(aed_chunk=0, aed_left_chunks=1, n_units=seen["n_units"], beam=4, max_tokens=64,
                        ctc_weight=0.3, fusion=None)

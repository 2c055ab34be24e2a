"""The RNN-T slice as a whole, and its CLI twins.

``pipeline.train_rnnt_units`` (a stateless prediction net, the auxiliary CTC
head) for three steps on both packages from the reference's initial
parameters carried across by ``from_flax``, then the device greedy: each
step's weights to the CE tests' tolerance and the same tokens. Then the
``train_nn --objective rnnt``, ``decode``, ``eval``, ``stream``,
``transcribe`` and ``serve --rnnt`` twins held to the pipeline functions
they run (in process, on the CPU)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jpipe
from mogasr.am import rnnt as JR
from mogasr.config import TrainConfig as JTrainConfig
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import rnnt as R
from mogasr_torch.am.params import from_flax
from mogasr_torch.config import BatchConfig, FrontendConfig, TrainConfig
from mogasr_torch.data.synthetic import make_corpus

CPU = torch.device("cpu")
TINY = dict(nn_hidden=16, nn_layers=2)
RUN = ["--hidden", "16", "--layers", "2"]
MODEL = ["--nn-hidden", "16", "--nn-layers", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def test_train_rnnt_units_then_decode_matches_jax(monkeypatch):
    """Three steps of the reference's train_rnnt_units against the port's
    from the same initial weights (the reference's, kept as its
    init_rnnt_train_state returns them) on seeded features (a row without
    labels among them), then the device greedy of both on the trained
    weights."""
    rng = np.random.default_rng(0)
    D, n_units = 8, 4
    feats = rng.standard_normal((3, 24, D)).astype(np.float32)
    nf = np.asarray([24, 17, 9], np.int32)
    words = [["1", "2", "0"], ["3"], []]

    def encode(ws):
        return [int(w) for w in ws]

    kw = dict(lr=1e-2, num_nn_steps=60, **TINY)
    jfb = jpipe.FeatBatch(["a", "b", "c"], jnp.asarray(feats), jnp.asarray(nf), words)
    initial = []
    j_init = JR.init_rnnt_train_state

    def keep_init(*args, **kwargs):
        state = j_init(*args, **kwargs)
        initial.append(state.params)
        return state

    monkeypatch.setattr(JR, "init_rnnt_train_state", keep_init)
    jm, jp = jpipe.train_rnnt_units([jfb], encode, n_units, JTrainConfig(**kw), steps=3)
    tm = R.build_rnnt_model(n_units, TrainConfig(**kw), D)
    tm.load_state_dict(from_flax(tm, initial[0]))
    monkeypatch.setattr(pipe, "rnnt_model_for", lambda *args, **kwargs: tm)
    fb = pipe.FeatBatch(["a", "b", "c"], torch.as_tensor(feats), torch.as_tensor(nf), words)
    model, sd = pipe.train_rnnt_units([fb], encode, n_units, TrainConfig(**kw), steps=3)
    want = from_flax(model, jp)
    for name, value in sd.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
    tokens = JR.rnnt_greedy_decode_device(jm, jp, jnp.asarray(feats), jnp.asarray(nf))
    assert sum(map(len, tokens)) > 0
    assert R.rnnt_greedy_decode_device(model, fb.feats, fb.n_frames) == tokens


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One ``train_nn --objective rnnt --bpe-merges`` run (two steps) and a
    ``train_lm`` run, both in process."""
    from mogasr_torch.cli import train_lm, train_nn

    d = str(tmp_path_factory.mktemp("rnnt"))
    train_nn.main(["--synthetic", "4", "--objective", "rnnt", "--arch", "lstm", *RUN, "--steps", "2",
                   "--bpe-merges", "12", "--run-dir", d, "--device", "cpu"])
    train_lm.main(["--synthetic", "12", "--steps", "2", "--hidden", "16", "--batch-size", "4", "--run-dir", d,
                   "--device", "cpu"])
    return d


def _model(d, bpe):
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    m = R.build_rnnt_model(bpe.n_units, TrainConfig(**TINY), FrontendConfig().feat_dim)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in restore_checkpoint(os.path.join(d, "nn_rnnt_lstm"))
                       ["params"].items()})
    return m.eval()


def test_train_nn_rnnt_matches_the_pipeline(run):
    """The checkpoint is ``train_rnnt_bpe``'s on the same features, units
    and sizes, bit for bit."""
    from mogasr_torch.cli.common import load_corpus
    from mogasr_torch.data.bpe import load_bpe, train_bpe

    bpe = load_bpe(os.path.join(run, "bpe.json"))
    corpus, _lex = load_corpus(type("A", (), dict(synthetic=4, synthetic_seed=0, synthetic_v2=0, manifest=None,
                                                  librispeech_root=None, max_utts=0))())
    batches = pipe.featurize(corpus, FrontendConfig(), BatchConfig(), CPU)
    assert train_bpe([fb.words[b] for fb in batches for b in range(fb.size)], n_merges=12).merges == bpe.merges
    _m, sd = pipe.train_rnnt_bpe(batches, bpe, TrainConfig(nn_arch="lstm", lr=1e-3, num_nn_steps=2, **TINY))
    got = _model(run, bpe).state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def _hyps(path):
    with open(path) as f:
        return [json.loads(line)["hyp"] for line in f]


def test_decode_and_eval_rnnt_match_the_pipeline(run, tmp_path):
    """``decode --rnnt --bpe`` (greedy; the beam; the beam with the neural
    LM re-ranking its N-best) and ``eval --rnnt`` give the words of the
    pipeline functions on the model they load."""
    from mogasr_torch.cli import decode, eval as eval_cli
    from mogasr_torch.data.bpe import load_bpe
    from mogasr_torch.lm.neural import load_nnlm, rescore_nbest_nnlm

    bpe = load_bpe(os.path.join(run, "bpe.json"))
    model = _model(run, bpe)
    corpus = ["--synthetic", "2", "--synthetic-seed", "3"]
    base = [*corpus, "--rnnt", "--am", "lstm", "--nn-ckpt", os.path.join(run, "nn_rnnt_lstm"), *MODEL, "--bpe",
            os.path.join(run, "bpe.json"), "--device", "cpu", "--run-dir", str(tmp_path)]
    utts = make_corpus(2, seed=3)
    (fb,) = [pipe.live_rows(b) for b in pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts],
                                                       FrontendConfig(), BatchConfig(), CPU)]
    decode.main([*base, "--out", str(tmp_path / "g.jsonl")])
    assert _hyps(tmp_path / "g.jsonl") == [bpe.decode(s) for s in R.rnnt_greedy_decode_device(model, fb.feats,
                                                                                                fb.n_frames)]
    ranked = R.rnnt_beam_decode_device(model, fb.feats, fb.n_frames, beam_size=2)
    decode.main([*base, "--rnnt-beam", "2", "--out", str(tmp_path / "b.jsonl")])
    assert _hyps(tmp_path / "b.jsonl") == [bpe.decode(r[0][1]) for r in ranked]
    decode.main([*base, "--rnnt-beam", "2", "--nnlm-rescore", os.path.join(run, "nnlm"), "--nnlm-weight", "2",
                 "--out", str(tmp_path / "n.jsonl")])
    lm, vocab = load_nnlm(os.path.join(run, "nnlm"), CPU)
    rescored = rescore_nbest_nnlm(lm, vocab, [[(bpe.decode(s), sc) for sc, s in r] for r in ranked], weight=2.0)
    assert _hyps(tmp_path / "n.jsonl") == [r[0][0] for r in rescored]
    eval_cli.main([*corpus, "--rnnt", "--nn-arch", "lstm", "--nn-ckpt", os.path.join(run, "nn_rnnt_lstm"), *MODEL,
                   "--bpe", os.path.join(run, "bpe.json"), "--device", "cpu", "--run-dir", str(tmp_path / "ev")])
    with open(tmp_path / "ev" / "eval_hyps.jsonl") as f:
        got = {r["utt_id"]: r["hyp"] for r in map(json.loads, f)}
    assert got == {u: h for u, h in zip(fb.utt_ids, _hyps(tmp_path / "g.jsonl"))}


def _streamed(wave):
    """The streaming features (sliding CMVN, the twins' window) of a wave."""
    from mogasr_torch.frontend.streaming import StreamingFrontend

    fe = StreamingFrontend(FrontendConfig(cmvn="sliding", cmvn_window=600), device=CPU)
    return np.concatenate([fe.process(wave[i:i + 4000]) for i in range(0, len(wave), 4000)] + [fe.finalize()])


def _greedy_words(model, bpe, f):
    seq = R.rnnt_greedy_decode_device(model, torch.as_tensor(f[None]), torch.as_tensor([f.shape[0]]),
                                      max_symbols=4 * f.shape[0])[0]
    return bpe.decode(seq)


def test_stream_serve_and_transcribe_rnnt_match_the_pipeline(run, tmp_path, capsys):
    """``stream --rnnt``, ``serve --rnnt`` (per session and ``--engine``)
    and ``transcribe --rnnt`` give the device greedy's words on the
    features they decode."""
    from mogasr_torch.cli import serve, stream, transcribe
    from mogasr_torch.data.bpe import load_bpe
    from mogasr_torch.frontend.vad import VadConfig, segment_utterances

    bpe = load_bpe(os.path.join(run, "bpe.json"))
    model = _model(run, bpe)
    common = ["--rnnt", "--nn-ckpt", os.path.join(run, "nn_rnnt_lstm"), *MODEL, "--bpe", os.path.join(run, "bpe.json"),
              "--device", "cpu", "--run-dir", str(tmp_path)]
    stream.main(["--synthetic-demo", "--max-symbols", "4000", *common])
    finals = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith('{"final"')]
    assert finals[0]["final"] == _greedy_words(model, bpe, _streamed(make_corpus(1, words_per_utt=(4, 6),
                                                                                               seed=7)[0].wave))
    want = _greedy_words(model, bpe, _streamed(make_corpus(1, words_per_utt=(2, 3), seed=7)[0].wave))
    for mode in ([], ["--engine"]):
        serve.main(["--synthetic-demo-session", "--max-symbols", "4000", *mode, *common])
        finals = [json.loads(line) for line in capsys.readouterr().out.splitlines() if '"final"' in line]
        assert [(e["session"], e["final"]) for e in finals] == [("demo", want)]
    transcribe.main(["--synthetic-demo", "--nn-arch", "lstm", *common])
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
        for uid, seq in zip(fb.utt_ids, R.rnnt_greedy_decode_device(model, fb.feats, fb.n_frames)):
            want[round(bounds[int(uid.split("-")[1])][0] / fcfg.sample_rate, 2)] = bpe.decode(seq)
    assert len(segs) == len(bounds) >= 2
    assert {s["start_s"]: s["words"] for s in segs} == want

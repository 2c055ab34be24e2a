"""The port's GMM CLI twins (``mogasr_torch.cli.{features,score,align,eval}``)
on the CPU against the reference CLIs run in-process, on the same corpus: 8
synthetic utterances of the small lexicon written as 16-bit WAV with a JSONL
manifest and a lexicon file (and 3 v2 utterances of the headline bundle's
vocabulary for ``eval --bundle``). The features within the front end's
tolerance, the score matrices within the plain scorer's, the alignments'
pdfs and phones identical, the eval hypotheses identical with the same WER
counts (with and without ``--consensus``); the eval resume; each unported
flag raising NotImplementedError naming its ROADMAP item; ``--device cuda``
without a card stopping the program."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am.gmm import GmmSet as JaxGmmSet
from mogasr.am.gmm import gmm_loglik as jax_gmm_loglik
from mogasr.data import audio as jax_audio
from mogasr.data import librispeech as jax_librispeech
from mogasr.data import manifest as jax_manifest
from mogasr_torch.cli import align as cli_align
from mogasr_torch.cli import eval as cli_eval
from mogasr_torch.cli import features as cli_features
from mogasr_torch.cli import score as cli_score
from mogasr_torch.cli import train_gmm as cli_train_gmm
from mogasr_torch.config import FrontendConfig
from mogasr_torch.data import kaldi_io
from mogasr_torch.data.synthetic import LEXICON, extended_lexicon, make_corpus, make_corpus_v2
from mogasr_torch.frontend.numpy_ref import extract_features_np
from mogasr_torch.utils.checkpoint import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(ROOT, "benchmarks", "headline")
FRONTEND_ATOL = FRONTEND_RTOL = 3e-4  # tests/test_torch_frontend.py
SCORER_ATOL, SCORER_RTOL = 1e-4, 1e-5  # the plain scorer against JAX's, tests/test_torch_gmm.py
# The two CLIs' score matrices come from their own front ends' features,
# which differ by up to the front end's tolerance: through the GMM's
# quadratic that moves a log-likelihood (~1e2) by up to ~1e-4 of itself.
SCORE_VS_REFERENCE_RTOL = 1e-3
SCORE_STATES, SCORE_COMPONENTS = 30, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (many small ops; the suite's
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_corpus(d, utts, prons):
    """A WAV manifest of ``utts`` in ``d`` and a lexicon file; returns the
    corpus flags."""
    os.makedirs(d / "wav")
    entries = []
    for u in utts:
        jax_audio.write_wav(str(d / "wav" / f"{u.utt_id}.wav"), u.wave, u.sample_rate)
        entries.append({"audio": f"wav/{u.utt_id}.wav", "text": " ".join(u.words), "id": u.utt_id})
    jax_manifest.write_manifest(str(d / "corpus.jsonl"), entries)
    with open(d / "lexicon.txt", "w") as f:
        for word in sorted(prons):
            f.write(f"{word.upper()} {' '.join(prons[word])}\n")
    return ["--manifest", str(d / "corpus.jsonl"), "--lexicon", str(d / "lexicon.txt")]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    utts = make_corpus(8, words_per_utt=(2, 3), seed=21)
    return d, utts, _write_corpus(d, utts, LEXICON)


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    d = tmp_path_factory.mktemp("v2")
    lexicon = extended_lexicon()
    utts = make_corpus_v2(3, lexicon=lexicon, seed=3)
    return d, utts, _write_corpus(d, utts, lexicon)


def _run_reference(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _both(tmp_path, monkeypatch, name, corpus, flags, out_ext=None):
    """Run the port's twin (on the CPU) and the reference CLI with the same
    flags; returns {who: (run dir, out path)}."""
    import importlib

    port = {"features": cli_features, "score": cli_score, "align": cli_align, "eval": cli_eval}[name]
    ref = importlib.import_module(f"cli.{name}")
    runs = {}
    for who in ("port", "reference"):
        d = tmp_path / who
        out = str(d / f"out.{out_ext}") if out_ext else None
        argv = corpus + flags + ["--run-dir", str(d / "run")] + (["--out", out] if out else [])
        if who == "port":
            port.main(argv + ["--device", "cpu"])
        else:
            _run_reference(ref, argv, monkeypatch)
        runs[who] = (str(d / "run"), out)
    return runs


def test_features_cli_matches_reference(small, tmp_path, monkeypatch):
    d, utts, corpus = small
    runs = _both(tmp_path, monkeypatch, "features", corpus,
                 ["--check-parity", "--write-ark", str(tmp_path / "feats.ark")], "npz")
    got, want = (np.load(runs[w][1]) for w in ("port", "reference"))
    assert sorted(got.files) == sorted(want.files) == sorted(u.utt_id for u in utts)
    cfg = FrontendConfig()
    for u in utts:
        # the wave as the manifest reads it back (16-bit), through the oracle
        oracle = extract_features_np(jax_audio.read_audio(str(d / "wav" / f"{u.utt_id}.wav"))[0], cfg)
        np.testing.assert_allclose(got[u.utt_id], oracle, atol=FRONTEND_ATOL, rtol=FRONTEND_RTOL)
        # no further from the reference than the reference's own error and the tolerance
        ref_err = np.abs(want[u.utt_id] - oracle)
        limit = ref_err + FRONTEND_ATOL + FRONTEND_RTOL * np.abs(oracle)
        assert np.all(np.abs(got[u.utt_id] - want[u.utt_id]) <= limit)
    for who in ("port", "reference"):
        rec = _records(runs[who][0])
        assert [r["stage"] for r in rec] == ["features", "parity"] and rec[1]["pass"]
        assert rec[0]["utts"] == len(utts) and rec[0]["frames"] == sum(len(got[k]) for k in got.files)
    # the ark (written last, by the reference) reads back: the port's wrote the same text
    back = kaldi_io.read_ark_t_dict(str(tmp_path / "feats.ark"))
    assert sorted(back) == sorted(got.files)
    for k in got.files:
        np.testing.assert_allclose(back[k], want[k], rtol=1e-6, atol=1e-6)


def test_features_cli_other_types(small, tmp_path):
    _d, utts, corpus = small
    cli_features.main(corpus + ["--feature-type", "plp", "--max-utts", "2", "--device", "cpu", "--run-dir",
                                str(tmp_path / "run"), "--out", str(tmp_path / "plp.npz")])
    got = np.load(tmp_path / "plp.npz")
    assert len(got.files) == 2 and got[utts[0].utt_id].shape[1] == FrontendConfig(feature_type="plp").feat_dim


def _random_gmm_np(S, K, D):
    """cli/score.py's random GMM: numpy seed 0."""
    rng = np.random.default_rng(0)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.standard_normal((S, K, D)).astype(np.float32),
            (0.5 + rng.random((S, K, D))).astype(np.float32))


def test_score_cli_matches_reference(small, tmp_path, monkeypatch):
    _d, utts, corpus = small
    size = ["--num-states", str(SCORE_STATES), "--num-components", str(SCORE_COMPONENTS)]
    runs = _both(tmp_path, monkeypatch, "score", corpus, size, "npz")
    got, want = (np.load(runs[w][1]) for w in ("port", "reference"))
    assert sorted(got.files) == sorted(want.files) == sorted(u.utt_id for u in utts)
    # the port's matrices against JAX's scorer on the port's own features
    cli_features.main(corpus + ["--device", "cpu", "--run-dir", str(tmp_path / "f"), "--out",
                                str(tmp_path / "feats.npz")])
    feats = np.load(tmp_path / "feats.npz")
    jgmm = JaxGmmSet(*(jnp.asarray(a) for a in _random_gmm_np(SCORE_STATES, SCORE_COMPONENTS, 39)))
    for k in got.files:
        assert got[k].shape == want[k].shape == (len(feats[k]), SCORE_STATES)
        np.testing.assert_allclose(got[k], np.asarray(jax_gmm_loglik(jnp.asarray(feats[k]), jgmm)),
                                   atol=SCORER_ATOL, rtol=SCORER_RTOL)
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_VS_REFERENCE_RTOL)
    rec, jrec = (_records(runs[w][0])[-1] for w in ("port", "reference"))
    assert (rec["stage"], rec["frames"], rec["S"], rec["K"]) == (jrec["stage"], jrec["frames"], jrec["S"], jrec["K"])


def test_score_cli_reads_the_port_checkpoint(small, tmp_path):
    _d, _utts, corpus = small
    w, m, v = _random_gmm_np(7, 2, 39)
    save_checkpoint(str(tmp_path / "gmm"), {"weights": w, "means": m, "vars": v}, step=3)
    cli_score.main(corpus + ["--max-utts", "2", "--gmm-ckpt", str(tmp_path / "gmm"), "--compute-dtype", "bfloat16",
                             "--device", "cpu", "--run-dir", str(tmp_path / "run"), "--out", str(tmp_path / "s.npz")])
    rec = _records(str(tmp_path / "run"))[-1]
    assert (rec["S"], rec["K"]) == (7, 2) and len(np.load(tmp_path / "s.npz").files) == 2


def test_align_cli_matches_reference(small, tmp_path, monkeypatch):
    _d, utts, corpus = small
    runs = _both(tmp_path, monkeypatch, "align", corpus, ["--num-components", "2"], "jsonl")
    got, want = (_jsonl(runs[w][1]) for w in ("port", "reference"))
    assert [g["utt_id"] for g in got] == [w["utt_id"] for w in want] and len(got) == len(utts)
    assert [(g["pdfs"], g["phones"]) for g in got] == [(w["pdfs"], w["phones"]) for w in want]
    np.testing.assert_allclose([g["score"] for g in got], [w["score"] for w in want], rtol=1e-5)
    rec, jrec = (_records(runs[w][0])[-1] for w in ("port", "reference"))
    assert (rec["stage"], rec["utts"]) == (jrec["stage"], jrec["utts"]) == ("align", len(utts))


@pytest.mark.parametrize("case", ["loop", "consensus", "bundle"])
def test_eval_cli_matches_reference(small, v2, tmp_path, monkeypatch, case):
    """The small lexicon's word loop with the random GMM (8 utterances, 1-best
    and, on 2 of them, consensus over the unpruned lattices), and the
    headline bundle's CD word loop on 3 v2 utterances."""
    if case == "bundle":
        _d, utts, corpus = v2
        flags = ["--bundle", BUNDLE]
    else:
        _d, utts, corpus = small
        flags = ["--consensus", "--max-utts", "2"] if case == "consensus" else []
    runs = _both(tmp_path, monkeypatch, "eval", corpus, flags)
    got, want = (_jsonl(os.path.join(runs[w][0], "eval_hyps.jsonl")) for w in ("port", "reference"))
    assert got == want and len(got) == (2 if case == "consensus" else len(utts))
    rec, jrec = (_records(runs[w][0])[-1] for w in ("port", "reference"))
    keys = ("stage", "split", "utts", "wer", "sub", "dels", "ins")
    assert {k: rec[k] for k in keys} == {k: jrec[k] for k in keys}
    assert rec["n_chips"] == 1  # the reference's mesh here is the tests' 8 host devices
    assert {"wall_sec", "utts_per_sec_per_chip", "rtf"} <= set(rec)
    if case == "bundle":
        assert rec["wer"] <= 0.1  # the trained system on its own vocabulary
    assert any(g["hyp"] for g in got)


def test_eval_cli_resumes(tmp_path):
    """A sweep cut inside its second batch (18 utterances, batches of 16):
    started again, it skips the first batch, decodes the cut one in full,
    the first line of an utterance wins, and the record equals the
    uninterrupted sweep's."""
    utts = make_corpus(18, words_per_utt=(1, 2), seed=5)
    corpus = _write_corpus(tmp_path, utts, LEXICON) + ["--device", "cpu"]
    cli_eval.main(corpus + ["--run-dir", str(tmp_path / "whole")])
    whole = _jsonl(str(tmp_path / "whole" / "eval_hyps.jsonl"))
    assert len(whole) == 18
    cut = tmp_path / "cut"
    os.makedirs(cut)
    # the first batch, one line of the second, and that line again, wrong
    lines = [json.dumps(r) for r in whole[:17]] + [json.dumps({**whole[16], "hyp": ["wrong"]})]
    (cut / "eval_hyps.jsonl").write_text("\n".join(lines) + "\n")
    cli_eval.main(corpus + ["--run-dir", str(cut), "--profile"])
    again = _jsonl(str(cut / "eval_hyps.jsonl"))
    assert again == [json.loads(x) for x in lines] + whole[16:]
    keys = ("utts", "wer", "sub", "dels", "ins")
    rec, wrec = _records(str(cut))[-1], _records(str(tmp_path / "whole"))[-1]
    assert {k: rec[k] for k in keys} == {k: wrec[k] for k in keys} and rec["utts"] == 18
    assert os.path.isfile(cut / "profile" / "trace.json")


REFUSED = [
    (cli_features, ["--add-pitch"], "10"), (cli_score, ["--add-pitch"], "10"), (cli_align, ["--add-pitch"], "10"),
    (cli_eval, ["--add-pitch"], "10"), (cli_eval, ["--streaming"], "10"), (cli_eval, ["--chunk-ms", "250"], "10"),
    (cli_eval, ["--fmllr"], "11"), (cli_eval, ["--mllr"], "11"), (cli_eval, ["--vtln"], "11"),
    (cli_eval, ["--am", "lstm"], "12"), (cli_eval, ["--nn-ckpt", "nn"], "12"),
    (cli_eval, ["--ctc"], "13"), (cli_eval, ["--rnnt"], "13"), (cli_eval, ["--aed"], "13"),
    (cli_eval, ["--bpe", "bpe.json"], "13"),
]


@pytest.mark.parametrize("cli,flags,item", REFUSED, ids=[f"{c.__name__.split('.')[-1]}{''.join(f)}"
                                                          for c, f, _i in REFUSED])
def test_cli_flags_not_ported_raise(tmp_path, cli, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        cli.main(["--synthetic", "1"] + flags + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])


@pytest.mark.parametrize("flags", [["--rnnt-beam", "4"], ["--nn-arch", "lstm"], ["--aed-beam", "2"]])
def test_eval_companion_flags_of_unported_paths_are_rejected(tmp_path, flags, capsys):
    with pytest.raises(SystemExit):
        cli_eval.main(["--synthetic", "1"] + flags + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("cli", [cli_features, cli_score, cli_align, cli_eval])
def test_gmm_clis_do_not_fall_back_to_the_cpu(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--synthetic", "1", "--run-dir", str(tmp_path / "run")])


@pytest.mark.parametrize("flags", [["--speed-perturb"], ["--aug-snr", "5,20", "--aug-gain=-3,3"], ["manifest"],
                                   ["librispeech"]])
def test_train_gmm_cli_on_real_corpora_and_augmentation(small, tmp_path, flags):
    """``train_gmm`` on the corpora and augmentation that used to raise: a
    manifest, a LibriSpeech-layout FLAC split, and the waveform
    augmentation flags (speed perturbation triples the utterances)."""
    d, utts, corpus = small
    if flags == ["manifest"]:
        args = corpus + ["--max-utts", "2"]
    elif flags == ["librispeech"]:
        root = tmp_path / "LibriSpeech"
        jax_librispeech.write_fixture_corpus(str(root), "dev-clean", utts[:2], fmt="flac")
        args = ["--librispeech-root", str(root), "--lexicon", str(d / "lexicon.txt")]
    else:
        args = ["--synthetic", "1"] + flags
    run_dir = str(tmp_path / "run")
    cli_train_gmm.main(args + ["--device", "cpu", "--run-dir", run_dir, "--num-components", "1", "--num-iters", "1"])
    done = [r for r in _records(run_dir) if r["stage"] == "train_gmm_done"]
    assert len(done) == 1 and np.isfinite(done[0]["final_avg_loglik"])

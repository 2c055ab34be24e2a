"""The CTC paths of the port's CLI twins on the CPU against the reference CLIs
run in-process, from one CTC model saved in each package's checkpoint
format (flax init carried across by ``from_flax``): ``decode --ctc`` (the
CTC word loop, greedy phones, ``--bpe`` greedy and through the device
prefix beam with ``--bias`` and ``--fusion-lm``), ``eval --ctc --bpe``,
``stream --ctc`` (the online decoder on the CTC word loop, and ``--bpe``
through the biased, fused host beam), ``transcribe --ctc`` (with and
without ``--bpe``), ``search --ctc`` and ``train_lm --unit-ngram``; then the
``train_nn --objective ctc`` twin (phones, ``--bpe-merges``,
``--init-from``, ``--distill-from``) against the pipeline functions it
calls, and the refused flags."""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import neural as jn
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr.utils import checkpoint as jckpt
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import neural as tn
from mogasr_torch.am.params import from_flax
from mogasr_torch.cli import decode as cli_decode
from mogasr_torch.cli import eval as cli_eval
from mogasr_torch.cli import search as cli_search
from mogasr_torch.cli import stream as cli_stream
from mogasr_torch.cli import train_lm as cli_train_lm
from mogasr_torch.cli import train_nn as cli_train_nn
from mogasr_torch.cli import transcribe as cli_transcribe
from mogasr_torch.config import BatchConfig, FrontendConfig, TrainConfig
from mogasr_torch.data.bpe import load_bpe, train_bpe
from mogasr_torch.data.synthetic import make_corpus
from mogasr_torch.hmm.lexicon import synthetic_lexicon
from mogasr_torch.lm.unit_ngram import estimate_unit_bigram, save_unit_lm
from mogasr_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

CORPUS = ["--synthetic", "3", "--synthetic-seed", "11"]
NN = ["--nn-hidden", "16", "--nn-layers", "2"]
HEAD_GAIN = 30.0  # peaked posteriors: the decodes emit words
CONF_ATOL = 1e-3  # confidences: posteriors of K3's passes, tests/test_torch_lm.py


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _save_both(root, name, n_out, seed):
    """A CTC LstmAm (16 hidden, 1 LSTM layer) over n_out outputs: flax init,
    the head scaled, saved in the reference's format under root/ref/name and
    in the port's under root/port/name."""
    fcfg = FrontendConfig()
    jm = jn.build_model("lstm", n_out, JaxTrainConfig(nn_hidden=16, nn_layers=2))
    params = {"params": jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((2, 8, fcfg.feat_dim)),
                                         jnp.asarray([8, 8]))["params"]}
    params["params"]["Dense_0"]["kernel"] = params["params"]["Dense_0"]["kernel"] * HEAD_GAIN
    jckpt.save_checkpoint(os.path.join(root, "ref", name), {"params": params}, step=1)
    tm = tn.build_model("lstm", n_out, TrainConfig(nn_hidden=16, nn_layers=2), fcfg.feat_dim)
    save_checkpoint(os.path.join(root, "port", name), {"params": from_flax(tm, params)}, step=1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctc_models"))
    lex = synthetic_lexicon()
    _save_both(root, "phones", lex.n_phones + 1, 0)
    texts = [u.words for u in make_corpus(24, seed=11)]
    bpe = train_bpe(texts, n_merges=12)
    from mogasr_torch.data.bpe import save_bpe

    save_bpe(bpe, os.path.join(root, "bpe.json"))
    _save_both(root, "bpe", bpe.n_units + 1, 1)
    save_unit_lm(os.path.join(root, "unit_lm.npz"), estimate_unit_bigram([bpe.encode(t) for t in texts], bpe.n_units))
    with open(os.path.join(root, "phrases.txt"), "w") as f:
        f.write(" ".join(texts[0][:2]) + "\n" + texts[1][0] + "\n")
    return root


def _ckpt(models, who, name):
    return os.path.join(models, "port" if who == "port" else "ref", name)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _records(run_dir):
    return _jsonl(os.path.join(run_dir, "metrics.jsonl"))


def _lines(text):
    """The JSON lines a CLI printed, its metrics records (printed too) left out."""
    lines = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    return [e for e in lines if "stage" not in e]


def _run(who, module, argv, tmp_path, monkeypatch):
    """Run the port's twin (``--device cpu``) or the reference CLI in-process
    with its own run dir; returns the run dir."""
    run_dir = str(tmp_path / who)
    if who == "port":
        module.main(argv + ["--device", "cpu", "--run-dir", run_dir])
    else:
        monkeypatch.setattr(sys, "argv", ["prog"] + argv + ["--run-dir", run_dir])
        importlib.import_module(f"cli.{module.__name__.split('.')[-1]}").main()
    return run_dir


TIMING = ("wall_sec", "rtf", "utts_per_sec", "utts_per_sec_per_chip", "time")


def _same_record(rec, jrec):
    assert {k: v for k, v in rec.items() if k not in TIMING} == {k: v for k, v in jrec.items() if k not in TIMING}


DECODES = {
    "word": ["--mode", "word"],
    "phone": ["--mode", "phone"],
    "bpe_greedy": ["--bpe", "{m}/bpe.json"],
    "bpe_beam": ["--bpe", "{m}/bpe.json", "--bias", "{m}/phrases.txt", "--fusion-lm", "{m}/unit_lm.npz",
                 "--bias-beam", "4"],
}


@pytest.mark.parametrize("case", list(DECODES))
def test_decode_ctc_matches_reference(models, tmp_path, monkeypatch, case):
    flags = [f.format(m=models) for f in DECODES[case]]
    name = "bpe" if case.startswith("bpe") else "phones"
    out = {}
    for who in ("port", "ref"):
        hyps = str(tmp_path / f"{who}.jsonl")
        run = _run(who, cli_decode, CORPUS + NN + ["--ctc", "--am", "lstm", "--nn-ckpt", _ckpt(models, who, name),
                                                  "--out", hyps] + flags, tmp_path, monkeypatch)
        out[who] = (_records(run)[-1], _jsonl(hyps))
    (rec, hyps), (jrec, jhyps) = out["port"], out["ref"]
    _same_record(rec, jrec)
    assert hyps == jhyps and len(hyps) == 3 and sum(len(h["hyp"]) for h in hyps) > 0


def test_eval_ctc_bpe_matches_reference(models, tmp_path, monkeypatch):
    """``eval --ctc --bpe``: the same hypotheses and WER counts; without
    --bpe both stop with the reference's message."""
    out = {}
    for who in ("port", "ref"):
        run = _run(who, cli_eval, CORPUS + NN + ["--ctc", "--nn-arch", "lstm", "--bpe", f"{models}/bpe.json",
                                                "--nn-ckpt", _ckpt(models, who, "bpe")], tmp_path, monkeypatch)
        out[who] = (_records(run)[-1], _jsonl(os.path.join(run, "eval_hyps.jsonl")))
    (rec, hyps), (jrec, jhyps) = out["port"], out["ref"]
    for r in (rec, jrec):  # the reference spreads its batch over the test run's 8 host devices
        r.pop("n_chips")
    _same_record(rec, jrec)
    assert hyps == jhyps and rec["utts"] == 3
    for who in ("port", "ref"):
        with pytest.raises(SystemExit, match="--ctc requires --bpe and --nn-ckpt"):
            _run(who, cli_eval, CORPUS + ["--ctc", "--nn-ckpt", "x"], tmp_path / "nobpe", monkeypatch)


STREAMS = {
    "graph": [],
    "bpe_beam": ["--bpe", "{m}/bpe.json", "--bias", "{m}/phrases.txt", "--fusion-lm", "{m}/unit_lm.npz",
                 "--bias-beam", "4"],
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_stream_ctc_matches_reference(models, tmp_path, monkeypatch, capsys, case):
    """``stream --ctc``: the same partial after every chunk and the same
    final words (the RTF aside)."""
    flags = [f.format(m=models) for f in STREAMS[case]]
    name = "phones" if case == "graph" else "bpe"
    got = {}
    for who in ("port", "ref"):
        _run(who, cli_stream, ["--synthetic-demo", "--ctc", "--nn-ckpt", _ckpt(models, who, name)] + NN + flags,
             tmp_path, monkeypatch)
        got[who] = [{k: v for k, v in e.items() if k != "rtf"} for e in _lines(capsys.readouterr().out)]
    assert got["port"] == got["ref"] and len(got["port"]) > 3 and got["port"][-1]["final"]


@pytest.mark.parametrize("case", ["graph", "bpe"])
def test_transcribe_ctc_matches_reference(models, tmp_path, monkeypatch, capsys, case):
    flags = ["--bpe", f"{models}/bpe.json"] if case == "bpe" else []
    name = "bpe" if case == "bpe" else "phones"
    got = {}
    for who in ("port", "ref"):
        _run(who, cli_transcribe, ["--synthetic-demo", "--ctc", "--nn-arch", "lstm", "--nn-ckpt",
                                   _ckpt(models, who, name)] + NN + flags, tmp_path, monkeypatch)
        got[who] = _lines(capsys.readouterr().out)
    segs, jsegs = got["port"], got["ref"]
    assert len(segs) == len(jsegs) == 4 and sum(len(s["words"]) for s in segs) > 0
    for s, j in zip(segs, jsegs):
        assert (s["start_s"], s["end_s"], s["words"], s["word_times"]) == \
            (j["start_s"], j["end_s"], j["words"], j["word_times"])
        np.testing.assert_allclose(s["confidences"], j["confidences"], atol=CONF_ATOL)


def test_search_ctc_matches_reference(models, tmp_path, monkeypatch):
    out = {}
    for who in ("port", "ref"):
        hits = str(tmp_path / f"{who}.jsonl")
        run = _run(who, cli_search, CORPUS + NN + ["--ctc", "--nn-arch", "lstm", "--nn-ckpt",
                                                  _ckpt(models, who, "phones"), "--terms", "cat,dog fish",
                                                  "--threshold", "0.0", "--out", hits], tmp_path, monkeypatch)
        out[who] = (_records(run)[-1], _jsonl(hits))
    (rec, hits), (jrec, jhits) = out["port"], out["ref"]
    _same_record(rec, jrec)
    assert [(r["utt_id"], [(h["term"], h["start_sec"], h["end_sec"]) for h in r["hits"]]) for r in hits] == \
        [(r["utt_id"], [(h["term"], h["start_sec"], h["end_sec"]) for h in r["hits"]]) for r in jhits]
    np.testing.assert_allclose([h["posterior"] for r in hits for h in r["hits"]],
                               [h["posterior"] for r in jhits for h in r["hits"]], atol=1e-3)


@pytest.mark.parametrize("units", ["bpe", "phone"])
def test_train_lm_unit_ngram_matches_reference(models, tmp_path, monkeypatch, units):
    flags = ["--bpe", f"{models}/bpe.json"] if units == "bpe" else []
    out = {}
    for who in ("port", "ref"):
        run = _run(who, cli_train_lm, ["--synthetic", "12", "--unit-ngram"] + flags, tmp_path, monkeypatch)
        out[who] = (_records(run)[-1], np.load(os.path.join(run, "unit_lm.npz")))
    (rec, lm), (jrec, jlm) = out["port"], out["ref"]
    _same_record(rec, jrec)
    assert rec["units"] == units
    for k in ("n_units", "pair_logp", "init_logp"):
        np.testing.assert_array_equal(lm[k], jlm[k])


# ------------------------------------------------------------- train_nn --objective ctc

TRAIN = ["--synthetic", "4", "--synthetic-seed", "5", "--hidden", "12", "--layers", "2", "--steps", "2"]


def _featurized():
    corpus = [(u.utt_id, u.wave, u.words) for u in make_corpus(4, seed=5)]
    return pipe.featurize(corpus, FrontendConfig(), BatchConfig(), torch.device("cpu"))


def _params(run, name):
    return {k: torch.as_tensor(v) for k, v in restore_checkpoint(os.path.join(run, name))["params"].items()}


def test_train_nn_ctc_matches_the_pipeline(tmp_path):
    """``train_nn --objective ctc`` (phones, then ``--bpe-merges`` with its
    bpe.json, then an MLP warm-started ``--init-from`` an MPC run) saves the
    state_dicts of ``pipeline.train_ctc``/``train_ctc_bpe`` on the same
    batches, bitwise."""
    lex = synthetic_lexicon()
    tcfg = TrainConfig(nn_arch="lstm", nn_hidden=12, nn_layers=2, num_nn_steps=2)
    run = str(tmp_path / "phones")
    cli_train_nn.main(TRAIN + ["--arch", "lstm", "--objective", "ctc", "--device", "cpu", "--run-dir", run])
    assert _records(run)[-1]["stage"] == "train_ctc_done"
    _m, want = pipe.train_ctc(_featurized(), lex, tcfg, arch="lstm")
    got = _params(run, "nn_ctc_lstm")
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)

    run = str(tmp_path / "bpe")
    cli_train_nn.main(TRAIN + ["--arch", "lstm", "--objective", "ctc", "--bpe-merges", "10", "--device", "cpu",
                               "--run-dir", run])
    batches = _featurized()
    bpe = train_bpe([fb.words[b] for fb in batches for b in range(fb.size)], n_merges=10)
    assert load_bpe(os.path.join(run, "bpe.json")) == bpe
    _m, want = pipe.train_ctc_bpe(batches, bpe, tcfg, arch="lstm")
    got = _params(run, "nn_ctc_lstm")
    assert all(torch.equal(got[k], want[k]) for k in want)

    pre = str(tmp_path / "mpc")
    cli_train_nn.main(TRAIN + ["--arch", "mlp", "--objective", "mpc", "--device", "cpu", "--run-dir", pre])
    run = str(tmp_path / "warm")
    cli_train_nn.main(TRAIN + ["--arch", "mlp", "--objective", "ctc", "--init-from", os.path.join(pre, "nn_mpc_mlp"),
                               "--device", "cpu", "--run-dir", run])
    warm = [r for r in _records(run) if r["stage"] == "ctc_warm_start"]
    assert len(warm) == 1 and 0 < warm[0]["leaves_copied"] < warm[0]["leaves_total"]
    _m, want = pipe.train_ctc(_featurized(), lex, TrainConfig(nn_arch="mlp", nn_hidden=12, nn_layers=2,
                                                              num_nn_steps=2), arch="mlp",
                              init_params=_params(pre, "nn_mpc_mlp"))
    got = _params(run, "nn_ctc_mlp")
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_train_nn_distill_matches_the_pipeline(tmp_path):
    """``train_nn --objective ctc --distill-from`` a BPE teacher run: the
    student's state_dict is ``pipeline.distill_ctc_units``'s, bitwise, and
    the teacher's bpe.json is copied to the student's run."""
    teacher = str(tmp_path / "teacher")
    cli_train_nn.main(TRAIN + ["--arch", "mlp", "--objective", "ctc", "--bpe-merges", "8", "--device", "cpu",
                               "--run-dir", teacher])
    run = str(tmp_path / "student")
    flags = ["--distill-teacher-arch", "mlp", "--distill-teacher-hidden", "12", "--distill-teacher-layers", "2"]
    cli_train_nn.main(TRAIN + ["--arch", "lstm", "--objective", "ctc", "--distill-from",
                               os.path.join(teacher, "nn_ctc_mlp"), "--device", "cpu", "--run-dir", run] + flags)
    bpe = load_bpe(os.path.join(teacher, "bpe.json"))
    assert load_bpe(os.path.join(run, "bpe.json")) == bpe
    batches = _featurized()
    t_model = tn.build_model("mlp", bpe.n_units + 1, TrainConfig(nn_hidden=12, nn_layers=2), FrontendConfig().feat_dim)
    t_model.load_state_dict(_params(teacher, "nn_ctc_mlp"))
    _m, want = pipe.distill_ctc_units(batches, t_model.eval(), bpe.encode, bpe.n_units,
                                      TrainConfig(nn_arch="lstm", nn_hidden=12, nn_layers=2, num_nn_steps=2))
    got = _params(run, "nn_ctc_lstm")
    assert all(torch.equal(got[k], want[k]) for k in want)


# the RNN-T paths run since the RNN-T port (tests/test_torch_cli_rnnt.py), the
# AED's since the AED port (tests/test_torch_cli_aed.py): they stop where the
# reference's stop
@pytest.mark.parametrize("cli,argv,exc,match", [
    (cli_decode, CORPUS + ["--rnnt", "--am", "lstm"], SystemExit, "--nn-ckpt is required"),
    (cli_stream, ["--synthetic-demo", "--rnnt", "--ctc"], SystemExit, "--rnnt requires --nn-ckpt"),
    (cli_train_nn, CORPUS + ["--objective", "aed", "--bpe-merges", "4", "--init-from", "x"], SystemExit,
     "--init-from .MPC warm start. supports --objective ctc"),
], ids=["decode-rnnt", "stream-rnnt", "train_nn-aed"])
def test_unported_families_still_raise(tmp_path, cli, argv, exc, match):
    with pytest.raises(exc, match=match):
        cli.main(argv + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])


@pytest.mark.parametrize("cli,argv", [(cli_train_lm, ["--synthetic", "2", "--unit-ngram"]),
                                      (cli_decode, CORPUS + ["--ctc", "--am", "lstm", "--nn-ckpt", "x"])],
                         ids=["train_lm", "decode"])
def test_ctc_clis_do_not_fall_back_to_the_cpu(tmp_path, cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(argv + ["--run-dir", str(tmp_path / "run")])

"""The port's streaming CLI twins on the CPU against the reference CLIs run
in-process: ``stream --synthetic-demo`` with and without ``--endpoint`` (the
same events, partial and final words, the RTF excepted), ``transcribe
--synthetic-demo --ctm`` (the same segments, words and word times,
confidences within 1e-3, the same CTM rows), ``eval --streaming``
(the same hypotheses and WER counts) and ``features --add-pitch`` (the pitch
triple within the reference's 1e-5, the spectral columns within the front
end's tolerance); each refused flag raising NotImplementedError naming its
ROADMAP item."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from mogasr_torch.cli import eval as cli_eval
from mogasr_torch.cli import features as cli_features
from mogasr_torch.cli import stream as cli_stream
from mogasr_torch.cli import transcribe as cli_transcribe
from mogasr_torch.data.synthetic import LEXICON, make_corpus

FRONTEND_ATOL = 3e-4   # tests/test_torch_frontend.py
PITCH_TOL = 1e-5       # tests/test_pitch.py
CONF_ATOL = 1e-3       # confidences: K3's posteriors, tests/test_torch_lm.py
SMALL_UTTS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (many small ops; the suite's
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _run_both(module_name, port_main, argv, tmp_path, monkeypatch, capsys):
    """(port's stdout JSON lines, reference's), each CLI with its own run dir."""
    import importlib

    port_main(argv + ["--device", "cpu", "--run-dir", str(tmp_path / "port")])
    got = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["prog"] + argv + ["--run-dir", str(tmp_path / "ref")])
    importlib.import_module(f"cli.{module_name}").main()
    want = _lines(capsys.readouterr().out)
    return got, want


@pytest.mark.parametrize("flags", [[], ["--endpoint"]], ids=["plain", "endpoint"])
def test_stream_cli_matches_reference(tmp_path, monkeypatch, capsys, flags):
    got, want = _run_both("stream", cli_stream.main, ["--synthetic-demo", "--num-components", "2"] + flags,
                          tmp_path, monkeypatch, capsys)
    events = [e for e in got if "partial" in e or "final" in e]
    ref_events = [e for e in want if "partial" in e or "final" in e]
    assert len(events) > 3 and events[-1]["final"]
    for e in events + ref_events:
        e.pop("rtf", None)
    assert events == ref_events
    if flags:
        assert "endpoint" in events[-1] and any("endpoint" in e for e in events[:-1])
    rec = [e for e in got if e.get("stage") == "stream"]
    assert rec and rec[0]["final_words"] == events[-1]["final"]


def test_transcribe_cli_matches_reference(tmp_path, monkeypatch, capsys):
    import importlib

    ctm = {w: str(tmp_path / f"{w}.ctm") for w in ("port", "ref")}
    flags = ["--synthetic-demo", "--num-components", "2", "--ctm"]
    cli_transcribe.main(flags + [ctm["port"], "--device", "cpu", "--run-dir", str(tmp_path / "port")])
    got = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["prog"] + flags + [ctm["ref"], "--run-dir", str(tmp_path / "ref")])
    importlib.import_module("cli.transcribe").main()
    want = _lines(capsys.readouterr().out)
    segs, ref_segs = ([r for r in x if "words" in r] for x in (got, want))
    assert len(segs) == len(ref_segs) == 4
    for s, r in zip(segs, ref_segs):
        assert {k: s[k] for k in ("start_s", "end_s", "words", "word_times")} == \
            {k: r[k] for k in ("start_s", "end_s", "words", "word_times")}
        np.testing.assert_allclose(s["confidences"], r["confidences"], atol=CONF_ATOL)
        assert "nbest" not in s and "nbest" not in r
    rows = {w: [line.split() for line in open(ctm[w])] for w in ctm}
    assert [r[:5] for r in rows["port"]] == [r[:5] for r in rows["ref"]] and rows["port"]
    np.testing.assert_allclose([float(r[5]) for r in rows["port"]], [float(r[5]) for r in rows["ref"]],
                               atol=CONF_ATOL + 1e-3)
    rec = [e for e in got if e.get("stage") == "transcribe"]
    assert rec and rec[0]["segments"] == 4


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """SMALL_UTTS small-lexicon utterances as a WAV manifest with a lexicon
    file (few: each utterance length is a JAX compile of the reference's
    pitch and streaming front end)."""
    from mogasr.data import audio as jax_audio
    from mogasr.data import manifest as jax_manifest

    d = tmp_path_factory.mktemp("stream_small")
    utts = make_corpus(SMALL_UTTS, words_per_utt=(2, 3), seed=23)
    os.makedirs(d / "wav")
    entries = []
    for u in utts:
        jax_audio.write_wav(str(d / "wav" / f"{u.utt_id}.wav"), u.wave, u.sample_rate)
        entries.append({"audio": f"wav/{u.utt_id}.wav", "text": " ".join(u.words), "id": u.utt_id})
    jax_manifest.write_manifest(str(d / "corpus.jsonl"), entries)
    with open(d / "lexicon.txt", "w") as f:
        for word in sorted(LEXICON):
            f.write(f"{word.upper()} {' '.join(LEXICON[word])}\n")
    return utts, ["--manifest", str(d / "corpus.jsonl"), "--lexicon", str(d / "lexicon.txt")]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("chunk", [[], ["--chunk-ms", "250"]], ids=["500ms", "250ms"])
def test_eval_streaming_matches_reference(small, tmp_path, monkeypatch, capsys, chunk):
    _utts, corpus = small
    flags = corpus + ["--streaming", "--num-components", "2"] + chunk
    _run_both("eval", cli_eval.main, flags, tmp_path, monkeypatch, capsys)
    hyps = {}
    for who in ("port", "ref"):
        with open(tmp_path / who / "eval_hyps.jsonl") as f:
            hyps[who] = [json.loads(line) for line in f]
    assert hyps["port"] == hyps["ref"] and len(hyps["port"]) == SMALL_UTTS
    keys = ("utts", "wer", "sub", "dels", "ins")
    rec, jrec = _records(str(tmp_path / "port"))[-1], _records(str(tmp_path / "ref"))[-1]
    assert {k: rec[k] for k in keys} == {k: jrec[k] for k in keys}


def test_features_add_pitch_matches_reference(small, tmp_path, monkeypatch, capsys):
    utts, corpus = small
    out = {w: str(tmp_path / f"{w}.npz") for w in ("port", "ref")}
    cli_features.main(corpus + ["--add-pitch", "--check-parity", "--device", "cpu", "--run-dir",
                                str(tmp_path / "port"), "--out", out["port"]])
    monkeypatch.setattr(sys, "argv", ["prog"] + corpus + ["--add-pitch", "--run-dir", str(tmp_path / "ref"), "--out",
                                                          out["ref"]])
    import importlib

    importlib.import_module("cli.features").main()
    capsys.readouterr()
    got, want = np.load(out["port"]), np.load(out["ref"])
    assert sorted(got.files) == sorted(want.files) == sorted(u.utt_id for u in utts)
    for k in got.files:
        assert got[k].shape == want[k].shape and got[k].shape[1] == 42
        np.testing.assert_allclose(got[k][:, :39], want[k][:, :39], atol=2 * FRONTEND_ATOL, rtol=2 * FRONTEND_ATOL)
        np.testing.assert_allclose(got[k][:, 39:], want[k][:, 39:], atol=PITCH_TOL, rtol=PITCH_TOL)
    assert _records(str(tmp_path / "port"))[-1]["pass"]


# --ctc and its --bpe, --bias and --fusion-lm run since the CTC port
# (tests/test_torch_cli_ctc.py), --rnnt since the RNN-T port
# (tests/test_torch_cli_rnnt.py: without a checkpoint or an LSTM encoder it
# stops, or it fails to find the checkpoint it names), --aed since the AED
# port (tests/test_torch_cli_aed.py: without a checkpoint it stops as the
# reference stops)
NO_CKPT = (SystemExit, "--rnnt requires --nn-ckpt")
MISSING = (FileNotFoundError, "no checkpoint under")
ITEM13 = (SystemExit, "--aed requires --nn-ckpt")
STREAM_REFUSED = [
    (cli_stream, ["--synthetic-demo", "--rnnt", "--nn-ckpt", "nn"], MISSING),
    (cli_stream, ["--synthetic-demo", "--rnnt"], NO_CKPT),
    (cli_stream, ["--synthetic-demo", "--aed"], ITEM13),
    (cli_stream, ["--synthetic-demo", "--aed", "--bpe", "b.json"], ITEM13),
    (cli_stream, ["--synthetic-demo", "--rnnt", "--bias", "p.txt"], NO_CKPT),
    (cli_stream, ["--synthetic-demo", "--aed", "--fusion-lm", "u.npz"], ITEM13),
    (cli_transcribe, ["--synthetic-demo", "--rnnt", "--nn-ckpt", "nn"], (SystemExit, "lstm/blstm encoder")),
    (cli_transcribe, ["--synthetic-demo", "--rnnt"], (SystemExit, "--rnnt requires --nn-ckpt")),
    (cli_transcribe, ["--synthetic-demo", "--aed"], ITEM13),
    (cli_transcribe, ["--synthetic-demo", "--aed", "--bpe", "b.json"], ITEM13),
]


@pytest.mark.parametrize("cli,flags,raised", STREAM_REFUSED,
                         ids=[f"{c.__name__.split('.')[-1]}{f[-1] if len(f) == 2 else f[-2]}"
                              for c, f, _r in STREAM_REFUSED])
def test_stream_cli_flags_not_ported_raise(tmp_path, cli, flags, raised):
    with pytest.raises(raised[0], match=raised[1]):
        cli.main(flags + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])


# --rnnt-pred is read by stream and transcribe --rnnt since the RNN-T port; the
# AED's options by stream and transcribe --aed since the AED port: the model
# loader and the final beam get their values
@pytest.mark.parametrize("cli,flags", [(cli_stream, ["--aed-ctc-weight", "0.3"]), (cli_stream, ["--aed-chunk", "8"]),
                                       (cli_transcribe, ["--aed-chunk", "8"]), (cli_transcribe, ["--aed-beam", "2"])])
def test_stream_cli_companion_flags_are_rejected(tmp_path, cli, flags, monkeypatch):
    from mogasr_torch.hmm.lexicon import synthetic_lexicon
    from test_torch_cli_aed import Probed, aed_probe

    seen = aed_probe(monkeypatch)
    with pytest.raises(Probed):
        cli.main(["--synthetic-demo", "--aed", "--nn-ckpt", "x"] + flags
                 + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])
    key = {"--aed-ctc-weight": "ctc_weight", "--aed-chunk": "aed_chunk", "--aed-beam": "beam"}[flags[0]]
    assert str(seen[key]) == flags[1]
    assert seen["n_units"] == synthetic_lexicon().n_phones


@pytest.mark.parametrize("cli", [cli_stream, cli_transcribe])
def test_stream_clis_do_not_fall_back_to_the_cpu(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--synthetic-demo", "--run-dir", str(tmp_path / "run")])

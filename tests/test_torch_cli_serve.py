"""The port's ``serve`` twin (mogasr_torch/cli/serve.py) on the CPU against the
reference's cli/serve.py run in-process, on the reference's own scenarios
(tests/test_serve.py): the demo session, interleaved sessions with protocol
errors and a shutdown, ``--engine`` against the per-session mode,
``--partial-every``, ``--endpoint``, and ``--ctc --bpe`` with and without
``--engine`` from one CTC model saved in both checkpoint formats. Every event
line is equal. One ``--tcp`` server on localhost with two clients checks
per-connection session ownership; ``--rnnt`` and ``--aed`` without a
checkpoint stop as the reference's stop, the AED's companion options reach
its engine, and the twin does not fall back to the CPU."""

import importlib
import io
import json
import os
import socket
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr_torch.cli import serve as cli_serve
from mogasr_torch.data.synthetic import make_corpus

CHUNK = 4000
GMM = ["--num-components", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _events(text):
    """The protocol's JSON lines (the metrics records left out)."""
    lines = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    return [e for e in lines if "stage" not in e]


def _stream(sessions, tail=({"type": "shutdown"},), head=()):
    """Event lines: starts, the sessions' audio interleaved chunk by chunk,
    ends, then ``tail``."""
    lines = list(head) + [{"type": "start", "session": sid} for sid, _w in sessions]
    chunks = {sid: [w[i:i + CHUNK] for i in range(0, len(w), CHUNK)] for sid, w in sessions}
    for i in range(max(len(c) for c in chunks.values())):
        for sid, c in chunks.items():
            if i < len(c):
                lines.append({"type": "audio", "session": sid, "pcm": c[i].tolist()})
    lines += [{"type": "end", "session": sid} for sid, _w in sessions] + list(tail)
    return "\n".join(json.dumps(line) for line in lines) + "\n"


def _run_both(argv, tmp_path, monkeypatch, capsys, stdin=None):
    """(port's events, reference's events) for the same arguments and stdin."""
    got = {}
    for who in ("port", "ref"):
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        run = ["--run-dir", str(tmp_path / who)]
        if who == "port":
            cli_serve.main(argv.get("port", argv["all"]) + run + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["prog"] + argv.get("ref", argv["all"]) + run)
            importlib.import_module("cli.serve").main()
        got[who] = _events(capsys.readouterr().out)
    return got["port"], got["ref"]


ENGINE = ["--engine", "--engine-capacity", "4"]


@pytest.mark.parametrize("flags", [[], ENGINE, ENGINE + ["--partial-every", "4"]],
                         ids=["per-session", "engine", "partial-every"])
def test_demo_session_matches_reference(tmp_path, monkeypatch, capsys, flags):
    got, want = _run_both({"all": ["--synthetic-demo-session"] + GMM + flags}, tmp_path, monkeypatch, capsys)
    assert got == want
    assert got[0] == {"session": "demo", "event": "ready"} and len([e for e in got if "final" in e]) == 1
    assert len([e for e in got if "partial" in e]) >= (1 if "--partial-every" in flags else 3)


def _interleaved():
    utts = make_corpus(2, words_per_utt=(2, 2), seed=9)
    head = [{"type": "start", "session": "a"},                          # a duplicate start: an error
            {"type": "audio", "session": "ghost", "pcm": [0.0] * 10}]   # no such session
    tail = [{"type": "end", "session": "a"},                            # already ended
            {"type": "bogus", "session": "b"}, {"type": "shutdown"},
            {"type": "start", "session": "never"}]                      # after shutdown: unread
    return _stream([("a", utts[0].wave), ("b", utts[1].wave)], tail=tail, head=head)


def test_interleaved_sessions_and_errors_match_reference(tmp_path, monkeypatch, capsys):
    """Per-session and engine mode on the reference's interleaved stream: the
    reference's events line for line; the engine's finals the per-session
    mode's."""
    text = _interleaved()
    finals = {}
    for mode, flags in (("plain", []), ("engine", ENGINE)):
        got, want = _run_both({"all": GMM + flags}, tmp_path / mode, monkeypatch, capsys, stdin=text)
        assert got == want
        errors = [e for e in got if "error" in e]
        assert any(e.get("session") == "a" and "exists" in e["error"] for e in errors)
        assert any(e.get("session") == "ghost" for e in errors)
        assert not any(e.get("session") == "never" for e in got)
        finals[mode] = {e["session"]: e["final"] for e in got if "final" in e}
    assert set(finals["plain"]) == {"a", "b"} and finals["engine"] == finals["plain"]


@pytest.mark.parametrize("flags", [[], ENGINE], ids=["per-session", "engine"])
def test_endpoint_matches_reference(tmp_path, monkeypatch, capsys, flags):
    utt = make_corpus(1, words_per_utt=(2, 3), seed=7)[0]
    wave = np.concatenate([utt.wave, np.zeros(int(1.5 * 16000), np.float32)])
    lines = [{"type": "start", "session": "e"}]
    lines += [{"type": "audio", "session": "e", "pcm": wave[i:i + CHUNK].tolist()} for i in range(0, len(wave), CHUNK)]
    text = "\n".join(json.dumps(line) for line in lines + [{"type": "shutdown"}]) + "\n"
    got, want = _run_both({"all": ["--num-components", "1", "--endpoint"] + flags}, tmp_path, monkeypatch, capsys,
                          stdin=text)
    assert got == want
    finals = [e for e in got if "final" in e]
    assert len(finals) == 1 and finals[0]["endpoint"] == "rule1_trailing_silence"


@pytest.fixture(scope="module")
def ctc_model(tmp_path_factory):
    """A BPE-CTC LstmAm (16 hidden, 1 LSTM layer; flax init, the head scaled
    so that the greedy decode emits units) saved in both checkpoint formats,
    its bpe.json, a unit LM and a phrase file."""
    from mogasr.am import neural as jn
    from mogasr.config import TrainConfig as JaxTrainConfig
    from mogasr.utils import checkpoint as jckpt
    from mogasr_torch.am import neural as tn
    from mogasr_torch.am.params import from_flax
    from mogasr_torch.config import FrontendConfig, TrainConfig
    from mogasr_torch.data.bpe import save_bpe, train_bpe
    from mogasr_torch.lm.unit_ngram import estimate_unit_bigram, save_unit_lm
    from mogasr_torch.utils.checkpoint import save_checkpoint

    root = str(tmp_path_factory.mktemp("serve_ctc"))
    texts = [u.words for u in make_corpus(24, seed=11)]
    bpe = train_bpe(texts, n_merges=12)
    save_bpe(bpe, os.path.join(root, "bpe.json"))
    save_unit_lm(os.path.join(root, "unit_lm.npz"), estimate_unit_bigram([bpe.encode(t) for t in texts], bpe.n_units))
    with open(os.path.join(root, "phrases.txt"), "w") as f:
        f.write(" ".join(texts[0][:2]) + "\n")
    feat_dim = FrontendConfig().feat_dim
    jm = jn.build_model("lstm", bpe.n_units + 1, JaxTrainConfig(nn_hidden=16, nn_layers=2))
    params = {"params": jax.jit(jm.init)(jax.random.key(1), jnp.zeros((2, 8, feat_dim)), jnp.asarray([8, 8]))["params"]}
    params["params"]["Dense_0"]["kernel"] = params["params"]["Dense_0"]["kernel"] * 30.0
    jckpt.save_checkpoint(os.path.join(root, "ref"), {"params": params}, step=1)
    tm = tn.build_model("lstm", bpe.n_units + 1, TrainConfig(nn_hidden=16, nn_layers=2), feat_dim)
    save_checkpoint(os.path.join(root, "port"), {"params": from_flax(tm, params)}, step=1)
    return root


@pytest.mark.parametrize("flags", [[], ENGINE, ["--bias", "{m}/phrases.txt", "--fusion-lm", "{m}/unit_lm.npz",
                                                "--bias-beam", "4"]], ids=["per-session", "engine", "beam"])
def test_ctc_bpe_matches_reference(ctc_model, tmp_path, monkeypatch, capsys, flags):
    utts = make_corpus(2, words_per_utt=(2, 2), seed=3)
    text = _stream([("a", utts[0].wave), ("b", utts[1].wave)])
    common = ["--ctc", "--bpe", os.path.join(ctc_model, "bpe.json"), "--nn-hidden", "16", "--nn-layers", "2"]
    common += [f.format(m=ctc_model) for f in flags]
    got, want = _run_both({"port": common + ["--nn-ckpt", os.path.join(ctc_model, "port")],
                           "ref": common + ["--nn-ckpt", os.path.join(ctc_model, "ref")], "all": None},
                          tmp_path, monkeypatch, capsys, stdin=text)
    assert got == want
    finals = {e["session"]: e["final"] for e in got if "final" in e}
    assert set(finals) == {"a", "b"} and any(finals.values())


def _recv_lines(sock, n, timeout=60.0):
    """n JSON lines from a socket."""
    buf, out, end = b"", [], time.time() + timeout
    while len(out) < n and time.time() < end:
        data = sock.recv(1 << 16)
        if not data:
            break
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            out.append(json.loads(line))
    return out


def test_tcp_two_clients_own_their_sessions(tmp_path):
    """Two connections to one server: each gets the responses to its own
    events; a session started by one cannot be fed or ended by the other."""
    port_file = tmp_path / "port.txt"
    server = threading.Thread(target=cli_serve.main, args=(
        ["--tcp", "0", "--port-file", str(port_file), "--device", "cpu", "--run-dir", str(tmp_path / "run")] + GMM,),
        daemon=True)
    server.start()
    for _ in range(600):
        if port_file.exists() and port_file.read_text():
            break
        time.sleep(0.05)
    port = int(port_file.read_text())
    wave = make_corpus(1, words_per_utt=(2, 2), seed=9)[0].wave
    a, b = (socket.create_connection(("127.0.0.1", port), timeout=60) for _ in range(2))
    try:
        def send(sock, ev):
            sock.sendall((json.dumps(ev) + "\n").encode())

        send(a, {"type": "start", "session": "s1"})
        assert _recv_lines(a, 1) == [{"session": "s1", "event": "ready"}]
        send(b, {"type": "audio", "session": "s1", "pcm": [0.0] * 10})
        send(b, {"type": "end", "session": "s1"})
        owned = {"session": "s1", "error": "session owned by another connection"}
        assert _recv_lines(b, 2) == [owned, owned]
        send(b, {"type": "start", "session": "s2"})
        assert _recv_lines(b, 1) == [{"session": "s2", "event": "ready"}]
        send(a, {"type": "audio", "session": "s1", "pcm": wave[:CHUNK].tolist()})
        part = _recv_lines(a, 1)[0]
        assert part["session"] == "s1" and "partial" in part and part["t_audio_s"] == 0.25
        send(a, {"type": "end", "session": "s1"})
        fin = _recv_lines(a, 1)[0]
        assert fin["session"] == "s1" and "final" in fin
        send(b, {"type": "end", "session": "s2"})
        assert _recv_lines(b, 1) == [{"session": "s2", "final": [], "audio_s": 0.0}]
        send(a, {"type": "shutdown"})
        server.join(timeout=60)
        assert not server.is_alive()
    finally:
        a.close()
        b.close()


# serve --rnnt runs since the RNN-T port (tests/test_torch_cli_rnnt.py), serve
# --aed since the AED port (tests/test_torch_cli_aed.py): without a checkpoint
# each stops as the reference stops
@pytest.mark.parametrize("argv,match", [(["--rnnt"], "--rnnt requires --nn-ckpt"),
                                        (["--aed"], "--aed requires --nn-ckpt")])
def test_unported_families_raise(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_serve.main(argv + ["--synthetic-demo-session", "--device", "cpu", "--run-dir", str(tmp_path / "run")])


# --rnnt-pred and --max-symbols are read by serve --rnnt since the RNN-T port;
# the AED's options by serve --aed --engine since the AED port: the model
# loader and the engine get their values
@pytest.mark.parametrize("argv", [["--aed-chunk", "8"], ["--aed-beam", "2"], ["--aed-ctc-weight", "0.3"],
                                  ["--aed-stream-precision", "bfloat16"]])
def test_unported_companion_options_are_refused(tmp_path, argv, monkeypatch):
    from test_torch_cli_aed import Probed, aed_probe

    seen = aed_probe(monkeypatch)
    with pytest.raises(Probed):
        cli_serve.main(["--aed", "--engine", "--nn-ckpt", "x"] + argv
                       + ["--synthetic-demo-session", "--device", "cpu", "--run-dir", str(tmp_path / "run")])
    key = argv[0][2:].replace("-", "_")
    key = {"aed_beam": "beam", "aed_ctc_weight": "ctc_weight", "aed_stream_precision": "stream_precision"}.get(key, key)
    assert str(seen[key]) == argv[1]
    assert seen["capacity"] == 16 and seen["feature_path"] == "device"


def test_tcp_with_engine_refused(tmp_path):
    with pytest.raises(SystemExit, match="per-session mode only"):
        cli_serve.main(["--tcp", "0", "--engine", "--device", "cpu", "--run-dir", str(tmp_path / "run")])


def test_serve_does_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_serve.main(["--synthetic-demo-session", "--run-dir", str(tmp_path / "run")])

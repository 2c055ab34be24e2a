"""The port's training entry points on the CPU (``--device cpu``): the twin
of cli/train_gmm.py end to end (ML EM, MMI, sMBR, the tied-triphone system
and a bundle that both packages load), its resume from <run-dir>/em_ckpt,
the flags that are not ported yet, and the twin of
benchmarks/train_headline.py at a tiny size."""

import json
import os

import numpy as np
import pytest
import torch

from mogasr.utils.bundle import load_system as jax_load_system
from mogasr_torch.cli import train_gmm as cli_train_gmm
from mogasr_torch.recipes import train_headline
from mogasr_torch.utils import checkpoint as ckpt
from mogasr_torch.utils.bundle import load_system

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# The reference CLI's records for --num-iters 2 --mmi 1 --smbr 1 --triphones N
REFERENCE_STAGES = ["em", "em", "train_gmm_done", "train_mmi", "train_mmi_done", "train_smbr", "train_smbr_done",
                    "em", "em", "train_cd_done"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tests issue many small
    ops, and with the suite's workers sharing the cores torch's thread pool
    spends its time waiting for them (a 100x slower run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_gmm_cli_end_to_end_and_resume(tmp_path):
    run_dir, bundle = str(tmp_path / "run"), str(tmp_path / "bundle")
    common = ["--synthetic", "4", "--device", "cpu", "--run-dir", run_dir, "--num-components", "1"]
    cli_train_gmm.main(common + ["--num-iters", "2", "--triphones", "120", "--mmi", "1", "--smbr", "1",
                                 "--bundle-out", bundle])
    records = _records(run_dir)
    assert [r["stage"] for r in records if r["stage"] != "em_warning"] == REFERENCE_STAGES
    assert ckpt.all_steps(os.path.join(run_dir, "em_ckpt")) == [1, 2]
    for name in ("gmm", "gmm_cd"):
        assert ckpt.latest_step(os.path.join(run_dir, name)) == 2
    cd_done = records[-1]
    gmm, topo, fcfg, tied, meta = load_system(bundle, CPU)
    jgmm, jtopo, jfcfg, jtied, jmeta = jax_load_system(bundle)
    assert tied.n_pdfs == jtied.n_pdfs == cd_done["tied_pdfs"] == gmm.n_states and tied.tying == jtied.tying
    for a, b in zip(gmm, jgmm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert meta == jmeta and meta["final_avg_loglik"] == cd_done["final_avg_loglik"]

    # started again with one more iteration: resumes after the saved step 2
    cli_train_gmm.main(common + ["--num-iters", "3"])
    again = _records(run_dir)[len(records):]
    assert again[0]["stage"] == "em_resume" and again[0]["step"] == 2
    assert [r["stage"] for r in again[1:3]] == ["em", "train_gmm_done"] and again[1]["iter"] == 2
    assert again[2]["iters"] == 3 and ckpt.all_steps(os.path.join(run_dir, "em_ckpt")) == [1, 2, 3]


@pytest.mark.parametrize("flags", [["--lda", "2"], ["--add-pitch"]])
def test_train_gmm_cli_flags_not_ported_raise(tmp_path, flags):
    """(The corpora and augmentation flags that raised here until their data
    modules were ported run in test_torch_cli_gmm.py.)"""
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        cli_train_gmm.main(["--synthetic", "2"] + flags + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])


def test_entry_points_do_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_train_gmm.main(["--synthetic", "2", "--run-dir", str(tmp_path / "run")])
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_headline.main(["--out", str(tmp_path / "b")])


def test_train_headline_twin_at_a_tiny_size(tmp_path):
    out = str(tmp_path / "bundle")
    lines = []
    res = train_headline.main(["--train-utts", "12", "--test-utts", "4", "--mono-iters", "1", "--mono-components",
                               "1", "--cd-iters", "1", "--components", "1", "--target-pdfs", "200", "--min-occ", "5",
                               "--device", "cpu", "--out", out], log=lines.append)
    with open(os.path.join(ROOT, "benchmarks", "headline", "system.json")) as f:
        reference_meta = json.load(f)["meta"]
    meta = res["meta"]
    assert list(meta) == list(reference_meta)
    assert meta["train_utts"] == 12 and len(meta["em_loglik_mono"]) == len(meta["em_loglik_cd"]) == 1
    assert 0.0 <= meta["heldout_wer"] <= 1.0 and meta["tied_pdfs"] == res["tied"].n_pdfs
    _, _, _, jtied, jmeta = jax_load_system(out)
    assert jmeta == meta and jtied.n_pdfs == meta["tied_pdfs"]
    assert set(res["cd"].setup_seconds) == {"cd_stats", "tie", "cd_init"}
    assert any(line.startswith("cd iter 0:") for line in "\n".join(lines).splitlines())


def test_run_logger_timer_and_trace(tmp_path):
    """The reference's metrics.jsonl records, a Timer, and --profile's
    torch.profiler trace (CPU activity here)."""
    from mogasr_torch.utils.metrics import RunLogger, Timer, rtf, trace

    logger = RunLogger(str(tmp_path / "run"), echo=False)
    with trace(str(tmp_path / "run" / "profile")), Timer() as t:
        torch.ones(64, 64) @ torch.ones(64, 64)
    logger.log({"stage": "em", "iter": 0, "avg_loglik": np.float32(-20.5)})
    assert _records(str(tmp_path / "run"))[0]["avg_loglik"] == -20.5 and t.seconds > 0
    with open(tmp_path / "run" / "profile" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert rtf(10.0, 2.5) == 0.25

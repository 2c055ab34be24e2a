"""The neural-AM CLI twins of the port on the CPU: ``train_nn`` (the CE path
with SpecAugment, i-vectors, MMI and sMBR fine-tuning, periodic checkpoints
and their average; the MPC path) and ``decode``/``eval --am ... --nn-ckpt``.

They are held to the port's pipeline functions, which the other
test_torch_nn_* files hold to the reference (a reference CLI's run of these
paths compiles its JAX training steps anew, several times the cost of the
pipeline tests): the CE checkpoint of the CLI's first saved step equals the
pipeline functions' model after as many steps (the same labels, priors,
i-vectors, initial weights and SpecAugment draws), the decode twins write
the hypotheses of ``make_nn_scorer`` + ``decode_batch`` on the same corpus.
The AED objective and its options reach the AED training entry points (a
probe stands in for them; tests/test_torch_cli_aed.py trains); the option
checks the reference makes stop as its CLIs stop."""

import json
import os

import numpy as np
import pytest
import torch

from mogasr_torch import pipeline as pipe
from mogasr_torch.am.ivector import load_extractor
from mogasr_torch.am.neural import build_model, state_priors
from mogasr_torch.am.params import init_
from mogasr_torch.am.train_nn import init_train_state, make_train_step
from mogasr_torch.cli import decode as cli_decode
from mogasr_torch.cli import eval as cli_eval
from mogasr_torch.cli import train_nn as cli_train_nn
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig
from mogasr_torch.data.synthetic import make_corpus
from mogasr_torch.hmm.lexicon import synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.utils.checkpoint import all_steps, restore_checkpoint

CPU = torch.device("cpu")
CORPUS = ["--synthetic", "3", "--synthetic-seed", "2"]
NN = ["--hidden", "8", "--layers", "2"]
TRAIN = CORPUS + NN + ["--arch", "mlp", "--steps", "4", "--bootstrap-iters", "2", "--bootstrap-components", "1",
                       "--ivector-dim", "2", "--ivector-components", "2", "--spec-augment", "--save-every", "2",
                       "--seq-mmi-steps", "2", "--seq-smbr-steps", "1", "--average-last", "2", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (its many small ops contend
    for the cores with the suite's other workers otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    run = str(tmp_path_factory.mktemp("train_nn") / "run")
    cli_train_nn.main(TRAIN + ["--run-dir", run])
    return run


def test_train_nn_cli_matches_the_pipeline_functions(trained):
    """Steps 2 and 4 (--save-every 2), the fine-tuned model as step 5 (the CE
    loop wrote step 4), replaced by the average of steps 4 and 5; step 2 is
    the pipeline functions' model after two steps, bit for bit. (A
    fine-tuning starts a fresh optimizer, whose first step is at learning
    rate 0: two MMI steps move the model.)"""
    run = trained
    ck_dir = os.path.join(run, "nn_mlp")
    assert all_steps(ck_dir) == [2, 4, 5]
    recs = {r["stage"]: r for r in _records(run)}
    assert {"train_nn_done", "nn_mmi_done", "nn_smbr_done", "ivector_extractor", "ckpt_average"} <= set(recs)
    assert recs["ckpt_average"]["saved_step"] == 5 and recs["train_nn_done"]["steps"] == 4
    assert 0.0 <= recs["nn_smbr_done"]["acc_per_frame_last"] <= 1.0
    assert np.isfinite(recs["nn_mmi_done"]["mmi_per_frame_last"])

    utts = make_corpus(3, seed=2)
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    fcfg = FrontendConfig()
    batches = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg, BatchConfig(), CPU)
    gmm = pipe.train_gmm(batches, lex, topo, GmmConfig(n_states=topo.n_pdfs, n_components=1, feat_dim=fcfg.feat_dim),
                         TrainConfig(num_em_iters=2)).gmm
    labels = [pipe.align_batch(fb, gmm, lex, topo)[1] for fb in batches]
    priors = state_priors(np.concatenate([lab.numpy().reshape(-1) for lab in labels]), topo.n_pdfs)
    aug = pipe.append_ivectors(batches, load_extractor(os.path.join(run, "ivector_extractor"), CPU))
    cfg = TrainConfig(nn_arch="mlp", nn_hidden=8, nn_layers=2, lr=1e-3, num_nn_steps=4)
    model = init_(build_model("mlp", topo.n_pdfs, cfg, fcfg.feat_dim + 2), torch.Generator().manual_seed(0))
    state, step = init_train_state(model, cfg), make_train_step(cfg, spec_aug=True)
    for k in range(2):
        fb, lab = aug[k % len(aug)], labels[k % len(aug)]
        state, _m = step(state, fb.feats, fb.n_frames, lab)
    ck = restore_checkpoint(ck_dir, step=2)
    np.testing.assert_array_equal(ck["log_priors"], priors)
    assert set(ck["params"]) == set(model.state_dict())
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(ck["params"][name], value.numpy(), err_msg=name)
    c4, avg = restore_checkpoint(ck_dir, step=4), restore_checkpoint(ck_dir, step=5)
    assert any(not np.array_equal(avg["params"][k], c4["params"][k]) for k in c4["params"])


def test_decode_and_eval_with_the_nn_checkpoint(trained, tmp_path):
    """``decode --am mlp --nn-ckpt --ivector-ckpt`` writes the hypotheses of
    the scorer of the checkpoint's latest step over the i-vector features,
    decoded on the corpus's word loop; ``eval --am mlp --nn-ckpt`` (of an
    MLP without i-vectors) sweeps as the pipeline does."""
    run = trained
    utts = make_corpus(3, seed=2)
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    fcfg = FrontendConfig()
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    graph = pipe.word_decode_graph(lex, topo, dcfg)
    ck = restore_checkpoint(os.path.join(run, "nn_mlp"))
    model = build_model("mlp", topo.n_pdfs, TrainConfig(nn_hidden=8, nn_layers=2), fcfg.feat_dim + 2)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in ck["params"].items()})
    batches = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg, BatchConfig(), CPU)
    aug = pipe.append_ivectors(batches, load_extractor(os.path.join(run, "ivector_extractor"), CPU))
    scorer = pipe.make_nn_scorer(model.eval(), ck["log_priors"])
    want = [h for fb in aug for h in pipe.decode_batch(fb, scorer(fb), graph, dcfg)[: fb.size]]
    out = str(tmp_path / "hyps.jsonl")
    cli_decode.main(CORPUS + ["--am", "mlp", "--nn-ckpt", os.path.join(run, "nn_mlp"), "--nn-hidden", "8",
                              "--nn-layers", "2", "--ivector-ckpt", os.path.join(run, "ivector_extractor"),
                              "--ivector-dim", "2", "--ivector-components", "2", "--out", out, "--device", "cpu",
                              "--run-dir", str(tmp_path / "d")])
    with open(out) as f:
        assert [json.loads(line)["hyp"] for line in f] == [[w.lower() for w in h] for h in want]

    plain = str(tmp_path / "plain")
    cli_train_nn.main(CORPUS + NN + ["--arch", "mlp", "--steps", "2", "--bootstrap-iters", "1",
                                     "--bootstrap-components", "1", "--device", "cpu", "--run-dir", plain])
    ck = restore_checkpoint(os.path.join(plain, "nn_mlp"))
    model = build_model("mlp", topo.n_pdfs, TrainConfig(nn_hidden=8, nn_layers=2), fcfg.feat_dim)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in ck["params"].items()})
    for precision in ("float32", "int8"):
        scorer = pipe.make_nn_scorer(model.eval(), ck["log_priors"], precision=precision)
        ebatches = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg, BatchConfig(batch_size=16), CPU)
        want = {fb.utt_ids[b]: h for fb in ebatches for b, h in enumerate(pipe.decode_batch(fb, scorer(fb), graph,
                                                                                               dcfg))}
        ev = str(tmp_path / f"e_{precision}")
        cli_eval.main(CORPUS + ["--am", "mlp", "--nn-ckpt", os.path.join(plain, "nn_mlp"), "--nn-hidden", "8",
                                "--nn-layers", "2", "--nn-precision", precision, "--device", "cpu", "--run-dir", ev])
        with open(os.path.join(ev, "eval_hyps.jsonl")) as f:
            got = {r["utt_id"]: r["hyp"] for r in map(json.loads, f)}
        assert got == want
        assert _records(ev)[-1]["utts"] == 3


def test_train_nn_mpc_cli(tmp_path):
    run = str(tmp_path / "mpc")
    cli_train_nn.main(CORPUS + NN + ["--arch", "mlp", "--objective", "mpc", "--steps", "2", "--device", "cpu",
                                     "--run-dir", run])
    ck = restore_checkpoint(os.path.join(run, "nn_mpc_mlp"))
    assert all_steps(os.path.join(run, "nn_mpc_mlp")) == [2] and set(ck) == {"params"}
    d = FrontendConfig().feat_dim
    assert ck["params"]["head.weight"].shape == (d, 8) and np.isfinite(ck["params"]["head.weight"]).all()
    assert _records(run)[-1]["stage"] == "train_mpc_done"


# --objective ctc, --init-from, --distill-from and --bpe-merges run since the
# CTC port (tests/test_torch_cli_ctc.py; their option checks in STOPS);
# --objective rnnt, --rnnt-pruned-band and --mwer-steps since the RNN-T port
# (tests/test_torch_cli_rnnt.py), --init-from stopping there as the
# reference stops; --objective aed, --aed-chunk and --aed-left-chunks since
# the AED port (tests/test_torch_cli_aed.py): the probe's "seen" are what
# the AED training entry point got (--aed-chunk/--aed-left-chunks alone are
# given with --objective aed, which reads them), --distill-from stops there
PROBED = None  # the exception class of tests/test_torch_cli_aed.py's probe
REFUSED = [(["--objective", "aed"], PROBED, dict(entry="train_aed", chunk_frames=0, left_chunks=1)),
           (["--objective", "aed", "--bpe-merges", "20"], PROBED, dict(entry="train_aed_bpe", chunk_frames=0)),
           (["--objective", "rnnt", "--init-from", "ck"], SystemExit, "--init-from .MPC warm start. supports --objective ctc"),
           (["--objective", "aed", "--distill-from", "ck"], SystemExit, "--distill-from supports --objective ctc"),
           (["--aed-chunk", "4"], PROBED, dict(entry="train_aed", chunk_frames=4, left_chunks=1)),
           (["--aed-left-chunks", "2"], PROBED, dict(entry="train_aed", chunk_frames=0, left_chunks=2))]


@pytest.mark.parametrize("flags,exc,match", REFUSED, ids=["".join(f) for f, _e, _m in REFUSED])
def test_train_nn_unported_flags_raise(tmp_path, flags, exc, match, monkeypatch):
    if exc is PROBED:
        from test_torch_cli_aed import Probed, aed_probe

        seen = aed_probe(monkeypatch)
        argv = flags if "--objective" in flags else ["--objective", "aed"] + flags
        with pytest.raises(Probed):
            cli_train_nn.main(CORPUS + argv + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])
        assert {k: seen[k] for k in match} == match
        return
    with pytest.raises(exc, match=match):
        cli_train_nn.main(CORPUS + flags + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])


STOPS = [
    (cli_train_nn, ["--steps", "0"], "--steps must be >= 1"),
    (cli_train_nn, ["--arch", "moe", "--objective", "mpc"], "--arch moe supports --objective ce"),
    (cli_train_nn, ["--init-from", "ck"], "--init-from \\(MPC warm start\\) supports --objective ctc"),
    (cli_train_nn, ["--distill-from", "ck"], "--distill-from supports --objective ctc"),
    (cli_train_nn, ["--objective", "ctc", "--distill-from", "ck", "--bpe-merges", "4"], "drop --bpe-merges"),
    (cli_decode, ["--am", "lstm"], "--nn-ckpt is required"),
    (cli_decode, ["--am", "lstm", "--nn-ckpt", "nn", "--bundle", "b"], "--bundle carries a GMM system"),
    (cli_decode, ["--ivector-ckpt", "iv"], "--ivector-ckpt augments hybrid/CTC neural features"),
    (cli_eval, ["--am", "lstm"], "requires --nn-ckpt"),
    (cli_eval, ["--am", "lstm", "--nn-ckpt", "nn", "--bundle", "b"], "--bundle carries a GMM system"),
]


@pytest.mark.parametrize("cli,flags,msg", STOPS, ids=[f"{c.__name__.split('.')[-1]}{''.join(f)}"
                                                      for c, f, _m in STOPS])
def test_option_checks_stop_as_the_reference(tmp_path, cli, flags, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(CORPUS + flags + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])

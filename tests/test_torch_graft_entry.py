"""The twin of the reference's driver entry points (mogasr_torch.graft_entry)
and the rank launcher's failure paths, on the CPU.

- ``entry()``'s setup and forward step against the reference's: the same
  batch, the front end (mogasr.frontend.jax_frontend) within 3e-4, the GMM
  scorer at 1000 x 256 x 39 against ``gmm_loglik`` on the same features
  within rtol 1e-5 (atol 1e-2 at logliks of magnitude ~1e3), Viterbi over the
  word loop against the reference's on the same emissions (paths
  identical, scores rtol 1e-5), and the fused step's paths equal the
  reference's chain;
- ``dryrun_multichip(4)`` runs every section over four gloo ranks and
  prints the reference's summary line;
- ``run_ranks``: a rank that raises fails the launch at once with its
  traceback, ranks that hang fail it at the deadline, and the card is never
  replaced by the CPU.
"""

from __future__ import annotations

import importlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am.gmm import GmmSet as JGmm
from mogasr.am.gmm import gmm_loglik as jgmm_loglik
from mogasr.config import DecodeConfig as JDecodeConfig
from mogasr.decoder import viterbi as jvit
from mogasr.frontend.jax_frontend import make_frontend as jmake_frontend
from mogasr.hmm import graph as jgr
from mogasr_torch import graft_entry
from mogasr_torch.am.gmm import gmm_from_numpy, gmm_loglik
from mogasr_torch.decoder import viterbi as tvit
from mogasr_torch.dist import cases, launch

ref_entry = importlib.import_module("__graft_entry__")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_chain():
    """The reference's setup and its front end, scorer and Viterbi, each
    run on its own."""
    from mogasr import pipeline as jpipe

    fcfg, lex, topo, batch = ref_entry._build_setup()
    gmm = graft_entry.headline_gmm(D=fcfg.feat_dim)
    feats, nf = jmake_frontend(fcfg, batch.waves.shape[1])(jnp.asarray(batch.waves), jnp.asarray(batch.num_samples))
    B, T, D = feats.shape
    ll = jgmm_loglik(feats.reshape(B * T, D), JGmm(*map(jnp.asarray, gmm))).reshape(B, T, -1)
    graphs = jgr.batch_graphs([jpipe.word_decode_graph(lex, topo, JDecodeConfig())] * B)
    res = jvit.viterbi(ll, {k: jnp.asarray(v) for k, v in graphs.items()}, nf,
                       acoustic_scale=JDecodeConfig().acoustic_scale)
    return dict(batch=batch, gmm=gmm, feats=np.array(feats), nf=np.array(nf), ll=np.array(ll),
                graphs=graphs, path=np.asarray(res.path), score=np.asarray(res.score))


def test_entry_setup_is_the_reference_batch(ref_chain):
    _fcfg, _lex, _topo, batch = graft_entry._build_setup()
    np.testing.assert_array_equal(batch.waves, ref_chain["batch"].waves)
    np.testing.assert_array_equal(batch.num_samples, ref_chain["batch"].num_samples)
    assert batch.utt_ids == ref_chain["batch"].utt_ids and batch.waves.shape[1] // 160 <= 151


def test_entry_pieces_match_the_reference(ref_chain):
    fn, (waves, num_samples) = graft_entry.entry("cpu")
    assert waves.device.type == "cpu"
    from mogasr_torch.frontend.torch_frontend import make_frontend
    from mogasr_torch.config import FrontendConfig

    feats, nf = make_frontend(FrontendConfig(), waves.shape[1], torch.device("cpu"))(waves, num_samples)
    np.testing.assert_allclose(feats.numpy(), ref_chain["feats"], atol=3e-4)
    np.testing.assert_array_equal(nf.numpy(), ref_chain["nf"])
    B, T, D = ref_chain["feats"].shape
    ll = gmm_loglik(torch.as_tensor(ref_chain["feats"]).reshape(B * T, D),
                    gmm_from_numpy(*ref_chain["gmm"], device=torch.device("cpu"))).reshape(B, T, -1)
    np.testing.assert_allclose(ll.numpy(), ref_chain["ll"], rtol=1e-5, atol=1e-2)
    res = tvit.viterbi(torch.as_tensor(ref_chain["ll"]), tvit.graphs_to_torch(ref_chain["graphs"], torch.device("cpu")),
                       torch.as_tensor(ref_chain["nf"]), acoustic_scale=JDecodeConfig().acoustic_scale)
    np.testing.assert_array_equal(res.path.numpy(), ref_chain["path"])
    np.testing.assert_allclose(res.score.numpy(), ref_chain["score"], rtol=1e-5)
    path, score = fn(waves, num_samples)
    np.testing.assert_array_equal(path.numpy(), ref_chain["path"])
    np.testing.assert_allclose(score.numpy(), ref_chain["score"], rtol=1e-5)


def test_entry_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_ranks(cases.hung_rank, 2, args=(0.0,))


def test_dryrun_multichip_prints_its_line(capsys):
    results = graft_entry.dryrun_multichip(4, device="cpu", timeout_s=240)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4) ok: em loglik=")
    for part in ("nn loss=", "seq-mmi per-frame=", "ctc loss=", "mpc loss=", "distill loss=", "rnnt loss=",
                 "rnnt-pruned ok", "aed loss=", "mwer risk=", "soft-em loglik=", "decode frames=48",
                 "tp score ok ({'data': 2, 'model': 2})", "tp mlp loss=", "pp loss=", "ep loss=",
                 "sp logits ok (2, 32, 8)", "dp lstm plain recurrence ok", "(gloo)"):
        assert part in line, part
    keys = [k for k in results[0] if k not in ("launches", "backend")]
    assert all(results[r][k] == results[0][k] for r in range(4) for k in keys)  # replicated values


def test_a_failing_rank_fails_the_launch_at_once():
    """Rank 1 raises while rank 0 waits for it in a barrier: the launch
    raises with rank 1's traceback well before the deadline."""
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="fails on purpose"):
        launch.run_ranks(cases.failing_rank, 2, device="cpu", timeout_s=120, args=(1,))
    assert time.monotonic() - t0 < 60


def test_hung_ranks_fail_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="deadline"):
        launch.run_ranks(cases.hung_rank, 1, device="cpu", timeout_s=2, args=(600.0,))
    assert time.monotonic() - t0 < 30


def test_backend_choice():
    assert launch.default_backend("cpu", 2) == "gloo"
    assert launch.default_backend("cpu", 1) == "gloo"

"""The port's tied-triphone recipe against the JAX pipeline on the CPU: the
per-triphone-state statistics of a monophone alignment (keys in the same
order, sums bit for bit), the state tying, CD EM in both modes, and a
trained system's bundle written by either package and read by both.

The fixture ``small`` (6 utterances, two length buckets, the same features
in both packages) and the EM tolerances come from test_torch_train."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.am.gmm import GmmSet as JaxGmm
from mogasr.config import FrontendConfig as JaxFrontendConfig
from mogasr.config import GmmConfig as JaxGmmConfig
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr.hmm import triphone as jax_tri
from mogasr.utils.bundle import load_system as jax_load_system
from mogasr.utils.bundle import save_system as jax_save_system
from mogasr_torch import pipeline as pipe
from mogasr_torch.config import FrontendConfig, GmmConfig, TrainConfig
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.utils.bundle import load_system, save_system
from test_torch_train import HISTORY_RTOL, PARAM_ATOL, small  # noqa: F401 (fixture)

CPU = torch.device("cpu")
TARGET_PDFS, MIN_OCC = 120, 3.0
# CD Baum-Welch EM amplifies float32 rounding past HISTORY_RTOL["baum-welch"]:
# JAX against itself, with every feature moved by one ulp, reads 1.4e-4,
# 3.7e-4, 6.8e-4 and 3.7e-4 (relative) over these 4 iterations; the port
# against JAX reads 9.5e-5, 3.6e-4, 5.7e-4 and 3.2e-4. Viterbi EM and the
# parameters keep the test_torch_train constants (port vs JAX: 1.6e-7 and
# 8.2e-5 Viterbi, 4.7e-3 Baum-Welch).
CD_HISTORY_RTOL = {**HISTORY_RTOL, "baum-welch": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tests issue many small
    ops, and with the suite's workers sharing the cores torch's thread pool
    spends its time waiting for them (a 100x slower run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mono(small):
    """A 2-component monophone GMM trained by the port with re-estimated
    transitions, and the same model and topology on the JAX side."""
    lex, topo, batches, jlex, jtopo, jbatches = small
    res = pipe.train_gmm(batches, lex, topo, GmmConfig(n_states=topo.n_pdfs, n_components=2),
                         TrainConfig(num_em_iters=3), reestimate_transitions=True)
    jgmm = JaxGmm(*(jnp.asarray(a.numpy()) for a in res.gmm))
    return res.gmm, res.topo, jgmm, jtopo.with_transitions(np.asarray(res.topo.per_phone_self_prob))


@pytest.fixture(scope="module")
def cd_stats(small, mono):
    lex, _, batches, jlex, _, jbatches = small
    gmm, topo, jgmm, jtopo = mono
    return pipe.collect_cd_stats(batches, gmm, lex, topo), jax_pipe.collect_cd_stats(jbatches, jgmm, jlex, jtopo)


def _mean_stats(raw):
    return {k: (occ, (sx / max(occ, 1e-8)).astype(np.float64)) for k, (occ, sx, _sxx) in raw.items()}


def test_collect_cd_stats_matches_jax(cd_stats):
    ours, theirs = cd_stats
    assert list(ours) == list(theirs)  # first-seen order: tie_states groups in it
    for key, (occ, sx, sxx) in ours.items():
        jocc, jsx, jsxx = theirs[key]
        assert occ == jocc
        np.testing.assert_array_equal(sx, jsx)
        np.testing.assert_array_equal(sxx, jsxx)
        assert sx.dtype == sxx.dtype == np.float64


def test_tie_states_matches_jax(mono, cd_stats):
    _, topo, _, jtopo = mono
    ours, theirs = cd_stats
    tied = tri.tie_states(topo, _mean_stats(ours), TARGET_PDFS, min_occ=MIN_OCC)
    jtied = jax_tri.tie_states(jtopo, _mean_stats(theirs), TARGET_PDFS, min_occ=MIN_OCC)
    assert tied.n_pdfs == jtied.n_pdfs and tied.n_pdfs > len(tied.backoff) + topo.sil_states
    assert list(tied.tying.items()) == list(jtied.tying.items())
    assert list(tied.backoff.items()) == list(jtied.backoff.items())


@pytest.mark.parametrize("mode", ["viterbi", "baum-welch"])
def test_train_triphone_matches_jax(small, mono, mode):
    lex, _, batches, jlex, _, jbatches = small
    gmm, topo, jgmm, jtopo = mono
    iters = 4  # one split, at iteration 2: K = 1 -> 2
    tied, ours = pipe.train_triphone(batches, lex, topo, GmmConfig(n_components=2), TrainConfig(num_em_iters=iters),
                                     gmm, target_pdfs=TARGET_PDFS, min_occ=MIN_OCC, mode=mode)
    jtied, theirs = jax_pipe.train_triphone(jbatches, jlex, jtopo, JaxGmmConfig(n_components=2),
                                            JaxTrainConfig(num_em_iters=iters), jgmm, target_pdfs=TARGET_PDFS,
                                            min_occ=MIN_OCC, mode=mode)
    assert list(tied.tying.items()) == list(jtied.tying.items()) and tied.n_pdfs == jtied.n_pdfs
    assert ours.gmm.means.shape == (tied.n_pdfs, 2, 39) and len(ours.history) == iters
    np.testing.assert_allclose(ours.history, theirs.history, rtol=CD_HISTORY_RTOL[mode])
    for a, b in zip(ours.gmm, theirs.gmm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=PARAM_ATOL[mode])
    assert set(ours.setup_seconds) == {"cd_stats", "tie", "cd_init"}


def test_save_system_round_trips_through_both_packages(mono, cd_stats, tmp_path):
    """The same trained system written by each package: the same system.json
    document and gmm.npz arrays; each bundle read by both load_systems gives
    back the saved arrays, tying and transitions bit for bit."""
    gmm, topo, jgmm, jtopo = mono
    ours, theirs = cd_stats
    tied = tri.tie_states(topo, _mean_stats(ours), TARGET_PDFS, min_occ=MIN_OCC)
    jtied = jax_tri.tie_states(jtopo, _mean_stats(theirs), TARGET_PDFS, min_occ=MIN_OCC)
    meta = {"source": "test", "final_avg_loglik": -20.5}
    save_system(str(tmp_path / "pt"), gmm, topo, FrontendConfig(), tied=tied, meta=meta)
    jax_save_system(str(tmp_path / "jax"), jgmm, jtopo, JaxFrontendConfig(), tied=jtied, meta=meta)
    docs = [json.load(open(tmp_path / d / "system.json")) for d in ("pt", "jax")]
    assert docs[0] == docs[1]
    for d in ("pt", "jax"):
        with np.load(tmp_path / d / "gmm.npz") as z:
            for name, a in zip(("weights", "means", "vars"), gmm):
                np.testing.assert_array_equal(z[name], a.numpy())
        pg, ptopo, pfcfg, ptied, pmeta = load_system(str(tmp_path / d), CPU)
        jg, jt, jfcfg, jtd, jmeta = jax_load_system(str(tmp_path / d))
        for a, b, c in zip(gmm, pg, jg):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        assert ptopo.per_phone_self_prob == jt.per_phone_self_prob == topo.per_phone_self_prob
        assert ptied.tying == jtd.tying == tied.tying and ptied.backoff == jtd.backoff == tied.backoff
        assert pfcfg == FrontendConfig() and pmeta == jmeta == meta

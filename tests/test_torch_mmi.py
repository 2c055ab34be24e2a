"""The port's discriminative training against the JAX package on the CPU: the
extended Baum-Welch update on the same statistics, MMI and sMBR training on
noisy features (clean synthetic phones give one-hot posteriors, where the
numerator and denominator coincide and EBW does nothing), and the sMBR
quantities of a word loop with random emissions.

The fixture ``small`` (6 utterances, the same features in both packages)
comes from test_torch_train."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.am import em as jem
from mogasr.am import mmi as jax_mmi
from mogasr.am import smbr as jax_smbr
from mogasr.am.gmm import GmmSet as JaxGmm
from mogasr.config import DecodeConfig as JaxDecodeConfig
from mogasr.hmm import graph as jax_gr
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import em, mmi, smbr
from mogasr_torch.am.gmm import gmm_from_numpy
from mogasr_torch.config import DecodeConfig, GmmConfig, TrainConfig
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.hmm import graph as gr
from test_torch_train import small  # noqa: F401 (fixture)

CPU = torch.device("cpu")
# Port against JAX, two iterations on the noisy features. The statistics come
# from float32 passes that sum in another order, and the EBW update amplifies
# that: JAX against itself, with every feature moved by one ulp, reads (MMI)
# criterion 1.4e-6 relative, parameters 7.9e-4, and (sMBR) expected accuracy
# 5.9e-5 relative, parameters 0.060 (a variance near 13 whose smoothing
# constant is small; 0.014 after one iteration). The port reads 2.8e-6 and
# 1.4e-3 (MMI), 4.8e-5 and 0.10 (sMBR; 0.012 after one iteration).
HISTORY_RTOL = {"mmi": 1e-5, "smbr": 2e-4}
PARAM_ATOL = {"mmi": 5e-3, "smbr": 0.2}
SMBR_ONE_ITER_PARAM_ATOL = 3e-2
# smbr_quantities on random emissions (measured: weights 1.5e-7, expected
# accuracy 5.5e-7 relative, loglik equal)
SMBR_WEIGHT_ATOL, SMBR_RTOL = 1e-4, 1e-5


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
def noisy(small):
    """The fixture's features plus seeded Gaussian noise (std 2), in both
    packages, and a 1-component monophone GMM trained on them by the port."""
    lex, topo, batches, jlex, jtopo, _ = small
    rng = np.random.default_rng(5)
    fbs, jfbs = [], []
    for fb in batches:
        x = fb.feats.numpy() + 2.0 * rng.standard_normal(fb.feats.shape).astype(np.float32)
        fbs.append(pipe.FeatBatch(fb.utt_ids, torch.as_tensor(x), fb.n_frames, fb.words))
        jfbs.append(jax_pipe.FeatBatch(fb.utt_ids, jnp.asarray(x), jnp.asarray(fb.n_frames.numpy()), fb.words))
    gmm = pipe.train_gmm(fbs, lex, topo, GmmConfig(n_states=topo.n_pdfs, n_components=1),
                         TrainConfig(num_em_iters=2)).gmm
    return lex, topo, fbs, jlex, jtopo, jfbs, gmm, JaxGmm(*(jnp.asarray(a.numpy()) for a in gmm))


def _random_stats(rng, S, K, D, scale):
    occ = (scale * rng.random((S, K))).astype(np.float32)
    sx = (rng.standard_normal((S, K, D)) * occ[:, :, None]).astype(np.float32)
    sxx = ((1.0 + rng.random((S, K, D))) * occ[:, :, None]).astype(np.float32)
    return occ, sx, sxx


def test_ebw_update_matches_jax():
    rng = np.random.default_rng(0)
    S, K, D = 7, 3, 5
    w = rng.dirichlet(np.ones(K), size=S).astype(np.float32)
    mu = rng.standard_normal((S, K, D)).astype(np.float32)
    var = (0.5 + rng.random((S, K, D))).astype(np.float32)
    num, den = _random_stats(rng, S, K, D, 10.0), _random_stats(rng, S, K, D, 12.0)
    num[0][0] = 0.0  # a Gaussian without numerator occupancy keeps its parameters
    g = gmm_from_numpy(w, mu, var, CPU)
    ours = mmi.ebw_update(g, *(em.GmmStats(*map(torch.as_tensor, s), torch.zeros(()), torch.zeros(()))
                                for s in (num, den)))
    theirs = jax_mmi.ebw_update(JaxGmm(*map(jnp.asarray, (w, mu, var))),
                                *(jem.GmmStats(*map(jnp.asarray, s), jnp.zeros(()), jnp.zeros(())) for s in (num, den)))
    assert torch.equal(ours.weights, g.weights)
    np.testing.assert_array_equal(ours.means[0, 0].numpy(), mu[0, 0])
    for a, b in ((ours.means, theirs.means), (ours.vars, theirs.vars)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert bool((ours.vars > 0).all())


def _assert_params_close(ours, theirs, atol):
    for a, b in zip(ours.gmm, theirs.gmm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def _assert_disc_close(ours, theirs, kind):
    assert len(ours.history) == len(theirs.history) == 2
    np.testing.assert_allclose(ours.history, theirs.history, rtol=HISTORY_RTOL[kind])
    _assert_params_close(ours, theirs, PARAM_ATOL[kind])
    assert len(ours.seconds) == len(ours.stage_seconds) == 2


def test_train_mmi_matches_jax(noisy):
    lex, topo, fbs, jlex, jtopo, jfbs, gmm, jgmm = noisy
    ours = mmi.train_mmi(fbs, lex, topo, gmm, n_iters=2, acoustic_scale=0.1)
    theirs = jax_mmi.train_mmi(jfbs, jlex, jtopo, jgmm, n_iters=2, acoustic_scale=0.1)
    _assert_disc_close(ours, theirs, "mmi")
    assert ours.history[1] > ours.history[0]
    assert float((ours.gmm.means - gmm.means).abs().max()) > 1e-3  # EBW moved the model
    assert set(ours.stage_seconds[0]) == set(pipe.TRAIN_STAGES)


def test_train_smbr_matches_jax(noisy):
    lex, topo, fbs, jlex, jtopo, jfbs, gmm, jgmm = noisy
    ours = smbr.train_smbr(fbs, lex, topo, gmm, n_iters=2, acoustic_scale=0.1)
    theirs = jax_smbr.train_smbr(jfbs, jlex, jtopo, jgmm, n_iters=2, acoustic_scale=0.1)
    _assert_disc_close(ours, theirs, "smbr")
    _assert_params_close(smbr.train_smbr(fbs, lex, topo, gmm, n_iters=1, acoustic_scale=0.1),
                         jax_smbr.train_smbr(jfbs, jlex, jtopo, jgmm, n_iters=1, acoustic_scale=0.1),
                         SMBR_ONE_ITER_PARAM_ATOL)
    assert 0.0 < ours.history[0] < 1.0
    assert float((ours.gmm.means - gmm.means).abs().max()) > 1e-3
    assert set(ours.stage_seconds[0]) == set(smbr.SMBR_STAGES)


def test_smbr_quantities_match_jax(small):
    """A ragged batch (rows of T, 1 and 0 frames among them) over the
    synthetic lexicon's word loop, random emissions and reference pdfs."""
    lex, topo, _, jlex, jtopo, _ = small
    graph = pipe.word_decode_graph(lex, topo, DecodeConfig())
    rng = np.random.default_rng(2)
    B, T, P = 5, 37, topo.n_pdfs
    ll = (rng.standard_normal((B, T, P)) * 4 - 20).astype(np.float32)
    nf = np.asarray([T, 1, 0, 20, 29], np.int32)
    ref = rng.integers(0, P, (B, T)).astype(np.int32)
    ref[np.arange(T)[None, :] >= nf[:, None]] = -1
    graphs_np = gr.batch_graphs([graph] * B)
    ours = smbr.smbr_quantities(torch.as_tensor(ll), vit.graphs_to_torch(graphs_np, CPU), torch.as_tensor(ref),
                                torch.as_tensor(nf), acoustic_scale=0.3, n_pdfs=P)
    jgraph = jax_pipe.word_decode_graph(jlex, jtopo, JaxDecodeConfig())
    jgraphs = {k: jnp.asarray(v) for k, v in jax_gr.batch_graphs([jgraph] * B).items()}
    theirs = jax_smbr.smbr_quantities(jnp.asarray(ll), jgraphs, jnp.asarray(ref), jnp.asarray(nf),
                                      acoustic_scale=0.3, n_pdfs=P)
    assert ours.weights_pdf.shape == (B, T, P)
    np.testing.assert_allclose(ours.weights_pdf.numpy(), np.asarray(theirs.weights_pdf), rtol=0,
                               atol=SMBR_WEIGHT_ATOL)
    live = nf > 0
    for a, b in ((ours.expected_acc, theirs.expected_acc), (ours.loglik, theirs.loglik)):
        np.testing.assert_allclose(a.numpy()[live], np.asarray(b)[live], rtol=SMBR_RTOL)
    assert float(ours.weights_pdf[2].abs().max()) == 0.0  # no frames, no weight
    assert 0.0 < float(ours.expected_acc[0]) < T

"""mogasr_torch.am.em against mogasr.am.em on the same numpy inputs: hard and
soft E-steps, the M-step (flooring, the low-occupancy guard, inert
zero-weight slots), splitting with and without occupancy gating, flat-start
init, transition re-estimation and MAP adaptation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import em as jem
from mogasr.am.gmm import GmmSet as JaxGmm
from mogasr_torch.am import em
from mogasr_torch.am.gmm import gmm_from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
S, K, D, N = 7, 4, 5, 300


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _gmm_np(seed=0, zero_slots=False):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(K), size=S).astype(np.float32)
    if zero_slots:  # inert slots of a gated split
        w[:3, K // 2:] = 0.0
        w /= w.sum(-1, keepdims=True)
    mu = rng.standard_normal((S, K, D)).astype(np.float32)
    var = (0.3 + rng.random((S, K, D))).astype(np.float32)
    return w, mu, var


def _both(w, mu, var):
    return gmm_from_numpy(w, mu, var, CPU), JaxGmm(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))


def _close(ours, theirs, rtol=1e-5, atol=1e-5):
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _stats(seed=1):
    rng = np.random.default_rng(seed)
    occ = (rng.random((S, K)) * 20).astype(np.float32)
    occ[0, 0] = 1e-3   # below min_occ: keeps the old parameters
    occ[1] = 0.0       # a state without frames
    sx = (rng.standard_normal((S, K, D)) * occ[:, :, None]).astype(np.float32)
    sxx = ((rng.random((S, K, D)) + 0.5) * occ[:, :, None] + sx ** 2 / np.maximum(occ, 1e-3)[:, :, None]
           ).astype(np.float32)
    return occ, sx, sxx


def test_accumulate_stats_matches_jax():
    rng = np.random.default_rng(2)
    g, jg = _both(*_gmm_np(zero_slots=True))
    x = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(-1, S, N)
    ours = em.accumulate_stats(g, torch.as_tensor(x), torch.as_tensor(labels))
    theirs = jem.accumulate_stats(jg, jnp.asarray(x), jnp.asarray(labels))
    _close(ours, theirs, rtol=1e-5, atol=1e-4)
    assert float(ours.n_frames) == float((labels >= 0).sum())


@pytest.mark.parametrize("state_chunk", [3, 8, 128])
def test_accumulate_stats_soft_matches_jax(state_chunk):
    rng = np.random.default_rng(3)
    g, jg = _both(*_gmm_np(seed=4, zero_slots=True))
    x = rng.standard_normal((N, D)).astype(np.float32)
    post = rng.dirichlet(np.ones(S), size=N).astype(np.float32)
    post[-20:] = 0.0  # padding rows
    ours = em.accumulate_stats_soft(g, torch.as_tensor(x), torch.as_tensor(post), state_chunk=state_chunk)
    theirs = jem.accumulate_stats_soft(jg, jnp.asarray(x), jnp.asarray(post))
    _close(ours, theirs, rtol=1e-4, atol=1e-4)


def test_zero_and_add_stats():
    z = em.zero_stats(S, K, D, device=torch.device("cpu"))
    assert z.occ.shape == (S, K) and z.sx.shape == (S, K, D) and float(z.loglik) == 0.0
    occ, sx, sxx = (torch.as_tensor(a) for a in _stats())
    s = em.GmmStats(occ, sx, sxx, torch.tensor(-5.0), torch.tensor(10.0))
    total = em.add_stats(em.add_stats(z, s), s)
    torch.testing.assert_close(total.sx, 2 * sx)
    assert float(total.n_frames) == 20.0 and float(total.loglik) == -10.0


def test_em_entry_points_take_their_device_from_the_caller():
    """zero_stats and init_from_labels have no default device: the caller
    names it (the port runs on the card unless asked for the CPU)."""
    meta = torch.device("meta")
    z = em.zero_stats(S, K, D, device=meta)
    assert all(t.device == meta for t in z)
    x = np.random.default_rng(8).standard_normal((N, D)).astype(np.float32)
    g = em.init_from_labels(x, np.arange(N) % S, S, device=meta)
    assert all(t.device == meta for t in g)
    with pytest.raises(TypeError):
        em.zero_stats(S, K, D)
    with pytest.raises(TypeError):
        em.init_from_labels(x, np.arange(N) % S, S)


@pytest.mark.parametrize("zero_slots", [False, True])
def test_m_step_matches_jax(zero_slots):
    g, jg = _both(*_gmm_np(seed=5, zero_slots=zero_slots))
    occ, sx, sxx = _stats()
    z = np.zeros((), np.float32)
    ours = em.m_step(g, em.GmmStats(*(torch.as_tensor(a) for a in (occ, sx, sxx, z, z))),
                     var_floor=0.01, weight_floor=1e-4)
    theirs = jem.m_step(jg, jem.GmmStats(*(jnp.asarray(a) for a in (occ, sx, sxx, z, z))),
                        var_floor=0.01, weight_floor=1e-4)
    _close(ours, theirs, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ours.means[0, 0].numpy(), g.means[0, 0].numpy())  # guarded
    assert float(ours.vars.min()) >= 0.01


@pytest.mark.parametrize("gated", [False, True])
def test_split_components_matches_jax(gated):
    g, jg = _both(*_gmm_np(seed=6))
    occ = np.asarray([10.0, 500.0, 0.0, 80.0, 79.0, 1000.0, 3.0])
    kw = dict(state_occ=occ, min_frames_per_comp=10.0) if gated else {}
    ours = em.split_components(g, perturb=0.3, **kw)
    theirs = jem.split_components(jg, perturb=0.3, **kw)
    assert ours.weights.shape == (S, 2 * K)
    _close(ours, theirs, rtol=1e-6, atol=1e-6)
    if gated:  # the same with the occupancies as a tensor on the GMM's device
        _close(em.split_components(g, perturb=0.3, state_occ=torch.as_tensor(occ),
                                   min_frames_per_comp=10.0), theirs, rtol=1e-6, atol=1e-6)


def test_init_from_labels_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(-1, S, N)
    labels[labels == 2] = 3   # a state with no frames: global mean/var
    labels[10] = 5
    labels[labels == 5] = 4
    labels[10] = 5            # a state with one frame
    ours = em.init_from_labels(x, labels, S, var_floor=0.05, device=torch.device("cpu"))
    theirs = jem.init_from_labels(x, labels, S, var_floor=0.05)
    _close(ours, theirs, rtol=0, atol=0)


def test_uniform_alignment_and_transitions_match_jax():
    ids = np.asarray([4, 1, 1, 6, 2], np.int32)
    for n in (0, 3, 5, 17):
        np.testing.assert_array_equal(em.uniform_alignment_labels(ids, 5, n),
                                      jem.uniform_alignment_labels(ids, 5, n))
    rng = np.random.default_rng(8)
    paths = np.sort(rng.integers(0, 6, (3, 20)), axis=1)
    paths[1, 12:] = -1
    pdfs = np.where(paths >= 0, paths % 4, -1)
    pdf_to_phone = np.asarray([0, 1, 1, 2])
    for a, b in zip(em.estimate_transitions(paths, pdfs, pdf_to_phone, 3, prior_count=0.5),
                    jem.estimate_transitions(paths, pdfs, pdf_to_phone, 3, prior_count=0.5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("adapt_vars", [False, True])
def test_m_step_map_matches_jax(adapt_vars):
    g, jg = _both(*_gmm_np(seed=9))
    occ, sx, sxx = _stats(seed=10)
    z = np.zeros((), np.float32)
    ours = em.m_step_map(g, em.GmmStats(*(torch.as_tensor(a) for a in (occ, sx, sxx, z, z))),
                         tau=5.0, adapt_vars=adapt_vars)
    theirs = jem.m_step_map(jg, jem.GmmStats(*(jnp.asarray(a) for a in (occ, sx, sxx, z, z))),
                            tau=5.0, adapt_vars=adapt_vars)
    _close(ours, theirs, rtol=1e-5, atol=1e-6)

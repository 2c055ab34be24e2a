"""The adaptation modules of the port (``mogasr_torch.am.{fmllr,mllr,stc,
lda}``) against the JAX package on the same seeded numpy inputs, on the CPU.

Statistics: the reference tests' own tolerances (``tests/test_fmllr.py``:
k_stat within 1e-5 of its largest entry; ``tests/test_mllr.py``: occ atol
1e-4, xsum within 1e-5 of its largest entry; ``tests/test_stc.py``: occ atol
1e-4, scatter within 1e-5 of its largest entry; ``tests/test_lda.py``: occ
rtol 1e-6, first and outer rtol 1e-5, which the port, summing in float64,
holds against the exact statistics). The host solves (``solve_fmllr``,
``_aux_objective``, ``solve_mllr(_classes)``, ``solve_stc``,
``stc_aux_loglik``, ``solve_lda``, ``compose_affine``, ``splice_np``) are
the reference's numpy code: on the same numpy statistics their results are
bitwise equal. The reference's behavioural checks run on the port: identity
on matched data, the fMLLR objective rising with sweeps, recovery of an
affine corruption, a pure shift, the class-MLLR back-off, STC decorrelation
and its monotone objective, LDA's whitening. The pipeline functions and CLI
twins built on these are ``test_torch_cli_adapt``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import fmllr as JF
from mogasr.am import lda as JL
from mogasr.am import mllr as JM
from mogasr.am import stc as JS
from mogasr.am.gmm import GmmSet as JaxGmmSet
from mogasr.am.gmm import gmm_loglik_np
from mogasr.config import TopologyConfig
from mogasr.hmm.lexicon import synthetic_lexicon as jax_synthetic_lexicon
from mogasr.hmm.topology import build_topology as jax_build_topology
from mogasr_torch import config as tc
from mogasr_torch.am import aligned
from mogasr_torch.am import fmllr as F
from mogasr_torch.am import lda as L
from mogasr_torch.am import mllr as M
from mogasr_torch.am import stc as S
from mogasr_torch.am.gmm import gmm_from_numpy
from mogasr_torch.hmm.lexicon import synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def gmm_and_data():
    """The reference tests' fixture: S=6, K=2, D=5 and 1200 frames sampled
    from the model (seed 1234)."""
    rng = np.random.default_rng(1234)
    S, K, D = 6, 2, 5
    w = rng.dirichlet(np.ones(K), size=S).astype(np.float32)
    mu = (3 * rng.standard_normal((S, K, D))).astype(np.float32)
    var = (0.3 + rng.random((S, K, D))).astype(np.float32)
    N = 1200
    labels = rng.integers(0, S, N)
    comps = np.array([rng.choice(K, p=w[s]) for s in labels])
    x = mu[labels, comps] + rng.standard_normal((N, D)).astype(np.float32) * np.sqrt(var[labels, comps])
    return (w, mu, var), x.astype(np.float32), labels.astype(np.int64)


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    """Chunks of a few hundred frames, so every accumulator here sums over
    several of them (a chunk's temporaries are 256 MiB on the card)."""
    monkeypatch.setattr(aligned, "CHUNK_BYTES", 1 << 16)


def _both(params):
    return gmm_from_numpy(*params, CPU), JaxGmmSet(*map(jnp.asarray, params))


def _t(a):
    return torch.as_tensor(np.array(a))


def aligned_loglik(params, x, labels):
    ll = gmm_loglik_np(x, *map(np.asarray, params))
    return float(ll[np.arange(len(labels)), labels].mean())


def _corrupt(x, A, b):
    return (x @ A.T + b).astype(np.float32)


def test_fmllr_stats_and_solve_match_jax(gmm_and_data):
    params, x, labels = gmm_and_data
    g, jg = _both(params)
    rng = np.random.default_rng(3)
    A_true = (np.eye(5) * 0.8 + 0.05 * rng.standard_normal((5, 5))).astype(np.float32)
    x_bad = _corrupt(x, A_true, rng.standard_normal(5).astype(np.float32) * 0.5)
    # padding rows carry garbage and label -1
    xp = np.concatenate([x_bad, 100 * np.ones((50, 5), np.float32)])
    lp = np.concatenate([labels, np.full(50, -1)])
    ours = F.accumulate_fmllr_stats(g, _t(xp), _t(lp))
    theirs = JF.accumulate_fmllr_stats(jg, jnp.asarray(x_bad), jnp.asarray(labels))
    for name in ("k_stat", "g_stat"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(theirs, name))
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), err_msg=name)
    np.testing.assert_allclose(float(ours.beta), float(theirs.beta), rtol=1e-6)
    # the host solve on the same numpy statistics: bitwise
    host = F.host_stats(ours)
    jstats = JF.FmllrStats(*(jnp.asarray(a) for a in host))
    for sweeps in (1, 10):
        np.testing.assert_array_equal(F.solve_fmllr(host, sweeps), JF.solve_fmllr(jstats, sweeps))
    W = F.solve_fmllr(ours)
    assert F._aux_objective(np.asarray(W, np.float64), host) == JF._aux_objective(np.asarray(W, np.float64), jstats)
    np.testing.assert_allclose(F.apply_fmllr(_t(x_bad), W).numpy(), np.asarray(JF.apply_fmllr(jnp.asarray(x_bad), W)),
                               rtol=1e-6, atol=1e-6)


def test_fmllr_behaviour(gmm_and_data):
    """The reference's checks on the port: identity on matched data, the
    objective rising with sweeps, recovery of an affine corruption."""
    params, x, labels = gmm_and_data
    g, _ = _both(params)
    W = F.solve_fmllr(F.accumulate_fmllr_stats(g, _t(x), _t(labels)))
    np.testing.assert_allclose(W[:, :-1], np.eye(5), atol=0.15)
    np.testing.assert_allclose(W[:, -1], 0.0, atol=0.2)

    x_bad = _corrupt(x, np.diag([0.7, 1.3, 0.9, 1.1, 0.8]).astype(np.float32),
                     np.array([0.5, -0.3, 0.2, 0.0, -0.4], np.float32))
    stats = F.host_stats(F.accumulate_fmllr_stats(g, _t(x_bad), _t(labels)))
    q0 = F._aux_objective(np.concatenate([np.eye(5), np.zeros((5, 1))], 1), stats)
    q1 = F._aux_objective(F.solve_fmllr(stats, n_sweeps=1), stats)
    q5 = F._aux_objective(F.solve_fmllr(stats, n_sweeps=5), stats)
    assert q0 - 1e-6 <= q1 <= q5 + 1e-6 and q5 > q0 + 1.0

    rng = np.random.default_rng(3)
    A_true = (np.eye(5) * 0.8 + 0.05 * rng.standard_normal((5, 5))).astype(np.float32)
    x_bad = _corrupt(x, A_true, rng.standard_normal(5).astype(np.float32) * 0.5)
    ll_clean, ll_bad = aligned_loglik(params, x, labels), aligned_loglik(params, x_bad, labels)
    assert ll_bad < ll_clean - 0.5
    W = F.estimate_fmllr(g, [(_t(x_bad), _t(labels))], n_sweeps=10)
    ll_ad = aligned_loglik(params, F.apply_fmllr(_t(x_bad), W).numpy(), labels)
    assert ll_ad > ll_bad + 0.5 * (ll_clean - ll_bad), (ll_clean, ll_bad, ll_ad)
    np.testing.assert_allclose(W[:, :-1] @ A_true, np.eye(5), atol=0.25)


def test_mllr_stats_and_solves_match_jax(gmm_and_data):
    params, x, labels = gmm_and_data
    g, jg = _both(params)
    classes = np.array([0, 0, 0, 1, 1, 1], np.int32)
    b0 = np.array([1.5, 0.0, -1.0, 0.5, 0.0], np.float32)
    b1 = np.array([-1.0, 1.0, 0.5, -0.5, 1.0], np.float32)
    x_bad = (x + np.where((classes[labels] == 0)[:, None], b0, b1)).astype(np.float32)
    xp = np.concatenate([x_bad, 100 * np.ones((50, 5), np.float32)])
    lp = np.concatenate([labels, np.full(50, -1)])
    ours = M.accumulate_mllr_stats(g, _t(xp), _t(lp))
    theirs = JM.accumulate_mllr_stats(jg, jnp.asarray(x_bad), jnp.asarray(labels))
    np.testing.assert_allclose(ours.occ.numpy(), np.asarray(theirs.occ), atol=1e-4)
    scale = np.abs(np.asarray(theirs.xsum)).max()
    np.testing.assert_allclose(ours.xsum.numpy(), np.asarray(theirs.xsum), atol=1e-5 * scale)
    # the host solves on the same numpy statistics: bitwise
    host = M.MllrStats(ours.occ.numpy(), ours.xsum.numpy())
    jhost = JM.MllrStats(jnp.asarray(host.occ), jnp.asarray(host.xsum))
    np.testing.assert_array_equal(M.solve_mllr(g, host), JM.solve_mllr(jg, jhost))
    np.testing.assert_array_equal(M.solve_mllr_classes(g, host, classes), JM.solve_mllr_classes(jg, jhost, classes))
    Ws = M.solve_mllr_classes(g, ours, classes)
    np.testing.assert_allclose(M.apply_mllr_classes(g, Ws, classes).means.numpy(),
                               np.asarray(JM.apply_mllr_classes(jg, Ws, classes).means), rtol=1e-6, atol=1e-5)
    W = M.solve_mllr(g, ours)
    np.testing.assert_allclose(M.apply_mllr(g, W).means.numpy(), np.asarray(JM.apply_mllr(jg, W).means),
                               rtol=1e-6, atol=1e-5)
    # per-class beats the compromised global transform and recovers nearly all
    ll_clean, ll_bad = aligned_loglik(params, x, labels), aligned_loglik(params, x_bad, labels)
    ll_global = aligned_loglik(tuple(a.numpy() for a in M.apply_mllr(g, W)), x_bad, labels)
    ll_class = aligned_loglik(tuple(a.numpy() for a in M.apply_mllr_classes(g, Ws, classes)), x_bad, labels)
    assert ll_class > ll_global + 0.05 and ll_class > ll_bad + 0.9 * (ll_clean - ll_bad)


def test_mllr_behaviour(gmm_and_data):
    """Identity on matched data, a pure shift recovered, low occupancy ->
    identity, an empty class backing off to the global transform."""
    params, x, labels = gmm_and_data
    g, _ = _both(params)
    W = M.estimate_mllr(g, [(_t(x), _t(labels))])
    np.testing.assert_allclose(W[:, :-1], np.eye(5), atol=0.15)
    np.testing.assert_allclose(W[:, -1], 0.0, atol=0.25)
    b_true = np.array([1.0, -0.8, 0.5, 0.0, -1.2], np.float32)
    W = M.estimate_mllr(g, [(_t(x + b_true), _t(labels))])
    np.testing.assert_allclose(W[:, -1], b_true, atol=0.2)
    W = M.estimate_mllr(g, [(_t(x[:2]), _t(labels[:2]))], min_occ=100.0)
    np.testing.assert_allclose(W[:, :-1], np.eye(5), atol=1e-6)
    keep = labels < 3  # starve states 3..5 entirely
    stats = M.accumulate_mllr_stats(g, _t(x[keep]), _t(labels[keep]))
    Ws = M.solve_mllr_classes(g, stats, np.array([0, 0, 0, 1, 1, 1], np.int32))
    np.testing.assert_allclose(Ws[1], M.solve_mllr(g, stats), atol=1e-6)


def test_speech_sil_classes_match_jax():
    lex = synthetic_lexicon()
    topo = build_topology(lex, tc.TopologyConfig())
    jtopo = jax_build_topology(jax_synthetic_lexicon(), TopologyConfig())
    np.testing.assert_array_equal(M.speech_sil_classes(topo), JM.speech_sil_classes(jtopo))


@pytest.fixture(scope="module")
def correlated_data():
    """The reference's STC fixture: per-class diagonal Gaussians mixed by a
    shared non-orthogonal R (seed 77)."""
    rng = np.random.default_rng(77)
    Sn, K, D, N = 5, 1, 4, 4000
    R = np.eye(D) + 0.45 * rng.standard_normal((D, D))
    mu_z = 3 * rng.standard_normal((Sn, D))
    var_z = 0.2 + rng.random((Sn, D))
    labels = rng.integers(0, Sn, N)
    z = mu_z[labels] + rng.standard_normal((N, D)) * np.sqrt(var_z[labels])
    x = (z @ R.T).astype(np.float32)
    var_x = np.stack([np.diag((R * var_z[s]) @ R.T) for s in range(Sn)])
    params = (np.ones((Sn, K), np.float32), (mu_z @ R.T)[:, None, :].astype(np.float32),
              var_x[:, None, :].astype(np.float32))
    return params, x, labels.astype(np.int64)


def test_stc_stats_and_solve_match_jax(correlated_data):
    params, x, labels = correlated_data
    g, jg = gmm_from_numpy(*params, CPU), JaxGmmSet(*map(jnp.asarray, params))
    xp = np.concatenate([x, 100 * np.ones((37, x.shape[1]), np.float32)])
    lp = np.concatenate([labels, np.full(37, -1)])
    ours = S.accumulate_stc_stats(g, _t(xp), _t(lp))
    theirs = JS.accumulate_stc_stats(jg, jnp.asarray(x), jnp.asarray(labels))
    np.testing.assert_allclose(ours.occ.numpy(), np.asarray(theirs.occ), atol=1e-4)
    scale = np.abs(np.asarray(theirs.scatter)).max()
    np.testing.assert_allclose(ours.scatter.numpy(), np.asarray(theirs.scatter), atol=1e-5 * scale)
    host = S.StcStats(ours.occ.numpy(), ours.scatter.numpy())
    jhost = JS.StcStats(jnp.asarray(host.occ), jnp.asarray(host.scatter))
    A, vars_y = S.solve_stc(g, host, n_iters=10)
    jA, jvars_y = JS.solve_stc(jg, jhost, n_iters=10)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(vars_y, jvars_y)
    assert S.stc_aux_loglik(A, g, host, vars_y) == JS.stc_aux_loglik(A, jg, jhost, vars_y)
    np.testing.assert_array_equal(S.stc_feature_transform(A), JS.stc_feature_transform(A))
    np.testing.assert_allclose(S.apply_stc(g, A, vars_y).means.numpy(),
                               np.asarray(JS.apply_stc(jg, A, vars_y).means), rtol=1e-6, atol=1e-5)

    # the reference's behaviour: near-diagonal transformed covariances, a
    # monotone objective
    D = x.shape[1]
    Wn = host.scatter.reshape(-1, D, D) / host.occ.reshape(-1)[:, None, None]

    def ratio(Amat):
        covs = np.einsum("id,mde,je->mij", Amat, Wn, Amat)
        return sum(np.abs(c - np.diag(np.diag(c))).sum() for c in covs) / sum(np.abs(np.diag(c)).sum() for c in covs)

    assert ratio(np.asarray(A, np.float64)) < 0.35 * ratio(np.eye(D))
    prev = -np.inf
    for n in (1, 3, 10):
        A_n, v_n = S.estimate_stc(g, [(_t(x), _t(labels))], n_iters=n)
        q = S.stc_aux_loglik(A_n, g, ours, v_n)
        assert q >= prev - 1e-6
        prev = q


def _class_data(rng, n_classes=8, dim=20, per_class=400):
    means = 3.0 * rng.standard_normal((n_classes, dim))
    feats = np.concatenate([m + rng.standard_normal((per_class, dim)) for m in means]).astype(np.float32)
    return feats, np.repeat(np.arange(n_classes), per_class).astype(np.int32)


def test_lda_stats_and_solve_match_jax():
    feats, labels = _class_data(np.random.default_rng(0))
    pad_feats = np.concatenate([feats, 99.0 * np.ones((17, feats.shape[1]), np.float32)])
    pad_labels = np.concatenate([labels, np.full(17, -1, np.int32)])
    ours = L.accumulate_lda_stats(_t(pad_feats), _t(pad_labels), 8)
    theirs = JL.accumulate_lda_stats(jnp.asarray(pad_feats), jnp.asarray(pad_labels), 8)
    unpadded = L.accumulate_lda_stats(_t(feats), _t(labels), 8)
    # the port sums in float64 and rounds once: held to the exact statistics
    # at the reference's rtol (JAX's float32 sums sit up to 5e-5 from them on
    # entries that cancel), its occupancies equal to JAX's, padding invariant
    f64 = feats.astype(np.float64)
    exact = (np.bincount(labels, minlength=8), np.stack([f64[labels == c].sum(0) for c in range(8)]), f64.T @ f64)
    for name, want, rtol in zip(("occ", "first", "outer"), exact, (1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(getattr(ours, name).numpy(), want, rtol=rtol, err_msg=name)
        np.testing.assert_array_equal(getattr(ours, name).numpy(), getattr(unpadded, name).numpy())
    np.testing.assert_array_equal(ours.occ.numpy(), np.asarray(theirs.occ))
    host = L.LdaStats(*(a.numpy() for a in ours))
    jhost = JL.LdaStats(*(jnp.asarray(a) for a in host))
    W = L.solve_lda(host, 5)
    np.testing.assert_array_equal(W, JL.solve_lda(jhost, 5))
    # the reference's properties: A Sw A^T = I, A Sb A^T diagonal descending
    A = np.asarray(W[:, :-1], np.float64)
    mu_g = feats.astype(np.float64).mean(0)
    sw = sum(((feats[labels == c] - feats[labels == c].mean(0)).T @ (feats[labels == c] - feats[labels == c].mean(0)))
             for c in range(8)) / len(feats)
    sb = sum((labels == c).sum() * np.outer(feats[labels == c].mean(0) - mu_g, feats[labels == c].mean(0) - mu_g)
             for c in range(8)) / len(feats)
    np.testing.assert_allclose(A @ sw @ A.T, np.eye(5), atol=1e-3)
    aba = A @ sb @ A.T
    assert np.abs(aba - np.diag(np.diag(aba))).max() < 1e-3 and np.all(np.diff(np.diag(aba)) <= 1e-6)
    rng = np.random.default_rng(4)
    w1, w2 = rng.standard_normal((5, 9)).astype(np.float32), rng.standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_array_equal(L.compose_affine(w2, w1), JL.compose_affine(w2, w1))


def test_splice_matches_oracle_and_jax():
    rng = np.random.default_rng(3)
    t0, t1, T, D, ctx = 11, 7, 16, 4, 3
    feats = np.zeros((2, T, D), np.float32)
    feats[0, :t0] = rng.standard_normal((t0, D))
    feats[1, :t1] = rng.standard_normal((t1, D))
    feats[1, t1:] = 5.0  # garbage in the padding
    out = L.splice_frames(_t(feats), _t([t0, t1]), ctx).numpy()
    for b, n in ((0, t0), (1, t1)):
        np.testing.assert_array_equal(L.splice_np(feats[b, :n], ctx), JL.splice_np(feats[b, :n], ctx))
        np.testing.assert_allclose(out[b, :n], L.splice_np(feats[b, :n], ctx), rtol=1e-6)
    assert np.all(out[0, t0:] == 0.0) and np.all(out[1, t1:] == 0.0)
    np.testing.assert_array_equal(out, np.asarray(JL.splice_frames(jnp.asarray(feats), jnp.asarray([t0, t1]), ctx)))

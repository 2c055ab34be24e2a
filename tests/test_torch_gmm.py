"""mogasr_torch GMM scorer against the JAX scorer, the interpret-mode Pallas
kernel and the golden logliks; weight transfer; the kernel wrapper's CPU
dispatch. Inputs are numpy arrays from a seed, handed to both packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am.gmm import GmmSet as JaxGmmSet
from mogasr.am.gmm import gmm_loglik as jax_gmm_loglik
from mogasr.am.gmm import natural_params as jax_natural_params
from mogasr.am.gmm_pallas import gmm_loglik_pallas
from mogasr_torch.am import gmm_cuda
from mogasr_torch.am.gmm import GmmSet, gmm_from_numpy, gmm_loglik

CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden.npz")
# Both sides compute in float32 and differ only in summation order: the
# measured gap is 1.5e-5 on logliks of magnitude 40-130.
ATOL, RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def system():
    """A small GMM (S=20, K=4, D=39) and N=100 frames, each drawn from one
    of its components, as numpy arrays."""
    rng = np.random.default_rng(0)
    S, K, D, N = 20, 4, 39, 100
    w = rng.dirichlet(np.ones(K), size=S).astype(np.float32)
    mu = rng.standard_normal((S, K, D)).astype(np.float32)
    var = (0.5 + rng.random((S, K, D))).astype(np.float32)
    st, comp = rng.integers(0, S, N), rng.integers(0, K, N)
    x = (mu[st, comp] + np.sqrt(var[st, comp]) * rng.standard_normal((N, D))).astype(np.float32)
    return w, mu, var, x


def _jax_gmm(w, mu, var):
    return JaxGmmSet(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_plain_matches_jax(system, mode):
    w, mu, var, x = system
    want = np.asarray(jax_gmm_loglik(jnp.asarray(x), _jax_gmm(w, mu, var), mode=mode))
    got = gmm_loglik(torch.as_tensor(x), gmm_from_numpy(w, mu, var, CPU), mode=mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_plain_matches_pallas_interpret(system, mode):
    w, mu, var, x = system
    want = np.asarray(gmm_loglik_pallas(
        jnp.asarray(x), _jax_gmm(w, mu, var), tile_m=64, interpret=True, mode=mode))
    got = gmm_loglik(torch.as_tensor(x), gmm_from_numpy(w, mu, var, CPU), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_plain_matches_golden():
    data = np.load(FIXTURE)
    g = gmm_from_numpy(data["gmm_w"], data["gmm_mu"], data["gmm_var"], CPU)
    got = gmm_loglik(torch.as_tensor(data["feats"][:50]), g)
    # the reference's own golden tolerance (tests/test_golden.py)
    np.testing.assert_allclose(got.numpy(), data["loglik"], atol=1e-3, rtol=1e-4)


def test_gmm_from_numpy_round_trip(system):
    w, mu, var, _x = system
    jg = _jax_gmm(w, mu, var)
    g = gmm_from_numpy(np.asarray(jg.weights), np.asarray(jg.means), np.asarray(jg.vars), CPU)
    assert isinstance(g, GmmSet)
    assert (g.n_states, g.n_components, g.feat_dim) == mu.shape
    for ours, theirs in zip(g, jg):
        assert ours.dtype == torch.float32 and ours.device == CPU
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_bf16_max_picks_the_same_states_as_jax(system):
    """The two bf16 paths round c differently (the reference splits it into
    a bf16 hi/lo pair, the port keeps it float32), so compare decisions."""
    w, mu, var, x = system
    want = np.asarray(gmm_loglik_pallas(
        jnp.asarray(x), _jax_gmm(w, mu, var), tile_m=64, interpret=True,
        compute_dtype="bfloat16", mode="max"))
    got = gmm_loglik(torch.as_tensor(x), gmm_from_numpy(w, mu, var, CPU),
                     mode="max", compute_dtype="bfloat16").numpy()
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_fused_wrapper_takes_plain_version_on_cpu(system, compute_dtype, mode):
    w, mu, var, x = system
    g = gmm_from_numpy(w, mu, var, CPU)
    before = gmm_cuda.LAUNCHES
    feats = torch.as_tensor(x).reshape(4, 25, -1)
    got = gmm_cuda.gmm_loglik_batched(feats, g, compute_dtype=compute_dtype, mode=mode)
    want = gmm_loglik(torch.as_tensor(x), g, mode=mode, compute_dtype=compute_dtype)
    assert torch.equal(got.reshape(100, -1), want)
    assert gmm_cuda.LAUNCHES == before


def test_bad_arguments_raise(system):
    w, mu, var, x = system
    g = gmm_from_numpy(w, mu, var, CPU)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_loglik_fused(torch.as_tensor(x), g, mode="mean")
    with pytest.raises(ValueError):
        gmm_cuda.gmm_loglik_fused(torch.as_tensor(x), g, compute_dtype="int8")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kernel_params_layout_matches_jax(system, compute_dtype):
    """The kernel's component-major layout holds JAX's natural parameters:
    ab_t[k, r, s] = ab[r, s*K + k] (in the compute dtype), c_t[k, s] = c[s*K + k]."""
    w, mu, var, _x = system
    S, K, D = mu.shape
    nat = jax_natural_params(_jax_gmm(w, mu, var))
    ab_t, c_t = gmm_cuda.kernel_params(gmm_from_numpy(w, mu, var, CPU), compute_dtype)
    assert ab_t.is_contiguous() and c_t.is_contiguous() and c_t.dtype == torch.float32
    want_ab = torch.as_tensor(np.asarray(nat.ab).reshape(2 * D, S, K).transpose(2, 0, 1).copy())
    want_c = np.asarray(nat.c).reshape(S, K).T
    torch.testing.assert_close(ab_t, want_ab.to(ab_t.dtype), atol=0, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), want_c, atol=ATOL, rtol=RTOL)

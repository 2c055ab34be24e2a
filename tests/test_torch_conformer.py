"""The port's Conformer (mogasr_torch.am.aed's encoder, am.neural.ConformerAm)
against the JAX package's flax modules on the CPU, weights carried by
``from_flax``: d_model 32, 2 blocks, 4 heads, kernel 15, odd and even T,
ragged n_frames, a nonzero relative-position bias, within 2e-5 (the
neural families' tolerance, test_torch_neural; the port reads up to 1.3e-6
here); and padding invariance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import aed as jaed
from mogasr.am import neural as jn
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr_torch.am import aed as taed
from mogasr_torch.am import neural as tn
from mogasr_torch.am.params import from_flax
from mogasr_torch.config import TrainConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, D, P, HIDDEN, LAYERS = 3, 9, 6, 32, 2
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def pair():
    """(flax ConformerAm, its params with a random rel_bias, the port's model)."""
    jm = jn.build_model("conformer", P, JaxTrainConfig(nn_hidden=HIDDEN, nn_layers=LAYERS))
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, 8, D)), jnp.asarray([8, 8]))
    rng = np.random.default_rng(1)
    enc = dict(params["params"]["enc"])
    for i in range(LAYERS):
        blk = dict(enc[f"blks_{i}"])
        attn = dict(blk["attn"])
        attn["rel_bias"] = jnp.asarray(rng.standard_normal(attn["rel_bias"].shape).astype(np.float32))
        blk["attn"] = attn
        enc[f"blks_{i}"] = blk
    params = {"params": {**params["params"], "enc": enc}}
    tm = tn.build_model("conformer", P, TrainConfig(nn_hidden=HIDDEN, nn_layers=LAYERS), D)
    assert set(from_flax(tm, params)) == set(tm.state_dict())
    tm.load_state_dict(from_flax(tm, params))
    return jm, params, tm


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, D)).astype(np.float32), np.asarray([T, T - 6, 3], np.int32)


@pytest.mark.parametrize("T", [37, 40])
def test_conformer_am_matches_flax(pair, T):
    """``__call__`` on valid frames, ``subsampled`` and the bare encoder on
    valid subsampled frames, n_out equal."""
    jm, params, tm = pair
    feats, nf = _inputs(T, T)
    x, n = jnp.asarray(feats), jnp.asarray(nf)
    enc = jaed.ConformerEncoder(d_model=HIDDEN, blocks=LAYERS, heads=4, conv_kernel=15)

    @jax.jit
    def reference(x, n):
        return (jm.apply(params, x, n), jm.apply(params, x, n, method="subsampled"),
                enc.apply({"params": params["params"]["enc"]}, x, n)[0])

    want, (want_sub, want_n), want_enc = jax.tree.map(np.asarray, reference(x, n))
    with torch.no_grad():
        ft, nt = torch.as_tensor(feats), torch.as_tensor(nf)
        got = tm(ft, nt).numpy()
        got_sub, got_n = tm.subsampled(ft, nt)
        got_enc, _ = tm.enc(ft, nt)
    assert got.shape == want.shape == (B, T, P) and got_sub.shape == want_sub.shape == (B, -(-T // 4), P)
    assert got_n.tolist() == want_n.tolist() == taed.subsampled_frames(nf).tolist()
    for b in range(B):
        np.testing.assert_allclose(got[b, : nf[b]], want[b, : nf[b]], **TOL)
        np.testing.assert_allclose(got_sub[b, : want_n[b]].numpy(), want_sub[b, : want_n[b]], **TOL)
        np.testing.assert_allclose(got_enc[b, : want_n[b]].numpy(), want_enc[b, : want_n[b]], **TOL)
    # the 25 Hz head repeated 4x is the full-rate output
    np.testing.assert_array_equal(got, np.repeat(got_sub.numpy(), 4, axis=1)[:, :T])


def test_conformer_padding_invariance(pair):
    """Valid frames do not move when the padding is trashed and the bucket
    widened (by an odd number of frames: the subsampling windows must not
    shift with T's parity)."""
    _jm, _params, tm = pair
    feats, nf = _inputs(37, 3)
    rng = np.random.default_rng(4)
    wide = np.concatenate([feats, rng.standard_normal((B, 9, D)).astype(np.float32)], axis=1)
    for b, n in enumerate(nf):
        wide[b, n:] = 50 * rng.standard_normal(wide[b, n:].shape)
    with torch.no_grad():
        a = tm(torch.as_tensor(feats), torch.as_tensor(nf)).numpy()
        w = tm(torch.as_tensor(wide), torch.as_tensor(nf)).numpy()
    for b, n in enumerate(nf):
        np.testing.assert_allclose(w[b, :n], a[b, :n], rtol=1e-5, atol=1e-5)


def test_subsample_helpers_match_the_reference():
    for n in range(1, 12):
        assert taed._same_lohi(n) == jaed._same_lohi(n)
        assert taed.subsampled_frames(n) == int(jaed.subsampled_frames(jnp.asarray(n)))

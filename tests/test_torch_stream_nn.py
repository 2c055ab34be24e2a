"""The streaming LstmAm of mogasr_torch (am/neural.py: LstmAmStream,
lstm_stream_init, make_lstm_stream_step; the carries of am/fast_lstm.py and
am/lstm_cuda.py, the plain version of K4's carry arm) against flax on the
same numpy inputs and weights (``am.params.from_flax``), at H <= 64: one
layer from given carries against flax's ``nn.RNN(initial_carry=...,
return_carry=True)``, the streaming model against the reference's
LstmAmStream at two chunkings and against the offline LstmAm (the
reference's contract: 1e-5), and rows at n_valid = 0 keeping their carries
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mogasr.am import neural as jn
from mogasr_torch.am import fast_lstm, lstm_cuda
from mogasr_torch.am import neural as tn
from mogasr_torch.am.params import from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
B, T, D, H, P = 3, 20, 8, 16, 12
TOL = 1e-5


@pytest.fixture(scope="module")
def lstm():
    """One flax init of the two-layer LstmAm, its port, inputs and priors."""
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    jmodel = jn.LstmAm(n_pdfs=P, hidden=H, layers=2)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(feats), jnp.full((B,), T))
    model = tn.LstmAmStream(P, D, hidden=H, layers=2)
    model.load_state_dict(from_flax(model, params))
    log_priors = np.log(rng.dirichlet(np.ones(P))).astype(np.float32)
    yield jmodel, params, model, feats, log_priors
    jax.clear_caches()


def test_layer_carries_match_flax_rnn():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    c0, h0 = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    rnn = fnn.RNN(fnn.OptimizedLSTMCell(H))
    params = jax.jit(rnn.init)(jax.random.key(1), jnp.asarray(x))
    (jc, jh), jy = rnn.apply(params, jnp.asarray(x), initial_carry=(jnp.asarray(c0), jnp.asarray(h0)),
                             return_carry=True)
    one = tn.LstmAm(1, D, hidden=H, layers=1)
    one.load_state_dict(from_flax(one, {"OptimizedLSTMCell_0": params["params"]["cell"], "Dense_0": {
        "kernel": np.zeros((H, 1), np.float32), "bias": np.zeros(1, np.float32)}}))
    cell = one.cells[0]
    with torch.no_grad():
        xg = cell.input_gates(torch.as_tensor(x), "float32")
        y, (h, c) = fast_lstm.lstm_layer(xg, cell.w_rec, torch.full((B,), T), h0=torch.as_tensor(h0),
                                         c0=torch.as_tensor(c0), return_carry=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunks", [[20], [7, 13]], ids=["whole", "7-13"])
def test_stream_matches_reference_stream_and_offline(lstm, chunks):
    jmodel, params, model, feats, log_priors = lstm
    lp = torch.as_tensor(log_priors)
    jstep = jn.make_lstm_stream_step(jmodel, params, jnp.asarray(log_priors))
    jcarries = jn.lstm_stream_init(jmodel, B, D)
    step = tn.make_lstm_stream_step(model, lp)
    carries = tn.lstm_stream_init(model, B, CPU)
    want, got, t0 = [], [], 0
    for tc in chunks:
        jcarries, jll = jstep(jcarries, jnp.asarray(feats[:, t0:t0 + tc]))
        carries, ll = step(carries, torch.as_tensor(feats[:, t0:t0 + tc]))
        want.append(np.asarray(jll))
        got.append(ll.numpy())
        t0 += tc
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(want, 1), rtol=TOL, atol=TOL)
    for (c, h), (jc, jh) in zip(carries, jcarries):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)
    with torch.no_grad():
        offline = tn.posteriors_to_loglik(tn.LstmAm.forward(model, torch.as_tensor(feats), torch.full((B,), T)), lp)
    np.testing.assert_allclose(np.concatenate(got, 1), offline.numpy(), rtol=TOL, atol=TOL)


def test_zero_valid_rows_keep_their_carries(lstm):
    jmodel, params, model, feats, _ = lstm
    x = torch.as_tensor(feats)
    with torch.no_grad():
        _, carries = model(x[:, :6], tn.lstm_stream_init(model, B, CPU))
        _, after = model(x[:, 6:11], carries, n_valid=torch.tensor([5, 0, 2]))
        # the reference's LstmAmStream with n_valid: the carries at each row's n_valid
        _, jafter = jn.LstmAmStream(n_pdfs=P, hidden=H, layers=2).apply(
            params, jnp.asarray(feats[:, 6:11]), [(jnp.asarray(c.numpy()), jnp.asarray(h.numpy()))
                                                  for c, h in carries], n_valid=jnp.asarray([5, 0, 2]))
    for (c0, h0), (c1, h1), (jc, jh) in zip(carries, after, jafter):
        assert torch.equal(c1[1], c0[1]) and torch.equal(h1[1], h0[1])
        np.testing.assert_allclose(c1.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(h1.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)


def test_kernel_wrapper_carries_on_cpu():
    """``lstm_cuda.lstm_layer`` with carries takes the plain version on the
    CPU: the same tensors, and no launch."""
    rng = np.random.default_rng(6)
    xg = torch.as_tensor(rng.standard_normal((B, 9, 4 * H)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((H, 4 * H)) / 4).astype(np.float32))
    h0, c0 = (torch.as_tensor(rng.standard_normal((B, H)).astype(np.float32)) for _ in range(2))
    nf = torch.tensor([9, 0, 4])
    before = lstm_cuda.LAUNCHES, lstm_cuda.CARRY_LAUNCHES
    y, (h, c) = lstm_cuda.lstm_layer(xg, w, nf, h0=h0, c0=c0, return_carry=True)
    y2, (h2, c2) = fast_lstm.lstm_layer(xg, w, nf, h0=h0, c0=c0, return_carry=True)
    assert (lstm_cuda.LAUNCHES, lstm_cuda.CARRY_LAUNCHES) == before
    assert torch.equal(y, y2) and torch.equal(h, h2) and torch.equal(c, c2)
    assert torch.equal(h[1], h0[1]) and torch.equal(c[1], c0[1]) and torch.equal(y[1], h0[1].expand(9, H))

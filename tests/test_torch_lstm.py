"""The plain LSTM recurrence (mogasr_torch.am.fast_lstm, the plain version
of kernel K4) and the K4 wrapper's CPU route (mogasr_torch.am.lstm_cuda)
against the JAX package's Pallas kernel in interpret mode
(``lstm_layer_pallas(..., interpret=True)``) and its prefused forward, on the
same numpy inputs: float32 within 2e-5 (tests/test_lstm_pallas.py), the bf16
mode within the reference's bf16 bound, 0.05."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import fast_lstm as jfl
from mogasr.am import lstm_pallas as jlp
from mogasr.am.neural import LstmAm as JaxLstmAm
from mogasr_torch.am import fast_lstm, lstm_cuda
from mogasr_torch.am.neural import LstmAm
from mogasr_torch.am.params import from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _layer_inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    w = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    nf = np.r_[T, 1, 0, rng.integers(1, T + 1, max(B - 3, 0))][:B].astype(np.int32)
    return xg, w, nf


@pytest.mark.parametrize("B,T,H", [(3, 17, 11), (5, 9, 16), (4, 6, 33)])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_plain_recurrence_matches_pallas_interpret(B, T, H, compute_dtype):
    xg, w, nf = _layer_inputs(B + T + H, B, T, H)
    want = np.asarray(jlp.lstm_layer_pallas(jnp.asarray(xg), jnp.asarray(w), jnp.asarray(nf),
                                            compute_dtype=compute_dtype, interpret=True))
    got = fast_lstm.lstm_layer(torch.as_tensor(xg), torch.as_tensor(w), torch.as_tensor(nf), compute_dtype)
    assert got.shape == (B, T, H) and got.dtype == torch.float32
    tol = 2e-5 if compute_dtype == "float32" else 0.05
    # every frame: both freeze the carries past n_frames
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_frozen_carries_and_empty_rows():
    xg, w, nf = _layer_inputs(1, 4, 10, 8)
    out = fast_lstm.lstm_layer(torch.as_tensor(xg), torch.as_tensor(w), torch.as_tensor(nf))
    assert float(out[2].abs().max()) == 0.0                  # n_frames = 0: zeros
    assert torch.equal(out[1, 1:], out[1, :1].expand(9, 8))  # n_frames = 1: frame 0 repeated
    n = int(nf[3])
    assert torch.equal(out[3, n:], out[3, n - 1:n].expand(10 - n, 8))


def test_padding_invariance():
    xg, w, nf = _layer_inputs(2, 5, 12, 7)
    a = fast_lstm.lstm_layer(torch.as_tensor(xg), torch.as_tensor(w), torch.as_tensor(nf))
    rng = np.random.default_rng(3)
    wide = np.concatenate([xg, rng.standard_normal((5, 4, 28)).astype(np.float32)], axis=1)
    for b, n in enumerate(nf):
        wide[b, n:] = rng.standard_normal(wide[b, n:].shape) * 40
    b_ = fast_lstm.lstm_layer(torch.as_tensor(wide), torch.as_tensor(w), torch.as_tensor(nf))
    for row, n in enumerate(nf):
        np.testing.assert_array_equal(b_[row, :n].numpy(), a[row, :n].numpy())


def test_wrapper_takes_the_plain_version_on_cpu():
    xg, w, nf = _layer_inputs(4, 3, 8, 5)
    before = lstm_cuda.LAUNCHES
    for dt in ("float32", "bfloat16"):
        got = lstm_cuda.lstm_layer(torch.as_tensor(xg), torch.as_tensor(w), torch.as_tensor(nf), dt)
        want = fast_lstm.lstm_layer(torch.as_tensor(xg), torch.as_tensor(w), torch.as_tensor(nf), dt)
        assert torch.equal(got, want)
    assert lstm_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        lstm_cuda.lstm_layer(torch.as_tensor(xg), torch.as_tensor(w), torch.as_tensor(nf), "float16")


def test_kernel_row_order():
    """K4's row order: rows by n_frames longest first, ties in row order.
    The rows live at frame t (n_frames > t; n_frames past T counts as T)
    are a prefix of it, and of each of its strided row blocks, as the
    kernel counts them per frame; rows of 0 frames come last. Running the
    recurrence on rows in that order changes nothing."""
    T = 6
    nf = torch.tensor([3, 0, 6, 3, 9, 1, 0], dtype=torch.int64)
    perm, nfs = lstm_cuda.row_order(nf)
    assert perm.dtype == nfs.dtype == torch.int32
    assert perm.tolist() == [4, 2, 0, 3, 5, 1, 6]
    assert nfs.tolist() == [9, 6, 3, 3, 1, 0, 0]
    live = [sum(min(int(n), T) > t for n in nf) for t in range(T)]
    assert live == [5, 4, 4, 2, 2, 2]
    for t in range(T):
        assert set(perm[: live[t]].tolist()) == {b for b in range(7) if min(int(nf[b]), T) > t}
        for rb in range(3):  # row block rb of 3: rows rb, rb + 3, ...
            block = nfs[rb::3].tolist()
            n_live = sum(n > t for n in block)
            assert all(n > t for n in block[:n_live]) and not any(n > t for n in block[n_live:])
    every = lstm_cuda.row_order(torch.full((4,), T, dtype=torch.int32))
    assert every[0].tolist() == [0, 1, 2, 3] and every[1].tolist() == [T] * 4
    none = lstm_cuda.row_order(torch.zeros(4, dtype=torch.int32))
    assert none[0].tolist() == [0, 1, 2, 3] and none[1].tolist() == [0] * 4

    xg, w, nf_np = _layer_inputs(6, 7, T, 5)
    xg, w, nf_t = torch.as_tensor(xg), torch.as_tensor(w), torch.as_tensor(nf_np)
    perm = lstm_cuda.row_order(nf_t)[0].long()
    assert torch.equal(fast_lstm.lstm_layer(xg[perm], w, nf_t[perm]), fast_lstm.lstm_layer(xg, w, nf_t)[perm])


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_am_matches_prefused_and_pallas_forward(layers):
    rng = np.random.default_rng(5 + layers)
    B, T, D, H = 3, 17, 7, 11
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    nf = np.asarray([T, 12, 4], np.int32)
    jm = JaxLstmAm(n_pdfs=5, hidden=H, layers=layers)
    params = jm.init(jax.random.key(layers), jnp.asarray(feats), jnp.asarray(nf))
    prefused = np.asarray(jfl.lstm_am_apply_prefused(params, jnp.asarray(feats), jnp.asarray(nf)))
    pallas = np.asarray(jlp.lstm_am_apply_pallas(params, jnp.asarray(feats), jnp.asarray(nf), interpret=True))
    tm = LstmAm(5, D, hidden=H, layers=layers)
    tm.load_state_dict(from_flax(tm, params))
    with torch.no_grad():
        got = tm(torch.as_tensor(feats), torch.as_tensor(nf)).numpy()
    # the fused forwards freeze carries as the port does: every frame agrees
    np.testing.assert_allclose(got, prefused, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)

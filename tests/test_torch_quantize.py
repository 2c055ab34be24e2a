"""Reduced-precision inference of the port (mogasr_torch.am.quantize)
against the JAX package's mogasr.am.quantize on the same numpy inputs and
the same (flax-initialised) weights: int8 quantization bitwise (``q``) and
to 1 ulp (scales), int8 logits of MlpAm and LstmAm, bf16 logits of every
family within the reference's bf16 bound of float32, and the .npz format."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import neural as jn
from mogasr.am import quantize as jq
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr_torch.am import neural as tn
from mogasr_torch.am import quantize as tq
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


CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _pair(arch, hidden=16, layers=2, seed=0, B=3, T=12, D=6):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    nf = np.asarray([T, 7, 3][:B], np.int32)
    jm = jn.build_model(arch, 5, JaxTrainConfig(nn_hidden=hidden, nn_layers=layers, nn_context=1))
    params = {"params": jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(feats), jnp.asarray(nf))["params"]}
    tm = tn.build_model(arch, 5, TrainConfig(nn_hidden=hidden, nn_layers=layers, nn_context=1), D)
    tm.load_state_dict(from_flax(tm, params))
    return jm, params, tm, feats, nf


def test_quantize_dense_int8_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.3
    w[:, 3] = 0.0  # a zero column: scale 1, q 0
    q, s = jq.quantize_dense_int8(jnp.asarray(w))
    q2, s2 = tq.quantize_dense_int8(torch.as_tensor(w))
    assert q2.dtype == torch.int8 and s2.dtype == torch.float32
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q))
    np.testing.assert_array_max_ulp(s2.numpy(), np.asarray(s), maxulp=1)
    assert float(s2[3]) == 1.0 and int(q2[:, 3].abs().max()) == 0


def test_int8_dynamic_dot_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    x[0, 3] = 0.0  # a zero row: scale 1
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.2
    q, s = jq.quantize_dense_int8(jnp.asarray(w))
    want = np.asarray(jq.int8_dynamic_dot(jnp.asarray(x), q, s))
    q2, s2 = tq.quantize_dense_int8(torch.as_tensor(w))
    got = tq.int8_dynamic_dot(torch.as_tensor(x), q2, s2).numpy()
    # same integers, same scales: the float32 products equal JAX's int32 ones
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    rel = np.linalg.norm(got - x @ w) / np.linalg.norm(x @ w)
    assert rel < 0.02, rel


def test_int8_dot_refuses_inexact_widths():
    q = torch.zeros((1041, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        tq.int8_dynamic_dot(torch.zeros((2, 1041)), q, torch.ones(3))
    tq.int8_dynamic_dot(torch.zeros((2, 1040)), q[:1040], torch.ones(3))


@pytest.mark.parametrize("arch", ["mlp", "lstm"])
def test_int8_logits_match_jax(arch):
    jm, params, tm, feats, nf = _pair(arch, seed=2)
    want = np.asarray(jq.make_int8_logits(jm, params)(jnp.asarray(feats), jnp.asarray(nf)))
    with torch.no_grad():
        got = tq.make_int8_logits(tm)(torch.as_tensor(feats), torch.as_tensor(nf)).numpy()
        f32 = tm(torch.as_tensor(feats), torch.as_tensor(nf)).numpy()
    for b, n in enumerate(nf):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=2e-5, atol=2e-5)
        rel = np.linalg.norm(got[b, :n] - f32[b, :n]) / np.linalg.norm(f32[b, :n])
        assert rel < 0.05, (b, rel)  # the reference's int8 bound (tests/test_quantize.py)


def test_int8_rejects_other_families():
    _, _, tm, *_ = _pair("tdnn")
    with pytest.raises(NotImplementedError):
        tq.make_int8_logits(tm)
    with pytest.raises(ValueError):
        tq.make_quantized_logits(tm, "float16")


@pytest.mark.parametrize("arch", ["mlp", "lstm", "blstm", "tdnn", "moe"])
def test_bf16_logits_close_to_float32(arch):
    jm, params, tm, feats, nf = _pair(arch, seed=3)
    x, n = torch.as_tensor(feats), torch.as_tensor(nf)
    with torch.no_grad():
        got = tq.make_quantized_logits(tm, "bfloat16")(x, n)
        f32 = tq.make_quantized_logits(tm, "float32")(x, n)
    assert got.dtype == torch.float32 and got.shape == f32.shape
    # against the reference's bf16 logits for one family of each recipe: a bf16
    # copy of the module (mlp, as the reference), and bf16 operands with
    # float32 gates and carries (lstm, the port's own, as K4 runs)
    want = (np.asarray(jq.make_bf16_logits(jm, params)(jnp.asarray(feats), jnp.asarray(nf)))
            if arch in ("mlp", "lstm") else None)
    for b, k in enumerate(nf):
        g, f = got[b, :k].numpy(), f32[b, :k].numpy()
        np.testing.assert_allclose(g, f, rtol=0.05, atol=0.05)  # tests/test_lstm_pallas.py:84
        if want is not None:
            np.testing.assert_allclose(g, want[b, :k], rtol=0.05, atol=0.05)
    # the bf16 copy leaves the float32 model as it was
    assert all(p.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("arch", ["mlp", "lstm"])
def test_quantized_checkpoint_roundtrip_and_reference_format(arch, tmp_path):
    jm, params, tm, feats, nf = _pair(arch, hidden=24, seed=4)
    qp = tq.quantize_mlp_int8(tm) if arch == "mlp" else tq.quantize_lstm_int8(tm)
    apply = ((lambda q: tq.mlp_apply_int8(tm, q, torch.as_tensor(feats), torch.as_tensor(nf)))
             if arch == "mlp" else (lambda q: tq.lstm_apply_int8(q, torch.as_tensor(feats), torch.as_tensor(nf))))
    path = str(tmp_path / "q.npz")
    tq.save_quantized(path, qp)
    assert torch.equal(apply(tq.load_quantized(path, CPU)), apply(qp))  # bit-identical reload
    # a checkpoint the reference wrote loads in the port and gives its logits
    jqp = jq.quantize_mlp_int8(jm, params) if arch == "mlp" else jq.quantize_lstm_int8(params)
    ref_path = str(tmp_path / "ref.npz")
    jq.save_quantized(ref_path, jqp)
    theirs = tq.load_quantized(ref_path, CPU)
    assert torch.equal(apply(theirs), apply(qp))

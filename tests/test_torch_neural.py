"""The port's neural frame classifiers (mogasr_torch.am.neural, .params)
against the JAX package's flax modules, on the CPU: the same numpy inputs,
the flax parameters carried over by ``from_flax``, logits on valid frames
within rtol/atol 2e-5 (the reference's own tolerance for its fused LSTM,
tests/test_lstm_pallas.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import neural as jn
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr_torch.am import neural as tn
from mogasr_torch.am.params import from_flax, init_
from mogasr_torch.config import TrainConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T, D, P = 3, 17, 7, 5
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, batch=B, frames=T, dim=D):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((batch, frames, dim)).astype(np.float32)
    nf = np.asarray([frames, max(frames - 5, 1), 4] + list(rng.integers(1, frames + 1, batch - 3)),
                    np.int32)[:batch]
    return feats, nf


def _pair(arch, hidden, layers, seed=0, feats=None, nf=None, **cfg):
    """(flax model, its params, the port's model with the same weights)."""
    jm = jn.build_model(arch, P, JaxTrainConfig(nn_hidden=hidden, nn_layers=layers, **cfg))
    if feats is None:
        feats, nf = _inputs(seed)
    params = {"params": jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(feats), jnp.asarray(nf))["params"]}
    tm = tn.build_model(arch, P, TrainConfig(nn_hidden=hidden, nn_layers=layers, **cfg), feats.shape[-1])
    tm.load_state_dict(from_flax(tm, params))
    return jm, params, tm


def _valid_close(got, want, nf, **tol):
    for b, n in enumerate(nf):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **(tol or TOL))


# arch, hidden, nn_layers (LstmAm/BlstmAm/MoeAm use nn_layers - 1 layers)
FAMILIES = [("mlp", 16, 2), ("lstm", 11, 2), ("lstm", 16, 3), ("blstm", 12, 3), ("tdnn", 11, 3),
            ("moe", 12, 3)]


@pytest.mark.parametrize("arch,hidden,layers", FAMILIES)
def test_family_logits_match_flax(arch, hidden, layers):
    feats, nf = _inputs(hidden + layers)
    jm, params, tm = _pair(arch, hidden, layers, seed=layers, feats=feats, nf=nf)
    assert set(from_flax(tm, params["params"])) == set(tm.state_dict())  # the tree or its inside
    want = np.asarray(jm.apply(params, jnp.asarray(feats), jnp.asarray(nf)))
    with torch.no_grad():
        got = tm(torch.as_tensor(feats), torch.as_tensor(nf)).numpy()
    assert got.shape == want.shape == (B, T, P) and got.dtype == np.float32
    _valid_close(got, want, nf)


@pytest.mark.parametrize("arch", ["lstm", "blstm", "tdnn", "mlp", "moe"])
def test_family_padding_invariance(arch):
    """Valid frames do not move when the padding is trashed and widened."""
    feats, nf = _inputs(4)
    tm = init_(tn.build_model(arch, P, TrainConfig(nn_hidden=12, nn_layers=2), D), torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    trashed = np.concatenate([feats, rng.standard_normal((B, 6, D)).astype(np.float32)], axis=1)
    for b, n in enumerate(nf):
        trashed[b, n:] = rng.standard_normal(trashed[b, n:].shape) * 40
    with torch.no_grad():
        a = tm(torch.as_tensor(feats), torch.as_tensor(nf)).numpy()
        b_ = tm(torch.as_tensor(trashed), torch.as_tensor(nf)).numpy()
    _valid_close(b_, a, nf, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("context", [0, 1, 4])
def test_splice_frames_bitwise(context):
    feats, nf = _inputs(7, batch=4, frames=9, dim=5)
    nf[3] = 0
    want = np.asarray(jn.splice_frames(jnp.asarray(feats), jnp.asarray(nf), context))
    got = tn.splice_frames(torch.as_tensor(feats), torch.as_tensor(nf), context).numpy()
    np.testing.assert_array_equal(got, want)


def test_flip_valid_matches_flax_and_is_an_involution():
    from flax.linen.recurrent import flip_sequences

    feats, nf = _inputs(8, batch=4, frames=6, dim=2)
    nf[3] = 0
    want = np.asarray(flip_sequences(jnp.asarray(feats), jnp.asarray(nf), 1, False))
    got = tn.flip_valid(torch.as_tensor(feats), torch.as_tensor(nf))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tn.flip_valid(got, torch.as_tensor(nf)).numpy(), feats)


def test_lstm_plain_and_kernel_routes_agree_on_cpu():
    """On CPU tensors the kernel route takes the plain recurrence."""
    feats, nf = _inputs(9)
    _, _, tm = _pair("lstm", 11, 3, seed=9, feats=feats, nf=nf)
    x, n = torch.as_tensor(feats), torch.as_tensor(nf)
    with torch.no_grad():
        np.testing.assert_array_equal(tm(x, n).numpy(), tm(x, n, use_kernels=False).numpy())


def test_build_model_archs():
    cfg = TrainConfig(nn_hidden=8, nn_layers=3, nn_context=2, nn_experts=3)
    kinds = {"mlp": (tn.MlpAm, 3), "lstm": (tn.LstmAm, 2), "blstm": (tn.BlstmAm, 2),
             "tdnn": (tn.TdnnAm, 3), "moe": (tn.MoeAm, 2), "conformer": (tn.ConformerAm, 3)}
    for arch, (cls, layers) in kinds.items():
        m = tn.build_model(arch, P, cfg, D)
        assert isinstance(m, cls) and m.layers == layers and m.hidden == 8
    assert tn.build_model("moe", P, cfg, D).ffn == 16
    assert tn.build_model("conformer", P, cfg, D).enc.d_model == 8  # max(heads * (hidden // heads), heads)
    assert tn.build_model("conformer", P, TrainConfig(nn_hidden=2), D).enc.d_model == 4
    with pytest.raises(ValueError):
        tn.build_model("rnn", P, cfg, D)
    with pytest.raises(TypeError):
        from_flax(torch.nn.Linear(2, 2), {"params": {}})


def test_init_follows_flax_initializers():
    cfg = TrainConfig(nn_hidden=64, nn_layers=3)
    gen = torch.Generator().manual_seed(0)
    lstm = init_(tn.build_model("lstm", P, cfg, 40), gen)
    cell = lstm.cells[0]
    H = 64
    for g in range(4):  # each gate's recurrent kernel is orthogonal
        w = cell.w_rec[:, g * H:(g + 1) * H].detach()
        torch.testing.assert_close(w.T @ w, torch.eye(H), atol=1e-5, rtol=0)
    # lecun_normal: truncated at 2 std of the untruncated scale, std sqrt(1/fan_in)
    w_in = cell.w_in.detach()
    assert abs(float(w_in.std()) - (1 / 40) ** 0.5) < 0.01
    assert float(w_in.abs().max()) <= 2 * (1 / 40) ** 0.5 / 0.87962566103423978 + 1e-6
    assert float(cell.bias.detach().abs().max()) == 0.0
    tdnn = init_(tn.build_model("tdnn", P, cfg, 40), torch.Generator().manual_seed(0))
    assert abs(float(tdnn.convs[1].weight.detach().std()) - (1 / (3 * 64)) ** 0.5) < 0.01
    assert float(tdnn.norms[0].weight.detach().min()) == 1.0
    assert float(tdnn.norms[0].bias.detach().abs().max()) == 0.0
    moe = init_(tn.build_model("moe", P, cfg, 40), torch.Generator().manual_seed(0))
    assert abs(float(moe.blocks[0].W2.detach().std()) - (1 / 128) ** 0.5) < 0.01
    again = init_(tn.build_model("lstm", P, cfg, 40), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(lstm.state_dict().values(), again.state_dict().values()))


def test_moe_block_matches_jax():
    rng = np.random.default_rng(10)
    N, H, E, F = 23, 6, 3, 8
    args = [rng.standard_normal(s).astype(np.float32) * 0.5
            for s in ((N, H), (H, E), (E, H, F), (E, F), (E, F, H), (E, H))]
    valid = rng.random(N) > 0.3
    y, lb = jn.moe_block_dense(*map(jnp.asarray, args), jnp.asarray(valid))
    y2, lb2 = tn.moe_block_dense(*map(torch.as_tensor, args), torch.as_tensor(valid))
    np.testing.assert_allclose(y2.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(lb2), float(lb), rtol=1e-6)


def test_loss_priors_and_hybrid_conversion_match_jax():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 9, P)).astype(np.float32) * 3
    labels = rng.integers(-1, P, (2, 9)).astype(np.int32)
    loss, acc = jn.frame_ce_loss(jnp.asarray(logits), jnp.asarray(labels))
    loss2, acc2 = tn.frame_ce_loss(torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_allclose(float(loss2), float(loss), rtol=1e-6)
    assert float(acc2) == pytest.approx(float(acc), abs=1e-7)
    pri = jn.state_priors(labels, P, smooth=0.5)
    np.testing.assert_array_equal(tn.state_priors(labels, P, smooth=0.5), pri)
    want = np.asarray(jn.posteriors_to_loglik(jnp.asarray(logits), jnp.asarray(pri)))
    got = tn.posteriors_to_loglik(torch.as_tensor(logits), torch.as_tensor(pri)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

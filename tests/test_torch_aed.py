"""The port's attention encoder-decoder (mogasr_torch.am.aed) against the JAX
package's flax modules on the CPU, weights carried by ``from_flax`` at the
reference tests' sizes (d_model 32, 2 encoder blocks, 1 decoder block, 2
heads, kernel 7, 5 units), every leaf drawn at random: the parameter
mapping, the model's forward (within 2e-5), the teacher batch (exactly),
the smoothed CE (1e-5), the training objective and its gradient, one AdamW
step against optax, the beam search in every option (tokens and lengths
identical, scores within 1e-4), and MWER's sequence log-probability, its
objective and gradient."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import aed as J
from mogasr.am import train_nn as jtrain
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr_torch.am import aed as T
from mogasr_torch.am import train_nn as ttrain
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


NU, D, B, TF, L = 5, 9, 3, 37, 6
SIZES = dict(d_model=32, enc_blocks=2, dec_blocks=1, heads=2, conv_kernel=7)
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)


def _random_params(jm, seed):
    """The flax model's parameters with every leaf drawn at random (scale
    0.3): no two leaves equal, so a swapped mapping cannot pass."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((2, 16, D)), jnp.asarray([16, 16]),
                            jnp.zeros((2, 3), jnp.int32))
    leaves, tdef = jax.tree.flatten(shapes)
    return jax.tree.unflatten(tdef, [jnp.asarray(0.3 * rng.standard_normal(x.shape).astype(np.float32))
                                     for x in leaves])


def _pair(chunk):
    jm = J.AedModel(n_units=NU, chunk_frames=chunk, **SIZES)
    params = _random_params(jm, 1 + chunk)
    tm = T.AedModel(NU, D, chunk_frames=chunk, **SIZES)
    tm.load_state_dict(from_flax(tm, params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def offline():
    return _pair(0)


@pytest.fixture(scope="module")
def chunked():
    return _pair(4)


def _batch(seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, TF, D)).astype(np.float32)
    nf = np.asarray([TF, 30, 14], np.int32)
    nl = np.asarray([L, 3, 0], np.int32)
    labels = rng.integers(0, NU, (B, L)).astype(np.int32)
    labels[np.arange(L)[None, :] >= nl[:, None]] = -1
    return feats, nf, labels, nl


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("chunk", [0, 4])
def test_from_flax_maps_every_leaf_once(chunk, offline, chunked):
    """Every torch parameter comes from exactly one flax leaf of its size and
    every leaf is used: matched by their values, which are all distinct."""
    _jm, params, tm = chunked if chunk else offline
    sd = from_flax(tm, params)
    assert set(sd) == set(tm.state_dict())
    leaves = [np.asarray(x) for x in jax.tree.leaves(params)]
    used = []
    for name, value in sd.items():
        assert tuple(value.shape) == tuple(tm.state_dict()[name].shape), name
        hits = [i for i, x in enumerate(leaves)
                if x.size == value.numel() and np.allclose(np.sort(x.ravel()), np.sort(value.numpy().ravel()))]
        assert len(hits) == 1, name
        used += hits
    assert sorted(used) == list(range(len(leaves)))


@pytest.mark.parametrize("chunk", [0, 4])
def test_model_matches_flax(chunk, offline, chunked):
    """``forward``: the decoder logits, and the CTC logits and encoder output
    on each row's valid frames, with ragged n_frames and -1-padded tokens."""
    jm, params, tm = chunked if chunk else offline
    feats, nf, labels, nl = _batch(3)
    dec_in = np.concatenate([np.full((B, 1), NU, np.int32), labels], axis=1)
    wl, wc, wn = jax.tree.map(np.asarray, jm.apply(params, jnp.asarray(feats), jnp.asarray(nf), jnp.asarray(dec_in)))
    we, _ = jm.apply(params, jnp.asarray(feats), jnp.asarray(nf), method=J.AedModel.encode)
    with torch.no_grad():
        gl, gc, gn = tm(*_t(feats, nf, dec_in))
        ge, _ = tm.encode(*_t(feats, nf))
    assert gn.tolist() == wn.tolist()
    np.testing.assert_allclose(gl.numpy(), wl, **TOL)
    for b in range(B):
        np.testing.assert_allclose(gc[b, : wn[b]].numpy(), wc[b, : wn[b]], **TOL)
        np.testing.assert_allclose(ge[b, : wn[b]].numpy(), np.asarray(we)[b, : wn[b]], **TOL)
    assert T._sin_positions(11, 33).tobytes() == J._sin_positions(11, 33).tobytes()


def test_build_and_teacher_batch_match_the_reference():
    """``build_aed_model``'s derived sizes; ``make_teacher_batch`` exactly;
    ``smoothed_ce`` within 1e-5."""
    for hidden, layers in ((256, 4), (512, 3), (30, 1)):
        jm = J.build_aed_model(NU, JaxTrainConfig(nn_hidden=hidden, nn_layers=layers))
        tm = T.build_aed_model(NU, TrainConfig(nn_hidden=hidden, nn_layers=layers), D)
        assert (tm.d_model, tm.enc_blocks, tm.dec_blocks, tm.heads) == (jm.d_model, jm.enc_blocks,
                                                                        jm.dec_blocks, jm.heads)
    _f, _n, labels, nl = _batch(4)
    want = [np.asarray(x) for x in J.make_teacher_batch(jnp.asarray(labels), jnp.asarray(nl), NU, NU + 1)]
    got = T.make_teacher_batch(*_t(labels, nl), NU, NU + 1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((B, L + 1, NU + 2)).astype(np.float32)
    np.testing.assert_allclose(
        T.smoothed_ce(torch.as_tensor(logits), got[1], got[2], 0.1).numpy(),
        np.asarray(J.smoothed_ce(jnp.asarray(logits), jnp.asarray(want[1]), jnp.asarray(want[2]), 0.1)),
        rtol=1e-5, atol=1e-5)


def _grads(model):
    """Every parameter's gradient, zeros where none reached it (as jax.grad
    gives them)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("chunk", [0, 4])
def test_objective_and_gradient_match_jax(chunk, offline, chunked):
    """``aed_objective`` (CE over n_labels + 1, CTC over max(n_labels, 1),
    the plain CTC recursion on the CPU): the loss, its metrics, and the
    gradient of every parameter against ``jax.value_and_grad``, with a
    batch-padding row of 0 frames."""
    jm, params, tm = chunked if chunk else offline
    feats, nf, labels, nl = _batch(6)
    nf[2] = 0

    def jloss(p):
        return J.aed_objective(jm, p, jnp.asarray(feats), jnp.asarray(nf), jnp.asarray(labels), jnp.asarray(nl))

    (wl, wm), wg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm.zero_grad()
    loss, met = T.aed_objective(tm, *_t(feats, nf, labels, nl))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5)
    for key in ("ce", "ctc"):
        np.testing.assert_allclose(met[key].item(), float(wm[key]), rtol=1e-5, err_msg=key)
    want = from_flax(tm, wg)
    for name, g in _grads(tm).items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
    tm.zero_grad(set_to_none=True)


def test_train_step_matches_optax():
    """Two ``make_aed_train_step`` steps (SpecAugment off) against the
    reference's jitted step: the metrics of each, the first step's clipped
    gradients in Adam's first moments, the parameters after the second."""
    jcfg = JaxTrainConfig(lr=1e-2, num_nn_steps=40, nn_hidden=32, nn_layers=1)
    cfg = TrainConfig(lr=1e-2, num_nn_steps=40, nn_hidden=32, nn_layers=1)
    jm = J.build_aed_model(NU, jcfg, heads=2)
    params = _random_params(jm, 3)
    jstate = J.AedTrainState(params, jtrain.make_optimizer(jcfg).init(params), jnp.zeros((), jnp.int32))
    tm = T.build_aed_model(NU, cfg, D, heads=2)
    tm.load_state_dict(from_flax(tm, params))
    jstep = J.make_aed_train_step(jm, jcfg)
    state, step = T.init_aed_train_state(tm, cfg), T.make_aed_train_step(tm, cfg)
    for k in range(2):
        f, n, lab, nl = _batch(20 + k)
        jstate, jmet = jstep(jstate, jnp.asarray(f), jnp.asarray(n), jnp.asarray(lab), jnp.asarray(nl))
        state, met = step(state, *_t(f, n, lab, nl))
        for key in ("loss", "ce", "ctc"):
            np.testing.assert_allclose(met[key], float(jmet[key]), rtol=1e-5, err_msg=f"step {k} {key}")
        if k == 0:
            mu = from_flax(tm, jstate.opt_state[1][0].mu)
            for name, p in tm.named_parameters():
                np.testing.assert_allclose(10 * state.opt.state[p]["exp_avg"].numpy(), 10 * mu[name].numpy(),
                                           err_msg=name, **GRAD_TOL)
    assert state.step == int(jstate.step) == 2
    want = from_flax(tm, jstate.params)
    for name, value in tm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
    assert isinstance(state, ttrain.TrainState)


def _unit_lm(seed):
    rng = np.random.default_rng(seed)

    def norm(x):
        return x - np.log(np.exp(x).sum(-1, keepdims=True))

    return types.SimpleNamespace(n_units=NU, pair_logp=norm(rng.standard_normal((NU, NU))).astype(np.float32),
                                 init_logp=norm(rng.standard_normal(NU)).astype(np.float32))


BEAMS = {
    "greedy": dict(beam=1),
    "beam4": dict(beam=4),
    "beam4_scan": dict(beam=4, early_exit=False),
    "beam4_ctc": dict(beam=4, ctc_weight=0.3),
    "beam4_ctc_scan": dict(beam=4, ctc_weight=0.3, early_exit=False),
    "beam1_ctc": dict(beam=1, ctc_weight=0.3),
    "length_penalty": dict(beam=4, length_penalty=0.6),
    "fusion": dict(beam=4, fusion=True),
    "return_all": dict(beam=4, return_all=True, ctc_weight=0.3),
}


@pytest.mark.parametrize("name", list(BEAMS))
def test_beam_search_matches_jax(name, chunked):
    """``make_aed_decoder`` (the chunked model) against the reference's
    jitted beam with the same options: tokens and lengths identical, scores
    within 1e-4; the early exit gives the fixed scan's tokens. Rows: ragged,
    one of 3 frames (a hypothesis longer than its subsampled frames scores
    ~1e30 on CTC)."""
    jm, params, tm = chunked
    opts = dict(BEAMS[name])
    if opts.pop("fusion", False):
        opts["fusion"] = J.aed_fusion_matrix(jm, _unit_lm(9), 0.5)
        np.testing.assert_array_equal(T.aed_fusion_matrix(tm, _unit_lm(9), 0.5), np.asarray(opts["fusion"]))
    feats, _nf, _l, _n = _batch(8)
    nf = np.asarray([TF, 22, 3], np.int32)
    want = [np.asarray(x) for x in J.make_aed_decoder(jm, params, max_tokens=9, **opts)(jnp.asarray(feats),
                                                                                        jnp.asarray(nf))]
    got = [x.numpy() for x in T.make_aed_decoder(tm, max_tokens=9, **opts)(feats, nf)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-4)
    if opts.get("early_exit", True):
        scan = T.make_aed_decoder(tm, max_tokens=9, **{**opts, "early_exit": False})(feats, nf)
        np.testing.assert_array_equal(scan[0].numpy(), got[0])
        np.testing.assert_array_equal(scan[2].numpy(), got[2])


def test_decode_batch_matches_jax(offline):
    """``aed_decode_batch``'s unit lists (the offline model), with the joint
    CTC rescoring."""
    jm, params, tm = offline
    feats, nf, _l, _n = _batch(10)
    want = J.aed_decode_batch(jm, params, jnp.asarray(feats), jnp.asarray(nf), beam=3, max_tokens=8, ctc_weight=0.3)
    assert T.aed_decode_batch(tm, feats, nf, beam=3, max_tokens=8, ctc_weight=0.3) == want


def test_mwer_matches_jax(chunked):
    """``aed_seq_logprob`` on its own, and ``aed_mwer_objective`` (with its
    CE anchor) and its gradient, on an N-best with a masked slot and a
    padding row."""
    jm, params, tm = chunked
    feats, nf, labels, nl = _batch(11)
    nf[2] = 0
    rng = np.random.default_rng(12)
    N, U = 3, 7
    n_h = rng.integers(0, U + 1, (B, N)).astype(np.int32)
    hyps = rng.integers(0, NU, (B, N, U)).astype(np.int32)
    hyps[np.arange(U)[None, None, :] >= n_h[..., None]] = -1
    mask = np.asarray([[True, True, False], [True, False, True], [True, True, True]])
    risks = rng.integers(0, 5, (B, N)).astype(np.float32)

    @jax.jit
    def seq_lp(p, f, n, h, nh):
        enc, n_out = jm.apply(p, f, n, method=J.AedModel.encode)
        return J.aed_seq_logprob(jm, p, enc, n_out, h, nh)

    want_lp = np.asarray(seq_lp(params, jnp.asarray(feats), jnp.asarray(nf), jnp.asarray(hyps[:, 0]),
                                jnp.asarray(n_h[:, 0])))
    with torch.no_grad():
        tenc, tn_out = tm.encode(*_t(feats, nf))
        got_lp = T.aed_seq_logprob(tm, tenc, tn_out, *_t(hyps[:, 0], n_h[:, 0]))
    np.testing.assert_allclose(got_lp.numpy()[:2], want_lp[:2], rtol=1e-5, atol=1e-4)

    args = (feats, nf, hyps, n_h, mask, risks, labels, nl)

    def jloss(p):
        return J.aed_mwer_objective(jm, p, *map(jnp.asarray, args))

    (wl, wm), wg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm.zero_grad()
    loss, met = T.aed_mwer_objective(tm, *_t(*args))
    loss.backward()
    for key in ("loss", "mwer", "expected_risk", "ce"):
        np.testing.assert_allclose(met[key].item(), float(wm[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    want = from_flax(tm, wg)
    for name, g in _grads(tm).items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
    tm.zero_grad(set_to_none=True)

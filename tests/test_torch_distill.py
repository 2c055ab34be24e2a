"""The port's CTC distillation (mogasr_torch.am.distill and
pipeline.distill_ctc_units) against the JAX package on the CPU: the masked
frame KL against the reference's and its numpy oracle, two distillation
steps from the same flax parameters (an LstmAm student, an MlpAm teacher),
and the pipeline function's student."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import ctc as jctc
from mogasr.am import distill as jdistill
from mogasr.am import neural as jn
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import ctc
from mogasr_torch.am import distill
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


D, V = 6, 6


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("tau", [1.0, 2.0])
def test_distill_kl_matches_jax_and_oracle(tau):
    rng = np.random.default_rng(0)
    s, t = (rng.standard_normal((3, 11, V)).astype(np.float32) for _ in range(2))
    nf = np.asarray([11, 4, 0], np.int32)
    got = distill.distill_kl(torch.as_tensor(s), torch.as_tensor(t), torch.as_tensor(nf), tau).item()
    np.testing.assert_allclose(got, float(jdistill.distill_kl(jnp.asarray(s), jnp.asarray(t), jnp.asarray(nf), tau)),
                               rtol=1e-5)
    np.testing.assert_allclose(got, distill.distill_kl_oracle_np(s, t, nf, tau), rtol=1e-5)
    assert distill.distill_kl_oracle_np(s, t, nf, tau) == jdistill.distill_kl_oracle_np(s, t, nf, tau)


def _models(arch, cfg_kw, seed):
    jcfg = JaxTrainConfig(lr=1e-2, num_nn_steps=40, **cfg_kw)
    jm = jn.build_model(arch, V, jcfg)
    jstate = jctc.init_ctc_train_state(jm, jcfg, D, jax.random.key(seed))
    tm = tn.build_model(arch, V, TrainConfig(lr=1e-2, num_nn_steps=40, **cfg_kw), D)
    tm.load_state_dict(from_flax(tm, jstate.params))
    return jcfg, jm, jstate, tm


def test_distill_steps_match_jax():
    """Two of the reference's jitted distillation steps (alpha 0.5, tau 2)
    against ``make_distill_train_step``: each step's loss, kl, ctc and
    utt_nll (rtol 1e-5) and the student's parameters after the second."""
    jcfg, jm, jstate, sm = _models("lstm", dict(nn_hidden=10, nn_layers=2), 1)
    _tc, jt, jtstate, tm = _models("mlp", dict(nn_hidden=12, nn_layers=2, nn_context=1), 2)
    jstep = jdistill.make_distill_train_step(jm, jt, jtstate.params, jcfg, alpha=0.5, temperature=2.0)
    cfg = TrainConfig(lr=1e-2, num_nn_steps=40, nn_hidden=10, nn_layers=2)
    state, step = ctc.init_ctc_train_state(sm, cfg), distill.make_distill_train_step(tm, cfg, alpha=0.5,
                                                                                     temperature=2.0)
    rng = np.random.default_rng(3)
    for k in range(2):
        f = rng.standard_normal((3, 12, D)).astype(np.float32)
        nf = np.asarray([12, 7, 0], np.int32)
        lab = np.asarray([[1, 1, 3], [0, 2, -1], [-1, -1, -1]], np.int32)
        nl = np.asarray([3, 2, 0], np.int32)
        jstate, jmet = jstep(jstate, *(jnp.asarray(a) for a in (f, nf, lab, nl)))
        state, met = step(state, *(torch.as_tensor(a) for a in (f, nf, lab, nl)))
        for key in ("loss", "kl", "ctc", "utt_nll"):
            np.testing.assert_allclose(met[key], float(jmet[key]), rtol=1e-5, err_msg=f"step {k} {key}")
    want = from_flax(sm, jstate.params)
    for name, value in sm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_distill_ctc_units_trains_a_student():
    """``pipeline.distill_ctc_units``: a fresh LstmAm student over the
    teacher's units takes the steps asked for; its weights move and stay
    finite, the teacher's do not move."""
    rng = np.random.default_rng(4)
    feats = torch.as_tensor(rng.standard_normal((2, 10, D)).astype(np.float32))
    fbs = [pipe.FeatBatch(["a", "b"], feats, torch.as_tensor([10, 6], dtype=torch.int32), [["x"], ["y", "x"]])]
    enc = {"x": [0, 1], "y": [2]}
    cfg = TrainConfig(num_nn_steps=3, nn_hidden=8, nn_layers=2)
    teacher = init_(tn.build_model("mlp", 4, TrainConfig(nn_hidden=8, nn_layers=2, nn_context=1), D),
                    torch.Generator().manual_seed(1))
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    logs = []
    model, sd = pipe.distill_ctc_units(fbs, teacher, lambda ws: sum((enc[w] for w in ws), []), 3, cfg,
                                       student_arch="lstm", logger=SimpleNamespace(log=logs.append))
    fresh = pipe._ctc_model("lstm", 3, cfg, fbs).state_dict()
    assert isinstance(model, tn.LstmAm) and sd["head.weight"].shape == (4, 8)
    assert all(torch.isfinite(v).all() for v in sd.values())
    assert not torch.equal(sd["head.weight"], fresh["head.weight"])
    assert all(torch.equal(v, t_before[k]) for k, v in teacher.state_dict().items())

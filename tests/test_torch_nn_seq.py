"""The port's sequence training of the hybrid NN (mogasr_torch.am.nn_seq)
against the JAX package on the CPU: the gradients of ``FbLoglik`` and
``SmbrAcc`` (the forward-backward's loglik and the expected frame accuracy,
with the posterior identities as their backward) against ``jax.grad``
through the reference's forward-backward scan, at the reference's inputs
and tolerances (tests/test_nn_seq.py); the plain autograd route against the
Functions; and the reference's MMI and sMBR steps (``make_nn_{mmi,smbr}_
step``) against the port's on the same weights and graphs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import neural as jn
from mogasr.am import nn_seq as jseq
from mogasr.am import train_nn as jtrain
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr.decoder import forward_backward as jfbd
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import neural as tn
from mogasr_torch.am import nn_seq
from mogasr_torch.am import train_nn as ttrain
from mogasr_torch.am.params import from_flax
from mogasr_torch.config import DecodeConfig, TopologyConfig, TrainConfig
from mogasr_torch.data.synthetic import LEXICON
from mogasr_torch.decoder.viterbi import graphs_to_torch
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm.lexicon import make_lexicon
from mogasr_torch.hmm.topology import build_topology


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KAPPA = 0.3
FB_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_nn_seq.py::test_fb_loglik_grad_equals_pdf_occupancies
SMBR_TOL = dict(rtol=2e-3, atol=2e-4)    # tests/test_nn_seq.py::test_smbr_autodiff_grad_equals_signed_weights


@pytest.fixture(scope="module")
def system():
    lex = make_lexicon({w: LEXICON[w] for w in ["cat", "dog"]})
    topo = build_topology(lex, TopologyConfig())
    return lex, topo


def _both(graphs_np):
    return graphs_to_torch(graphs_np, torch.device("cpu")), {k: jnp.asarray(v) for k, v in graphs_np.items()}


def test_fb_loglik_gradient_matches_jax(system):
    """d sum(loglik) / d emit_ll on the align graphs (40 and 32 frames, as the
    reference's test), FbLoglik against jax.grad, and the plain autograd
    route against FbLoglik."""
    lex, topo = system
    graphs, jgraphs = _both(pipe.build_align_graphs([["cat"], ["dog", "cat"]], lex, topo))
    rng = np.random.default_rng(0)
    ll = rng.standard_normal((2, 40, topo.n_pdfs)).astype(np.float32)
    nf = np.asarray([40, 32], np.int32)
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jfbd.forward_backward(
        x, jgraphs, jnp.asarray(nf), acoustic_scale=KAPPA).loglik)))(jnp.asarray(ll)))
    grads = {}
    for use_kernels in (True, False):
        x = torch.tensor(ll, requires_grad=True)
        out = nn_seq.fb_loglik(x, graphs, torch.as_tensor(nf), KAPPA, use_kernels)
        assert bool((out > -1e29).all())  # a feasible path
        out.sum().backward()
        grads[use_kernels] = x.grad.numpy()
    np.testing.assert_allclose(grads[True], want, **FB_TOL)
    np.testing.assert_allclose(grads[False], grads[True], **FB_TOL)
    assert not grads[True][1, 32:].any()  # padded frames carry no gradient


def test_smbr_acc_gradient_matches_jax(system):
    """d sum(E[acc]) / d emit_ll over the word loop (24 and 17 frames, random
    reference pdfs, as the reference's test): SmbrAcc against jax.grad of
    the reference's gamma-dot-accuracy, and E[acc] itself."""
    lex, topo = system
    den = pipe.word_decode_graph(lex, topo, DecodeConfig(acoustic_scale=KAPPA))
    graphs, jgraphs = _both(gr.batch_graphs([den, den]))
    rng = np.random.default_rng(1)
    T = 24
    ll = rng.standard_normal((2, T, topo.n_pdfs)).astype(np.float32)
    ref = rng.integers(0, topo.n_pdfs, (2, T)).astype(np.int32)
    nf = np.asarray([24, 17], np.int32)
    mask = np.arange(T)[None, :] < nf[:, None]
    ref = np.where(mask, ref, -1).astype(np.int32)

    def e_acc_total(x):
        res = jfbd.forward_backward(x, jgraphs, jnp.asarray(nf), acoustic_scale=KAPPA)
        acc = jgraphs["emit_id"][:, None, :] == jnp.asarray(ref)[:, :, None]
        gam = jnp.where(jnp.asarray(mask)[..., None], jnp.exp(jnp.maximum(res.log_gamma, -80.0)), 0.0)
        return jnp.sum(gam * acc.astype(gam.dtype))

    want_val, want = jax.jit(jax.value_and_grad(e_acc_total))(jnp.asarray(ll))
    x = torch.tensor(ll, requires_grad=True)
    acc = nn_seq.smbr_accuracy(x, graphs, torch.as_tensor(ref), torch.as_tensor(nf), KAPPA)
    acc.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **SMBR_TOL)
    np.testing.assert_allclose(acc.sum().item(), float(want_val), rtol=1e-4)


@pytest.fixture(scope="module")
def seq_setup(system):
    """An MlpAm in both packages (the same flax weights), random features,
    the align and word-loop graphs, reference pdfs and priors."""
    lex, topo = system
    P = topo.n_pdfs
    kw = dict(nn_hidden=8, nn_layers=2, nn_context=1, lr=1e-2, num_nn_steps=20)
    jm = jn.build_model("mlp", P, JaxTrainConfig(**kw))
    D = 5
    params = {"params": jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, 8, D)), jnp.asarray([8, 8]))["params"]}
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 40, D)).astype(np.float32)
    nf = np.asarray([40, 33], np.int32)
    ref = rng.integers(0, P, (2, 40)).astype(np.int32)
    ref[np.arange(40)[None, :] >= nf[:, None]] = -1
    log_priors = np.log(rng.dirichlet(np.ones(P))).astype(np.float32)
    num_np = pipe.build_align_graphs([["cat"], ["dog", "cat"]], lex, topo)
    den_np = gr.batch_graphs([pipe.word_decode_graph(lex, topo, DecodeConfig(acoustic_scale=0.1))] * 2)
    return jm, params, kw, P, D, feats, nf, ref, log_priors, num_np, den_np


def _port_model(jm_params, kw, P, D):
    tm = tn.build_model("mlp", P, TrainConfig(**kw), D)
    tm.load_state_dict(from_flax(tm, jm_params))
    return tm


@pytest.mark.parametrize("criterion", ["mmi", "smbr"])
def test_sequence_steps_match_jax(seq_setup, criterion):
    """Two steps (the first at learning rate 0, as the schedule starts, so
    the second moves the weights) of the reference's jitted step against the
    port's: the criterion of each step and the weights after the second."""
    jm, params, kw, P, D, feats, nf, ref, log_priors, num_np, den_np = seq_setup
    jcfg, cfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    tm = _port_model(params, kw, P, D)
    jstate = jtrain.TrainState(params, jtrain.make_optimizer(jcfg).init(params), jnp.zeros((), jnp.int32))
    state = ttrain.init_train_state(tm, cfg)
    num, jnum = _both(num_np)
    den, jden = _both(den_np)
    x, n = torch.as_tensor(feats), torch.as_tensor(nf)
    if criterion == "mmi":
        jstep = jseq.make_nn_mmi_step(jm, jcfg, jnp.asarray(log_priors), acoustic_scale=0.1)
        step = nn_seq.make_nn_mmi_step(cfg, torch.as_tensor(log_priors), acoustic_scale=0.1)
        args, jargs, key = (num, den), (jnum, jden), "mmi_per_frame"
    else:
        jstep = jseq.make_nn_smbr_step(jm, jcfg, jnp.asarray(log_priors), acoustic_scale=0.1)
        step = nn_seq.make_nn_smbr_step(cfg, torch.as_tensor(log_priors), acoustic_scale=0.1)
        args, jargs, key = (den, torch.as_tensor(ref)), (jden, jnp.asarray(ref)), "acc_per_frame"
    for k in range(2):
        jstate, jmet = jstep(jstate, jnp.asarray(feats), jnp.asarray(nf), *jargs)
        state, met = step(state, x, n, *args)
        np.testing.assert_allclose(met[key], float(jmet[key]), rtol=1e-4, err_msg=f"step {k}")
        np.testing.assert_allclose(met["loss"], -met[key])
    want = from_flax(tm, jstate.params)
    for name, value in tm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_finetune_loops_log_and_refuse_empty(seq_setup, system):
    """finetune_nn_mmi/smbr over a batch: one history entry a step, the
    logger's records, the model trained in place; no batches raises."""
    lex, topo = system
    jm, params, kw, P, D, feats, nf, ref, log_priors, _num_np, _den_np = seq_setup
    tm = _port_model(params, kw, P, D)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    fb = pipe.FeatBatch(["a", "b"], torch.as_tensor(feats), torch.as_tensor(nf), [["cat"], ["dog", "cat"]])

    class Log:
        records = []

        def log(self, rec):
            self.records.append(rec)

    log = Log()
    model, hist = nn_seq.finetune_nn_mmi([fb], lex, topo, tm, log_priors, TrainConfig(**kw), steps=3, logger=log)
    assert model is tm and len(hist) == 3 and np.isfinite(hist).all()
    model, shist = nn_seq.finetune_nn_smbr([(fb, torch.as_tensor(ref))], lex, topo, tm, log_priors,
                                           TrainConfig(**kw), steps=2, logger=log)
    assert len(shist) == 2 and all(0.0 <= a <= 1.0 for a in shist)
    assert [(r["stage"], r["step"]) for r in log.records] == [("nn_mmi", 3), ("nn_smbr", 2)]
    assert any(not torch.equal(before[k], v) for k, v in tm.state_dict().items())
    with pytest.raises(ValueError, match="no batches"):
        nn_seq.finetune_nn_mmi([], lex, topo, tm, log_priors, TrainConfig(**kw), steps=1)

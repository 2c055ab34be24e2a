"""mogasr_torch forward-backward against the JAX scan
(decoder/forward_backward.py) and the interpret-mode Pallas kernels
(decoder/fb_pallas.py): loglik and state log-posteriors on align, phone-loop
and CTC-skip graphs with ragged batches (n_frames of T, 1 and 0) at acoustic
scale 0.8; posterior normalisation, padding invariance, the pdf collapse, and
the kernel wrapper's CPU dispatch, skip graphs included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.config import TopologyConfig
from mogasr.decoder import forward_backward as jax_fb
from mogasr.decoder.fb_pallas import forward_backward_pallas
from mogasr.hmm import graph as gr
from mogasr.hmm.lexicon import make_lexicon
from mogasr.hmm.topology import build_topology
from mogasr_torch.decoder import fb_cuda
from mogasr_torch.decoder import forward_backward as fbd
from mogasr_torch.decoder import viterbi as vit

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def topo():
    lex = make_lexicon({"ab": ["a", "b"], "ba": ["b", "a"], "aa": ["a", "a"]})
    return build_topology(lex, TopologyConfig(states_per_phone=2, sil_states=1))


def _graphs_np(topo, kind):
    lex = topo.lexicon
    if kind == "loop":
        return gr.batch_graphs([gr.loop_graph(topo)] * 4)
    gs = gr.batch_graphs([gr.align_graph(topo, lex.words_to_phone_ids(["ab"], edge_sil=True)),
                          gr.align_graph(topo, lex.words_to_phone_ids(["ab", "ba"])),
                          gr.align_graph(topo, lex.words_to_phone_ids(["aa"])),
                          gr.align_graph(topo, lex.words_to_phone_ids(["ba"]))])
    if kind == "skip":
        # CTC-style (j-2 -> j) skips inside every chain
        chain = gs["chain_id"]
        same = np.zeros_like(chain, bool)
        same[:, 2:] = (chain[:, 2:] == chain[:, :-2]) & (chain[:, 2:] >= 0)
        gs["skip_logp"] = np.where(same, np.float32(-0.7), gr.NEG_INF).astype(np.float32)
    return gs


def _inputs(topo, T=14, seed=2):
    rng = np.random.default_rng(seed)
    emit = rng.standard_normal((4, T, topo.n_pdfs)).astype(np.float32)
    return emit, np.asarray([T, 1, 0, 9], np.int32)


def _torch(graphs_np):
    return vit.graphs_to_torch(graphs_np, CPU)


def _jax(graphs_np):
    return {k: jnp.asarray(v) for k, v in graphs_np.items()}


@pytest.mark.parametrize("kind", ["align", "loop", "skip"])
def test_matches_jax_forward_backward(topo, kind):
    graphs_np = _graphs_np(topo, kind)
    emit, nf = _inputs(topo)
    ref = jax_fb.forward_backward(jnp.asarray(emit), _jax(graphs_np), jnp.asarray(nf), acoustic_scale=0.8)
    got = fbd.forward_backward(torch.as_tensor(emit), _torch(graphs_np), torch.as_tensor(nf),
                               acoustic_scale=0.8)
    # the same float32 recursion, op for op; XLA and PyTorch round the
    # logsumexp's sum in their own order
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(ref.loglik), rtol=1e-6)
    np.testing.assert_allclose(got.log_gamma.numpy(), np.asarray(ref.log_gamma), rtol=1e-5, atol=1e-5)
    assert (got.log_gamma.numpy()[2] == fbd.NEG_INF).all()  # n_frames == 0
    assert (got.log_gamma.numpy()[1, 1:] == fbd.NEG_INF).all()


@pytest.mark.parametrize("kind", ["align", "loop"])
def test_pallas_kernels_match_plain(topo, kind):
    """fb_pallas in interpret mode against the port's plain version, with
    tests/test_fb_pallas.py's tolerances."""
    graphs_np = _graphs_np(topo, kind)
    emit, nf = _inputs(topo, T=12, seed=4)
    nf = np.asarray([12, 8, 5, 1], np.int32)
    ref = forward_backward_pallas(jnp.asarray(emit), _jax(graphs_np), jnp.asarray(nf),
                                  acoustic_scale=0.8, interpret=True)
    got = fbd.forward_backward(torch.as_tensor(emit), _torch(graphs_np), torch.as_tensor(nf),
                               acoustic_scale=0.8)
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(ref.loglik), rtol=1e-5, atol=1e-5)
    for b, n in enumerate(nf):
        r = np.asarray(ref.log_gamma[b, :n])
        g = got.log_gamma.numpy()[b, :n]
        sel = r > -30
        np.testing.assert_allclose(g[sel], r[sel], rtol=1e-4, atol=1e-4)
        assert (g[~sel] < -25).all()


def test_posteriors_normalize(topo):
    graphs_np = _graphs_np(topo, "loop")
    emit, nf = _inputs(topo, T=9, seed=5)
    got = fbd.forward_backward(torch.as_tensor(emit), _torch(graphs_np), torch.as_tensor(nf))
    for b, n in enumerate(nf):
        gamma = np.exp(got.log_gamma.numpy()[b, :n])
        np.testing.assert_allclose(gamma.sum(axis=1), 1.0, rtol=1e-4)


def test_padding_invariance(topo):
    graphs_np = _graphs_np(topo, "align")
    rng = np.random.default_rng(6)
    T = 10
    emit = rng.standard_normal((4, T, topo.n_pdfs)).astype(np.float32)
    nf = torch.as_tensor([6, 6, 6, 6])
    base = fbd.forward_backward(torch.as_tensor(emit), _torch(graphs_np), nf)
    trashed = emit.copy()
    trashed[:, 6:] = rng.standard_normal(trashed[:, 6:].shape) * 40
    got = fbd.forward_backward(torch.as_tensor(trashed), _torch(graphs_np), nf)
    torch.testing.assert_close(got.loglik, base.loglik, rtol=0, atol=0)
    torch.testing.assert_close(got.log_gamma, base.log_gamma, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["align", "loop"])
def test_state_posteriors_to_pdf_matches_jax(topo, kind):
    graphs_np = _graphs_np(topo, kind)
    emit, nf = _inputs(topo, seed=7)
    ref = jax_fb.forward_backward(jnp.asarray(emit), _jax(graphs_np), jnp.asarray(nf))
    want = jax_fb.state_posteriors_to_pdf(ref.log_gamma, jnp.asarray(graphs_np["emit_id"]), topo.n_pdfs)
    got = fbd.state_posteriors_to_pdf(torch.as_tensor(np.array(ref.log_gamma)),
                                      torch.as_tensor(graphs_np["emit_id"]), topo.n_pdfs)
    assert got.shape == (4, emit.shape[1], topo.n_pdfs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.numpy().sum(-1)[0], 1.0, rtol=1e-5)


def test_float64_run(topo):
    """The float64 call that the kernels are held against on the card."""
    graphs_np = _graphs_np(topo, "align")
    emit, nf = _inputs(topo, seed=8)
    r32 = fbd.forward_backward(torch.as_tensor(emit), _torch(graphs_np), torch.as_tensor(nf))
    r64 = fbd.forward_backward(torch.as_tensor(emit).double(), _torch(graphs_np), torch.as_tensor(nf))
    assert r64.log_gamma.dtype == torch.float64
    ok = r64.loglik > fbd.NEG_INF / 2
    torch.testing.assert_close(r32.loglik[ok].double(), r64.loglik[ok], rtol=1e-6, atol=0)


def test_kernel_wrapper_on_cpu_is_plain(topo):
    graphs_np = _graphs_np(topo, "loop")
    emit, nf = _inputs(topo)
    before = (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES)
    got = fb_cuda.forward_backward(torch.as_tensor(emit), _torch(graphs_np), torch.as_tensor(nf),
                                   acoustic_scale=0.8)
    want = fbd.forward_backward(torch.as_tensor(emit), _torch(graphs_np), torch.as_tensor(nf),
                                acoustic_scale=0.8)
    assert (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES) == before  # no kernel on the CPU
    torch.testing.assert_close(got.loglik, want.loglik, rtol=0, atol=0)
    torch.testing.assert_close(got.log_gamma, want.log_gamma, rtol=0, atol=0)


def test_kernel_wrapper_rejects_skip_and_other_devices(topo):
    """K3f/K3b have a skip arm, so the wrapper takes skip graphs: on the CPU
    it is the plain version, exactly, and no launch. A device other than
    the CPU and CUDA is rejected."""
    emit, nf = _inputs(topo)
    before = (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES)
    got = fb_cuda.forward_backward(torch.as_tensor(emit), _torch(_graphs_np(topo, "skip")), torch.as_tensor(nf))
    want = fbd.forward_backward(torch.as_tensor(emit), _torch(_graphs_np(topo, "skip")), torch.as_tensor(nf))
    assert (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES) == before
    torch.testing.assert_close(got.loglik, want.loglik, rtol=0, atol=0)
    torch.testing.assert_close(got.log_gamma, want.log_gamma, rtol=0, atol=0)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        fb_cuda.forward_backward(torch.empty(emit.shape, device=meta),
                                 vit.graphs_to_torch(_graphs_np(topo, "loop"), meta), torch.as_tensor(nf))

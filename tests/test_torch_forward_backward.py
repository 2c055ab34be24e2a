"""mogasr_torch forward-backward against the JAX scan
(decoder/forward_backward.py) and the interpret-mode Pallas kernels
(decoder/fb_pallas.py): loglik and state log-posteriors on align, phone-loop
and CTC-skip graphs with ragged batches (n_frames of T, 1 and 0) at acoustic
scale 0.8; posterior normalisation, padding invariance, the pdf collapse,
the kernel wrapper's CPU dispatch, skip graphs included; and the premise of
the kernels' chain arm: align graphs have no loop arc, and dropping the loop
term on them changes no live value (a test-local copy of the plain passes
without it, held bitwise to the plain version), with the plain version
against JAX on tied-triphone align graphs at the training batch's width."""

import os

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
from mogasr_torch import pipeline as pipe
from mogasr_torch.data.synthetic import extended_lexicon
from mogasr_torch.decoder import fb_cuda
from mogasr_torch.decoder import forward_backward as fbd
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.utils.bundle import load_system


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmarks", "headline")


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


# ---- the chain arm's premise (csrc/forward_backward.cu)


@pytest.fixture(scope="module")
def headline():
    """The headline bundle's topology and tied triphones."""
    _gmm, topo, _fcfg, tied, _meta = load_system(BUNDLE, CPU)
    return topo, tied


def _word_lists(topo, tied, n_rows, j_lo, j_hi, seed):
    """Seeded transcripts of the training corpus's vocabulary (300 words,
    3-9 words each) whose longest CD align graph has j_lo < J <= j_hi
    states, with an empty transcript (a batch's dummy row) last."""
    words = sorted(extended_lexicon(300))
    rng = np.random.default_rng(seed)
    while True:
        rows = [[words[i] for i in rng.integers(0, len(words), rng.integers(3, 10))] for _ in range(n_rows - 1)]
        longest = max(tri.align_graph_cd(tied, topo.lexicon.words_to_phone_ids(w, oov="sil")).n_states
                      for w in rows)
        if j_lo < longest <= j_hi:
            return rows + [[]]


def _align_graphs_np(topo, tied, kind, n_rows=6, seed=11):
    rows = _word_lists(topo, tied, n_rows, 128, 192, seed)
    align_fn = None if kind == "mono" else (lambda p: tri.align_graph_cd(tied, p))
    graphs = pipe.build_align_graphs(rows, topo.lexicon, topo, align_fn=align_fn)
    if kind == "cd_skip":
        chain = graphs["chain_id"]
        same = np.zeros_like(chain, bool)
        same[:, 2:] = (chain[:, 2:] == chain[:, :-2]) & (chain[:, 2:] >= 0)
        graphs["skip_logp"] = np.where(same, np.float32(-0.1), gr.NEG_INF).astype(np.float32)
    return graphs


@pytest.mark.parametrize("kind", ["mono", "cd"])
def test_align_graphs_have_no_loop_arc(headline, kind):
    """Every enter_logp and exit_logp of a batch of align graphs, monophone
    and tied-triphone (J padded to a multiple of 64, a dummy row's silence
    graph and the padding states included), is NEG_INF: the condition under
    which the kernels take their chain arm."""
    topo, tied = headline
    graphs = _align_graphs_np(topo, tied, kind)
    J = graphs["emit_id"].shape[1]
    assert J % 64 == 0 and graphs["n_states"].min() < J
    for key in ("enter_logp", "exit_logp"):
        assert graphs[key].dtype == np.float32 and (graphs[key] == np.float32(fbd.NEG_INF)).all(), key


def _chain_forward_backward(emit_ll, graphs, n_frames):
    """The plain forward and backward passes (decoder/forward_backward.py)
    with the loop term left out -- no exit/enter logsumexp, no ent/ext
    logaddexp -- as the kernels' chain arm computes them."""
    emit_graph = fbd.gather_emissions(emit_ll, graphs["emit_id"], 1.0)
    B, T, J = emit_graph.shape
    sl, al, init, final = (graphs[k] for k in ("self_logp", "adv_logp", "init_logp", "final_logp"))
    skip = graphs.get("skip_logp")
    neg1 = torch.full((B, 1), fbd.NEG_INF)
    neg2 = torch.full((B, 2), fbd.NEG_INF)
    alpha = init + emit_graph[:, 0]
    alphas = [alpha]
    for t in range(1, T):
        new = torch.logaddexp(alpha + sl, torch.cat([neg1, alpha[:, :-1] + al[:, 1:]], dim=1))
        if skip is not None:
            new = torch.logaddexp(new, torch.cat([neg2, alpha[:, :-2] + skip[:, 2:]], dim=1))
        new = new + emit_graph[:, t]
        active = (t < n_frames)[:, None]
        alphas.append(torch.where(active, new, torch.full_like(new, fbd.NEG_INF)))
        alpha = torch.where(active, new, alpha)
    loglik = torch.logsumexp(alpha + final, dim=1)
    beta = final
    betas = [beta]
    for t in range(T - 2, -1, -1):
        eb = emit_graph[:, t + 1] + beta
        new = torch.logaddexp(sl + eb, torch.cat([al[:, 1:] + eb[:, 1:], neg1], dim=1))
        if skip is not None:
            new = torch.logaddexp(new, torch.cat([skip[:, 2:] + eb[:, 2:], neg2], dim=1))
        beta = torch.where((t + 1 < n_frames)[:, None], new, beta)
        betas.append(beta)
    betas.reverse()
    log_gamma = torch.stack(alphas, dim=1) + torch.stack(betas, dim=1) - loglik[:, None, None]
    mask = (torch.arange(T)[None, :] < n_frames[:, None])[:, :, None]
    return fbd.FBResult(torch.where(mask, log_gamma, torch.full_like(log_gamma, fbd.NEG_INF)), loglik)


@pytest.mark.parametrize("kind", ["mono", "cd", "cd_skip"])
def test_chain_arm_without_loop_term_is_exact(headline, kind):
    """On align graphs the loop term adds logaddexp(a, ~-2e30) = a to every
    live state, so leaving it out changes no number that EM reads: loglik,
    every log_gamma above NEG_INF / 2 and the pdf posteriors are bitwise the
    plain version's, over n_frames of T, 1, 0 and ragged; the rest is below
    -1e29 in both."""
    topo, tied = headline
    graphs = vit.graphs_to_torch(_align_graphs_np(topo, tied, kind), CPU)
    B, T = graphs["emit_id"].shape[0], 300
    rng = np.random.default_rng(12)
    emit = torch.as_tensor((rng.standard_normal((B, T, tied.n_pdfs)) * 4 - 20).astype(np.float32))
    nf = torch.as_tensor([T, 1, 0, 211, 157, T], dtype=torch.int32)
    want = fbd.forward_backward(emit, graphs, nf)
    got = _chain_forward_backward(emit, graphs, nf)
    assert torch.equal(got.loglik, want.loglik)
    live = want.log_gamma > fbd.NEG_INF / 2
    assert bool(live.any()) and torch.equal(live, got.log_gamma > fbd.NEG_INF / 2)
    assert torch.equal(got.log_gamma[live], want.log_gamma[live])
    assert bool((got.log_gamma[~live] < -1e29).all()) and bool((want.log_gamma[~live] < -1e29).all())
    n_pdfs = tied.n_pdfs
    assert torch.equal(fbd.state_posteriors_to_pdf(got.log_gamma, graphs["emit_id"], n_pdfs),
                       fbd.state_posteriors_to_pdf(want.log_gamma, graphs["emit_id"], n_pdfs))


def test_matches_jax_on_cd_align_graphs_at_training_width(headline):
    """The plain forward-backward against JAX's on tied-triphone align graphs
    at the widest training batch's width (J = 192, T = 550; 4 rows, one of
    them a dummy), with test_matches_jax_forward_backward's tolerances."""
    topo, tied = headline
    graphs_np = _align_graphs_np(topo, tied, "cd", n_rows=4, seed=13)
    assert graphs_np["emit_id"].shape[1] == 192
    rng = np.random.default_rng(14)
    T = 550
    emit = (rng.standard_normal((4, T, tied.n_pdfs)) * 4 - 20).astype(np.float32)
    nf = np.asarray([T, 431, 302, 97], np.int32)
    ref = jax_fb.forward_backward(jnp.asarray(emit), _jax(graphs_np), jnp.asarray(nf))
    got = fbd.forward_backward(torch.as_tensor(emit), _torch(graphs_np), torch.as_tensor(nf))
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(ref.loglik), rtol=1e-6)
    np.testing.assert_allclose(got.log_gamma.numpy(), np.asarray(ref.log_gamma), rtol=1e-5, atol=1e-5)

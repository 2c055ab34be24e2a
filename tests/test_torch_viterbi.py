"""mogasr_torch Viterbi against the JAX scan (decoder/viterbi.py) and the
interpret-mode Pallas kernel (decoder/viterbi_pallas.py): the same contract
as tests/test_viterbi_pallas.py -- path and entered exact, scores to rtol
1e-6 -- on align, phone-loop and word-loop graphs with ragged batches, plus
beam pruning, the score without a backtrace, CTC skip transitions and the
token/pdf readouts; and the two facts K2's redesign rests on (csrc/viterbi.cu):
on align graphs the recursion without its exit argmax and enter term is the
plain one bit for bit, and on the headline word loop the exit argmax over the
exit states alone, with the full argmax as fallback, is the full argmax."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.config import TopologyConfig
from mogasr.decoder import viterbi as jax_vit
from mogasr.decoder.viterbi_pallas import viterbi_pallas
from mogasr.hmm import graph as gr
from mogasr.hmm.lexicon import make_lexicon
from mogasr.hmm.topology import build_topology
from mogasr_torch import pipeline as pipe
from mogasr_torch.data.synthetic import extended_lexicon
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.decoder import viterbi_cuda
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
BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "headline")


@pytest.fixture(scope="module")
def topo():
    lex = make_lexicon({"ab": ["a", "b"], "ba": ["b", "a"], "aa": ["a", "a"]})
    return build_topology(lex, TopologyConfig(states_per_phone=2, sil_states=1))


def _graphs(topo, kind):
    lex = topo.lexicon
    if kind == "align":
        return [gr.align_graph(topo, lex.words_to_phone_ids(["ab"], edge_sil=True)),
                gr.align_graph(topo, lex.words_to_phone_ids(["ab", "ba"])),
                gr.align_graph(topo, lex.words_to_phone_ids(["aa"]))]
    if kind == "phone_loop":
        return [gr.loop_graph(topo)] * 3
    tokens = [(w, lex.words_to_phone_ids([w])) for w in lex.words]
    return [gr.loop_graph(topo, tokens=tokens)] * 3


def _with_skip(graphs_np):
    """Add CTC-style (j-2 -> j) skips inside every chain."""
    chain = graphs_np["chain_id"]
    same = np.zeros_like(chain, bool)
    same[:, 2:] = (chain[:, 2:] == chain[:, :-2]) & (chain[:, 2:] >= 0)
    out = dict(graphs_np)
    out["skip_logp"] = np.where(same, np.float32(-0.1), gr.NEG_INF).astype(np.float32)
    return out


def _inputs(topo, T=14, seed=3):
    rng = np.random.default_rng(seed)
    emit = (rng.standard_normal((3, T, topo.n_pdfs)) * 2).astype(np.float32)
    return emit, np.asarray([T, 9, 4], np.int32)


def _run_both(graphs_np, emit, n_frames, **kw):
    ref = jax_vit.viterbi(jnp.asarray(emit), {k: jnp.asarray(v) for k, v in graphs_np.items()},
                          jnp.asarray(n_frames), **kw)
    got = vit.viterbi(torch.as_tensor(emit), vit.graphs_to_torch(graphs_np, CPU),
                      torch.as_tensor(n_frames), **kw)
    return ref, got


def _assert_equal(ref, got):
    assert got.path.dtype == torch.int32 and got.entered.dtype == torch.bool
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(got.entered.numpy(), np.asarray(ref.entered))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["align", "phone_loop", "word_loop"])
def test_matches_jax_scan_and_pallas(topo, kind):
    graphs_np = gr.batch_graphs(_graphs(topo, kind))
    emit, n_frames = _inputs(topo)
    ref, got = _run_both(graphs_np, emit, n_frames, acoustic_scale=0.7)
    _assert_equal(ref, got)
    pallas = viterbi_pallas(jnp.asarray(emit), {k: jnp.asarray(v) for k, v in graphs_np.items()},
                            jnp.asarray(n_frames), acoustic_scale=0.7, interpret=True)
    _assert_equal(pallas, got)
    # the kernel wrapper takes the plain version on the CPU
    before = viterbi_cuda.LAUNCHES
    wrapped = viterbi_cuda.viterbi(torch.as_tensor(emit), vit.graphs_to_torch(graphs_np, CPU),
                                   torch.as_tensor(n_frames), acoustic_scale=0.7)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)
    assert viterbi_cuda.LAUNCHES == before


def test_beam_matches_jax(topo):
    graphs_np = gr.batch_graphs(_graphs(topo, "phone_loop"))
    emit, n_frames = _inputs(topo, seed=4)
    ref, got = _run_both(graphs_np, emit, n_frames, beam=3.0)
    _assert_equal(ref, got)


def test_skip_graph_matches_jax(topo):
    graphs_np = _with_skip(gr.batch_graphs(_graphs(topo, "word_loop")))
    emit, n_frames = _inputs(topo, seed=5)
    ref, got = _run_both(graphs_np, emit, n_frames)
    _assert_equal(ref, got)
    assert (np.asarray(ref.path)[:, 1:] - np.asarray(ref.path)[:, :-1] == 2).any()


def test_padding_frames_are_ignored(topo):
    graphs_np = gr.batch_graphs(_graphs(topo, "phone_loop"))
    emit, n_frames = _inputs(topo, seed=6)
    trashed = emit.copy()
    trashed[1, 9:] = 50 * np.random.default_rng(7).standard_normal(trashed[1, 9:].shape)
    g = vit.graphs_to_torch(graphs_np, CPU)
    base = vit.viterbi(torch.as_tensor(emit), g, torch.as_tensor(n_frames))
    got = vit.viterbi(torch.as_tensor(trashed), g, torch.as_tensor(n_frames))
    for a, b in zip(got, base):
        assert torch.equal(a, b)


def test_path_to_pdfs_and_tokens_match_jax(topo):
    graphs_np = gr.batch_graphs(_graphs(topo, "word_loop"))
    emit, n_frames = _inputs(topo, seed=8)
    ref, got = _run_both(graphs_np, emit, n_frames)
    ref_pdfs = jax_vit.path_to_pdfs(ref, {k: jnp.asarray(v) for k, v in graphs_np.items()})
    got_pdfs = vit.path_to_pdfs(got, vit.graphs_to_torch(graphs_np, CPU))
    np.testing.assert_array_equal(got_pdfs.numpy(), np.asarray(ref_pdfs))
    labels = _graphs(topo, "word_loop")[0].labels
    assert vit.path_to_tokens(got, labels, graphs_np["chain_id"]) == \
        jax_vit.path_to_tokens(ref, labels, graphs_np["chain_id"])


def test_kernel_wrapper_rejects_skip_and_beam(topo):
    """K2 has a skip arm and a beam mask, so the wrapper takes skip graphs and
    a beam: on the CPU it is the plain version, bitwise, and no launch. Only
    a device other than the CPU and CUDA is rejected, skips or not."""
    graphs_np = gr.batch_graphs(_graphs(topo, "align"))
    emit, n_frames = _inputs(topo)
    before = viterbi_cuda.LAUNCHES
    for g_np in (graphs_np, _with_skip(graphs_np)):
        g = vit.graphs_to_torch(g_np, CPU)
        for beam in (0.0, 5.0):
            got = viterbi_cuda.viterbi(torch.as_tensor(emit), g, torch.as_tensor(n_frames), beam=beam)
            want = vit.viterbi(torch.as_tensor(emit), g, torch.as_tensor(n_frames), beam=beam)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    assert viterbi_cuda.LAUNCHES == before
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi(torch.empty(emit.shape, device=meta),
                             vit.graphs_to_torch(_with_skip(graphs_np), meta), torch.as_tensor(n_frames))


@pytest.mark.parametrize("kind", ["align", "word_loop"])
def test_kernel_align_on_cpu_is_plain(topo, kind):
    """viterbi_cuda.align (forced alignment with each frame's pdf, which K2
    writes in its backtrace) takes the plain version on the CPU: the plain
    Viterbi and path_to_pdfs of it, -1 past n_frames, and no launch."""
    graphs_np = gr.batch_graphs(_graphs(topo, kind))
    emit, n_frames = _inputs(topo, seed=14)
    g = vit.graphs_to_torch(graphs_np, CPU)
    before = viterbi_cuda.LAUNCHES
    res, pdfs = viterbi_cuda.align(torch.as_tensor(emit), g, torch.as_tensor(n_frames), acoustic_scale=0.7)
    want = vit.viterbi(torch.as_tensor(emit), g, torch.as_tensor(n_frames), acoustic_scale=0.7)
    assert viterbi_cuda.LAUNCHES == before
    for a, b in zip(res, want):
        assert torch.equal(a, b)
    assert torch.equal(pdfs, vit.path_to_pdfs(want, g)) and bool((pdfs[2, n_frames[2]:] == -1).all())


@pytest.mark.parametrize("kind", ["align", "phone_loop", "word_loop"])
@pytest.mark.parametrize("beam", [0.5, 2.0, 6.0])
def test_kernel_wrapper_beam_matches_jax(topo, kind, beam):
    """The beam through the kernel's wrapper (the plain version on the CPU)
    against JAX's beam mask: tight beams prune most states every frame."""
    graphs_np = gr.batch_graphs(_graphs(topo, kind))
    emit, n_frames = _inputs(topo, seed=11)
    ref = jax_vit.viterbi(jnp.asarray(emit), {k: jnp.asarray(v) for k, v in graphs_np.items()},
                          jnp.asarray(n_frames), acoustic_scale=0.7, beam=beam)
    got = viterbi_cuda.viterbi(torch.as_tensor(emit), vit.graphs_to_torch(graphs_np, CPU),
                               torch.as_tensor(n_frames), acoustic_scale=0.7, beam=beam)
    _assert_equal(ref, got)


@pytest.mark.parametrize("beam", [0.0, 3.0])
def test_without_backtrace_matches_jax(topo, beam):
    """with_backtrace=False: JAX's zero path, no entered frame, the same score."""
    graphs_np = gr.batch_graphs(_graphs(topo, "word_loop"))
    emit, n_frames = _inputs(topo, seed=12)
    ref, got = _run_both(graphs_np, emit, n_frames, beam=beam, with_backtrace=False)
    _assert_equal(ref, got)
    assert not got.path.any() and not got.entered.any()
    full = vit.viterbi(torch.as_tensor(emit), vit.graphs_to_torch(graphs_np, CPU),
                       torch.as_tensor(n_frames), beam=beam)
    assert torch.equal(got.score, full.score)
    wrapped = viterbi_cuda.viterbi(torch.as_tensor(emit), vit.graphs_to_torch(graphs_np, CPU),
                                   torch.as_tensor(n_frames), beam=beam, with_backtrace=False)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)


# ---- K2's chain arm and compact exit set (csrc/viterbi.cu)


@pytest.fixture(scope="module")
def headline():
    """The headline bundle's topology and tied triphones."""
    _gmm, topo, _fcfg, tied, _meta = load_system(BUNDLE, CPU)
    return topo, tied


def _align_graphs_np(topo, tied, kind, seed=11):
    """Align graphs of five seeded transcripts of the training corpus's
    vocabulary (300 words, 3-9 each) and an empty one (a batch's dummy row:
    silence), monophone or tied-triphone, padded to a common J (a multiple of
    64); ``*_skip`` adds CTC (j-2 -> j) skips inside every chain."""
    words = sorted(extended_lexicon(300))
    rng = np.random.default_rng(seed)
    rows = [[words[i] for i in rng.integers(0, len(words), rng.integers(3, 10))] for _ in range(5)] + [[]]
    align_fn = None if kind.startswith("mono") else (lambda p: tri.align_graph_cd(tied, p))
    graphs = pipe.build_align_graphs(rows, topo.lexicon, topo, align_fn=align_fn)
    return _with_skip(graphs) if kind.endswith("skip") else graphs


def _chain_viterbi(emit_ll, graphs, n_frames, acoustic_scale=1.0, beam=0.0):
    """The plain recursion (decoder/viterbi.py) without the exit argmax and
    the enter candidate, as K2's chain arm computes it: per frame stay,
    advance and skip, the beam mask, rows frozen past n_frames; the same
    backtrace, which then never meets an enter code."""
    B, T, _P = emit_ll.shape
    emit_id = graphs["emit_id"].to(torch.int64)
    sl, al, skip = graphs["self_logp"], graphs["adv_logp"], graphs.get("skip_logp")
    J = emit_id.shape[1]
    emit_graph = torch.gather(emit_ll * acoustic_scale, 2, emit_id[:, None, :].expand(B, T, J))
    neg1, neg2 = torch.full((B, 1), vit.NEG_INF), torch.full((B, 2), vit.NEG_INF)
    zero, one, three = (torch.tensor(v, dtype=torch.uint8) for v in (0, 1, 3))
    delta = graphs["init_logp"] + emit_graph[:, 0]
    bps = []
    for t in range(1, T):
        stay = delta + sl
        adv = torch.cat([neg1, delta[:, :-1] + al[:, 1:]], dim=1)
        best = torch.maximum(stay, adv)
        bp = torch.where(best == adv, one, zero)
        if skip is not None:
            sk = torch.cat([neg2, delta[:, :-2] + skip[:, 2:]], dim=1)
            bp = torch.where(sk > best, three, bp)
            best = torch.maximum(best, sk)
        bp = torch.where(best == stay, zero, bp)
        new = best + emit_graph[:, t]
        if beam > 0:
            thresh = new.amax(dim=1, keepdim=True) - beam
            new = torch.where(new >= thresh, new, torch.full_like(new, vit.NEG_INF))
        active = (t < n_frames)[:, None]
        delta = torch.where(active, new, delta)
        bps.append(torch.where(active, bp, zero))
    final = delta + graphs["final_logp"]
    score, j = final.amax(dim=1), final.argmax(dim=1)
    path = [None] * T
    for t in range(T - 1, 0, -1):
        path[t] = j
        b = torch.gather(bps[t - 1], 1, j[:, None])[:, 0]
        assert not bool((b == 2).any())
        j = torch.where(b == 1, j - 1, torch.where(b == 3, j - 2, j))
    path[0] = j
    mask = torch.arange(T)[None, :] < n_frames[:, None]
    path = torch.where(mask, torch.stack(path, dim=1).to(torch.int32), torch.full((B, T), -1, dtype=torch.int32))
    entered = torch.zeros((B, T), dtype=torch.bool)
    entered[:, 0] = True
    return vit.ViterbiResult(path, entered & mask, score)


@pytest.mark.parametrize("beam", [0.0, 6.0])
@pytest.mark.parametrize("kind", ["mono", "cd", "cd_skip"])
def test_chain_arm_without_exit_and_enter_is_exact(headline, kind, beam):
    """On align graphs (no loop arc: every enter and exit log-prob NEG_INF;
    padding states NEG_INF throughout) the recursion without the exit argmax
    and the enter candidate -- K2's chain arm -- gives path, entered and
    score bitwise equal to the plain version and to JAX's viterbi, over
    n_frames of T, 1, 0, shorter than the chain and ragged, monophone and
    tied-triphone, with and without skips, exact and with a beam."""
    topo, tied = headline
    graphs_np = _align_graphs_np(topo, tied, kind)
    for key in ("enter_logp", "exit_logp"):
        assert (graphs_np[key] == np.float32(gr.NEG_INF)).all(), key
    B, J = graphs_np["emit_id"].shape
    assert J % 64 == 0 and graphs_np["n_states"].min() < J
    T = int(graphs_np["n_states"].max()) + 30
    rng = np.random.default_rng(12)
    emit = (rng.standard_normal((B, T, tied.n_pdfs)) * 4 - 20).astype(np.float32)
    nf = np.asarray([T, 1, 0, 9, T - 40, T], np.int32)
    g = vit.graphs_to_torch(graphs_np, CPU)
    got = _chain_viterbi(torch.as_tensor(emit), g, torch.as_tensor(nf), 0.8, beam)
    want = vit.viterbi(torch.as_tensor(emit), g, torch.as_tensor(nf), 0.8, beam)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool((want.score[[0, 5]] > vit.NEG_INF / 2).all())  # the full rows reach their final state
    ref = jax_vit.viterbi(jnp.asarray(emit), {k: jnp.asarray(v) for k, v in graphs_np.items()}, jnp.asarray(nf),
                          acoustic_scale=0.8, beam=beam)
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(got.entered.numpy(), np.asarray(ref.entered))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))


def test_compact_exit_argmax_is_the_full_argmax(headline):
    """The word-loop arm's exit argmax: the first-index argmax over the exit
    states alone (exit_logp above NEG_INF: 301 of the headline word loop's
    3048), taken when its maximum is above NEG_INF, else the full argmax. At
    every frame of the plain recursion it is bitwise the full first-index
    argmax of delta + exit_logp, the first frames (no exit state live yet:
    the fallback) included."""
    topo, tied = headline
    graph = tri.word_loop_graph_cd(tied, insertion_penalty=2.0)
    g = vit.graphs_to_torch(gr.batch_graphs([graph] * 2), CPU)
    B, J = g["emit_id"].shape
    exits = g["exit_logp"] > vit.NEG_INF
    assert J == 3048 and exits.sum(dim=1).tolist() == [301, 301]
    T = 60
    rng = np.random.default_rng(13)
    emit = torch.as_tensor((rng.standard_normal((B, T, tied.n_pdfs)) * 4 - 20).astype(np.float32))
    emit_graph = torch.gather(emit, 2, g["emit_id"].to(torch.int64)[:, None, :].expand(B, T, J))
    neg1 = torch.full((B, 1), vit.NEG_INF)
    delta = g["init_logp"] + emit_graph[:, 0]
    fallback = []
    for t in range(1, T):
        exit_scores = delta + g["exit_logp"]
        full_v, full_i = exit_scores.amax(dim=1), exit_scores.argmax(dim=1)
        compact = torch.where(exits, exit_scores, torch.full_like(exit_scores, -np.inf))
        comp_v, comp_i = compact.amax(dim=1), compact.argmax(dim=1)
        use = comp_v > vit.NEG_INF
        assert torch.equal(torch.where(use, comp_v, full_v), full_v)
        assert torch.equal(torch.where(use, comp_i, full_i), full_i)
        fallback.append(int((~use).sum()))
        # the plain frame (decoder/viterbi.py), beam off
        ent = full_v[:, None] + g["enter_logp"]
        best = torch.maximum(torch.maximum(delta + g["self_logp"],
                                           torch.cat([neg1, delta[:, :-1] + g["adv_logp"][:, 1:]], dim=1)), ent)
        delta = best + emit_graph[:, t]
    assert fallback[0] == B and sum(fallback) < B * (T - 1) and fallback[-1] == 0

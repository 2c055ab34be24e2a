"""mogasr_torch Viterbi against the JAX scan (decoder/viterbi.py) and the
interpret-mode Pallas kernel (decoder/viterbi_pallas.py): the same contract
as tests/test_viterbi_pallas.py -- path and entered exact, scores to rtol
1e-6 -- on align, phone-loop and word-loop graphs with ragged batches, plus
beam pruning, the score without a backtrace, CTC skip transitions and the
token/pdf readouts."""

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
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.decoder import viterbi_cuda

CPU = torch.device("cpu")


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

"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with a card and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Shapes are small and ragged (not multiples of the kernels' tiles); the
headline-size comparison is chip_smoke.py's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mogasr_torch import pipeline as pipe
from mogasr_torch.am import fast_lstm, gmm_cuda, lstm_cuda
from mogasr_torch.am import neural as tn
from mogasr_torch.am.params import init_
from mogasr_torch.am.gmm import gmm_from_numpy, gmm_loglik, quantize_int8, quadratic_features
from mogasr_torch.config import DecodeConfig, TopologyConfig, TrainConfig
from mogasr_torch.decoder import fb_cuda
from mogasr_torch.decoder import forward_backward as fbd
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.decoder import viterbi_cuda
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm.lexicon import make_lexicon
from mogasr_torch.hmm.topology import build_topology

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("S,K,D,N", [(70, 3, 39, 1000), (5, 1, 13, 7), (130, 16, 39, 200)])
def test_gmm_kernel_matches_plain(dev, compute_dtype, mode, S, K, D, N):
    rng = np.random.default_rng(S + K + N)
    g = gmm_from_numpy(rng.dirichlet(np.ones(K), size=S), rng.standard_normal((S, K, D)),
                       0.3 + rng.random((S, K, D)), dev)
    x = torch.as_tensor(rng.standard_normal((N, D)).astype(np.float32), device=dev)
    before = gmm_cuda.LAUNCHES
    got = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype=compute_dtype, mode=mode)
    want = gmm_loglik(x, g, mode=mode, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert gmm_cuda.LAUNCHES == before + 1
    assert got.shape == (N, S) and got.dtype == torch.float32
    # same operands, float32 accumulation in another order
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    params = gmm_cuda.kernel_params(g, compute_dtype)
    assert torch.equal(gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode, params=params), got)
    with pytest.raises(ValueError):
        other = "bfloat16" if compute_dtype == "float32" else "float32"
        gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode, params=gmm_cuda.kernel_params(g, other))


def _random_gmm(dev, S, K, D, N):
    rng = np.random.default_rng(S + K + N)
    g = gmm_from_numpy(rng.dirichlet(np.ones(K), size=S), rng.standard_normal((S, K, D)),
                       0.3 + rng.random((S, K, D)), dev)
    return g, torch.as_tensor(rng.standard_normal((N, D)).astype(np.float32), device=dev)


@pytest.mark.parametrize("S,K,D,N", [(70, 3, 39, 1000), (5, 1, 13, 7), (130, 16, 39, 200), (33, 5, 39, 129),
                                     (33, 3, 200, 65)])
def test_int8_kernel_matches_plain(dev, S, K, D, N):
    """K5 against the plain int8 scorer: bitwise the same quantized operands
    and integer products, dequantized in the same order; the online
    logsumexp sums in another order (K1's tolerance)."""
    g, x = _random_gmm(dev, S, K, D, N)
    before = gmm_cuda.INT8_LAUNCHES
    got = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype="int8")
    want = gmm_loglik(x, g, compute_dtype="int8")
    torch.cuda.synchronize()
    assert gmm_cuda.INT8_LAUNCHES == before + 1
    assert got.shape == (N, S) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    # the card quantizes as the CPU does
    x2 = quadratic_features(x)
    for a, b in zip(quantize_int8(x2, 1), quantize_int8(x2.cpu(), 1)):
        assert torch.equal(a.cpu(), b)
    with pytest.raises(NotImplementedError):
        gmm_cuda.gmm_loglik_fused(x, g, compute_dtype="int8", mode="max")
    with pytest.raises(ValueError):
        gmm_cuda.gmm_loglik_fused(x, g, compute_dtype="int8", params=gmm_cuda.kernel_params(g))


@pytest.mark.parametrize("D", [13, 39, 120])
@pytest.mark.parametrize("K", [1, 17])
@pytest.mark.parametrize("S", [5, 65, 130])
@pytest.mark.parametrize("N", [1, 63, 129])
def test_int8_kernel_tile_edges(dev, N, S, K, D):
    """K5 on the shared core's wgmma s8 route at the edges of its tiles: N
    around a warpgroup's 64 rows, S around the 64-state tile, K = 1 and 17
    (more components than ring stages), D = 13, 39 and 120 (one chunk of 32
    rows, one of 96, two of 128). The int32 products are exact, so it sits
    within K1's tolerance of the plain int8 scorer (the logsumexp sums in
    another order)."""
    g, x = _random_gmm(dev, S, K, D, N)
    before = gmm_cuda.INT8_LAUNCHES
    got = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype="int8")
    want = gmm_loglik(x, g, compute_dtype="int8")
    torch.cuda.synchronize()
    assert gmm_cuda.INT8_LAUNCHES == before + 1
    assert got.shape == (N, S) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("S,K,D,N,kc", [(70, 3, 39, 1000, None), (5, 1, 13, 7, None), (130, 16, 39, 200, 16),
                                        (130, 16, 39, 200, 5), (33, 5, 39, 129, 2)])
def test_wide_kernel_matches_plain_and_k1(dev, compute_dtype, mode, S, K, D, N, kc):
    """K1w against the plain scorer (K1's tolerance), and in max mode bitwise
    against K1: each score sums over r in K1's order and max is exact."""
    g, x = _random_gmm(dev, S, K, D, N)
    before = gmm_cuda.WIDE_LAUNCHES
    got = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode, layout="wide", kc=kc)
    want = gmm_loglik(x, g, mode=mode, compute_dtype=compute_dtype)
    k1 = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode)
    torch.cuda.synchronize()
    assert gmm_cuda.WIDE_LAUNCHES == before + 1
    assert got.shape == (N, S) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    if mode == "max":
        assert torch.equal(got, k1)
    params = gmm_cuda.kernel_params(g, compute_dtype, "wide", kc, mode)
    assert torch.equal(gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode, params=params, layout="wide",
                                                 kc=kc), got)
    with pytest.raises(ValueError):  # chunked params for the wide layout
        gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode, params=gmm_cuda.kernel_params(g, compute_dtype),
                                  layout="wide")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
@pytest.mark.parametrize("S,K,D,N", [(70, 17, 39, 1), (130, 1, 39, 63), (65, 17, 13, 65), (200, 2, 13, 129),
                                     (70, 5, 120, 130), (90, 3, 65, 64), (33, 3, 200, 65)])
def test_tensor_core_tile_edges(dev, compute_dtype, mode, S, K, D, N):
    """The edges of the 128-frame x 64-state tile, of the component ring and
    of the row chunks: N around a warpgroup's 64 rows, S not a multiple of
    64, D = 13 (one chunk of 32 rows), K = 1 and K = 17 (more components than
    ring stages), D = 120 (fbank with deltas: two chunks of 128) and 65 (two
    of 80), D = 200 (four of 112; float32 restages its frame tile per chunk);
    K1 and K1w (kc = 5) against the plain scorer, and bitwise equal in max
    mode."""
    g, x = _random_gmm(dev, S, K, D, N)
    before = (gmm_cuda.LAUNCHES, gmm_cuda.WIDE_LAUNCHES)
    got = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode)
    wide = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode, layout="wide", kc=min(5, K))
    want = gmm_loglik(x, g, mode=mode, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert (gmm_cuda.LAUNCHES, gmm_cuda.WIDE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(wide, want, atol=1e-3, rtol=1e-4)
    if mode == "max":
        assert torch.equal(wide, got)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_wide_kernel_at_sweep_chunking(dev, compute_dtype, mode):
    """K1w at bench.py's sweep chunking, K = 256 in 16 chunks of kc = 16:
    bitwise K1 in max mode, K1's tolerance of the plain scorer in both."""
    g, x = _random_gmm(dev, 100, 256, 39, 200)
    got = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode, layout="wide", kc=16)
    k1 = gmm_cuda.gmm_loglik_fused(x, g, compute_dtype, mode)
    want = gmm_loglik(x, g, mode=mode, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(k1, want, atol=1e-3, rtol=1e-4)
    if mode == "max":
        assert torch.equal(got, k1)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_gmm_kernels_no_rows(dev, compute_dtype, mode):
    """N = 0: an empty [0, S] result and no launch counted."""
    g, x = _random_gmm(dev, 70, 3, 39, 1)
    before = (gmm_cuda.LAUNCHES, gmm_cuda.WIDE_LAUNCHES)
    for layout in gmm_cuda.LAYOUTS:
        out = gmm_cuda.gmm_loglik_fused(x[:0], g, compute_dtype, mode, layout=layout)
        assert out.shape == (0, 70) and out.dtype == torch.float32
    assert (gmm_cuda.LAUNCHES, gmm_cuda.WIDE_LAUNCHES) == before


def _random_graphs(rng, B, J, P, skip=False):
    """Chain+loop-shaped random graph arrays: chains of 1-5 states; with
    ``skip``, CTC-style (j-2 -> j) skips inside every chain, nearly free."""
    out = {k: np.full((B, J), gr.NEG_INF, np.float32) for k in
           ("self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp")
           + (("skip_logp",) if skip else ())}
    out["emit_id"] = rng.integers(0, P, (B, J)).astype(np.int32)
    for b in range(B):
        j = 0
        while j < J:
            n = min(int(rng.integers(1, 6)), J - j)
            out["self_logp"][b, j:j + n] = -rng.random(n)
            out["adv_logp"][b, j + 1:j + n] = -rng.random(n - 1)
            out["enter_logp"][b, j] = out["init_logp"][b, j] = -3 * rng.random()
            out["exit_logp"][b, j + n - 1] = out["final_logp"][b, j + n - 1] = -rng.random()
            if skip and n > 2:
                out["skip_logp"][b, j + 2:j + n] = -0.05 * rng.random(n - 2)
            j += n
    return out


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("J", [37, 3048, 5000])
def test_viterbi_kernel_bitwise_equals_plain(dev, J, skip):
    """K2, and its skip arm on graphs with skip transitions: path, entered
    and score bitwise equal; the skips are taken (the best scores rise over
    the same graph's without them)."""
    rng = np.random.default_rng(J)
    B, T, P = 5, 40, 97
    graphs = vit.graphs_to_torch(_random_graphs(rng, B, J, P, skip), dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3).astype(np.float32), device=dev)
    nf = torch.as_tensor([T, 17, 1, 0, 33], dtype=torch.int32, device=dev)
    for scale in (1.0, 0.3):
        before = viterbi_cuda.LAUNCHES
        got = viterbi_cuda.viterbi(ll, graphs, nf, acoustic_scale=scale)
        want = vit.viterbi(ll, graphs, nf, acoustic_scale=scale)
        torch.cuda.synchronize()
        assert viterbi_cuda.LAUNCHES == before + 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if skip:
            no_skip = viterbi_cuda.viterbi(ll, {k: v for k, v in graphs.items() if k != "skip_logp"}, nf,
                                           acoustic_scale=scale)
            assert bool((got.score >= no_skip.score).all()) and bool((got.score > no_skip.score).any())


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("J", [37, 3048, 5000])
@pytest.mark.parametrize("beam", [0.5, 3.0, 40.0])
def test_viterbi_kernel_beam_bitwise_equals_plain(dev, J, beam, skip):
    """K2 with the beam mask: one block max per frame, thresh = max - beam,
    states below it NEG_INF; path, entered and score bitwise equal, with
    and without skip transitions."""
    rng = np.random.default_rng(J + 1)
    B, T, P = 5, 40, 97
    graphs = vit.graphs_to_torch(_random_graphs(rng, B, J, P, skip), dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3).astype(np.float32), device=dev)
    nf = torch.as_tensor([T, 17, 1, 0, 33], dtype=torch.int32, device=dev)
    for scale in (1.0, 0.3):
        got = viterbi_cuda.viterbi(ll, graphs, nf, acoustic_scale=scale, beam=beam)
        want = vit.viterbi(ll, graphs, nf, acoustic_scale=scale, beam=beam)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("beam", [0.0, 3.0])
def test_viterbi_kernel_without_backtrace(dev, beam):
    """with_backtrace=False: the forward kernel alone; the plain version's
    score, a zero path, no entered frame."""
    rng = np.random.default_rng(4)
    B, T, P, J = 5, 40, 97, 300
    graphs = vit.graphs_to_torch(_random_graphs(rng, B, J, P), dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3).astype(np.float32), device=dev)
    nf = torch.as_tensor([T, 17, 1, 0, 33], dtype=torch.int32, device=dev)
    before = viterbi_cuda.LAUNCHES
    got = viterbi_cuda.viterbi(ll, graphs, nf, beam=beam, with_backtrace=False)
    want = vit.viterbi(ll, graphs, nf, beam=beam, with_backtrace=False)
    full = viterbi_cuda.viterbi(ll, graphs, nf, beam=beam)
    torch.cuda.synchronize()
    assert viterbi_cuda.LAUNCHES == before + 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got.score, full.score) and not got.path.any()


def test_skip_graph_decodes_on_k2(dev):
    """pipe.decode_batch on a graph with skip transitions: K2's skip arm on
    the card (one launch), equal to use_kernels=False."""
    lex = make_lexicon({"ab": ["a", "b"], "ba": ["b", "a"], "aa": ["a", "a"]})
    topo = build_topology(lex, TopologyConfig())
    g = pipe.word_decode_graph(lex, topo, DecodeConfig())
    chain = g.chain_id
    skip = np.full(chain.shape, gr.NEG_INF, np.float32)
    skip[2:] = np.where((chain[2:] == chain[:-2]) & (chain[2:] >= 0), np.float32(-0.1), gr.NEG_INF)
    g.skip_logp = skip
    rng = np.random.default_rng(15)
    B, T = 3, 40
    ll = torch.as_tensor((rng.standard_normal((B, T, topo.n_pdfs)) * 3).astype(np.float32), device=dev)
    fb = pipe.FeatBatch(["a", "b", "c"], torch.zeros((B, T, 1), device=dev),
                        torch.tensor([T, 25, 0], dtype=torch.int32, device=dev), [[], [], []])
    before = viterbi_cuda.LAUNCHES
    got = pipe.decode_batch_scored(fb, ll, g, DecodeConfig())
    assert viterbi_cuda.LAUNCHES == before + 1
    want = pipe.decode_batch_scored(fb, ll, g, DecodeConfig(), use_kernels=False)
    assert got == want


def test_viterbi_kernel_checks_graphs(dev):
    rng = np.random.default_rng(1)
    g = _random_graphs(rng, 2, 20, 10)
    ll = torch.zeros((2, 5, 10), device=dev)
    nf = torch.tensor([5, 5], device=dev)
    bad = vit.graphs_to_torch({**g, "emit_id": g["emit_id"].astype(np.int64)}, dev)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi(ll, bad, nf)
    wide = vit.graphs_to_torch(_random_graphs(rng, 2, 8 * 1024 + 1, 10), dev)
    with pytest.raises(RuntimeError):  # above the kernel's state limit
        viterbi_cuda.viterbi(ll, wide, nf)


def test_viterbi_kernel_traps_on_bad_emit_id(dev):
    """An emit_id outside [0, P) stops the kernel instead of reading past
    ll's row. The trap poisons the CUDA context, so it runs in a child."""
    code = """
import torch
from mogasr_torch.decoder import viterbi_cuda
B, J, P = 2, 40, 10
g = {k: torch.zeros((B, J), device="cuda") for k in
     ("self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp")}
g["emit_id"] = torch.full((B, J), P, dtype=torch.int32, device="cuda")
viterbi_cuda.viterbi(torch.zeros((B, 5, P), device="cuda"), g, torch.tensor([5, 5]))
torch.cuda.synchronize()
print("no error")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "no error" not in proc.stdout
    assert "CUDA error" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("J", [37, 200, 3048, 8192])
def test_fb_kernels_match_plain(dev, J, skip):
    """K3f/K3b against the plain forward-backward: loglik and log_gamma on
    valid frames, NEG_INF on padded ones, ragged n_frames including 0 and 1;
    with ``skip``, their skip arm on graphs with skip transitions. Every row
    has loop arcs: the general arm, up to the kernels' widest J."""
    rng = np.random.default_rng(J)
    B, T, P = 5, 40, 97
    graphs = vit.graphs_to_torch(_random_graphs(rng, B, J, P, skip), dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3).astype(np.float32), device=dev)
    nf = torch.as_tensor([T, 17, 1, 0, 33], dtype=torch.int32, device=dev)
    for scale in (1.0, 0.8):
        before = (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES)
        got = fb_cuda.forward_backward(ll, graphs, nf, acoustic_scale=scale)
        want = fbd.forward_backward(ll, graphs, nf, acoustic_scale=scale)
        torch.cuda.synchronize()
        assert (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        assert got.log_gamma.shape == (B, T, J) and got.loglik.shape == (B,)
        assert fb_cuda.LAST_ARMS.tolist() == [[fb_cuda.ARM_GENERAL] * B] * 2
        _assert_fb_close(got, want, nf)


def _assert_fb_close(got, want, nf):
    # the logsumexp over states sums in another order: fb_pallas's tolerances
    torch.testing.assert_close(got.loglik, want.loglik, rtol=1e-5, atol=1e-5)
    for b, n in enumerate(nf.tolist()):
        g, w = got.log_gamma[b, :n], want.log_gamma[b, :n]
        sel = w > -30
        torch.testing.assert_close(g[sel], w[sel], rtol=1e-4, atol=1e-4)
        assert bool((g[~sel] < -25).all())
        assert bool((got.log_gamma[b, n:] == fbd.NEG_INF).all())


def _chain_graphs(rng, J, P, n_states, skip=False):
    """Align-graph-shaped arrays: row b one left-to-right chain of
    n_states[b] states from state 0 to its final state, the rest padding;
    no loop arc (every enter and exit log-prob NEG_INF); with ``skip``,
    (j-2 -> j) skips along the chain."""
    B = len(n_states)
    out = {k: np.full((B, J), gr.NEG_INF, np.float32) for k in
           ("self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp")
           + (("skip_logp",) if skip else ())}
    out["emit_id"] = rng.integers(0, P, (B, J)).astype(np.int32)
    for b, n in enumerate(n_states):
        stay = rng.uniform(0.3, 0.9, n)
        out["self_logp"][b, :n] = np.log(stay)
        out["adv_logp"][b, 1:n] = np.log1p(-stay[:-1])  # the source state's advance
        out["init_logp"][b, 0] = out["final_logp"][b, n - 1] = 0.0
        if skip and n > 2:
            out["skip_logp"][b, 2:n] = -1.0 - rng.random(n - 2)
    return out


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("J", [64, 192, 256, 320, 1024, 2048])
def test_fb_kernels_on_chain_graphs(dev, J, skip):
    """K3f/K3b on graphs without a loop arc, the align graphs' shape: the
    chain arm up to its J limit (one to eight warps of registers per row,
    the j-1 / j+1 neighbours across lanes and warps), the block arm without
    the logsumexp above it; n_frames 0, 1, T and ragged, with and without
    skip transitions, against the plain version at the general arm's
    tolerances."""
    rng = np.random.default_rng(J + skip)
    B, P, T = 5, 97, J + 8
    nf = torch.tensor([T, 1, 0, T - 3, J // 2 + 1], dtype=torch.int32, device=dev)
    n_states = [J, J, J, J - 2, J // 2]
    graphs = vit.graphs_to_torch(_chain_graphs(rng, J, P, n_states, skip), dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3 - 5).astype(np.float32), device=dev)
    for scale in (1.0, 0.8):
        got = fb_cuda.forward_backward(ll, graphs, nf, acoustic_scale=scale)
        want = fbd.forward_backward(ll, graphs, nf, acoustic_scale=scale)
        torch.cuda.synchronize()
        arm = fb_cuda.ARM_CHAIN if J <= 1024 else fb_cuda.ARM_BLOCK
        assert fb_cuda.LAST_ARMS.tolist() == [[arm] * B] * 2
        assert bool((want.loglik[[0, 3]] > fbd.NEG_INF / 2).all())  # the long rows reach their final state
        _assert_fb_close(got, want, nf)


def test_fb_kernels_mixed_arms(dev):
    """A batch whose first row has one finite exit arc (a loop arc: the
    general arm) and whose other rows have none (the chain arm), in one
    launch of each kernel, against the plain version."""
    rng = np.random.default_rng(21)
    B, J, P, T = 4, 192, 97, 230
    g = _chain_graphs(rng, J, P, [J, 150, J - 5, 100])
    g["exit_logp"][0, J - 1] = -0.5
    graphs = vit.graphs_to_torch(g, dev)
    nf = torch.tensor([T, 170, 200, 3], dtype=torch.int32, device=dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3 - 5).astype(np.float32), device=dev)
    before = (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES, fb_cuda.COMBINE_LAUNCHES)
    got = fb_cuda.forward_backward(ll, graphs, nf)
    want = fbd.forward_backward(ll, graphs, nf)
    torch.cuda.synchronize()
    assert (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES, fb_cuda.COMBINE_LAUNCHES) == tuple(x + 1 for x in before)
    assert fb_cuda.LAST_ARMS.tolist() == [[fb_cuda.ARM_GENERAL] + [fb_cuda.ARM_CHAIN] * 3] * 2
    _assert_fb_close(got, want, nf)


@pytest.mark.parametrize("kind", ["chain", "general"])
def test_fb_kernels_repeat_bitwise(dev, kind):
    """log_gamma and loglik bitwise the same over 20 calls: K3f and K3b run
    on two streams at once and the combine waits for both."""
    rng = np.random.default_rng(22)
    B, J, P, T = 32, 192, 97, 550
    if kind == "chain":
        g = _chain_graphs(rng, J, P, rng.integers(100, J + 1, B).tolist())
    else:
        g = _random_graphs(rng, B, J, P)
    graphs = vit.graphs_to_torch(g, dev)
    nf = torch.as_tensor(rng.integers(200, T + 1, B).astype(np.int32), device=dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3 - 5).astype(np.float32), device=dev)
    first = fb_cuda.forward_backward(ll, graphs, nf)
    for _ in range(20):
        again = fb_cuda.forward_backward(ll, graphs, nf)
        assert torch.equal(again.log_gamma, first.log_gamma) and torch.equal(again.loglik, first.loglik)


def test_fb_kernels_count_launches(dev):
    """One call launches K3f, K3b and the combine once each; an empty batch
    launches none."""
    rng = np.random.default_rng(23)
    graphs = vit.graphs_to_torch(_chain_graphs(rng, 64, 20, [64, 30]), dev)
    ll = torch.zeros((2, 70, 20), device=dev)
    counters = lambda: (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES, fb_cuda.COMBINE_LAUNCHES)  # noqa: E731
    before = counters()
    fb_cuda.forward_backward(ll, graphs, torch.tensor([70, 40], device=dev))
    assert counters() == tuple(x + 1 for x in before)
    fb_cuda.forward_backward(ll[:, :0], graphs, torch.tensor([0, 0], device=dev))
    torch.cuda.synchronize()
    assert counters() == tuple(x + 1 for x in before)


def test_fb_kernels_one_frame(dev):
    rng = np.random.default_rng(3)
    B, J, P = 3, 50, 20
    graphs = vit.graphs_to_torch(_random_graphs(rng, B, J, P), dev)
    ll = torch.as_tensor(rng.standard_normal((B, 1, P)).astype(np.float32), device=dev)
    nf = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    got = fb_cuda.forward_backward(ll, graphs, nf)
    want = fbd.forward_backward(ll, graphs, nf)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.loglik, want.loglik, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.log_gamma, want.log_gamma, rtol=1e-4, atol=1e-4)


def test_fb_kernels_check_graphs(dev):
    rng = np.random.default_rng(2)
    g = _random_graphs(rng, 2, 20, 10)
    ll = torch.zeros((2, 5, 10), device=dev)
    nf = torch.tensor([5, 5], device=dev)
    bad = vit.graphs_to_torch({**g, "self_logp": g["self_logp"].astype(np.float64)}, dev)
    with pytest.raises(ValueError):
        fb_cuda.forward_backward(ll, bad, nf)
    wide = vit.graphs_to_torch(_random_graphs(rng, 2, 8 * 1024 + 1, 10), dev)
    with pytest.raises(RuntimeError):  # above the kernels' state limit
        fb_cuda.forward_backward(ll, wide, nf)


def _align_graphs():
    lex = make_lexicon({"ab": ["a", "b"], "ba": ["b", "a"], "abc": ["a", "b", "c"]})
    topo = build_topology(lex, TopologyConfig())
    words = [["ab", "ba"], ["abc"], ["ba", "abc", "ab"], []]
    return topo, pipe.build_align_graphs(words, lex, topo)


def test_viterbi_kernel_bitwise_on_align_graphs(dev):
    """K2 on per-utterance align graphs (J padded to a multiple of 64), the
    traffic of Viterbi EM."""
    rng = np.random.default_rng(5)
    topo, graphs_np = _align_graphs()
    graphs = vit.graphs_to_torch(graphs_np, dev)
    B, T = graphs_np["emit_id"].shape[0], 60
    ll = torch.as_tensor((rng.standard_normal((B, T, topo.n_pdfs)) * 3 - 10).astype(np.float32), device=dev)
    nf = torch.tensor([T, 41, 25, 0], dtype=torch.int32, device=dev)
    got = viterbi_cuda.viterbi(ll, graphs, nf)
    want = vit.viterbi(ll, graphs, nf)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _assert_viterbi_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("beam", [0.0, 2.0])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("J", [37, 64, 192, 320, 1024, 2048])
def test_viterbi_chain_arm_bitwise(dev, J, skip, beam):
    """K2 on graphs without a loop arc (the align graphs' shape), padded
    (rows of fewer states than J), with n_frames of T, 1, 0 and short rows:
    the chain arm up to J = 1024 (one to eight warps of registers, 1-4 states
    a lane), the word-loop arm without the exit argmax above it; path,
    entered and score bitwise the plain version's, with and without skips
    and a beam, and every row reports its arm."""
    rng = np.random.default_rng(J + 2 * skip + int(beam))
    B, P, T = 6, 97, J + 40
    n_states = [J, J - 3, max(J // 2, 1), J, min(J, 5), J]
    nf = torch.tensor([T, T - 7, 1, 0, 12, J // 3 + 2], dtype=torch.int32, device=dev)
    graphs = vit.graphs_to_torch(_chain_graphs(rng, J, P, n_states, skip), dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3 - 5).astype(np.float32), device=dev)
    for scale in (1.0, 0.7):
        got = viterbi_cuda.viterbi(ll, graphs, nf, acoustic_scale=scale, beam=beam)
        arms = viterbi_cuda.LAST_ARMS.tolist()
        want = vit.viterbi(ll, graphs, nf, acoustic_scale=scale, beam=beam)
        torch.cuda.synchronize()
        _assert_viterbi_equal(got, want)
        assert arms == [viterbi_cuda.ARM_CHAIN if J <= 1024 else viterbi_cuda.ARM_BLOCK] * B
        if beam == 0:  # the long rows reach their final state
            assert bool((want.score[[0, 1]] > vit.NEG_INF / 2).all())
        score_only = viterbi_cuda.viterbi(ll, graphs, nf, acoustic_scale=scale, beam=beam, with_backtrace=False)
        assert torch.equal(score_only.score, want.score)


@pytest.mark.parametrize("beam", [0.0, 4.0])
@pytest.mark.parametrize("skip", [False, True])
def test_viterbi_chain_arm_on_align_graphs(dev, skip, beam):
    """K2's chain arm on per-utterance align graphs (J padded to a multiple
    of 64, a dummy row's silence graph), with CTC skips inside the chains and
    a beam: bitwise the plain version."""
    rng = np.random.default_rng(7 + skip)
    topo, graphs_np = _align_graphs()
    if skip:
        chain = graphs_np["chain_id"]
        same = np.zeros_like(chain, bool)
        same[:, 2:] = (chain[:, 2:] == chain[:, :-2]) & (chain[:, 2:] >= 0)
        graphs_np = {**graphs_np, "skip_logp": np.where(same, np.float32(-0.1), gr.NEG_INF).astype(np.float32)}
    graphs = vit.graphs_to_torch(graphs_np, dev)
    B, T = graphs_np["emit_id"].shape[0], 60
    ll = torch.as_tensor((rng.standard_normal((B, T, topo.n_pdfs)) * 3 - 10).astype(np.float32), device=dev)
    nf = torch.tensor([T, 41, 25, 0], dtype=torch.int32, device=dev)
    got = viterbi_cuda.viterbi(ll, graphs, nf, beam=beam)
    assert viterbi_cuda.LAST_ARMS.tolist() == [viterbi_cuda.ARM_CHAIN] * B
    _assert_viterbi_equal(got, vit.viterbi(ll, graphs, nf, beam=beam))


def _single_chain_row(g, b, J, rng):
    """Row b of graph arrays g: one chain over all J states, entered and
    left by the loop (enter/init at state 0, exit/final at J - 1)."""
    for k in ("self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp"):
        g[k][b] = gr.NEG_INF
    g["self_logp"][b] = -rng.random(J)
    g["adv_logp"][b, 1:] = -rng.random(J - 1)
    g["enter_logp"][b, 0] = g["init_logp"][b, 0] = -0.5
    g["exit_logp"][b, J - 1] = g["final_logp"][b, J - 1] = -0.5


@pytest.mark.parametrize("beam", [0.0, 3.0])
def test_viterbi_word_loop_arm_exit_fallbacks(dev, beam):
    """The word-loop arm's compact exit set and its fallback to the full
    argmax, in one launch with chain-arm rows: a row with loop arcs (random
    chains), a row whose only exit state is never live (one chain longer
    than T: the full argmax every frame), two rows without a loop arc; and
    a launch whose rows have more exit states than the compact list holds
    (J = 6000, every state a one-state chain). Bitwise the plain version."""
    rng = np.random.default_rng(31)
    B, J, P, T = 4, 300, 97, 40
    g = _random_graphs(rng, B, J, P)
    _single_chain_row(g, 1, J, rng)
    chains = _chain_graphs(rng, J, P, [J, 120])
    for k in chains:
        g[k][2:] = chains[k]
    graphs = vit.graphs_to_torch(g, dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3 - 5).astype(np.float32), device=dev)
    nf = torch.tensor([T, T, 30, 17], dtype=torch.int32, device=dev)
    got = viterbi_cuda.viterbi(ll, graphs, nf, beam=beam)
    A = viterbi_cuda
    assert A.LAST_ARMS.tolist() == [A.ARM_LOOP, A.ARM_LOOP, A.ARM_CHAIN, A.ARM_CHAIN]
    _assert_viterbi_equal(got, vit.viterbi(ll, graphs, nf, beam=beam))

    J = 6000
    g = {k: np.full((2, J), gr.NEG_INF, np.float32) for k in
         ("self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp")}
    g["emit_id"] = rng.integers(0, P, (2, J)).astype(np.int32)
    for k in ("self_logp", "enter_logp", "exit_logp", "init_logp", "final_logp"):
        g[k][:] = -rng.random((2, J)).astype(np.float32)
    graphs = vit.graphs_to_torch(g, dev)
    ll = torch.as_tensor((rng.standard_normal((2, T, P)) * 3).astype(np.float32), device=dev)
    nf = torch.tensor([T, 21], dtype=torch.int32, device=dev)
    got = viterbi_cuda.viterbi(ll, graphs, nf, beam=beam)
    assert viterbi_cuda.LAST_ARMS.tolist() == [viterbi_cuda.ARM_LOOP] * 2
    _assert_viterbi_equal(got, vit.viterbi(ll, graphs, nf, beam=beam))


def test_viterbi_align_writes_pdfs(dev):
    """viterbi_cuda.align: K2 with each frame's pdf written in its backtrace,
    on a launch mixing chain-arm and word-loop rows with n_frames of T, 0, 1
    and short: the plain Viterbi and path_to_pdfs of it, bitwise; one
    launch; pipeline.align_batch's labels on the kernels are path_to_pdfs of
    its path."""
    rng = np.random.default_rng(41)
    B, J, P, T = 4, 192, 97, 230
    g = _chain_graphs(rng, J, P, [J, 150, J - 5, 100])
    loop = _random_graphs(rng, 1, J, P)
    for k in loop:
        g[k][0] = loop[k][0]
    graphs = vit.graphs_to_torch(g, dev)
    nf = torch.tensor([T, 0, 1, 120], dtype=torch.int32, device=dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3 - 5).astype(np.float32), device=dev)
    before = viterbi_cuda.LAUNCHES
    res, pdfs = viterbi_cuda.align(ll, graphs, nf, acoustic_scale=0.9)
    torch.cuda.synchronize()
    assert viterbi_cuda.LAUNCHES == before + 1
    assert viterbi_cuda.LAST_ARMS.tolist() == [viterbi_cuda.ARM_LOOP] + [viterbi_cuda.ARM_CHAIN] * 3
    want = vit.viterbi(ll, graphs, nf, acoustic_scale=0.9)
    _assert_viterbi_equal(res, want)
    assert pdfs.dtype == torch.int32 and torch.equal(pdfs, vit.path_to_pdfs(want, graphs))

    topo, graphs_np = _align_graphs()
    B, T = graphs_np["emit_id"].shape[0], 60
    fb = pipe.FeatBatch(["a", "b", "c", "d"], torch.as_tensor(
        rng.standard_normal((B, T, 39)).astype(np.float32), device=dev),
        torch.tensor([T, 41, 25, 0], dtype=torch.int32, device=dev), [["ab", "ba"], ["abc"], ["ba", "abc", "ab"], []])
    rng_g = np.random.default_rng(5)
    K = 2
    gmm = gmm_from_numpy(rng_g.dirichlet(np.ones(K), size=topo.n_pdfs), rng_g.standard_normal((topo.n_pdfs, K, 39)),
                         0.5 + rng_g.random((topo.n_pdfs, K, 39)), dev)
    res, labels, graphs = pipe.align_batch(fb, gmm, topo.lexicon, topo)
    assert torch.equal(labels, vit.path_to_pdfs(res, graphs))


def test_fb_kernels_on_align_graphs(dev):
    rng = np.random.default_rng(6)
    topo, graphs_np = _align_graphs()
    graphs = vit.graphs_to_torch(graphs_np, dev)
    B, T = graphs_np["emit_id"].shape[0], 60
    ll = torch.as_tensor(rng.standard_normal((B, T, topo.n_pdfs)).astype(np.float32), device=dev)
    nf = torch.tensor([T, 41, 25, 0], dtype=torch.int32, device=dev)
    got = fb_cuda.forward_backward(ll, graphs, nf, acoustic_scale=0.8)
    want = fbd.forward_backward(ll, graphs, nf, acoustic_scale=0.8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.loglik, want.loglik, rtol=1e-5, atol=1e-5)
    post = fbd.state_posteriors_to_pdf(got.log_gamma, graphs["emit_id"], topo.n_pdfs)
    post_want = fbd.state_posteriors_to_pdf(want.log_gamma, graphs["emit_id"], topo.n_pdfs)
    torch.testing.assert_close(post, post_want, rtol=0, atol=1e-4)


# K4 vs the plain recurrence: float32 sums in another order (readings on the
# H100 below 1e-6); in bf16 mode h is rounded to bf16 every frame from values
# that differ in the last float32 bits, so an occasional rounding flips and
# the flips compound over frames (readings up to 7e-4 at T = 600).
K4_ATOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _lstm_inputs(rng, B, T, H, dev):
    xg = torch.as_tensor(rng.standard_normal((B, T, 4 * H)).astype(np.float32), device=dev)
    w = torch.as_tensor((rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32), device=dev)
    nf = torch.as_tensor(np.r_[T, 1, 0, rng.integers(1, T + 1, B - 3)][:B].astype(np.int32), device=dev)
    return xg, w, nf


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H", [(3, 17, 11), (16, 50, 200), (5, 9, 512), (64, 40, 512), (6, 12, 640)])
def test_lstm_kernel_matches_plain(dev, compute_dtype, B, T, H):
    xg, w, nf = _lstm_inputs(np.random.default_rng(B + T + H), B, T, H, dev)
    before = lstm_cuda.LAUNCHES
    got = lstm_cuda.lstm_layer(xg, w, nf, compute_dtype)
    want = fast_lstm.lstm_layer(xg, w, nf, compute_dtype)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == before + 1
    assert got.shape == (B, T, H) and got.dtype == torch.float32
    assert float(got[2].abs().max()) == 0.0  # n_frames = 0
    torch.testing.assert_close(got, want, rtol=0, atol=K4_ATOL[compute_dtype])


def test_lstm_kernel_wide_batch_runs_in_row_blocks(dev):
    """More rows than one launch takes (64): several launches from the one
    entry point, each over a block of the rows ordered by n_frames, the same
    result."""
    xg, w, nf = _lstm_inputs(np.random.default_rng(7), 150, 20, 200, dev)
    before = lstm_cuda.LAUNCHES
    got = lstm_cuda.lstm_layer(xg, w, nf)
    want = fast_lstm.lstm_layer(xg, w, nf)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES >= before + 3
    torch.testing.assert_close(got, want, rtol=0, atol=K4_ATOL["float32"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", ["all T", "all 0", "unsorted with ties"])
def test_lstm_kernel_row_lengths(dev, compute_dtype, lengths):
    """Every row live to the end (nothing to skip), no row live (the frame
    loop never runs: zeros), and rows given out of order with several equal
    lengths."""
    B, T, H = 24, 33, 96
    xg, w, _ = _lstm_inputs(np.random.default_rng(11), B, T, H, dev)
    nf = {"all T": np.full(B, T), "all 0": np.zeros(B),
          "unsorted with ties": np.random.default_rng(12).choice([0, 5, 5, 17, 17, 17, 33, 40], B)}[lengths]
    nf = torch.as_tensor(nf.astype(np.int32), device=dev)
    got = lstm_cuda.lstm_layer(xg, w, nf, compute_dtype)
    want = fast_lstm.lstm_layer(xg, w, nf, compute_dtype)
    torch.cuda.synchronize()
    if lengths == "all 0":
        assert float(got.abs().max()) == 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=K4_ATOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_lstm_kernel_repeats_bitwise(dev, compute_dtype):
    """The same launch at the hybrid path's widest shape (64 x 600 x 512),
    20 times: bitwise-equal results. A stale h read across the frame
    barrier, or through the bulk copies without the proxy fence, would show
    as a rare difference."""
    B, T, H = 64, 600, 512
    xg, w, nf = _lstm_inputs(np.random.default_rng(13), B, T, H, dev)
    first = lstm_cuda.lstm_layer(xg, w, nf, compute_dtype)
    for _ in range(19):
        assert torch.equal(lstm_cuda.lstm_layer(xg, w, nf, compute_dtype), first)
    torch.testing.assert_close(first, fast_lstm.lstm_layer(xg, w, nf, compute_dtype), rtol=0,
                               atol=K4_ATOL[compute_dtype])


def test_lstm_kernel_checks_inputs(dev):
    xg, w, nf = _lstm_inputs(np.random.default_rng(8), 4, 6, 8, dev)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_layer(xg[..., :-1], w, nf)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_layer(xg, w[:, :-4], nf)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_layer(xg, w.cpu(), nf)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_layer(xg.double(), w, nf)
    before = lstm_cuda.LAUNCHES
    out = lstm_cuda.lstm_layer(xg[:, :0], w, nf)  # no frames: no launch
    assert out.shape == (4, 0, 8) and lstm_cuda.LAUNCHES == before


@pytest.mark.parametrize("arch", ["lstm", "blstm"])
def test_recurrent_models_kernel_route_matches_plain(dev, arch):
    model = init_(tn.build_model(arch, 7, TrainConfig(nn_hidden=24, nn_layers=3), 5),
                  torch.Generator().manual_seed(3)).to(dev)
    rng = np.random.default_rng(9)
    feats = torch.as_tensor(rng.standard_normal((4, 30, 5)).astype(np.float32), device=dev)
    nf = torch.tensor([30, 17, 1, 0], dtype=torch.int32, device=dev)
    before = lstm_cuda.LAUNCHES
    with torch.no_grad():
        got = model(feats, nf)
        want = model(feats, nf, use_kernels=False)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == before + (2 if arch == "lstm" else 4)
    valid = tn.valid_mask(nf, 30, dev)
    torch.testing.assert_close(got[valid], want[valid], rtol=0, atol=1e-5)


def test_mmi_batch_on_k3_general_arm_matches_float64(dev):
    """One MMI batch at acoustic scale 0.1: noisy features, a ragged batch
    (a row without frames among them), the numerator on K3's chain arm over
    the align graphs, the denominator on its general arm over the word loop;
    statistics and the EBW update held to a float64 run at chip_smoke's
    phase 17 limits (``chip_smoke.mmi_batch_check``)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from mogasr_torch.hmm.lexicon import synthetic_lexicon

    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    rng = np.random.default_rng(17)
    S, K, D, T = topo.n_pdfs, 2, 39, 90
    gmm = gmm_from_numpy(rng.dirichlet(np.ones(K), size=S), rng.standard_normal((S, K, D)),
                         0.5 + rng.random((S, K, D)), dev)
    words = [[str(w) for w in rng.choice(lex.words, n)] for n in (3, 2, 0, 1, 2)]
    nf = torch.as_tensor([T, 61, 0, 40, 77], dtype=torch.int32, device=dev)
    feats = torch.as_tensor((rng.standard_normal((len(words), T, D)) * 2.0).astype(np.float32), device=dev)
    fb = pipe.FeatBatch([f"u{i}" for i in range(len(words))], feats, nf, words)
    den_graph = pipe.word_decode_graph(lex, topo, DecodeConfig(acoustic_scale=chip_smoke.MMI_SCALE))
    out = chip_smoke.mmi_batch_check(gmm, fb, lex, topo, den_graph)
    assert out["numerator"]["arms"] == [fb_cuda.ARM_CHAIN] * len(words)
    assert out["denominator"]["arms"] == [fb_cuda.ARM_GENERAL] * len(words)
    assert max(out["denominator"]["stats_err"].values()) <= chip_smoke.MMI_STATS_TOL


def _small_word_loop(skips: bool = False):
    """The small lexicon's multi-pronunciation word loop (an alternate
    pronunciation of 'fish'), optionally with a (j-2 -> j) skip of log-prob
    -0.7 inside every chain, its pronunciation priors, a bigram over it."""
    import dataclasses

    from mogasr_torch.data.synthetic import LEXICON
    from mogasr_torch.hmm.lexicon import make_lexicon_multi
    from mogasr_torch.lm import ngram

    variants = {w: [list(LEXICON[w])] for w in ["fish", "cat", "see", "sun", "tree", "dog"]}
    variants["fish"].append(["f", "iy", "sh"])
    lex = make_lexicon_multi(variants)
    topo = build_topology(lex, TopologyConfig())
    graph, pron_logp = pipe.word_decode_graph_multi(lex, topo, DecodeConfig(word_insertion_penalty=1.0))
    if skips:
        skip = np.full(graph.n_states, -1e30, np.float32)
        same = np.zeros(graph.n_states, bool)
        same[2:] = graph.chain_id[2:] == graph.chain_id[:-2]
        skip[same] = -0.7
        graph = dataclasses.replace(graph, skip_logp=skip)
    lm = ngram.estimate_bigram_kn([["fish", "cat"], ["see", "fish", "dog"], ["sun", "tree", "cat"]],
                                  sorted(set(graph.labels)))
    return topo, graph, pron_logp, lm


def _word_emissions(topo, graph, rng, B, T):
    """[B, T, P] float32 emissions that decode to words: noise, and each row
    walking the states of random word chains, 3 frames a state, with its
    pdf's score raised by 8."""
    scores = rng.standard_normal((B, T, topo.n_pdfs)) * 3 - 10
    for b in range(B):
        t = 0
        while t < T:
            c = int(rng.integers(len(graph.labels)))
            for j in np.nonzero(graph.chain_id == c)[0]:
                scores[b, t:t + 3, graph.emit_id[j]] += 8.0
                t += 3
    return scores.astype(np.float32)


@pytest.mark.parametrize("skips", [False, True])
@pytest.mark.parametrize("with_lattice", [False, True])
def test_viterbi_lm_on_the_card_matches_cpu(dev, with_lattice, skips):
    """The LM recursion on the card against the same function on the CPU,
    bitwise: its segment argmax reduces with exact atomic max/min, every
    other step is elementwise or a first-index max."""
    from mogasr_torch.decoder import lm_viterbi as lv

    topo, graph, pron_logp, lm = _small_word_loop(skips)
    rng = np.random.default_rng(23)
    B, T = 5, 53
    scores = torch.as_tensor(_word_emissions(topo, graph, rng, B, T))
    nf = torch.as_tensor([T, 1, 0, 37, 52], dtype=torch.int32)
    kw = dict(acoustic_scale=0.9, insertion_penalty=1.0, chain_entry_logp=pron_logp, with_lattice=with_lattice)
    got = lv.viterbi_lm(scores.to(dev), graph, lm, nf.to(dev), **kw)
    want = lv.viterbi_lm(scores, graph, lm, nf, **kw)
    if with_lattice:
        (got, lat), (want, lat_cpu) = got, want
        assert all(a.device.type == "cuda" for a in lat)
        for a, b in zip(lat, lat_cpu):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    assert got.path.device.type == "cuda"
    for field in ("path", "entered", "score"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field))


def test_confidence_and_nbest_through_k2_and_k3(dev):
    """decode_batch_with_confidence / decode_batch_nbest through K2 and
    K3f/K3b (the word loop: K3's general arm) against the plain versions on
    the card: the same words and spans, confidences within 1e-3."""
    topo, graph, _pron, _lm = _small_word_loop()
    rng = np.random.default_rng(29)
    B, T = 4, 61
    scores = torch.as_tensor(_word_emissions(topo, graph, rng, B, T), device=dev)
    fb = pipe.FeatBatch([f"u{i}" for i in range(3)], torch.zeros((B, T, 39), device=dev),
                        torch.as_tensor([T, 40, 0, 1], dtype=torch.int32, device=dev), [[], [], []])
    dcfg = DecodeConfig(word_insertion_penalty=1.0)
    k2, k3 = viterbi_cuda.LAUNCHES, fb_cuda.FWD_LAUNCHES
    got = pipe.decode_batch_with_confidence(fb, scores, graph, dcfg, with_times=True)
    assert viterbi_cuda.LAUNCHES == k2 + 1 and fb_cuda.FWD_LAUNCHES == k3 + 1
    assert set(fb_cuda.LAST_ARMS.flatten().tolist()) == {fb_cuda.ARM_GENERAL}
    want = pipe.decode_batch_with_confidence(fb, scores, graph, dcfg, with_times=True, use_kernels=False)
    assert [[(w, a, b) for w, _c, a, b in row] for row in got] == [[(w, a, b) for w, _c, a, b in row] for row in want]
    assert any(got)
    np.testing.assert_allclose([c for row in got for _w, c, _a, _b in row],
                               [c for row in want for _w, c, _a, _b in row], atol=1e-3)
    got_n = pipe.decode_batch_nbest(fb, scores, graph, dcfg, n_best=3)
    want_n = pipe.decode_batch_nbest(fb, scores, graph, dcfg, n_best=3, use_kernels=False)
    assert [[(d["best"], d["span"]) for d in row] for row in got_n] == \
        [[(d["best"], d["span"]) for d in row] for row in want_n]
    for row, wrow in zip(got_n, want_n):
        for d, w in zip(row, wrow):
            a, b = dict(d["alternatives"]), dict(w["alternatives"])
            assert all(abs(a[k] - b[k]) <= 1e-3 for k in a.keys() & b.keys())


def test_decode_batch_lattices_on_the_card_matches_cpu(dev):
    from mogasr_torch.decoder import lm_viterbi as lv

    topo, graph, pron_logp, lm = _small_word_loop()
    rng = np.random.default_rng(31)
    B, T = 3, 44
    scores = torch.as_tensor(_word_emissions(topo, graph, rng, B, T))
    nf = torch.as_tensor([T, 30, 9], dtype=torch.int32)
    dcfg = DecodeConfig(word_insertion_penalty=1.0)

    def fb_on(d):
        return pipe.FeatBatch(["a", "b", "c"], torch.zeros((B, T, 39), device=d), nf.to(d), [[], [], []])

    lats, res = pipe.decode_batch_lattices(fb_on(dev), scores.to(dev), graph, lm, dcfg, chain_entry_logp=pron_logp,
                                           prune_beam=8.0)
    want, want_res = pipe.decode_batch_lattices(fb_on(torch.device("cpu")), scores, graph, lm, dcfg,
                                                 chain_entry_logp=pron_logp, prune_beam=8.0)
    assert isinstance(res, lv.LmViterbiResult) and torch.equal(res.path.cpu(), want_res.path)
    assert [(lat.n_frames, lat.arcs) for lat in lats] == [(lat.n_frames, lat.arcs) for lat in want]


@pytest.mark.parametrize("J,n", [(192, 1168), (3048, 1168)])
def test_statistics_sums_repeat_bitwise(dev, J, n):
    """The E-step's sums over states and the collapse of graph states to
    pdfs (utils/segment.py): two runs on the card give the same bits, and
    those of the CPU on the same inputs (both add each target's terms one
    after another in position order); ``accumulate_stats`` and
    ``state_posteriors_to_pdf`` twice on the card, bitwise."""
    from mogasr_torch.am import em
    from mogasr_torch.utils.segment import collapse_columns, index_sum

    rng = np.random.default_rng(J)
    S, K, D, N = n, 16, 39, 8 * 550
    labels = np.where(rng.random(N) < 0.35, rng.integers(0, 3, N), rng.integers(0, S, N))
    labels[-300:] = -1
    labels = torch.as_tensor(labels.astype(np.int32))
    values = torch.as_tensor(rng.standard_normal((N, 2 * K + 1)).astype(np.float32))
    got = [index_sum(values.to(dev), labels.to(dev), S) for _ in range(2)]
    want = index_sum(values, labels, S)
    assert torch.equal(got[0], got[1]) and torch.equal(got[0].cpu(), want)
    g, x = _random_gmm(dev, S, K, D, N)
    stats = [em.accumulate_stats(g, x, labels.to(dev)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*stats))
    B, T = 4, 300
    emit_id = torch.as_tensor(rng.integers(0, n, (B, J)))
    gamma = torch.as_tensor(rng.standard_normal((B, T, J)).astype(np.float32))
    got = [collapse_columns(gamma.to(dev), emit_id.to(dev), n) for _ in range(2)]
    assert torch.equal(got[0], got[1]) and torch.equal(got[0].cpu(), collapse_columns(gamma, emit_id, n))
    log_gamma = (gamma * 20 - 30).to(dev)
    post = [fbd.state_posteriors_to_pdf(log_gamma, emit_id.to(dev), n) for _ in range(2)]
    assert torch.equal(post[0], post[1])

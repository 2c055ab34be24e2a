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


def _stream_chunks(n_frames, sizes):
    off = 0
    for tc in sizes:
        yield off, tc, np.clip(n_frames - off, 0, tc).astype(np.int32)
        off += tc


@pytest.mark.parametrize("beam", [0.0, 3.0])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("J", [37, 200, 3048])
def test_viterbi_chunk_arm_bitwise_equals_plain(dev, J, skip, beam):
    """K2's chunk arm against the plain chunk step, chunk after chunk: delta
    and started bitwise, the stored codes equal, the exit argmax equal where
    a code enters; word-loop rows (J 3048, random graphs) and chain rows
    (align graphs of J 37 and 200, without enter or exit arcs), a stream that
    never starts, one that starts in a later chunk and streams ending inside
    a chunk."""
    from mogasr_torch.decoder import online

    rng = np.random.default_rng(J + int(skip))
    B, T, P = 5, 40, 97
    g = _random_graphs(rng, B, J, P, skip)
    if J < 3048:  # align-shaped rows: no loop arc, the chain arm
        for k in ("enter_logp", "exit_logp"):
            g[k][:] = gr.NEG_INF
        g["init_logp"][:] = gr.NEG_INF
        g["init_logp"][:, 0] = 0.0
        g["final_logp"][:] = gr.NEG_INF
        g["final_logp"][:, -1] = 0.0
    graphs = vit.graphs_to_torch(g, dev)
    ll = torch.as_tensor((rng.standard_normal((B, T, P)) * 3).astype(np.float32), device=dev)
    # valid frames of each stream in chunks of 7, 9 and 24 frames: full,
    # ending inside the second chunk, one frame, none, and one that joins at
    # the second chunk (its first frame initializes there)
    schedule = np.asarray([[7, 9, 24], [7, 9, 1], [1, 0, 0], [0, 0, 0], [0, 9, 5]], np.int32)
    delta = torch.full((B, J), online.NEG_INF, device=dev)
    started = torch.zeros(B, dtype=torch.bool, device=dev)
    pd, ps = delta.clone(), started.clone()
    bp, xa = viterbi_cuda.code_buffers(B, J, T, dev)
    for c, (off, tc) in enumerate(((0, 7), (7, 9), (16, 24))):
        nv = schedule[:, c]
        before = viterbi_cuda.CHUNK_LAUNCHES
        viterbi_cuda.chunk_step(delta, started, ll[:, off:off + tc], torch.as_tensor(nv, device=dev), graphs, 0.7,
                                beam, bp, xa, off)
        pd, ps, pbp, pxa = online.chunk_step(pd, ps, ll[:, off:off + tc], torch.as_tensor(nv, device=dev), graphs,
                                             0.7, beam)
        torch.cuda.synchronize()
        assert viterbi_cuda.CHUNK_LAUNCHES == before + 1
        assert torch.equal(delta, pd) and torch.equal(started, ps)
        codes = viterbi_cuda.unpack_codes(bp, slice(off, off + tc), J)
        assert torch.equal(codes, pbp)
        enter = codes == 2
        want_x = pxa[:, :, None].expand(tc, B, J)[enter]
        assert torch.equal(xa[:, off:off + tc].t()[:, :, None].expand(tc, B, J)[enter], want_x)
    arm = viterbi_cuda.ARM_CHAIN if J < 3048 else viterbi_cuda.ARM_LOOP
    assert bool((viterbi_cuda.LAST_ARMS == arm).all())


@pytest.mark.parametrize("beam", [0.0, 3.0])
@pytest.mark.parametrize("J", [37, 3048])
def test_online_decoder_on_the_card_matches_cpu_and_offline(dev, J, beam):
    """The online decoder on the card (K2's chunk arm, its backtrace alone)
    against the same decoder on the CPU (the plain step, the host backtrace):
    every partial and the final result bitwise; the final result bitwise the
    offline K2 decode; the stream buffer grown by doubling."""
    from mogasr_torch.decoder import online

    rng = np.random.default_rng(J)
    B, T, P = 5, 70, 97
    g = _random_graphs(rng, B, J, P)
    ll = (rng.standard_normal((B, T, P)) * 3).astype(np.float32)
    n_frames = np.asarray([T, 17, 1, 0, 52], np.int32)
    card = online.OnlineDecoder(vit.graphs_to_torch(g, dev), acoustic_scale=0.7, beam=beam)
    cpu = online.OnlineDecoder(vit.graphs_to_torch(g, torch.device("cpu")), acoustic_scale=0.7, beam=beam)
    caps = []
    for off, tc, nv in _stream_chunks(n_frames, [25, 25, 20]):
        before = viterbi_cuda.BACKTRACE_LAUNCHES
        card.process(torch.as_tensor(ll[:, off:off + tc], device=dev), nv)
        cpu.process(torch.as_tensor(ll[:, off:off + tc]), nv)
        caps.append(card._bp.shape[1])
        for a, b in zip(card.partial(), cpu.partial()):
            assert torch.equal(a.cpu(), b)
        assert viterbi_cuda.BACKTRACE_LAUNCHES == before + 1
    assert caps == [64, 64, 128]
    final = card.finalize()
    for a, b in zip(final, cpu.finalize()):
        assert torch.equal(a.cpu(), b)
    off = viterbi_cuda.viterbi(torch.as_tensor(ll, device=dev), vit.graphs_to_torch(g, dev),
                               torch.as_tensor(n_frames, device=dev), acoustic_scale=0.7, beam=beam)
    assert torch.equal(final[0], off.path) and torch.equal(final[1], off.entered)
    # a stream without frames never starts (score NEG_INF); the offline
    # decode initializes every row at frame 0
    live = torch.as_tensor(n_frames > 0, device=dev)
    assert torch.equal(final[2][live], off.score[live])


def test_viterbi_chunk_arm_checks_buffers(dev):
    rng = np.random.default_rng(1)
    graphs = vit.graphs_to_torch(_random_graphs(rng, 2, 37, 9), dev)
    ll = torch.zeros((2, 4, 9), device=dev)
    delta = torch.zeros((2, 37), device=dev)
    started = torch.zeros(2, dtype=torch.bool, device=dev)
    bp = torch.zeros((2, 8, 2, 2), dtype=torch.int32, device=dev)
    xa = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    nv = torch.full((2,), 4, device=dev)
    with pytest.raises(ValueError):
        viterbi_cuda.chunk_step(delta[:, :-1], started, ll, nv, graphs, 1.0, 0.0, bp, xa, 0)
    with pytest.raises(ValueError):
        viterbi_cuda.chunk_step(delta, started, ll, nv, graphs, 1.0, 0.0, bp[:, :, :1], xa, 0)
    with pytest.raises(ValueError):  # the chunk does not fit the buffer (checked on the host)
        viterbi_cuda.chunk_step(delta, started, ll, nv, graphs, 1.0, 0.0, bp, xa, 6)
    with pytest.raises(ValueError):  # one row's does not
        viterbi_cuda.chunk_step(delta, started, ll, nv.cpu(), graphs, 1.0, 0.0, bp, xa, [0, 5])


@pytest.mark.parametrize("beam", [0.0, 3.0])
@pytest.mark.parametrize("J", [37, 3048])
def test_viterbi_chunk_arm_ragged_offsets_bitwise_plain(dev, J, beam):
    """K2's chunk arm with a frame offset per row (the serving engine's
    launch): rows at ragged offsets, reused rows back at 0, a row at the
    buffers' end and idle rows, from garbage-filled buffers, against the
    CPU route (the plain step, its codes scattered at the offsets): delta,
    started and both buffers bit for bit, over three chunks."""
    rng = np.random.default_rng(J + 7)
    B, Tc, P, t_cap = 9, 24, 97, 120
    g = _random_graphs(rng, B, J, P)
    graphs, graphs_c = vit.graphs_to_torch(g, dev), vit.graphs_to_torch(g, torch.device("cpu"))
    started = torch.as_tensor(rng.random(B) < 0.6)
    delta = torch.where(started[:, None], torch.as_tensor(rng.standard_normal((B, J)).astype(np.float32)),
                        torch.full((B, J), -1e30))
    bp = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, size=(B, t_cap, -(-J // 32), 2)), dtype=torch.int32)
    xa = torch.as_tensor(rng.integers(0, J, size=(B, t_cap)), dtype=torch.int32)
    frames = np.asarray([0, 0, 17, 40, 96, 120, 3, 0, 55])
    card = [t.to(dev) for t in (delta, started, bp, xa)]
    cpu = [t.clone() for t in (delta, started, bp, xa)]
    for c in range(3):
        nv = rng.integers(0, Tc + 1, size=B).astype(np.int32)
        nv[c] = 0                                   # an idle row
        nv = np.minimum(nv, t_cap - frames)         # the row at the end stays idle
        ll = (rng.standard_normal((B, Tc, P)) * 3).astype(np.float32)
        before = viterbi_cuda.CHUNK_LAUNCHES
        viterbi_cuda.chunk_step(card[0], card[1], torch.as_tensor(ll, device=dev), torch.as_tensor(nv), graphs,
                                0.7, beam, card[2], card[3], frames)
        viterbi_cuda.chunk_step(cpu[0], cpu[1], torch.as_tensor(ll), torch.as_tensor(nv), graphs_c, 0.7, beam,
                                cpu[2], cpu[3], frames)
        torch.cuda.synchronize()
        assert viterbi_cuda.CHUNK_LAUNCHES == before + 1
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)
        frames = frames + nv


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H", [(3, 17, 11), (64, 40, 512), (70, 12, 200)])
def test_lstm_carry_arm_matches_plain(dev, compute_dtype, B, T, H):
    """K4's carry arm: from random carries, ragged n_frames with rows at 0,
    against the plain recurrence; the outputs and the final carries within
    K4's tolerance, the carries of rows without frames h0 and c0 bitwise."""
    rng = np.random.default_rng(B + T + H)
    xg, w, nf = _lstm_inputs(rng, B, T, H, dev)
    h0, c0 = (torch.as_tensor(rng.standard_normal((B, H)).astype(np.float32), device=dev) for _ in range(2))
    before = lstm_cuda.LAUNCHES, lstm_cuda.CARRY_LAUNCHES
    got, (h, c) = lstm_cuda.lstm_layer(xg, w, nf, compute_dtype, h0=h0, c0=c0, return_carry=True)
    want, (hp, cp) = fast_lstm.lstm_layer(xg, w, nf, compute_dtype, h0=h0, c0=c0, return_carry=True)
    torch.cuda.synchronize()
    launched = lstm_cuda.LAUNCHES - before[0]
    assert launched >= 1 and lstm_cuda.CARRY_LAUNCHES - before[1] == launched
    for a, b in ((got, want), (h, hp), (c, cp)):
        torch.testing.assert_close(a, b, rtol=0, atol=K4_ATOL[compute_dtype])
    zero = nf == 0
    assert bool(zero.any())
    assert torch.equal(h[zero], h0[zero]) and torch.equal(c[zero], c0[zero])
    assert torch.equal(got[zero], h0[zero][:, None].expand(-1, T, H))


def test_lstm_stream_on_the_card_matches_offline(dev):
    """LstmAmStream on K4's carry arm, in chunks of 7, against the offline
    LstmAm on K4 (float32, the reference's 1e-5), and against the plain
    stream."""
    torch.manual_seed(0)
    B, T, D = 6, 30, 13
    model = tn.LstmAmStream(11, D, hidden=64, layers=2)
    init_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    feats = torch.randn((B, T, D), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        offline = tn.LstmAm.forward(model, feats, torch.full((B,), T, device=dev))
        carries = tn.lstm_stream_init(model, B, dev)
        plain_carries = carries
        outs, plain_outs = [], []
        for t0 in range(0, T, 7):
            y, carries = model(feats[:, t0:t0 + 7], carries)
            yp, plain_carries = model(feats[:, t0:t0 + 7], plain_carries, use_kernels=False)
            outs.append(y)
            plain_outs.append(yp)
    torch.testing.assert_close(torch.cat(outs, 1), offline, rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.cat(outs, 1), torch.cat(plain_outs, 1), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def adapt_system():
    """8 utterances of the small lexicon on the card in one ragged batch, two
    'speakers' (ids spkA-/spkB-), B's features through A = 0.8 I, b; a K = 2
    GMM trained on them on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mogasr_torch.config import BatchConfig, FrontendConfig, GmmConfig
    from mogasr_torch.data.synthetic import make_corpus
    from mogasr_torch.hmm.lexicon import synthetic_lexicon

    dev = torch.device("cuda", 0)
    utts = [(f"spk{'B' if i % 2 else 'A'}-{u.utt_id}", u.wave, u.words) for i, u in enumerate(make_corpus(8, seed=3))]
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    fcfg = FrontendConfig()
    fbs = pipe.featurize(utts, fcfg, BatchConfig(batch_size=16), dev)
    rng = np.random.default_rng(9)
    W = np.concatenate([np.eye(fcfg.feat_dim) * 0.8, 0.5 * rng.standard_normal((fcfg.feat_dim, 1))], axis=1)
    fbs = [pipe._apply_fmllr_batch(fb, {"spkB": W.astype(np.float32)}, lambda u: u.split("-")[0]) for fb in fbs]
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=2, feat_dim=fcfg.feat_dim)
    gmm, _ = pipe.train_gmm(fbs, lex, topo, gcfg, TrainConfig(num_em_iters=4))
    return dev, fbs, lex, topo, gcfg, gmm


@pytest.mark.parametrize("method", ["fmllr", "mllr"])
def test_two_pass_through_k1_k2_matches_plain(adapt_system, method):
    """The two-pass decode through K1/K2 against use_kernels=False on the
    card: the same transcripts, and the transforms of the speakers whose
    pass-1 alignment is the same on both paths within 1e-3."""
    dev, fbs, lex, topo, _gcfg, gmm = adapt_system
    fn = pipe.decode_with_fmllr if method == "fmllr" else pipe.decode_with_mllr
    k1, k2 = gmm_cuda.LAUNCHES, viterbi_cuda.LAUNCHES
    rep_k, rep_p = {}, {}
    hyps_k, W_k = fn(fbs, gmm, lex, topo, DecodeConfig(), report=rep_k)
    torch.cuda.synchronize()
    assert gmm_cuda.LAUNCHES > k1 and viterbi_cuda.LAUNCHES > k2
    k1, k2 = gmm_cuda.LAUNCHES, viterbi_cuda.LAUNCHES
    hyps_p, W_p = fn(fbs, gmm, lex, topo, DecodeConfig(), use_kernels=False, report=rep_p)
    torch.cuda.synchronize()
    assert (gmm_cuda.LAUNCHES, viterbi_cuda.LAUNCHES) == (k1, k2)
    assert hyps_k == hyps_p and set(W_k) == set(W_p) == {"spkA", "spkB"}
    same = [s for s in W_k if all(np.array_equal(rep_k["labels1"][u], rep_p["labels1"][u])
                                  for u in rep_k["labels1"] if u.startswith(s))]
    assert same
    for s in same:
        np.testing.assert_allclose(W_k[s], W_p[s], atol=1e-3)


def test_train_sat_repeats_bitwise(adapt_system):
    dev, fbs, lex, topo, gcfg, gmm = adapt_system
    runs = [pipe.train_sat(fbs, lex, topo, gcfg, gmm, n_iters=2) for _ in range(2)]
    (g1, W1, h1), (g2, W2, h2) = runs
    assert h1 == h2 and W1.keys() == W2.keys() == {"spkA", "spkB"}
    assert all(np.array_equal(W1[k], W2[k]) for k in W1)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("chunk_bytes", [1 << 14, 1 << 28])
def test_adaptation_state_sums_match_one_hot_einsum(dev, chunk_bytes, monkeypatch):
    """The chunked, sorted segment sums of MLLR, STC and LDA against the
    reference's one-hot einsums on the card (float32 in another order), and
    bitwise equal between two runs."""
    from mogasr_torch.am import aligned, lda, mllr, stc
    from mogasr_torch.am.aligned import component_posteriors

    monkeypatch.setattr(aligned, "CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(5)
    S, K, D, N = 40, 3, 13, 3001
    g = gmm_from_numpy(rng.dirichlet(np.ones(K), size=S), 2 * rng.standard_normal((S, K, D)),
                       0.3 + rng.random((S, K, D)), dev)
    x = torch.as_tensor(rng.standard_normal((N, D)).astype(np.float32), device=dev)
    labels = torch.as_tensor(np.where(rng.random(N) < 0.1, -1, rng.integers(0, S, N)), device=dev)
    valid = labels >= 0
    one_hot = torch.nn.functional.one_hot(labels.clamp(min=0), S).to(torch.float32) * valid[:, None]
    gamma, mu, _var = component_posteriors(g, x, labels)
    d = x[:, None, :] - mu
    want_m = (torch.einsum("ns,nk->sk", one_hot, gamma), torch.einsum("ns,nk,nd->skd", one_hot, gamma, x))
    want_s = torch.einsum("ns,nk,nkd,nke->skde", one_hot, gamma, d, d)
    want_l = (one_hot.sum(0), one_hot.T @ (x * valid[:, None]))
    for _ in range(2):
        got_m = mllr.accumulate_mllr_stats(g, x, labels)
        got_s = stc.accumulate_stc_stats(g, x, labels)
        got_l = lda.accumulate_lda_stats(x, labels, S)
        torch.testing.assert_close(got_m.occ, want_m[0], atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(got_m.xsum, want_m[1], atol=1e-5 * float(want_m[1].abs().max()), rtol=0)
        torch.testing.assert_close(got_s.scatter, want_s, atol=1e-5 * float(want_s.abs().max()), rtol=0)
        torch.testing.assert_close(got_l.occ, want_l[0], atol=0, rtol=1e-6)
        torch.testing.assert_close(got_l.first, want_l[1], atol=1e-5 * float(want_l[1].abs().max()), rtol=0)
        again = mllr.accumulate_mllr_stats(g, x, labels)
        assert torch.equal(again.occ, got_m.occ) and torch.equal(again.xsum, got_m.xsum)
        again_s = stc.accumulate_stc_stats(g, x, labels)
        assert torch.equal(again_s.scatter, got_s.scatter)


def test_kernel_wrappers_refuse_a_forward_that_needs_a_gradient(dev):
    """K4, K3 and K1's wrappers raise on the card when grad mode is on and an
    input requires grad (their outputs, written through ctypes, would carry
    no gradient); under no_grad, or with inputs that need none, they run."""
    rng = np.random.default_rng(0)
    xg = torch.as_tensor(rng.standard_normal((2, 5, 16)).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.standard_normal((4, 16)).astype(np.float32), device=dev).requires_grad_()
    nf = torch.tensor([5, 3], device=dev)
    with pytest.raises(RuntimeError, match=r"K4.*use_kernels=False"):
        lstm_cuda.lstm_layer(xg, w, nf)
    with torch.no_grad():
        lstm_cuda.lstm_layer(xg, w, nf)
    lstm_cuda.lstm_layer(xg, w.detach(), nf)

    lex = make_lexicon({"cat": ["k", "ae", "t"]})
    topo = build_topology(lex, TopologyConfig())
    graphs = vit.graphs_to_torch(pipe.build_align_graphs([["cat"], ["cat"]], lex, topo), dev)
    ll = torch.as_tensor(rng.standard_normal((2, 30, topo.n_pdfs)).astype(np.float32), device=dev)
    with pytest.raises(RuntimeError, match=r"K3.*FbLoglik"):
        fb_cuda.forward_backward(ll.requires_grad_(), graphs, torch.tensor([30, 20], device=dev))
    with torch.no_grad():
        fb_cuda.forward_backward(ll, graphs, torch.tensor([30, 20], device=dev))

    g, x = _random_gmm(dev, 7, 2, 13, 50)
    for leaf in (x, g.means):
        leaf.requires_grad_()
        with pytest.raises(RuntimeError, match=r"K1.*gmm_loglik"):
            gmm_cuda.gmm_loglik_fused(x, g)
        with torch.no_grad():
            gmm_cuda.gmm_loglik_fused(x, g)
        leaf.requires_grad_(False)


@pytest.mark.parametrize("arch", ["lstm", "blstm"])
def test_recurrent_training_forward_on_the_card(dev, arch):
    """A training forward through K4 raises; the trainer's forward (the plain
    recurrence) gives every parameter a nonzero gradient."""
    from mogasr_torch.am.train_nn import train_logits

    model = init_(tn.build_model(arch, 7, TrainConfig(nn_hidden=24, nn_layers=3), 5),
                  torch.Generator().manual_seed(0)).to(dev)
    feats = torch.randn((3, 20, 5), generator=torch.Generator().manual_seed(1)).to(dev)
    nf = torch.tensor([20, 11, 4], device=dev)
    with pytest.raises(RuntimeError, match="K4"):
        model(feats, nf)
    logits, _aux = train_logits(model, feats, nf)
    logits.logsumexp(-1).sum().backward()
    assert all(p.grad is not None and float(p.grad.abs().sum()) > 0 for p in model.parameters())


def test_sequence_functions_on_k3_match_plain_autograd(dev):
    """FbLoglik (align graphs: K3's chain arm; the word loop: its general arm)
    and SmbrAcc against autograd through the plain forward-backward on the
    card: the values, and the gradients within the reference's identity
    tolerances (rtol 1e-4 / atol 1e-5 and rtol 2e-3 / atol 2e-4)."""
    from mogasr_torch.am import nn_seq

    lex = make_lexicon({w: p for w, p in (("cat", ["k", "ae", "t"]), ("dog", ["d", "ao", "g"]))})
    topo = build_topology(lex, TopologyConfig())
    rng = np.random.default_rng(3)
    T, kappa = 60, 0.3
    nf = torch.tensor([60, 47, 33], device=dev)
    num = vit.graphs_to_torch(pipe.build_align_graphs([["cat"], ["dog", "cat"], ["dog"]], lex, topo), dev)
    den = vit.graphs_to_torch(gr.batch_graphs([pipe.word_decode_graph(lex, topo, DecodeConfig(acoustic_scale=kappa))]
                                              * 3), dev)
    ll = torch.as_tensor(rng.standard_normal((3, T, topo.n_pdfs)).astype(np.float32), device=dev)
    ref = torch.as_tensor(rng.integers(0, topo.n_pdfs, (3, T)).astype(np.int32), device=dev)
    ref = torch.where(torch.arange(T, device=dev)[None, :] < nf[:, None], ref, torch.full_like(ref, -1))
    cases = [("loglik num", lambda x, k: nn_seq.fb_loglik(x, num, nf, kappa, k), dict(rtol=1e-4, atol=1e-5)),
             ("loglik den", lambda x, k: nn_seq.fb_loglik(x, den, nf, kappa, k), dict(rtol=1e-4, atol=1e-5)),
             ("E[acc]", lambda x, k: nn_seq.smbr_accuracy(x, den, ref, nf, kappa, k), dict(rtol=2e-3, atol=2e-4))]
    for name, fn, tol in cases:
        out = {}
        for use_kernels in (True, False):
            x = ll.clone().requires_grad_()
            y = fn(x, use_kernels)
            y.sum().backward()
            out[use_kernels] = (y.detach(), x.grad)
        torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-4, atol=1e-3, msg=name)
        torch.testing.assert_close(out[True][1], out[False][1], msg=name, **tol)


def test_ctc_loss_on_k3_matches_the_plain_recursion(dev):
    """``am.ctc.ctc_loss`` on the card (K3's chain arm with skips through
    FbLoglik) against the plain recursion on the card: the loss on short
    ragged rows, those without labels or frames and those whose labels
    cannot fit (about 1e30) included; the gradient on the rows that fit, and
    exactly 0 on the two that cannot. One K3 launch, nothing else."""
    from mogasr_torch.am import ctc

    rng = np.random.default_rng(15)
    logits = torch.as_tensor(rng.standard_normal((6, 9, 7)).astype(np.float32), device=dev)
    nf = torch.as_tensor([9, 0, 3, 9, 2, 6], device=dev)
    labels = torch.as_tensor([[0, 1, 2, -1], [2, -1, -1, -1], [1, 1, 2, 3], [-1] * 4, [0, 1, 2, -1], [3, 3, 4, 5]],
                             device=dev)
    nl = torch.as_tensor([3, 1, 4, 0, 3, 4], device=dev)
    fit, short = [0, 1, 3, 5], [2, 4]
    out = {}
    launches = fb_cuda.FWD_LAUNCHES
    for use_kernels in (True, False):
        x = logits.clone().requires_grad_()
        loss = ctc.ctc_loss(x, nf, labels, nl, use_kernels=use_kernels)
        loss.sum().backward()
        out[use_kernels] = (loss.detach(), x.grad)
    torch.cuda.synchronize()
    assert fb_cuda.FWD_LAUNCHES == launches + 1
    assert float(out[False][0][short].min()) > 1e29
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-4, atol=0)
    torch.testing.assert_close(out[True][1][fit], out[False][1][fit], rtol=0, atol=1e-5)
    assert bool((out[True][1][short] == 0).all())


def test_k3_refuses_label_graphs_wider_than_it_takes(dev):
    """4096 labels make 8193 states, past K3's MAX_J: the launch is refused
    with the graph's width and the limit's place, and nothing else runs."""
    from mogasr_torch.am import ctc

    labels = torch.zeros((1, 4096), dtype=torch.int32, device=dev)
    logp = torch.zeros((1, 3, 5), device=dev)
    with pytest.raises(RuntimeError, match="J=8193.*MAX_J"):
        ctc.ctc_nll_fb(logp, torch.as_tensor([3], device=dev), labels, torch.as_tensor([4096], device=dev), 4)


def test_device_prefix_beam_on_the_card_matches_the_cpu(dev):
    """The device prefix beam on the card and on the CPU: the same ranked
    hypotheses (ties to the lower index, the merge sums in a fixed order),
    scores within float32 rounding."""
    from mogasr_torch.am import ctc

    rng = np.random.default_rng(16)
    logp = torch.log_softmax(torch.as_tensor(4.0 * rng.standard_normal((3, 30, 9)).astype(np.float32)), -1)
    nf = torch.as_tensor([30, 17, 0])
    fusion = (0.3 * rng.standard_normal((9, 8))).astype(np.float32)
    got = ctc.ctc_prefix_beam_decode_device(logp.to(dev), nf.to(dev), beam_size=5, u_cap=30, fusion=fusion)
    want = ctc.ctc_prefix_beam_decode_device(logp, nf, beam_size=5, u_cap=30, fusion=fusion)
    assert [[h for _s, h in r] for r in got] == [[h for _s, h in r] for r in want]
    np.testing.assert_allclose([s for r in got for s, _h in r], [s for r in want for s, _h in r], rtol=1e-5)


def test_aed_joint_rescoring_on_k3_matches_plain(dev):
    """The AED beam's joint CTC rescoring on the card. Its K3 term over
    ragged hypothesis rows (one of 520 tokens: 1041 states, so K3's block
    arm for the call; one of no tokens; two that cannot fit their frames,
    one of them of no frames, keep ~1e30) against the plain recursion; then
    the whole beam with CTC weight 0.3 on the card (the chain arm) against
    ``use_kernels=False`` on the card: the same tokens and lengths, scores
    within 1e-5 relative, one K3 launch."""
    from mogasr_torch.am import aed as A
    from mogasr_torch.am import ctc

    rng = np.random.default_rng(18)
    n_lab = [520, 40, 12, 0, 3]
    labels = np.full((5, 520), -1, np.int64)
    for b, n in enumerate(n_lab):
        seq = rng.integers(0, 6, n)
        seq[1:][seq[1:] == seq[:-1]] = (seq[1:][seq[1:] == seq[:-1]] + 1) % 6   # no repeats: n frames fit n labels
        labels[b, :n] = seq
    logits = torch.as_tensor(rng.standard_normal((5, 600, 7)).astype(np.float32), device=dev)
    n_out = torch.as_tensor([600, 300, 9, 600, 0], device=dev)
    lab, nl = torch.as_tensor(labels, device=dev), torch.as_tensor(n_lab, device=dev)
    got = ctc.ctc_loss(logits, n_out, lab, nl)
    arms = fb_cuda.LAST_ARMS.cpu().numpy()
    want = ctc.ctc_loss(logits, n_out, lab, nl, use_kernels=False)
    fit, short = [0, 1, 3], [2, 4]
    # the arm goes by the graphs' padded width: every row of this call takes the block arm
    assert (arms == fb_cuda.ARM_BLOCK).all()
    torch.testing.assert_close(got[fit], want[fit], rtol=1e-5, atol=0)
    assert float(got[short].min()) > 1e29 and float(want[short].min()) > 1e29

    model = init_(A.AedModel(5, 9, d_model=32, enc_blocks=1, dec_blocks=1, heads=2, conv_kernel=7),
                  torch.Generator().manual_seed(3)).to(dev).eval()
    feats = torch.as_tensor(rng.standard_normal((3, 40, 9)).astype(np.float32), device=dev)
    n_frames = torch.as_tensor([40, 25, 3], device=dev)
    before = fb_cuda.FWD_LAUNCHES
    k3 = A.make_aed_decoder(model, beam=3, max_tokens=10, ctc_weight=0.3, return_all=True)(feats, n_frames)
    torch.cuda.synchronize()
    assert fb_cuda.FWD_LAUNCHES == before + 1 and (fb_cuda.LAST_ARMS.cpu() == fb_cuda.ARM_CHAIN).all()
    plain = A.make_aed_decoder(model, beam=3, max_tokens=10, ctc_weight=0.3, return_all=True,
                               use_kernels=False)(feats, n_frames)
    assert torch.equal(k3[0], plain[0]) and torch.equal(k3[1], plain[1])
    torch.testing.assert_close(k3[2], plain[2], rtol=1e-5, atol=0)

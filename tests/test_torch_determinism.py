"""The deterministic statistics sums (mogasr_torch/utils/segment.py) against
the ``index_add_`` / ``scatter_add_`` accumulations they replace, on the CPU:
the hard E-step's sums over states at the training batch's width (32 x 550
frames, the headline bundle's 1168 x 16 x 39 GMM), and the collapse of graph
states to pdfs on tied-triphone align graphs and on the 3048-state word loop.
Each must agree within 1e-6 relative (on the CPU both add in the same order,
so they agree bit for bit). The parity tests against JAX's
``accumulate_stats``, ``state_posteriors_to_pdf`` and sMBR are in
test_torch_em.py, test_torch_forward_backward.py and test_torch_mmi.py."""

import os

import numpy as np
import pytest
import torch

from mogasr_torch import pipeline as pipe
from mogasr_torch.am import em
from mogasr_torch.am.gmm import gmm_from_numpy
from mogasr_torch.data.synthetic import extended_lexicon
from mogasr_torch.decoder import forward_backward as fbd
from mogasr_torch.decoder import viterbi as vit
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.utils.bundle import load_system
from mogasr_torch.utils.segment import collapse_columns, index_sum

CPU = torch.device("cpu")
BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "headline")
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def headline():
    _gmm, topo, _fcfg, tied, _meta = load_system(BUNDLE, CPU)
    return topo, tied


def _old_accumulate_stats(gmm, feats, labels):
    """accumulate_stats as it was, with index_add_ (the reference's scatter-adds)."""
    S, K, D = gmm.means.shape
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)
    mu, var = gmm.means[safe], torch.clamp(gmm.vars[safe], min=1e-8)
    w = torch.clamp(gmm.weights[safe], min=1e-30)
    x = feats[:, None, :]
    ll_k = torch.log(w) - 0.5 * (D * np.log(2 * np.pi) + torch.log(var).sum(-1)) - 0.5 * ((x - mu) ** 2 / var).sum(-1)
    gamma = torch.exp(ll_k - torch.logsumexp(ll_k, dim=-1)[:, None])
    gamma = torch.where(valid[:, None], gamma, torch.zeros_like(gamma))
    occ = torch.zeros((S, K)).index_add_(0, safe, gamma)
    sx = torch.zeros((S, K, D)).index_add_(0, safe, gamma[:, :, None] * feats[:, None, :])
    sxx = torch.zeros((S, K, D)).index_add_(0, safe, gamma[:, :, None] * (feats ** 2)[:, None, :])
    return occ, sx, sxx


def _assert_rel(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)


def _skewed_labels(rng, n, S, pad):
    """Frame labels as a Viterbi alignment gives them: a third of the
    frames on a few silence pdfs, the rest spread, the last ``pad`` -1."""
    labels = np.where(rng.random(n) < 0.35, rng.integers(0, 3, n), rng.integers(0, S, n))
    labels[n - pad:] = -1
    return torch.as_tensor(labels.astype(np.int32))


@pytest.mark.parametrize("S,K,D,N,pad", [(1168, 16, 39, 32 * 550, 1234), (81, 8, 39, 4000, 0), (7, 1, 13, 50, 49)])
def test_hard_stats_match_index_add(S, K, D, N, pad):
    rng = np.random.default_rng(S + N)
    gmm = gmm_from_numpy(rng.dirichlet(np.ones(K), size=S).astype(np.float32),
                         rng.standard_normal((S, K, D)).astype(np.float32),
                         (0.5 + rng.random((S, K, D))).astype(np.float32), CPU)
    feats = torch.as_tensor(rng.standard_normal((N, D)).astype(np.float32))
    labels = _skewed_labels(rng, N, S, pad)
    got = em.accumulate_stats(gmm, feats, labels)
    for g, w in zip((got.occ, got.sx, got.sxx), _old_accumulate_stats(gmm, feats, labels)):
        _assert_rel(g, w)
    assert float(got.n_frames) == N - pad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_sum_matches_index_add(dtype):
    rng = np.random.default_rng(3)
    values = torch.as_tensor(rng.standard_normal((5000, 3, 4)), dtype=dtype)
    index = torch.as_tensor(rng.integers(0, 40, 5000))
    index[index == 7] = 8  # a target no row reaches sums to zero
    index[::9] = -1        # rows that add to nothing
    got = index_sum(values, index, 41)
    keep = index >= 0
    _assert_rel(got, torch.zeros((41, 3, 4), dtype=dtype).index_add_(0, index[keep], values[keep]))
    assert not bool(got[7].any()) and not bool(got[40].any())


def _old_collapse(values, emit_id, n):
    B, T, J = values.shape
    return torch.zeros((B, T, n), dtype=values.dtype).scatter_add_(2, emit_id[:, None, :].expand(B, T, J), values)


def _cd_align_emit_id(topo, tied, n_rows, seed=5):
    words = sorted(extended_lexicon(300))
    rng = np.random.default_rng(seed)
    rows = [[words[i] for i in rng.integers(0, len(words), rng.integers(3, 10))] for _ in range(n_rows - 1)] + [[]]
    graphs = pipe.build_align_graphs(rows, topo.lexicon, topo, align_fn=lambda p: tri.align_graph_cd(tied, p))
    return vit.graphs_to_torch(graphs, CPU)["emit_id"]


@pytest.mark.parametrize("graph,B,T", [("align", 32, 550), ("word_loop", 4, 550)])
@pytest.mark.parametrize("signed", [False, True])
def test_collapse_matches_scatter_add(headline, graph, B, T, signed):
    """Posteriors (``state_posteriors_to_pdf``) and signed sMBR weights
    collapsed to the bundle's 1168 pdfs: CD align graphs (J = 192, a dummy
    row) and the word loop (J = 3048)."""
    topo, tied = headline
    if graph == "align":
        emit_id = _cd_align_emit_id(topo, tied, B)
    else:
        emit_id = pipe.decode_graphs(tri.word_loop_graph_cd(tied, insertion_penalty=2.0), B, CPU)[1]["emit_id"]
    J, n = emit_id.shape[1], tied.n_pdfs
    assert (graph == "align" and J == 192) or (graph == "word_loop" and J == 3048)
    rng = np.random.default_rng(J + signed)
    if signed:
        values = torch.as_tensor(rng.standard_normal((B, T, J)).astype(np.float32))
        _assert_rel(collapse_columns(values, emit_id, n), _old_collapse(values, emit_id, n))
        return
    log_gamma = torch.as_tensor((rng.standard_normal((B, T, J)) * 30 - 40).astype(np.float32))
    log_gamma[:, T // 2:] = fbd.NEG_INF
    gamma = torch.exp(torch.clamp(log_gamma, min=-80.0))
    gamma = torch.where(log_gamma <= fbd.NEG_INF / 2, torch.zeros_like(gamma), gamma)
    got = fbd.state_posteriors_to_pdf(log_gamma, emit_id, n)
    _assert_rel(got, _old_collapse(gamma, emit_id, n))
    assert got.is_contiguous() and not bool(got[:, T // 2:].any())

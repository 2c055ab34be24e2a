"""The port's decode path as a whole, at the full width of the headline
bundle (1168 pdfs x 16 components x 39 dims, a 3048-state word loop), on the
CPU: the bundle loads to the same arrays, and held-out utterances decode to
the same transcripts and scores as the JAX path -- in float32, with a beam,
and scored in int8 (the port's plain K5 against JAX's interpret-mode K5);
multi-pronunciation decode graphs equal JAX's."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.am.gmm import gmm_loglik as jax_gmm_loglik
from mogasr.am.gmm_pallas import gmm_loglik_batched as jax_gmm_loglik_batched
from mogasr.config import BatchConfig, DecodeConfig, TopologyConfig
from mogasr.data import synthetic as syn
from mogasr.data.batching import make_batches
from mogasr.decoder import viterbi as jax_vit
from mogasr.frontend.jax_frontend import cached_frontend
from mogasr.hmm import graph as gr
from mogasr.hmm import triphone as tri
from mogasr.hmm.lexicon import make_lexicon_multi as jax_make_lexicon_multi
from mogasr.hmm.topology import build_topology as jax_build_topology
from mogasr.utils.bundle import load_system as jax_load_system
from mogasr_torch import config as tcfg
from mogasr_torch import pipeline as pipe
from mogasr_torch.hmm.lexicon import make_lexicon_multi
from mogasr_torch.hmm.topology import build_topology
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
N_UTTS = 4


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def headline():
    gmm, topo, fcfg, tied, meta = load_system(BUNDLE, CPU)
    dmeta = meta["decode"]
    dcfg = DecodeConfig(acoustic_scale=dmeta["acoustic_scale"],
                        word_insertion_penalty=dmeta["word_insertion_penalty"])
    # bench.py's held-out corpus recipe; utterance i depends only on (seed, i)
    word_lex = {w: list(topo.lexicon.prons[w]) for w in topo.lexicon.words}
    utts = syn.make_corpus_v2(
        N_UTTS, lexicon=word_lex, speakers=syn.make_speakers(meta.get("speakers", 20)),
        style=syn.CorpusStyle(), seed=999, words_per_utt=(3, 9))
    graph = tri.word_loop_graph_cd(tied, insertion_penalty=dcfg.word_insertion_penalty)
    return gmm, topo, fcfg, tied, meta, dcfg, [(u.utt_id, u.wave, u.words) for u in utts], graph


def test_bundle_matches_reference(headline):
    gmm, topo, fcfg, tied, meta, *_ = headline
    jgmm, jtopo, jfcfg, jtied, jmeta = jax_load_system(BUNDLE)
    for ours, theirs in zip(gmm, jgmm):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # the port's own copy of FrontendConfig: equal fields
    assert dataclasses.asdict(fcfg) == dataclasses.asdict(jfcfg) and meta == jmeta
    assert topo.lexicon.phones == jtopo.lexicon.phones
    assert topo.lexicon.prons == jtopo.lexicon.prons
    assert topo.per_phone_self_prob == jtopo.per_phone_self_prob
    assert tied.n_pdfs == jtied.n_pdfs == gmm.n_states
    assert tied.tying == jtied.tying and tied.backoff == jtied.backoff


def test_headline_transcripts_match_jax(headline):
    gmm, _topo, fcfg, _tied, _meta, dcfg, utts, graph = headline
    assert graph.n_states == 3048
    bcfg = BatchConfig(batch_size=N_UTTS, bucket_boundaries=(250, 350, 450, 600))
    got = pipe.decode_corpus(utts, gmm, graph, fcfg, dcfg, bcfg, CPU,
                             compute_dtype="float32")

    jgmm = jax_load_system(BUNDLE)[0]
    graphs_np = gr.batch_graphs([graph] * N_UTTS)
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    hyps, scores = [], []
    for b in make_batches(utts, bcfg, fcfg):
        feats, n_frames = cached_frontend(fcfg, b.waves.shape[1])(
            jnp.asarray(b.waves), jnp.asarray(b.num_samples))
        B, T, D = feats.shape
        ll = jax_gmm_loglik(feats.reshape(B * T, D), jgmm, mode="max").reshape(B, T, -1)
        res = jax_vit.viterbi(ll, graphs, n_frames, acoustic_scale=dcfg.acoustic_scale)
        toks = jax_vit.path_to_tokens(res, graph.labels, graphs_np["chain_id"])
        for i in range(b.size):
            hyps.append([w.lower() for w in toks[i] if w not in pipe.DROP_TOKENS])
            scores.append(float(res.score[i]))

    assert got.n_utts == N_UTTS
    assert got.hyps == hyps
    assert all(len(h) > 0 for h in hyps)
    np.testing.assert_allclose(got.scores, scores, rtol=1e-5)
    assert set(got.stage_seconds) == set(pipe.STAGES)
    assert all(v > 0 for v in got.stage_seconds.values())


def test_word_decode_graph_and_decode_batch(headline):
    gmm, topo, fcfg, _tied, _meta, dcfg, utts, _graph = headline
    graph = pipe.word_decode_graph(topo.lexicon, topo, dcfg)
    ref = jax_pipe.word_decode_graph(topo.lexicon, topo, dcfg)
    for k in ("emit_id", "self_logp", "adv_logp", "enter_logp", "exit_logp",
              "init_logp", "final_logp", "chain_id"):
        np.testing.assert_array_equal(getattr(graph, k), getattr(ref, k))
    assert graph.labels == ref.labels

    fb = pipe.featurize(utts[:2], fcfg, BatchConfig(batch_size=2, bucket_boundaries=(600,)), CPU)[0]
    scores = pipe.score_batch(fb.feats, gmm, mode="max")
    assert scores.shape == (2, fb.feats.shape[1], gmm.n_states)
    out, out_scores = pipe.decode_batch_scored(fb, scores, graph, dcfg)
    assert len(out) == 2 and all(all(w not in pipe.DROP_TOKENS for w in seq) for seq in out)
    assert len(out_scores) == 2 and np.isfinite(out_scores).all()
    graphs = pipe.decode_graphs(graph, 2, CPU)
    assert (out, out_scores) == pipe.decode_batch_scored(fb, scores, graph, dcfg, use_kernels=False,
                                                         graphs=graphs)
    assert pipe.decode_batch(fb, scores, graph, dcfg, graphs=graphs) == out


GRAPH_KEYS = ("emit_id", "self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp",
              "final_logp", "chain_id")


def test_decode_batch_with_beam_matches_jax(headline):
    """K2's beam through pipe.decode_batch (the plain version on the CPU)
    against JAX's decode_batch at the same beam: a beam of 30 keeps a few
    dozen of the 3048 states each frame."""
    gmm, _topo, fcfg, _tied, _meta, dcfg, utts, graph = headline
    fb = pipe.featurize(utts[:2], fcfg, BatchConfig(batch_size=2, bucket_boundaries=(600,)), CPU)[0]
    scores = pipe.score_batch(fb.feats, gmm, mode="max")
    jfb = jax_pipe.FeatBatch(fb.utt_ids, jnp.asarray(fb.feats.numpy()), jnp.asarray(fb.n_frames.numpy()),
                             fb.words)
    for beam in (30.0, 200.0):
        bcfg = dataclasses.replace(dcfg, beam=beam)
        got, got_scores = pipe.decode_batch_scored(fb, scores, graph, bcfg)
        assert got == pipe.decode_batch(fb, scores, graph, bcfg)
        assert got == jax_pipe.decode_batch(jfb, jnp.asarray(scores.numpy()), graph, bcfg)
        assert all(len(h) > 0 for h in got) and np.isfinite(got_scores).all()


def test_word_decode_graph_multi_matches_jax():
    """One chain per pronunciation variant, the word prior plus a uniform
    pronunciation prior on each entry: equal arrays, labels and pron_logp."""
    variants = {"fish": [["f", "ih", "sh"], ["f", "iy", "sh"]], "the": [["dh", "ah"], ["dh", "iy"], ["th", "iy"]],
                "cat": [["k", "ae", "t"]]}
    lex, jlex = make_lexicon_multi(variants), jax_make_lexicon_multi(variants)
    topo = build_topology(lex, tcfg.TopologyConfig())
    jtopo = jax_build_topology(jlex, TopologyConfig())
    dcfg, jdcfg = tcfg.DecodeConfig(word_insertion_penalty=1.5), DecodeConfig(word_insertion_penalty=1.5)
    word_logp = np.log(np.asarray([0.2, 0.3, 0.4, 0.1], np.float32))
    for wl in (None, word_logp):
        g, pron = pipe.word_decode_graph_multi(lex, topo, dcfg, wl)
        jg, jpron = jax_pipe.word_decode_graph_multi(jlex, jtopo, jdcfg, wl)
        for k in GRAPH_KEYS:
            np.testing.assert_array_equal(getattr(g, k), getattr(jg, k))
        assert g.labels == jg.labels and g.labels.count("the") == 3
        np.testing.assert_array_equal(pron, jpron)
        via = pipe.word_decode_graph(lex, topo, dcfg, wl, multi_pron=True)
        jvia = jax_pipe.word_decode_graph(jlex, jtopo, jdcfg, wl, multi_pron=True)
        for k in GRAPH_KEYS:
            np.testing.assert_array_equal(getattr(via, k), getattr(jvia, k))
        assert via.labels == jvia.labels == g.labels
    single = pipe.word_decode_graph(lex, topo, dcfg)
    assert len(single.labels) == len(lex.words) + 1


def test_int8_slice_matches_jax(headline):
    """The slice as a whole: 4 held-out utterances scored in int8/sum at the
    headline width by the port's plain int8 scorer and by JAX's
    interpret-mode K5, then decoded: the transcripts equal each other's and
    the float32 decode's. Only the logsumexp's order differs: atol 1e-4, and
    rtol 1e-6 (two float32 ulps) for the logliks of magnitude up to ~600."""
    gmm, _topo, fcfg, _tied, _meta, dcfg, utts, graph = headline
    bcfg = BatchConfig(batch_size=N_UTTS, bucket_boundaries=(250, 350, 450, 600))
    fbs = pipe.featurize(utts, fcfg, bcfg, CPU)
    jgmm = jax_load_system(BUNDLE)[0]
    graphs = pipe.decode_graphs(graph, N_UTTS, CPU)
    for fb in fbs:
        s8 = pipe.score_batch(fb.feats, gmm, compute_dtype="int8", mode="sum")
        j8 = np.array(jax_gmm_loglik_batched(jnp.asarray(fb.feats.numpy()), jgmm, compute_dtype="int8",
                                               interpret=True))
        np.testing.assert_allclose(s8.numpy(), j8, atol=1e-4, rtol=1e-6)
        s32 = pipe.score_batch(fb.feats, gmm, compute_dtype="float32", mode="sum")
        hyp8 = pipe.decode_batch(fb, s8, graph, dcfg, graphs=graphs)
        hyp_j8 = pipe.decode_batch(fb, torch.as_tensor(j8), graph, dcfg, graphs=graphs)
        hyp32 = pipe.decode_batch(fb, s32, graph, dcfg, graphs=graphs)
        assert hyp8 == hyp_j8 == hyp32
        assert all(len(h) > 0 for h in hyp8)


def test_decode_corpus_checks_mode_and_layout(headline):
    gmm, _topo, fcfg, _tied, _meta, dcfg, utts, graph = headline
    bcfg = BatchConfig(batch_size=N_UTTS, bucket_boundaries=(600,))
    with pytest.raises(NotImplementedError):  # int8 folds in sum mode only
        pipe.decode_corpus(utts, gmm, graph, fcfg, dcfg, bcfg, CPU, compute_dtype="int8")
    with pytest.raises(ValueError):
        pipe.decode_corpus(utts, gmm, graph, fcfg, dcfg, bcfg, CPU, compute_dtype="int8", mode="sum",
                           layout="wide")
    with pytest.raises(ValueError):
        pipe.decode_corpus(utts, gmm, graph, fcfg, dcfg, bcfg, CPU, mode="mean")


def _jax_feat_batch(fb):
    return jax_pipe.FeatBatch(fb.utt_ids, jnp.asarray(fb.feats.numpy()), jnp.asarray(fb.n_frames.numpy()),
                              fb.words)


def test_decode_batch_returns_the_reference_tokens(headline):
    """decode_batch's signature and return value are the reference's: token
    lists per utterance, drop_tokens as the fifth positional argument."""
    gmm, _topo, fcfg, _tied, _meta, dcfg, utts, graph = headline
    fb = pipe.featurize(utts[:2], fcfg, BatchConfig(batch_size=2, bucket_boundaries=(600,)), CPU)[0]
    scores = pipe.score_batch(fb.feats, gmm, mode="max")
    jscores = jnp.asarray(scores.numpy())
    for drop in (pipe.DROP_TOKENS, ()):
        got = pipe.decode_batch(fb, scores, graph, dcfg, drop)
        assert isinstance(got, list) and len(got) == 2 and all(isinstance(seq, list) for seq in got)
        assert got == jax_pipe.decode_batch(_jax_feat_batch(fb), jscores, graph, dcfg, drop)
    assert any("<sil>" in seq for seq in pipe.decode_batch(fb, scores, graph, dcfg, ()))


def _chain_skips(g):
    """The graph with a (j-2 -> j) skip of log-prob -0.1 inside every chain."""
    chain = np.asarray(g.chain_id)
    skip = np.full(chain.shape, gr.NEG_INF, np.float32)
    skip[2:] = np.where((chain[2:] == chain[:-2]) & (chain[2:] >= 0), np.float32(-0.1), gr.NEG_INF)
    return dataclasses.replace(g, skip_logp=skip)


def test_skip_graph_decodes_as_jax(headline):
    """A word loop with skip transitions decodes through pipe.decode_batch
    (K2's wrapper, which takes skip graphs; on the CPU its plain version) to
    JAX's decode_batch's tokens, which run its XLA scan."""
    gmm, _topo, fcfg, _tied, _meta, dcfg, utts, graph = headline
    skip_graph = _chain_skips(graph)
    fb = pipe.featurize(utts[:2], fcfg, BatchConfig(batch_size=2, bucket_boundaries=(600,)), CPU)[0]
    scores = pipe.score_batch(fb.feats, gmm, mode="max")
    got, got_scores = pipe.decode_batch_scored(fb, scores, skip_graph, dcfg)
    assert got == jax_pipe.decode_batch(_jax_feat_batch(fb), jnp.asarray(scores.numpy()), skip_graph, dcfg)
    assert all(len(h) > 0 for h in got) and np.isfinite(got_scores).all()
    graphs = pipe.decode_graphs(skip_graph, 2, CPU)
    assert graphs[1]["skip_logp"] is not None
    assert (got, got_scores) == pipe.decode_batch_scored(fb, scores, skip_graph, dcfg, use_kernels=False,
                                                         graphs=graphs)
    # the skips are taken: the best path scores above the graph's without them
    _, plain_scores = pipe.decode_batch_scored(fb, scores, graph, dcfg)
    assert all(a >= b for a, b in zip(got_scores, plain_scores)) and got_scores != plain_scores


def test_skip_graphs_align_and_collect_stats(headline):
    """align_batch and batch_stats over align graphs with skip transitions
    run on the CPU through the pipeline's default route (the K2 and K3
    wrappers) and equal the plain route."""
    gmm, topo, fcfg, tied, _meta, _dcfg, utts, _graph = headline
    fb = pipe.featurize(utts[:2], fcfg, BatchConfig(batch_size=2, bucket_boundaries=(600,)), CPU)[0]

    def align_fn(pids):
        return _chain_skips(tri.align_graph_cd(tied, pids))

    res, labels, graphs = pipe.align_batch(fb, gmm, topo.lexicon, topo, align_fn=align_fn)
    want, want_labels, _ = pipe.align_batch(fb, gmm, topo.lexicon, topo, align_fn=align_fn, use_kernels=False)
    assert graphs["skip_logp"] is not None
    for a, b in zip(res, want):
        assert torch.equal(a, b)
    assert torch.equal(labels, want_labels)
    for mode in ("viterbi", "baum-welch"):
        s, _, _ = pipe.batch_stats(fb, gmm, topo.lexicon, topo, mode, align_fn, gmm.n_states)
        s_plain, _, _ = pipe.batch_stats(fb, gmm, topo.lexicon, topo, mode, align_fn, gmm.n_states,
                                         use_kernels=False)
        for a, b in zip(s, s_plain):
            assert torch.equal(a, b)
        assert float(s.occ.sum()) > 0

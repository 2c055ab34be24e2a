"""The port's LM decoder (``decoder.lm_viterbi``) and posterior confidence
against the JAX package on the CPU, on the same float32 scores fed to both.

At the full width of the headline bundle (1168 pdfs, the 3048-state word
loop, 301 chains and LM tokens) on 4 held-out utterances of bench.py: an
add-alpha and a Kneser-Ney bigram, with and without lattices; a uniform
bigram against the port's loop decoder; confidence and n-best. On the small
lexicon: a multi-pronunciation graph with pronunciation priors, a command
grammar, and a graph with skip transitions. The LM recursion is the
reference's operation for operation, so paths, entry flags and lattice
entry frames are equal and the scores bitwise equal (held to LM_RTOL)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.decoder import lm_viterbi as jax_lv
from mogasr.lm import ngram as jax_ngram
from mogasr_torch import pipeline as pipe
from mogasr_torch.config import BatchConfig, DecodeConfig, TopologyConfig
from mogasr_torch.data import synthetic as syn
from mogasr_torch.decoder import lm_viterbi as lv
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.hmm.lexicon import make_lexicon_multi
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.lm import ngram
from mogasr_torch.utils.bundle import load_system

CPU = torch.device("cpu")
BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "headline")
N_UTTS = 4
# Scores: bitwise equal is expected (the same float32 additions in the same
# order); the limit leaves room for a compiler that contracts differently.
LM_RTOL = 1e-4
# Confidences: the port's posteriors sum states to chains in another order
# than the reference's segment_sum, and both round to 4 decimals.
CONF_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tests issue many small
    ops, and with the suite's workers sharing the cores torch's thread pool
    spends its time waiting for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.fixture(scope="module")
def headline():
    """The bundle's word loop, 4 held-out utterances featurized and scored once
    (float32, max mode) and an LM corpus from the v2 phrase language."""
    gmm, topo, fcfg, tied, meta = load_system(BUNDLE, CPU)
    dcfg = DecodeConfig(acoustic_scale=meta["decode"]["acoustic_scale"],
                        word_insertion_penalty=meta["decode"]["word_insertion_penalty"])
    word_lex = {w: list(topo.lexicon.prons[w]) for w in topo.lexicon.words}
    utts = syn.make_corpus_v2(N_UTTS, lexicon=word_lex, speakers=syn.make_speakers(meta.get("speakers", 20)),
                              style=syn.CorpusStyle(), seed=999, words_per_utt=(3, 9))
    fb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg,
                        BatchConfig(batch_size=N_UTTS, bucket_boundaries=(600,)), CPU)[0]
    scores = pipe.score_batch(fb.feats, gmm, mode="max")
    graph = tri.word_loop_graph_cd(tied, insertion_penalty=dcfg.word_insertion_penalty)
    rng = np.random.default_rng(5)
    plm = syn.make_phrase_lm(sorted(word_lex))
    texts = [syn.sample_phrase_words(plm, rng, (3, 9)) for _ in range(400)]
    return {"tied": tied, "dcfg": dcfg, "fb": fb, "scores": scores, "graph": graph, "texts": texts}


def _jax_fb(fb):
    return jax_pipe.FeatBatch(fb.utt_ids, jnp.asarray(fb.feats.numpy()), jnp.asarray(fb.n_frames.numpy()),
                              fb.words)


def _both(scores, graph, lm, jlm, n_frames, with_lattice, **kw):
    got = lv.viterbi_lm(scores, graph, lm, n_frames, with_lattice=with_lattice, **kw)
    want = jax_lv.viterbi_lm(jnp.asarray(scores.numpy()), graph, jlm, jnp.asarray(n_frames.numpy()),
                             with_lattice=with_lattice, **kw)
    return got, want


def _assert_same(got, want, with_lattice):
    if with_lattice:
        (got, lat), (want, jlat) = got, want
        score, start, base = (a.numpy() for a in lat)
        jscore, jstart, jbase = (np.asarray(a) for a in jlat)
        assert score.shape == jscore.shape and start.dtype == jstart.dtype
        np.testing.assert_array_equal(start, jstart)
        np.testing.assert_allclose(score, jscore, rtol=LM_RTOL)
        np.testing.assert_allclose(base, jbase, rtol=LM_RTOL)
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(want.path))
    np.testing.assert_array_equal(got.entered.numpy(), np.asarray(want.entered))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=LM_RTOL)
    assert got.path.dtype == torch.int32 and got.score.dtype == torch.float32


@pytest.mark.parametrize("smoothing,with_lattice", [("addalpha", False), ("kn", False), ("addalpha", True),
                                                    ("kn", True)])
def test_viterbi_lm_matches_jax_at_full_width(headline, smoothing, with_lattice):
    h = headline
    graph, dcfg, fb = h["graph"], h["dcfg"], h["fb"]
    toks = sorted(set(graph.labels))
    est, jest = ((ngram.estimate_bigram_kn, jax_ngram.estimate_bigram_kn) if smoothing == "kn"
                 else (ngram.estimate_bigram, jax_ngram.estimate_bigram))
    lm, jlm = est(h["texts"], toks), jest(h["texts"], toks)
    assert lm.pair_logp.shape == (301, 301) and graph.n_states == 3048
    got, want = _both(h["scores"], graph, lm, jlm, fb.n_frames, with_lattice,
                      acoustic_scale=dcfg.acoustic_scale, insertion_penalty=dcfg.word_insertion_penalty)
    _assert_same(got, want, with_lattice)
    res = got[0] if with_lattice else got
    toks_out = lv.path_to_tokens_lm(res, graph)
    assert toks_out == jax_lv.path_to_tokens_lm(want[0] if with_lattice else want, graph)
    assert all(any(w != "<sil>" for w in t) for t in toks_out)


def test_uniform_lm_decodes_as_the_loop_graph(headline):
    """A uniform bigram with no insertion penalty decodes the transcripts of
    the port's ``decode_batch`` over the same word loop (tests/test_lm.py's
    equivalence), at full width."""
    h = headline
    graph = tri.word_loop_graph_cd(h["tied"], insertion_penalty=0.0)
    dcfg = DecodeConfig(acoustic_scale=h["dcfg"].acoustic_scale, word_insertion_penalty=0.0)
    lm = ngram.uniform_bigram(graph.labels)
    res = lv.viterbi_lm(h["scores"], graph, lm, h["fb"].n_frames, acoustic_scale=dcfg.acoustic_scale)
    base = pipe.decode_batch(h["fb"], h["scores"], graph, dcfg, drop_tokens=())
    assert lv.path_to_tokens_lm(res, graph) == base
    assert lv.chain_token_map(graph, lm).tolist() == jax_lv.chain_token_map(graph, lm).tolist()


@pytest.fixture(scope="module")
def small():
    """The small lexicon with an alternate pronunciation of 'fish', random
    float32 emissions over its pdfs, ragged frame counts."""
    variants = {w: [list(syn.LEXICON[w])] for w in ["fish", "cat", "see", "sun", "tree", "dog"]}
    variants["fish"].append(["f", "iy", "sh"])
    lex = make_lexicon_multi(variants)
    topo = build_topology(lex, TopologyConfig())
    rng = np.random.default_rng(3)
    T = 70
    scores = torch.as_tensor((rng.standard_normal((3, T, topo.n_pdfs)) * 3 - 10).astype(np.float32))
    n_frames = torch.as_tensor([T, 41, 1], dtype=torch.int32)
    return lex, topo, scores, n_frames


def _with_skips(graph):
    """The graph with a (j-2 -> j) skip of log-prob -0.7 inside every chain."""
    import dataclasses

    skip = np.full(graph.n_states, -1e30, np.float32)
    same = np.zeros(graph.n_states, bool)
    same[2:] = graph.chain_id[2:] == graph.chain_id[:-2]
    skip[same] = -0.7
    return dataclasses.replace(graph, skip_logp=skip)


@pytest.mark.parametrize("case", ["multi_pron", "grammar", "skips"])
@pytest.mark.parametrize("with_lattice", [False, True])
def test_viterbi_lm_small_graphs_match_jax(small, case, with_lattice):
    lex, topo, scores, n_frames = small
    dcfg = DecodeConfig(word_insertion_penalty=1.5)
    kw = {"acoustic_scale": 0.8, "insertion_penalty": 1.5}
    if case == "multi_pron":
        graph, pron_logp = pipe.word_decode_graph_multi(lex, topo, dcfg)
        assert graph.labels.count("fish") == 2 and pron_logp.min() < 0
        lm = ngram.estimate_bigram([["fish", "cat"], ["see", "fish", "dog"], ["sun", "tree"]],
                                   sorted(set(graph.labels)))
        kw["chain_entry_logp"] = pron_logp
    else:
        graph = pipe.word_decode_graph(lex, topo, dcfg)
        if case == "grammar":
            lm = ngram.grammar_bigram([["see", "cat"], ["see", "dog", "sun"]], tokens=sorted(set(graph.labels)))
        else:
            graph = _with_skips(graph)
            lm = ngram.estimate_bigram_kn([["cat", "dog"], ["tree", "sun", "cat"]], sorted(set(graph.labels)))
    got, want = _both(scores, graph, lm, lm, n_frames, with_lattice, **kw)
    _assert_same(got, want, with_lattice)
    res = got[0] if with_lattice else got
    if case == "grammar":
        allowed = {"see", "cat", "dog", "sun", "<sil>"}
        assert all(set(t) <= allowed for t in lv.path_to_tokens_lm(res, graph))
    if case == "skips":
        # the skip arm is taken: some frame steps back two states
        p = res.path.numpy()
        assert ((p[:, 1:] - p[:, :-1]) == 2).any()


def test_confidence_and_nbest_match_jax_at_full_width(headline):
    """``decode_batch_with_confidence`` and ``decode_batch_nbest`` (Viterbi +
    forward-backward over the word loop) against the reference on the same
    scores: the same words and spans, confidences within CONF_ATOL."""
    h = headline
    fb, scores, graph, dcfg = h["fb"], h["scores"], h["graph"], h["dcfg"]
    jfb, jscores = _jax_fb(fb), jnp.asarray(scores.numpy())
    got = pipe.decode_batch_with_confidence(fb, scores, graph, dcfg, with_times=True)
    want = jax_pipe.decode_batch_with_confidence(jfb, jscores, graph, dcfg, with_times=True)
    assert [[(w, t0, t1) for w, _c, t0, t1 in row] for row in got] == \
        [[(w, t0, t1) for w, _c, t0, t1 in row] for row in want]
    assert all(len(row) > 0 for row in got)
    np.testing.assert_allclose([c for row in got for _w, c, _a, _b in row],
                               [c for row in want for _w, c, _a, _b in row], atol=CONF_ATOL)
    plain = pipe.decode_batch_with_confidence(fb, scores, graph, dcfg, with_times=True, use_kernels=False)
    assert plain == got  # on the CPU both flags run the plain versions

    got_n = pipe.decode_batch_nbest(fb, scores, graph, dcfg, n_best=3)
    want_n = jax_pipe.decode_batch_nbest(jfb, jscores, graph, dcfg, n_best=3)
    assert [[(d["best"], d["span"]) for d in row] for row in got_n] == \
        [[(d["best"], tuple(d["span"])) for d in row] for row in want_n]
    for row, jrow in zip(got_n, want_n):
        for d, jd in zip(row, jrow):
            _assert_same_alternatives(d["alternatives"], jd["alternatives"], min_posterior=0.01)


def _assert_same_alternatives(got, want, min_posterior):
    """The same words (but for one within CONF_ATOL of the cut-off), their
    posteriors within CONF_ATOL, and the words whose posteriors are more
    than CONF_ATOL apart in the same order."""
    a, b = dict(got), dict(want)
    for w in a.keys() ^ b.keys():
        assert abs(a.get(w, b.get(w)) - min_posterior) <= CONF_ATOL
    rank = {w: i for i, (w, _p) in enumerate(got)}
    common = [w for w, _p in want if w in a]
    for i, w in enumerate(common):
        assert abs(a[w] - b[w]) <= CONF_ATOL
        for v in common[i + 1:]:
            if b[w] - b[v] > CONF_ATOL:
                assert rank[w] < rank[v]

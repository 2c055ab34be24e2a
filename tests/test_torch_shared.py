"""The port's copies of the reference's numpy-only modules (config, hmm/,
data/{batching,synthetic}, eval/wer, frontend/numpy_ref) against the
originals: the same configs, graph arrays, batches, waves, WER counts and
features, bit for bit."""

import dataclasses
import os

import numpy as np
import pytest

import mogasr.config as jax_config
from mogasr.data import batching as jax_batching
from mogasr.data import synthetic as jax_syn
from mogasr.eval import wer as jax_wer
from mogasr.frontend import numpy_ref as jax_numpy_ref
from mogasr.hmm import graph as jax_gr
from mogasr.hmm import triphone as jax_tri
from mogasr.utils.bundle import load_system as jax_load_system
from mogasr_torch import config
from mogasr_torch.data import batching
from mogasr_torch.data import synthetic as syn
from mogasr_torch.eval import wer
from mogasr_torch.frontend import numpy_ref
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.utils.bundle import load_system

BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmarks", "headline")


@pytest.fixture(scope="module")
def headline():
    import torch

    ours = load_system(BUNDLE, torch.device("cpu"))
    theirs = jax_load_system(BUNDLE)
    return ours, theirs


@pytest.fixture(scope="module")
def held_out():
    """The first 4 held-out utterances of bench.py, from both packages."""
    def corpus(s):
        return s.make_corpus_v2(4, lexicon=s.extended_lexicon(300), speakers=s.make_speakers(20),
                                style=s.CorpusStyle(), seed=999, words_per_utt=(3, 9))
    return corpus(syn), corpus(jax_syn)


def _assert_same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["FrontendConfig", "BatchConfig", "DecodeConfig", "GmmConfig",
                                  "TopologyConfig", "TrainConfig"])
def test_configs_match(name):
    assert dataclasses.asdict(getattr(config, name)()) == dataclasses.asdict(getattr(jax_config, name)())


def test_word_loop_graph_matches(headline):
    (_, _, _, tied, _), (_, _, _, jtied, _) = headline
    g = tri.word_loop_graph_cd(tied, insertion_penalty=2.0)
    jg = jax_tri.word_loop_graph_cd(jtied, insertion_penalty=2.0)
    assert g.n_states == 3048 and g.labels == jg.labels
    _assert_same_arrays(gr.batch_graphs([g] * 3), jax_gr.batch_graphs([jg] * 3))


def test_cd_align_graphs_match(headline, held_out):
    (_, topo, _, tied, _), (_, jtopo, _, jtied, _) = headline
    utts, _ = held_out
    gs = [tri.align_graph_cd(tied, topo.lexicon.words_to_phone_ids(u.words, oov="sil")) for u in utts]
    jgs = [jax_tri.align_graph_cd(jtied, jtopo.lexicon.words_to_phone_ids(u.words, oov="sil")) for u in utts]
    _assert_same_arrays(gr.batch_graphs(gs, j_max=192), jax_gr.batch_graphs(jgs, j_max=192))
    _assert_same_arrays(gr.batch_graphs([gr.align_graph(topo, [0, 3, 1])]),
                        jax_gr.batch_graphs([jax_gr.align_graph(jtopo, [0, 3, 1])]))


def test_synthetic_waves_match(held_out):
    utts, jutts = held_out
    for u, ju in zip(utts, jutts):
        assert (u.utt_id, u.words) == (ju.utt_id, ju.words)
        np.testing.assert_array_equal(u.wave, ju.wave)


def test_make_batches_matches(held_out):
    utts, _ = held_out
    items = [(u.utt_id, u.wave, u.words) for u in utts]
    fcfg = config.FrontendConfig()
    ours = list(batching.make_batches(items, config.BatchConfig(batch_size=3, bucket_boundaries=(250, 450, 600)),
                                      fcfg))
    theirs = list(jax_batching.make_batches(
        items, jax_config.BatchConfig(batch_size=3, bucket_boundaries=(250, 450, 600)), jax_config.FrontendConfig()))
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert (a.utt_ids, a.words) == (b.utt_ids, b.words)
        np.testing.assert_array_equal(a.waves, b.waves)
        np.testing.assert_array_equal(a.num_samples, b.num_samples)


def test_wer_counts_match():
    rng = np.random.default_rng(0)
    vocab = ["a", "b", "c", "d", "e"]
    refs = [list(rng.choice(vocab, rng.integers(0, 8))) for _ in range(40)]
    hyps = [list(rng.choice(vocab, rng.integers(0, 8))) for _ in range(40)]
    for native in (True, False):  # the reference's C++ scorer, where built, and its Python DP
        w, counts = wer.corpus_wer(refs, hyps)
        jw, jcounts = jax_wer.corpus_wer(refs, hyps, native=native)
        assert w == jw and dataclasses.astuple(counts) == dataclasses.astuple(jcounts)
    assert wer.per_utt_wer(refs, hyps) == jax_wer.per_utt_wer(refs, hyps)
    assert wer.wer_bootstrap_ci(refs, hyps, n_boot=50) == jax_wer.wer_bootstrap_ci(refs, hyps, n_boot=50)
    assert wer.error_report(refs[:5], hyps[:5]) == jax_wer.error_report(refs[:5], hyps[:5])


def test_numpy_ref_features_match(held_out):
    utts, _ = held_out
    for cfg, jcfg in ((config.FrontendConfig(), jax_config.FrontendConfig()),
                      (config.FrontendConfig(cmvn="sliding"), jax_config.FrontendConfig(cmvn="sliding"))):
        for u in utts[:2]:
            np.testing.assert_array_equal(numpy_ref.extract_features_np(u.wave, cfg),
                                          jax_numpy_ref.extract_features_np(u.wave, jcfg))

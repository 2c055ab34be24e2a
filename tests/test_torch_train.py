"""The port's GMM training path against the JAX pipeline on the CPU: flat
start, alignment, EM in both modes (splitting to K = 4, re-estimated
transitions) on a small monophone system, EM checkpoint resume (against the
port's own uninterrupted run, and against JAX's resume through orbax),
held-out evaluation, and one
Baum-Welch E-step at the full width of the headline bundle (1168 pdfs x 16
components x 39 dims, tied-triphone align graphs).

Both packages get the same features (the port's front end, handed to JAX as
numpy), so the comparison is of the training code alone."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.am import em as jem
from mogasr.am.gmm import GmmSet as JaxGmm
from mogasr.config import DecodeConfig as JaxDecodeConfig
from mogasr.config import GmmConfig as JaxGmmConfig
from mogasr.config import TopologyConfig as JaxTopologyConfig
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr.decoder import forward_backward as jax_fb
from mogasr.hmm import triphone as jax_tri
from mogasr.hmm.lexicon import synthetic_lexicon as jax_synthetic_lexicon
from mogasr.hmm.topology import build_topology as jax_build_topology
from mogasr.utils.bundle import load_system as jax_load_system
from mogasr_torch import pipeline as pipe
from mogasr_torch.config import (
    BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig,
)
from mogasr_torch.data import synthetic as syn
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.hmm.lexicon import synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.utils import checkpoint as ckpt
from mogasr_torch.utils.bundle import load_system

CPU = torch.device("cpu")
BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmarks", "headline")
# History (log-likelihood per frame) tolerances. Viterbi EM: the same hard
# statistics up to float32 summation order (the histories differ by 4.4e-7
# relative, the parameters by 3.9e-5). Baum-Welch EM divides by the soft
# frame count, the sum of the float32 posteriors, which both packages carry
# ~1e-3 (relative) away from the true frame count at these lengths: the
# alpha + beta - loglik cancellation (e.g. 386.52 and 386.41 for 387 frames).
# The histories differ by 3.1e-4 relative, the parameters by 4.8e-3.
HISTORY_RTOL = {"viterbi": 1e-4, "baum-welch": 5e-4}
PARAM_ATOL = {"viterbi": 1e-4, "baum-welch": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests: they issue many small ops,
    and with the suite's workers sharing the cores torch's thread pool spends
    its time waiting for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """Six synthetic utterances over two length buckets, featurized by the
    port; the same features as JAX FeatBatches."""
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    utts = syn.make_corpus(6, words_per_utt=(1, 3), seed=3)
    batches = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], FrontendConfig(),
                             BatchConfig(batch_size=3, bucket_boundaries=(150, 300, 500)), CPU)
    jbatches = [jax_pipe.FeatBatch(b.utt_ids, jnp.asarray(b.feats.numpy()), jnp.asarray(b.n_frames.numpy()),
                                   b.words) for b in batches]
    jlex = jax_synthetic_lexicon()
    return lex, topo, batches, jlex, jax_build_topology(jlex, JaxTopologyConfig()), jbatches


def test_flat_start_matches_jax(small):
    lex, topo, batches, jlex, jtopo, jbatches = small
    ours = pipe.flat_start(batches, lex, topo)
    theirs = jax_pipe.flat_start(jbatches, jlex, jtopo)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_align_batch_matches_jax(small):
    lex, topo, batches, jlex, jtopo, jbatches = small
    gmm = pipe.flat_start(batches, lex, topo)
    jgmm = jax_pipe.flat_start(jbatches, jlex, jtopo)
    res, labels, graphs = pipe.align_batch(batches[1], gmm, lex, topo)
    jres, jlabels, jgraphs = jax_pipe.align_batch(jbatches[1], jgmm, jlex, jtopo)
    assert graphs["emit_id"].shape[1] % 64 == 0
    np.testing.assert_array_equal(graphs["emit_id"].numpy(), np.asarray(jgraphs["emit_id"]))
    np.testing.assert_array_equal(res.path.numpy(), np.asarray(jres.path))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_allclose(res.score.numpy(), np.asarray(jres.score), rtol=1e-5)


@pytest.mark.parametrize("mode", ["viterbi", "baum-welch"])
def test_train_gmm_matches_jax(small, mode):
    lex, topo, batches, jlex, jtopo, jbatches = small
    iters = 5  # splits at iterations 2 and 4: K = 1 -> 4
    ours = pipe.train_gmm(batches, lex, topo, GmmConfig(n_states=topo.n_pdfs, n_components=4),
                          TrainConfig(num_em_iters=iters), mode=mode, reestimate_transitions=True)
    theirs = jax_pipe.train_gmm(jbatches, jlex, jtopo, JaxGmmConfig(n_states=jtopo.n_pdfs, n_components=4),
                                JaxTrainConfig(num_em_iters=iters), mode=mode, reestimate_transitions=True)
    assert ours.gmm.n_components == 4 and len(ours.history) == iters
    np.testing.assert_allclose(ours.history, theirs.history, rtol=HISTORY_RTOL[mode])
    assert ours.history[-1] > ours.history[0]
    for a, b in zip(ours.gmm, theirs.gmm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=PARAM_ATOL[mode])
    if mode == "viterbi":
        assert ours.topo.per_phone_self_prob == pytest.approx(theirs.topo.per_phone_self_prob, abs=1e-12)
    else:  # Baum-Welch EM re-estimates no transitions, in either package
        assert not ours.topo.per_phone_self_prob and not theirs.topo.per_phone_self_prob
    assert len(ours.seconds) == len(ours.stage_seconds) == iters
    assert all(set(st) == set(pipe.TRAIN_STAGES) for st in ours.stage_seconds)


def test_evaluate_matches_jax(small):
    lex, topo, batches, jlex, jtopo, jbatches = small
    gmm = pipe.train_gmm(batches, lex, topo, GmmConfig(n_states=topo.n_pdfs, n_components=1),
                         TrainConfig(num_em_iters=2)).gmm
    jgmm = JaxGmm(*(jnp.asarray(a.numpy()) for a in gmm))
    ours = pipe.evaluate(batches, gmm, lex, topo, DecodeConfig())
    theirs = jax_pipe.evaluate(jbatches, jgmm, jlex, jtopo, JaxDecodeConfig())
    assert ours == theirs


def test_train_gmm_rejects_ckpt_dir_and_unknown_mode(small, tmp_path, one_thread):
    """An unknown EM mode, and an EM checkpoint written for another
    [n_states, n_components, mode] fingerprint, raise ValueError."""
    lex, topo, batches, *_ = small
    gcfg, tcfg = GmmConfig(n_states=topo.n_pdfs, n_components=1), TrainConfig(num_em_iters=1)
    with pytest.raises(ValueError):
        pipe.train_gmm(batches, lex, topo, gcfg, tcfg, mode="mmi")
    ck = str(tmp_path / "em")
    pipe.train_gmm(batches, lex, topo, GmmConfig(n_states=topo.n_pdfs, n_components=2),
                   TrainConfig(num_em_iters=1), ckpt_dir=ck)
    for gcfg, mode in ((GmmConfig(n_states=topo.n_pdfs, n_components=4), "viterbi"),
                       (GmmConfig(n_states=topo.n_pdfs, n_components=2), "baum-welch")):
        with pytest.raises(ValueError, match="different config"):
            pipe.train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=2), mode=mode, ckpt_dir=ck)


def _assert_same_run(a, b):
    assert a.history == b.history
    for x, y in zip(a.gmm, b.gmm):
        assert torch.equal(x, y)
    assert a.topo == b.topo


@pytest.mark.parametrize("mode", ["viterbi", "baum-welch"])
def test_train_gmm_resume_is_bitwise(small, tmp_path, one_thread, mode):
    """Stopped after 3 iterations and resumed to 5 from the EM checkpoint:
    the uninterrupted run, bit for bit (ungated splits at iterations 2 and 4,
    re-estimated transitions in Viterbi EM)."""
    lex, topo, batches, *_ = small
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=4)
    assert gcfg.min_split_occ == 0.0
    ck = str(tmp_path / "em")
    whole = pipe.train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=5), mode=mode,
                           reestimate_transitions=True)
    first = pipe.train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=3), mode=mode,
                           reestimate_transitions=True, ckpt_dir=ck)
    assert ckpt.all_steps(ck) == [1, 2, 3]
    resumed = pipe.train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=5), mode=mode,
                             reestimate_transitions=True, ckpt_dir=ck)
    assert ckpt.all_steps(ck) == [1, 2, 3, 4, 5]
    assert first.history == whole.history[:3]
    _assert_same_run(resumed, whole)
    assert len(resumed.seconds) == len(resumed.stage_seconds) == 2
    assert set(resumed.setup_seconds) == {"restore"} and set(whole.setup_seconds) == {"flat_start"}
    # a run that finds its last step done only restores it
    again = pipe.train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=5), mode=mode,
                           reestimate_transitions=True, ckpt_dir=ck)
    _assert_same_run(again, whole)
    assert again.seconds == []


def test_train_gmm_resume_matches_jax_with_gated_splits(small, tmp_path, one_thread):
    """With min_split_occ > 0 the first split after a resume is ungated in
    the reference (the occupancies are not saved): the port's stop (after 2
    iterations) and resume (to 3, splitting at once) equals JAX's through
    orbax, and differs from the uninterrupted run."""
    lex, topo, batches, jlex, jtopo, jbatches = small
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=2, min_split_occ=5.0)
    jgcfg = JaxGmmConfig(n_states=jtopo.n_pdfs, n_components=2, min_split_occ=5.0)
    ours = [pipe.train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=n), ckpt_dir=str(tmp_path / "pt"))
            for n in (2, 3)][1]
    theirs = [jax_pipe.train_gmm(jbatches, jlex, jtopo, jgcfg, JaxTrainConfig(num_em_iters=n),
                                 ckpt_dir=str(tmp_path / "jax")) for n in (2, 3)][1]
    np.testing.assert_allclose(ours.history, theirs.history, rtol=HISTORY_RTOL["viterbi"])
    for a, b in zip(ours.gmm, theirs.gmm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=PARAM_ATOL["viterbi"])
    whole = pipe.train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=3))
    assert len(ours.history) == 3 and ours.gmm.n_components == 2
    assert int((whole.gmm.weights == 0).sum()) > int((ours.gmm.weights == 0).sum())


def test_headline_width_baum_welch_e_step_matches_jax():
    """One Baum-Welch E-step at the headline bundle's full width on 4
    utterances of its training corpus, with tied-triphone align graphs."""
    gmm, topo, fcfg, tied, _meta = load_system(BUNDLE, CPU)
    jgmm, jtopo, _jfcfg, jtied, _jmeta = jax_load_system(BUNDLE)
    S, K, D = gmm.means.shape
    word_lex = syn.extended_lexicon(300)
    utts = syn.make_corpus_v2(4, lexicon=word_lex, speakers=syn.make_speakers(20),
                              style=syn.CorpusStyle(), seed=100, words_per_utt=(3, 9))
    fb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg,
                        BatchConfig(batch_size=4, bucket_boundaries=(700,)), CPU)[0]
    assert fb.size == 4 and bool((fb.n_frames > 0).all())
    stats, res, _ = pipe.batch_stats(fb, gmm, topo.lexicon, topo, "baum-welch",
                                     lambda p: tri.align_graph_cd(tied, p), S)

    jfb = jax_pipe.FeatBatch(fb.utt_ids, jnp.asarray(fb.feats.numpy()), jnp.asarray(fb.n_frames.numpy()),
                             fb.words)
    graphs_np = jax_pipe.build_align_graphs(jfb.words, jtopo.lexicon, jtopo,
                                            align_fn=lambda p: jax_tri.align_graph_cd(jtied, p))
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    jres = jax_fb.forward_backward(jax_pipe.score_batch(jfb.feats, jgmm, use_pallas=False), graphs,
                                   jfb.n_frames)
    post = jax_fb.state_posteriors_to_pdf(jres.log_gamma, graphs["emit_id"], S)
    jstats = jem.accumulate_stats_soft(jgmm, jfb.feats.reshape(-1, D), post.reshape(-1, S))

    assert stats.occ.shape == (S, K) and stats.sx.shape == (S, K, D)
    np.testing.assert_allclose(res.loglik.numpy(), np.asarray(jres.loglik), rtol=1e-5)
    np.testing.assert_allclose(float(stats.loglik), float(jres.loglik.sum()), rtol=1e-5)
    # each package's float32 posteriors sit ~0.02 from a float64 run at these
    # lengths (alpha + beta - loglik cancels values ~1e4), and the two round
    # differently: the statistics differ by 4.0e-4 (occ), 7.3e-4 (sx) and
    # 1.3e-3 (sxx) of their largest entry, the soft frame counts by 5.5e-5
    for field in ("occ", "sx", "sxx"):
        a, b = getattr(stats, field).numpy(), np.asarray(getattr(jstats, field))
        assert np.abs(a - b).max() <= 3e-3 * np.abs(b).max(), field
    np.testing.assert_allclose(float(stats.n_frames), float(jstats.n_frames), rtol=2e-4)

"""The hybrid NN-HMM decode path of the port (``pipeline.make_nn_scorer`` +
``decode_corpus``) against the JAX package's (``make_nn_scorer`` +
``decode_batch``), on the CPU: the scorers on the same inputs at small size
in each precision, and the slice as a whole at full width, the LstmAm of
``benchmarks/bench_families.py`` (81 pdfs x 512 hidden x 2 layers, flax
init carried over by ``from_flax``) on the 3048-state monophone word loop."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.am import neural as jn
from mogasr.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr.data import synthetic as syn
from mogasr.data.batching import make_batches
from mogasr.decoder import viterbi as jax_vit
from mogasr.frontend.jax_frontend import cached_frontend
from mogasr.hmm import graph as gr
from mogasr.hmm.lexicon import make_lexicon
from mogasr.hmm.topology import build_topology
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import neural as tn
from mogasr_torch.am.params import from_flax
from mogasr_torch.config import TrainConfig
from mogasr_torch.hmm.lexicon import make_lexicon as t_make_lexicon
from mogasr_torch.hmm.topology import build_topology as t_build_topology


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
N_UTTS = 4
# With flax's initializers the LstmAm's logits spread ~0.1 and every
# utterance decodes to silence; a head scaled by this gain gives peaked
# posteriors, so the decode emits words and the transcripts test decisions.
HEAD_GAIN = 100.0


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _models(arch, n_pdfs, hidden, layers, feat_dim, seed, head_gain=1.0):
    jm = jn.build_model(arch, n_pdfs, JaxTrainConfig(nn_hidden=hidden, nn_layers=layers))
    params = {"params": jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((2, 8, feat_dim)), jnp.asarray([8, 8]))["params"]}
    if head_gain != 1.0:
        params["params"]["Dense_0"]["kernel"] = params["params"]["Dense_0"]["kernel"] * head_gain
    tm = tn.build_model(arch, n_pdfs, TrainConfig(nn_hidden=hidden, nn_layers=layers), feat_dim)
    tm.load_state_dict(from_flax(tm, params))
    return jm, params, tm


@pytest.mark.parametrize("arch,precision", [("lstm", "float32"), ("lstm", "bfloat16"), ("lstm", "int8"),
                                            ("mlp", "int8")])
def test_nn_scorer_matches_jax(arch, precision):
    rng = np.random.default_rng(0)
    P, D = 9, 6
    feats = rng.standard_normal((3, 14, D)).astype(np.float32)
    nf = np.asarray([14, 9, 2], np.int32)
    log_priors = np.log(rng.dirichlet(np.ones(P))).astype(np.float32)
    jm, params, tm = _models(arch, P, 12, 3, D, seed=1)
    want = np.asarray(jax_pipe.make_nn_scorer(jm, params, jnp.asarray(log_priors), precision)(
        SimpleNamespace(feats=jnp.asarray(feats), n_frames=jnp.asarray(nf))))
    fb = pipe.FeatBatch(["a", "b", "c"], torch.as_tensor(feats), torch.as_tensor(nf), [[], [], []])
    got = pipe.make_nn_scorer(tm, log_priors, precision)(fb)
    assert got.dtype == torch.float32 and got.shape == (3, 14, P) and not got.requires_grad
    assert torch.equal(got, pipe.make_nn_scorer(tm, log_priors, precision, use_kernels=False)(fb))
    # bf16 rounds at other places in the two frameworks: the reference's bf16 bound
    tol = 0.05 if precision == "bfloat16" else 2e-5
    for b, n in enumerate(nf):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def full_width():
    """bench_families.py's lstm row: extended_lexicon(300), monophone
    topology (81 pdfs), the word loop (3048 states), acoustic scale 0.1,
    make_corpus_v2 seed 999 with 3-9 words, buckets (250, 350, 450, 600),
    uniform log priors, LstmAm(81, hidden 512, 2 layers), its head scaled
    by HEAD_GAIN; both packages' objects."""
    fcfg = FrontendConfig()
    dcfg = DecodeConfig(acoustic_scale=0.1)
    word_lex = syn.extended_lexicon(300)
    lex = make_lexicon(word_lex)
    topo = build_topology(lex, TopologyConfig())
    t_lex = t_make_lexicon(word_lex)
    t_topo = t_build_topology(t_lex, TopologyConfig())
    n_pdfs = topo.n_pdfs
    assert n_pdfs == t_topo.n_pdfs == 81
    graph = jax_pipe.word_decode_graph(lex, topo, dcfg)
    t_graph = pipe.word_decode_graph(t_lex, t_topo, dcfg)
    assert graph.n_states == t_graph.n_states == 3048
    utts = syn.make_corpus_v2(N_UTTS, lexicon=word_lex, n_speakers=12, seed=999, words_per_utt=(3, 9))
    utts = [(u.utt_id, u.wave, u.words) for u in utts]
    bcfg = BatchConfig(batch_size=N_UTTS, bucket_boundaries=(250, 350, 450, 600))
    log_priors = np.log(np.full(n_pdfs, 1.0 / n_pdfs, np.float32))
    jm, params, tm = _models("lstm", n_pdfs, 512, 3, fcfg.feat_dim, seed=0, head_gain=HEAD_GAIN)
    assert tm.layers == 2 and tm.hidden == 512
    return SimpleNamespace(fcfg=fcfg, dcfg=dcfg, lex=lex, topo=topo, t_lex=t_lex, t_topo=t_topo, graph=graph,
                           t_graph=t_graph, utts=utts, bcfg=bcfg, log_priors=log_priors, jm=jm, params=params,
                           tm=tm)


def test_hybrid_slice_at_full_width_matches_jax(full_width):
    f = full_width
    fcfg, dcfg, graph, t_graph, utts, bcfg, log_priors = (f.fcfg, f.dcfg, f.graph, f.t_graph, f.utts, f.bcfg,
                                                          f.log_priors)
    score = jax_pipe.make_nn_scorer(f.jm, f.params, jnp.asarray(log_priors))
    graphs_np = gr.batch_graphs([graph] * N_UTTS)
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    hyps, scores = [], []
    for b in make_batches(utts, bcfg, fcfg):
        feats, n_frames = cached_frontend(fcfg, b.waves.shape[1])(jnp.asarray(b.waves), jnp.asarray(b.num_samples))
        fb = SimpleNamespace(feats=feats, n_frames=n_frames, size=b.size)
        ll = score(fb)
        res = jax_vit.viterbi(ll, graphs, n_frames, acoustic_scale=dcfg.acoustic_scale)
        scores += [float(s) for s in res.score[: b.size]]
        hyps += [[w.lower() for w in seq] for seq in jax_pipe.decode_batch(fb, ll, graph, dcfg)]

    got = pipe.decode_corpus(utts, pipe.make_nn_scorer(f.tm, log_priors), t_graph, fcfg, dcfg, bcfg, CPU)
    assert got.n_utts == N_UTTS and all(len(h) > 0 for h in hyps)
    assert got.hyps == hyps
    np.testing.assert_allclose(got.scores, scores, rtol=1e-5)
    assert set(got.stage_seconds) == set(pipe.STAGES) and got.stage_seconds["scoring"] > 0


def test_hybrid_evaluate_matches_jax(full_width):
    """pipe.evaluate with a scorer, in the reference's calls (scorer as the
    sixth argument, and with topo=None and a graph given), against JAX's
    evaluate on the same 4 utterances: the same WER dict."""
    f = full_width
    want = jax_pipe.evaluate(jax_pipe.featurize(f.utts, f.fcfg, f.bcfg), None, f.lex, f.topo, f.dcfg,
                             scorer=jax_pipe.make_nn_scorer(f.jm, f.params, jnp.asarray(f.log_priors)))
    batches = pipe.featurize(f.utts, f.fcfg, f.bcfg, CPU)
    scorer = pipe.make_nn_scorer(f.tm, f.log_priors)
    got = pipe.evaluate(batches, None, f.t_lex, f.t_topo, f.dcfg, scorer)
    assert got == want and got["n_utts"] == N_UTTS and got["ref_words"] > 0
    assert pipe.evaluate(batches, None, f.t_lex, None, f.dcfg, scorer=scorer, graph=f.t_graph) == want

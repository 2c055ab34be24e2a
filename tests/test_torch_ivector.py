"""i-vectors (``mogasr_torch.am.ivector``), ``pipeline.append_ivectors`` and
diarization (``mogasr_torch.diarize``, ``cli.diarize.build_session``)
against the JAX package on the same seeded numpy inputs, on the CPU.

The Baum-Welch statistics within the reference test's tolerances
(``tests/test_ivector.py``: n rtol 1e-5, f rtol 1e-4 atol 1e-4), the E-step's
i-vectors, the auxiliary objective and the UBM, trained on the same
features, within IVEC_RTOL/IVEC_ATOL (float32 products and sums in another
order), the total-variability matrix after 5 EM iterations from the same
statistics within T_ATOL; length normalization, cosine scores, AHC labels,
the k-means polish, the speech windows and the synthetic session are numpy
and equal bitwise. On one 2-speaker session the port's diarizer (trained by
the port) reaches the reference test's DER limits, and JAX's
``diarize_wave`` with the same UBM and T gives the same turns. The
extractor round-trips through the port's checkpoint format."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import diarize as jax_diarize
from mogasr import pipeline as jax_pipe
from mogasr.am import ivector as JI
from mogasr.am.gmm import GmmSet as JaxGmmSet
from mogasr.config import BatchConfig, FrontendConfig
from mogasr.data import synthetic as jax_syn
from mogasr_torch import config as tc
from mogasr_torch import diarize as D
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import aligned
from mogasr_torch.am import ivector as I
from mogasr_torch.am.gmm import gmm_from_numpy
from mogasr_torch.cli import diarize as cli_diarize
from mogasr_torch.cli import transcribe as cli_transcribe
from mogasr_torch.cli.diarize import build_session
from mogasr_torch.eval.diarization import der


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
IVEC_RTOL, IVEC_ATOL = 1e-4, 1e-4
T_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _t(a):
    return torch.as_tensor(np.array(a))


def _toy(seed=0, K=4, Dm=8, R=2, n_utts=40, frames=120):
    """The reference test's generative model: a toy UBM, a true T, frames
    sampled per utterance; padded rows carry garbage."""
    rng = np.random.default_rng(seed)
    ubm = (rng.dirichlet(np.ones(K) * 5)[None].astype(np.float32),
           (3.0 * rng.standard_normal((1, K, Dm))).astype(np.float32), np.ones((1, K, Dm), np.float32))
    t_true = 2.0 * rng.standard_normal((K, Dm, R))
    feats = np.zeros((n_utts, frames, Dm), np.float32)
    for u in range(n_utts):
        shifted = ubm[1][0] + t_true @ rng.standard_normal(R)
        comps = rng.choice(K, size=frames, p=ubm[0][0])
        feats[u] = shifted[comps] + rng.standard_normal((frames, Dm))
    nf = rng.integers(frames // 2, frames + 1, n_utts).astype(np.int32)
    for u in range(n_utts):
        feats[u, nf[u]:] = 777.0
    return ubm, feats, nf


def test_bw_stats_estep_and_tv_match_jax(monkeypatch):
    monkeypatch.setattr(aligned, "CHUNK_BYTES", 1 << 20)  # several row chunks
    ubm_np, feats, nf = _toy()
    ubm, jubm = gmm_from_numpy(*ubm_np, CPU), JaxGmmSet(*map(jnp.asarray, ubm_np))
    ours = I.accumulate_bw_stats(_t(feats), _t(nf), ubm)
    theirs = JI.accumulate_bw_stats(jnp.asarray(feats), jnp.asarray(nf), jubm)
    np.testing.assert_allclose(ours.n.numpy(), np.asarray(theirs.n), rtol=1e-5)
    np.testing.assert_allclose(ours.f.numpy(), np.asarray(theirs.f), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours.n.numpy().sum(-1), nf, rtol=1e-4)
    # T from the same (numpy) statistics on both sides
    host = I.BwStats(ours.n, ours.f)
    jhost = JI.BwStats(jnp.asarray(ours.n.numpy()), jnp.asarray(ours.f.numpy()))
    t_mat = I.train_total_variability([host], ubm, rank=2, n_iters=5)
    jt_mat = JI.train_total_variability([jhost], jubm, rank=2, n_iters=5)
    np.testing.assert_allclose(t_mat, jt_mat, atol=T_ATOL)
    vecs = I.extract_ivectors(host, ubm, jt_mat)
    jvecs = JI.extract_ivectors(jhost, jubm, jt_mat)
    np.testing.assert_allclose(vecs, jvecs, rtol=IVEC_RTOL, atol=IVEC_ATOL)
    np.testing.assert_allclose(I.tv_aux_loglik(host, ubm, jt_mat), JI.tv_aux_loglik(jhost, jubm, jt_mat),
                               rtol=IVEC_RTOL)
    # EM improves the auxiliary objective (the reference's check)
    t0 = I.train_total_variability([host], ubm, rank=2, n_iters=1)
    assert I.tv_aux_loglik(host, ubm, t_mat) > I.tv_aux_loglik(host, ubm, t0)
    # numpy helpers: bitwise
    np.testing.assert_array_equal(I.length_normalize(jvecs), JI.length_normalize(jvecs))
    np.testing.assert_array_equal(I.cosine_score(jvecs[:5], jvecs), JI.cosine_score(jvecs[:5], jvecs))
    ext = I.IvectorExtractor(ubm, jt_mat)
    np.testing.assert_allclose(I.utterance_ivectors(ext, _t(feats), _t(nf)),
                               JI.utterance_ivectors(JI.IvectorExtractor(jubm, jt_mat), jnp.asarray(feats),
                                                     jnp.asarray(nf)), rtol=IVEC_RTOL, atol=IVEC_ATOL)


def test_k1_ivector_is_whitened_mean_offset():
    """The reference's check: a one-component UBM with the true T recovers
    the generative w almost exactly."""
    rng = np.random.default_rng(7)
    Dm, R, U, T = 6, 2, 40, 400
    ubm = gmm_from_numpy(np.ones((1, 1)), rng.standard_normal((1, 1, Dm)), np.ones((1, 1, Dm)), CPU)
    t_true = 2.0 * rng.standard_normal((1, Dm, R)).astype(np.float32)
    w_true = rng.standard_normal((U, R))
    mu = ubm.means[0, 0].numpy()
    feats = np.stack([mu + t_true[0] @ w_true[u] + rng.standard_normal((T, Dm)) for u in range(U)]).astype(np.float32)
    stats = I.accumulate_bw_stats(_t(feats), _t(np.full(U, T, np.int32)), ubm)
    assert np.corrcoef(I.extract_ivectors(stats, ubm, t_true).ravel(), w_true.ravel())[0, 1] > 0.99


@pytest.fixture(scope="module")
def corpus_batches():
    """8 small-lexicon utterances featurized by the JAX front end; the port's
    FeatBatches hold the same arrays."""
    utts = [(u.utt_id, u.wave, u.words) for u in jax_syn.make_corpus(8, words_per_utt=(2, 3), seed=9)]
    jbatches = jax_pipe.featurize(utts, FrontendConfig(), BatchConfig(batch_size=4, bucket_boundaries=(300, 500)))
    return [pipe.FeatBatch(fb.utt_ids, _t(fb.feats), _t(fb.n_frames), fb.words) for fb in jbatches], jbatches


def test_ubm_extractor_and_append_ivectors_match_jax(corpus_batches, tmp_path):
    batches, jbatches = corpus_batches
    ubm = I.train_ubm(batches, n_components=4, n_iters=6)
    jubm = JI.train_ubm(jbatches, n_components=4, n_iters=6)
    assert ubm.n_states == 1 and ubm.n_components == 4
    for a, b in zip(ubm, jubm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=IVEC_RTOL, atol=IVEC_ATOL)
    np.testing.assert_allclose(ubm.weights.numpy().sum(), 1.0, atol=1e-4)
    # one extractor for both packages (the converter), through the checkpoint format
    rng = np.random.default_rng(0)
    t_mat = (0.3 * rng.standard_normal((4, batches[0].feats.shape[-1], 3))).astype(np.float32)
    ext = I.extractor_from_numpy(*(np.asarray(a) for a in jubm), t_mat, CPU)
    I.save_extractor(str(tmp_path / "iv"), ext)
    back = I.load_extractor(str(tmp_path / "iv"), CPU)
    assert back.rank == 3 and np.array_equal(back.t_mat, t_mat)
    assert all(torch.equal(a, b) for a, b in zip(back.ubm, ext.ubm))
    jext = JI.IvectorExtractor(jubm, t_mat)
    for ours, theirs in zip(pipe.append_ivectors(batches, back), jax_pipe.append_ivectors(jbatches, jext)):
        assert ours.feats.shape == tuple(theirs.feats.shape) and ours.utt_ids == theirs.utt_ids
        np.testing.assert_allclose(ours.feats.numpy(), np.asarray(theirs.feats), rtol=IVEC_RTOL, atol=IVEC_ATOL)
    by_utt = I.extract_ivectors_batches(batches, back.ubm, t_mat)
    jby_utt = JI.extract_ivectors_batches(jbatches, jubm, t_mat)
    assert by_utt.keys() == jby_utt.keys()
    np.testing.assert_allclose(np.stack(list(by_utt.values())), np.stack(list(jby_utt.values())),
                               rtol=IVEC_RTOL, atol=IVEC_ATOL)


def test_clustering_and_session_match_jax():
    rng = np.random.default_rng(0)
    X = np.concatenate([c + 0.3 * rng.standard_normal((12, 5)) for c in 2 * np.eye(5)[:3]])
    X = X / np.linalg.norm(X, axis=1, keepdims=True)
    for kw in ({"n_clusters": 3}, {"n_clusters": 5}, {"threshold": 0.5}, {"threshold": 0.05}):
        labels = D.ahc_labels(X, **kw)
        np.testing.assert_array_equal(labels, jax_diarize.ahc_labels(X, **kw))
        start = (labels + np.arange(len(labels)) % 2) % max(int(labels.max()) + 1, 1)
        np.testing.assert_array_equal(D._kmeans_refine(X, start), jax_diarize._kmeans_refine(X, start))
    spans = [(0, 5000), (9000, 60000), (70000, 71000)]
    assert D._speech_windows(spans, 24000, 12000) == jax_diarize._speech_windows(spans, 24000, 12000)
    from cli.diarize import build_session as jax_build_session

    wave, refs, train = build_session(2, 3, seed=4)
    jwave, jrefs, jtrain = jax_build_session(2, 3, seed=4)
    np.testing.assert_array_equal(wave, jwave)
    assert refs == jrefs and [(u, w) for u, _x, w in train] == [(u, w) for u, _x, w in jtrain]
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(train, jtrain))


def test_diarize_session_reaches_the_reference_limits_and_matches_jax():
    """The reference test's 2-speaker session: the port's diarizer (its
    defaults but 6 UBM and 6 TV iterations, on 24 training utterances)
    diarizes to DER < 0.30, below the one-speaker DER - 0.05; JAX's
    diarize_wave with the same UBM and T gives the same turns."""
    wave, refs, train_utts = build_session(2, 10, seed=4)
    fcfg = tc.FrontendConfig(cmvn="none")
    ubm, t_mat = D.train_diarizer(train_utts[:24], fcfg, n_components=16, rank=8, ubm_iters=6, tv_iters=6,
                                  device=CPU)
    turns = D.diarize_wave(wave, fcfg, ubm, t_mat, n_speakers=2)
    assert len({lab for _s, _e, lab in turns}) == 2
    out = der(refs, turns, collar_s=0.25)
    assert out["der"] < 0.30, out
    assert out["der"] < der(refs, [(s, e, 0) for s, e, _l in turns], collar_s=0.25)["der"] - 0.05, out
    jubm = JaxGmmSet(*(jnp.asarray(a.numpy()) for a in ubm))
    assert turns == jax_diarize.diarize_wave(wave, FrontendConfig(cmvn="none"), jubm, t_mat, n_speakers=2)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_diarize_and_transcribe_diarize_clis(tmp_path):
    """The twins alone (the reference CLIs' first runs cost their JAX
    compiles; their pieces are held to the reference above): ``diarize
    --synthetic-session`` logs the reference's record with its DER fields and
    writes JSONL turns and RTTM lines in the reference's formats;
    ``transcribe --diarize`` tags every segment with one of the requested
    speakers."""
    cli_diarize.main(["--synthetic-session", "4", "--speakers", "2", "--n-speakers", "2", "--ubm-components", "8",
                      "--rank", "4", "--out", str(tmp_path / "turns.jsonl"), "--rttm", str(tmp_path / "out.rttm"),
                      "--run-dir", str(tmp_path / "d"), "--device", "cpu"])
    rec = _jsonl(str(tmp_path / "d" / "metrics.jsonl"))[-1]
    assert set(rec) == {"stage", "recording_s", "turns", "speakers_found", "train_wall_s", "diarize_wall_s", "der",
                        "miss", "false_alarm", "confusion", "ref_speech_s", "time"}
    assert rec["stage"] == "diarize_done" and rec["speakers_found"] == 2
    turns = _jsonl(str(tmp_path / "turns.jsonl"))
    with open(tmp_path / "out.rttm") as f:
        rttm = f.read().splitlines()
    assert len(turns) == len(rttm) == rec["turns"] > 0
    t0 = turns[0]
    assert rttm[0] == (f"SPEAKER synthetic-session 1 {t0['start']:.3f} {t0['end'] - t0['start']:.3f} <NA> <NA> "
                       f"{t0['speaker']} <NA> <NA>")
    cli_transcribe.main(["--synthetic-demo", "--diarize", "--num-speakers", "2", "--out", str(tmp_path / "o.jsonl"),
                         "--run-dir", str(tmp_path / "t"), "--device", "cpu"])
    got = _jsonl(str(tmp_path / "o.jsonl"))
    assert len(got) == 4 and {r["speaker"] for r in got} <= {0, 1} and all(r["words"] for r in got)
    assert list(got[0]) == ["start_s", "end_s", "words", "confidences", "word_times", "speaker"]

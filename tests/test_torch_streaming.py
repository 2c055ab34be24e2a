"""mogasr_torch's streaming front end (frontend/streaming.py), the pipeline's
streaming functions and data/prefetch.py against the reference's, on the
same numpy inputs: StreamingFrontend against JAX's at three chunkings (one
shorter than a frame) within the reference's 2e-4, with global, sliding and
no CMVN and with energy and dither; the engine half (accept_samples,
absorb, finalize_absorbed) equal to process()/finalize(); featurize_streaming
against JAX's and against the offline featurize (5e-4, the reference's);
compute_global_cmvn; featurize_iter equal to featurize; prefetch's order,
exceptions, bounded lookahead and release of an abandoned producer."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.config import FrontendConfig as JaxFrontendConfig
from mogasr.frontend import streaming as jax_streaming
from mogasr_torch import pipeline as pipe
from mogasr_torch.config import BatchConfig, FrontendConfig
from mogasr_torch.data.prefetch import device_put_batches, prefetch
from mogasr_torch.data.synthetic import make_corpus, synth_utterance
from mogasr_torch.frontend import numpy_ref as npref
from mogasr_torch.frontend.streaming import StreamingFrontend


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
TOL = 2e-4          # tests/test_streaming.py: the streamer against the offline features
FEATURIZE_TOL = 5e-4


@pytest.fixture(scope="module")
def wave():
    return synth_utterance("s0", ["cat", "moon", "tree"], seed=11).wave


def _stream(cls, cfg, wave, chunk, **kw):
    sf = cls(cfg, **kw)
    outs = [sf.process(wave[i:i + chunk]) for i in range(0, len(wave), chunk)]
    outs.append(sf.finalize())
    return np.concatenate(outs)


@pytest.mark.parametrize("chunk", [160, 1600, 100000])
def test_streaming_matches_reference(wave, chunk):
    """cmvn none; 160 samples is shorter than a 400-sample frame."""
    cfg = FrontendConfig(cmvn="none")
    got = _stream(StreamingFrontend, cfg, wave, chunk, device=CPU)
    want = _stream(jax_streaming.StreamingFrontend, JaxFrontendConfig(cmvn="none"), wave, chunk)
    assert got.shape == want.shape == npref.extract_features_np(wave, cfg).shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, npref.extract_features_np(wave, cfg), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cmvn", ["global", "sliding"])
def test_streaming_cmvn_matches_reference(wave, cmvn):
    base = npref.extract_features_np(wave, FrontendConfig(cmvn="none"))
    stats = {}
    if cmvn == "global":
        stats = {"cmvn_mean": base.mean(0), "cmvn_istd": 1.0 / np.sqrt(np.maximum(base.var(0), 1e-10))}
    kw = {"cmvn": cmvn, "cmvn_window": 120}
    got = _stream(StreamingFrontend, FrontendConfig(**kw), wave, 3000, device=CPU, **stats)
    want = _stream(jax_streaming.StreamingFrontend, JaxFrontendConfig(**kw), wave, 3000, **stats)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if cmvn == "sliding":  # causal: equal to the offline sliding path
        np.testing.assert_allclose(got, npref.extract_features_np(wave, FrontendConfig(**kw)), atol=2e-3, rtol=2e-3)


def test_streaming_energy_with_dither(wave):
    kw = {"cmvn": "none", "use_energy": True, "dither": 1.0}
    got = _stream(StreamingFrontend, FrontendConfig(**kw), wave, 2500, device=CPU)
    want = _stream(jax_streaming.StreamingFrontend, JaxFrontendConfig(**kw), wave, 2500)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, npref.extract_features_np(wave, FrontendConfig(**kw)), atol=TOL, rtol=TOL)


def test_engine_half_equals_process(wave):
    """accept_samples -> the spectral chunk run by the caller -> absorb, then
    finalize_absorbed: process()'s and finalize()'s values bit for bit."""
    cfg = FrontendConfig(cmvn="sliding", use_energy=True)
    want = _stream(StreamingFrontend, cfg, wave, 1000, device=CPU)
    sf = StreamingFrontend(cfg, device=CPU)
    outs = []
    for i in range(0, len(wave), 1000):
        frames, energy = sf.accept_samples(wave[i:i + 1000])
        rows = np.zeros((0, cfg.base_dim), np.float32)
        for j in range(0, frames.shape[0], sf.chunk_frames):
            block = np.zeros((sf.chunk_frames, cfg.frame_length), np.float32)
            nb = frames[j:j + sf.chunk_frames].shape[0]
            block[:nb] = frames[j:j + nb]
            rows = np.concatenate([rows, sf.kernel(torch.from_numpy(block)).numpy()[:nb]])
        if energy is not None:
            rows[:, 0] = energy
        outs.append(sf.absorb(rows))
    outs.append(sf.finalize_absorbed())
    np.testing.assert_array_equal(np.concatenate(outs), want)


def test_streaming_rejects_acausal_configs():
    with pytest.raises(NotImplementedError, match="add_pitch"):
        StreamingFrontend(FrontendConfig(add_pitch=True), device=CPU)
    with pytest.raises(NotImplementedError, match="snip_edges"):
        StreamingFrontend(FrontendConfig(snip_edges=False), device=CPU)


@pytest.fixture(scope="module")
def corpus():
    return [(u.utt_id, u.wave, u.words) for u in make_corpus(6, words_per_utt=(2, 3), seed=31)]


def _by_id(batches):
    out = {}
    for fb in batches:
        feats, nf = np.asarray(fb.feats), np.asarray(fb.n_frames)
        for i, uid in enumerate(fb.utt_ids):
            out[uid] = feats[i, :nf[i]]
    return out


@pytest.mark.parametrize("cmvn", ["utterance", "sliding"])
def test_featurize_streaming_matches_reference_and_offline(corpus, cmvn):
    bcfg = BatchConfig(batch_size=4, bucket_boundaries=(150, 250, 400))
    fcfg = FrontendConfig(cmvn=cmvn)
    got = pipe.featurize_streaming(corpus, fcfg, bcfg, CPU, chunk_samples=4000)
    want = jax_pipe.featurize_streaming(corpus, JaxFrontendConfig(cmvn=cmvn), bcfg, chunk_samples=4000)
    assert [fb.utt_ids for fb in got] == [fb.utt_ids for fb in want]
    assert [fb.words for fb in got] == [fb.words for fb in want]
    for a, b in zip(got, want):
        assert tuple(a.feats.shape) == b.feats.shape
        np.testing.assert_array_equal(a.n_frames.numpy(), np.asarray(b.n_frames))
        np.testing.assert_allclose(a.feats.numpy(), np.asarray(b.feats), atol=FEATURIZE_TOL, rtol=FEATURIZE_TOL)
    off = _by_id(pipe.featurize(corpus, fcfg, bcfg, CPU))
    st = _by_id(got)
    assert set(off) == set(st)
    for uid in off:
        np.testing.assert_allclose(st[uid], off[uid], atol=FEATURIZE_TOL, rtol=FEATURIZE_TOL)


def test_compute_global_cmvn_matches_reference(corpus):
    bcfg = BatchConfig(batch_size=4, bucket_boundaries=(150, 250, 400))
    batches = pipe.featurize(corpus, FrontendConfig(cmvn="none"), bcfg, CPU)
    mean, istd = pipe.compute_global_cmvn(batches)
    jmean, jistd = jax_pipe.compute_global_cmvn(
        [jax_pipe.FeatBatch(fb.utt_ids, jnp.asarray(fb.feats.numpy()), jnp.asarray(fb.n_frames.numpy()), fb.words)
         for fb in batches])
    assert mean.dtype == istd.dtype == np.float32
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(istd, jistd)


def test_featurize_iter_is_featurize(corpus):
    fcfg, bcfg = FrontendConfig(), BatchConfig(batch_size=4, bucket_boundaries=(150, 250, 400))
    eager = pipe.featurize(corpus, fcfg, bcfg, CPU)
    it = pipe.featurize_iter(corpus, fcfg, bcfg, CPU)
    assert not isinstance(it, list)
    lazy = list(prefetch(device_put_batches(it, CPU), depth=2))
    assert len(lazy) == len(eager) > 1
    for a, b in zip(lazy, eager):
        assert a.utt_ids == b.utt_ids and a.words == b.words
        assert torch.equal(a.feats, b.feats) and torch.equal(a.n_frames, b.n_frames)


def test_prefetch_order_and_passthrough():
    items = list(range(57))
    assert list(prefetch(iter(items), depth=3)) == items
    assert list(prefetch(iter(items), depth=1)) == items
    assert list(prefetch(iter(items), depth=0)) == items


def test_prefetch_exception_propagates():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("producer boom")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="producer boom"):
        next(it)


def test_prefetch_bounded_lookahead():
    produced = []

    def gen():
        for i in range(10):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=2)
    time.sleep(0.3)
    # depth items queued and one blocked in the put
    assert len(produced) <= 4, produced
    assert list(it) == list(range(10))


def test_prefetch_abandoned_consumer_releases_producer():
    started = threading.active_count()
    it = prefetch(iter(range(1000)), depth=2)
    consumed = [x for _, x in zip(range(4), it)]
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > started and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= started, "producer thread leaked"
    assert consumed == [0, 1, 2, 3]

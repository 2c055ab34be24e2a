"""mogasr_torch's pitch features (frontend/pitch.py) against the reference's
(mogasr/frontend/pitch.py) on the same numpy inputs, at the reference's own
tolerance (rtol/atol 1e-5, tests/test_pitch.py): ``extract_pitch`` on
harmonic tones, a chirp, noise and a padded synthetic-speech batch (frame
counts equal, the padded frames zero), ``features_with_pitch`` on the
spectral features, ``pipeline.featurize`` with ``add_pitch`` (the spectral
columns those of ``featurize`` without it), and its padding invariance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.config import FrontendConfig as JaxFrontendConfig
from mogasr.frontend import pitch as jax_pitch
from mogasr_torch import pipeline as pipe
from mogasr_torch.config import BatchConfig, FrontendConfig
from mogasr_torch.data.synthetic import make_corpus
from mogasr_torch.frontend import pitch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SR = 16000
TOL = 1e-5
CPU = torch.device("cpu")


def _tone(f0, seconds, seed, chirp_to=None):
    t = np.arange(int(seconds * SR)) / SR
    f = f0 if chirp_to is None else f0 + (chirp_to - f0) * t / seconds
    ph = 2 * np.pi * np.cumsum(np.broadcast_to(f, t.shape)) / SR
    x = 0.5 * np.sin(ph) + 0.12 * np.sin(2 * ph) + 0.06 * np.sin(3 * ph)
    return (x + 0.02 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


def _batch(signals):
    S = max(len(s) for s in signals) + 500  # padding past every row, filled with noise
    waves = np.random.default_rng(0).standard_normal((len(signals), S)).astype(np.float32)
    for i, s in enumerate(signals):
        waves[i, :len(s)] = s
    return waves, np.asarray([len(s) for s in signals], np.int32)


def test_extract_pitch_matches_reference():
    signals = [_tone(120.0, 0.5, 1), _tone(220.0, 0.3, 2), _tone(90.0, 0.6, 3, chirp_to=300.0),
               np.random.default_rng(4).standard_normal(6000).astype(np.float32) * 0.3]
    waves, ns = _batch(signals)
    got, nf = pitch.extract_pitch(torch.as_tensor(waves), torch.as_tensor(ns))
    want, jnf = jax_pitch.extract_pitch(jnp.asarray(waves), jnp.asarray(ns))
    np.testing.assert_array_equal(nf.numpy(), np.asarray(jnf))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for b, n in enumerate(nf.tolist()):
        assert np.abs(got[b, n:].numpy()).max(initial=0.0) == 0.0
    assert float(np.median(got[0, :int(nf[0]), 0].numpy())) > 0.8  # a voiced tone


def test_features_with_pitch_and_featurize_match_reference():
    corpus = [(u.utt_id, u.wave, u.words) for u in make_corpus(3, words_per_utt=(2, 2), seed=13)]
    bcfg = BatchConfig(batch_size=4, bucket_boundaries=(150, 300))
    got = pipe.featurize(corpus, FrontendConfig(add_pitch=True), bcfg, CPU)
    want = jax_pipe.featurize(corpus, JaxFrontendConfig(add_pitch=True), bcfg)
    base = pipe.featurize(corpus, FrontendConfig(), bcfg, CPU)
    assert len(got) == len(want) == len(base)
    for fb, jfb, fb0 in zip(got, want, base):
        assert fb.utt_ids == jfb.utt_ids and fb.feats.shape[-1] == FrontendConfig(add_pitch=True).feat_dim
        D = fb0.feats.shape[-1]
        assert torch.equal(fb.feats[..., :D], fb0.feats)
        np.testing.assert_allclose(fb.feats[..., D:].numpy(), np.asarray(jfb.feats[..., D:]), rtol=TOL, atol=TOL)
        # features_with_pitch itself, on the reference's own spectral features and audio
        waves = np.zeros((fb.feats.shape[0], max(len(w) for _, w, _ in corpus)), np.float32)
        ns = np.zeros(fb.feats.shape[0], np.int32)
        for i, uid in enumerate(fb.utt_ids):
            w = next(w for u, w, _ in corpus if u == uid)
            waves[i, :len(w)] = w
            ns[i] = len(w)
        spec = np.array(jfb.feats[..., :D])
        ours = pitch.features_with_pitch(torch.as_tensor(spec), fb.n_frames, torch.as_tensor(waves),
                                         torch.as_tensor(ns))
        theirs = jax_pitch.features_with_pitch(jnp.asarray(spec), jnp.asarray(fb.n_frames.numpy()),
                                               jnp.asarray(waves), jnp.asarray(ns))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=TOL, atol=TOL)


def test_padding_invariance():
    x = _tone(130.0, 0.3, 5)
    base, nf = pitch.extract_pitch(torch.as_tensor(x)[None], torch.tensor([len(x)]))
    padded = np.concatenate([x, np.random.default_rng(7).standard_normal(3000).astype(np.float32)])
    got, nf2 = pitch.extract_pitch(torch.as_tensor(padded)[None], torch.tensor([len(x)]))
    n = int(nf[0])
    assert int(nf2[0]) == n
    np.testing.assert_allclose(got[0, :n].numpy(), base[0, :n].numpy(), rtol=TOL, atol=TOL)
    assert float(got[0, n:].abs().max()) == 0.0


def test_lowpass_kernel_is_the_reference_one():
    for cfg in (pitch.PitchConfig(), pitch.PitchConfig(lowpass_taps=31, work_rate=8000)):
        jcfg = jax_pitch.PitchConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
        np.testing.assert_array_equal(pitch._lowpass_kernel(cfg, SR), jax_pitch._lowpass_kernel(jcfg, SR))


def test_add_pitch_needs_snip_edges():
    with pytest.raises(NotImplementedError, match="snip_edges"):
        pipe.frontend_for(FrontendConfig(add_pitch=True, snip_edges=False), 16000, CPU)

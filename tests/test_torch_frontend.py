"""mogasr_torch front end against the JAX front end, the NumPy oracle and the
golden features: same inputs (numpy, from a seed) through both packages."""

import os

import numpy as np
import pytest
import torch

from mogasr.config import FrontendConfig
from mogasr.data.synthetic import synth_utterance
from mogasr.frontend.jax_frontend import make_frontend as jax_make_frontend
from mogasr.frontend.numpy_ref import dither_noise_np, extract_features_np
from mogasr_torch.frontend.torch_frontend import _dither_noise, extract_features, make_frontend


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden.npz")
# the reference's own front-end tolerance (tests/test_golden.py)
ATOL = RTOL = 3e-4


def _ragged_batch():
    """Three synthetic utterances of different lengths plus a 200-sample one
    (no full frame), zero-padded to one [4, N] batch."""
    waves = [synth_utterance(f"u{i}", w, seed=i).wave
             for i, w in enumerate([["cat", "dog"], ["sun"], ["tree", "fish", "see"]])]
    waves.append(np.random.default_rng(0).standard_normal(200).astype(np.float32))
    lens = np.asarray([len(w) for w in waves], np.int32)
    batch = np.zeros((len(waves), lens.max()), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    return batch, lens


def _both(cfg, batch, lens):
    fj, nj = jax_make_frontend(cfg, batch.shape[1])(batch, lens)
    ft, nt = make_frontend(cfg, batch.shape[1], CPU)(torch.as_tensor(batch), torch.as_tensor(lens))
    return np.asarray(fj), np.asarray(nj), ft.numpy(), nt.numpy()


@pytest.mark.parametrize("kw", [
    {},
    {"feature_type": "fbank"},
    {"dither": 1.0},
    {"snip_edges": False},
    {"snip_edges": False, "use_energy": True},
    {"delta_order": 1},
    {"feature_type": "plp"},
    {"feature_type": "plp", "use_energy": True, "cmvn": "none", "delta_order": 1},
    {"feature_type": "plp", "snip_edges": False, "dither": 1.0},
], ids=["mfcc", "fbank", "dither", "centered", "centered_energy", "delta1", "plp", "plp_energy",
        "plp_centered_dither"])
def test_matches_jax_ragged_batch(kw):
    batch, lens = _ragged_batch()
    fj, nj, ft, nt = _both(FrontendConfig(**kw), batch, lens)
    np.testing.assert_array_equal(nt, nj)
    assert ft.shape == fj.shape and ft.dtype == np.float32
    np.testing.assert_allclose(ft, fj, atol=ATOL, rtol=RTOL)


def test_sliding_cmvn_matches_oracle_and_jax():
    """The port keeps the sliding statistics in float64, as the oracle does,
    so it holds 3e-4 against the oracle. The reference's float32 cumsums sit
    up to ~6e-3 from the oracle (tests/test_sliding_cmvn.py), so against the
    reference the port may differ by that error of the reference's own and
    no more."""
    cfg = FrontendConfig(cmvn="sliding", cmvn_window=50)
    batch, lens = _ragged_batch()
    fj, nj, ft, nt = _both(cfg, batch, lens)
    np.testing.assert_array_equal(nt, nj)
    for b in range(3):
        n = int(nt[b])
        ref = extract_features_np(batch[b, : lens[b]], cfg)
        np.testing.assert_allclose(ft[b, :n], ref, atol=ATOL, rtol=RTOL)
        jax_err = np.abs(fj[b, :n] - ref)
        assert np.all(np.abs(ft[b, :n] - fj[b, :n]) <= jax_err + ATOL + RTOL * np.abs(ref))


def test_matches_golden():
    data = np.load(FIXTURE)
    got = extract_features(data["wave"], FrontendConfig(), CPU)
    assert got.shape == data["feats"].shape
    np.testing.assert_allclose(got, data["feats"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("snip_edges", [True, False])
def test_batched_equals_solo(snip_edges):
    cfg = FrontendConfig(snip_edges=snip_edges, dither=1.0)
    batch, lens = _ragged_batch()
    feats, nf = make_frontend(cfg, batch.shape[1], CPU)(torch.as_tensor(batch), torch.as_tensor(lens))
    for b in range(batch.shape[0]):
        n = int(nf[b])
        assert n == cfg.num_frames(int(lens[b]))
        if n:
            solo = extract_features(batch[b, : lens[b]], cfg, CPU)
            np.testing.assert_allclose(feats[b, :n].numpy(), solo, atol=1e-5)
        assert not feats[b, n:].any()


def test_dither_noise_matches_numpy():
    got = _dither_noise(20000, CPU).numpy()
    np.testing.assert_allclose(got, dither_noise_np(0, 20000), atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"use_energy": True, "cmvn": "none", "delta_order": 1}],
                         ids=["plp", "plp_energy"])
def test_plp_matches_oracle(kw):
    """PLP cepstra (equal loudness, cube root, iDCT-I GEMM, Levinson-Durbin,
    LPC -> cepstrum) against numpy_ref.plp_from_pspec's chain, per
    utterance of a padded batch."""
    cfg = FrontendConfig(feature_type="plp", **kw)
    batch, lens = _ragged_batch()
    feats, nf = make_frontend(cfg, batch.shape[1], CPU)(torch.as_tensor(batch), torch.as_tensor(lens))
    for b in range(3):
        n = int(nf[b])
        ref = extract_features_np(batch[b, : lens[b]], cfg)
        assert ref.shape == (n, cfg.feat_dim)
        np.testing.assert_allclose(feats[b, :n].numpy(), ref, atol=ATOL, rtol=RTOL)
    assert not feats[3].any()  # the 200-sample row has no frame

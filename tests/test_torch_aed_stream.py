"""The port's chunked streaming Conformer (mogasr_torch.am.aed: the causal
encoder, its chunk mask, ``stream_step``) against the JAX package on the
CPU at the reference tests' sizes (d_model 32, 2 encoder blocks, 2 heads,
kernel 7, chunk 4): the chunk-masked offline encoder against flax, the
chunk step against JAX's ``make_aed_stream_step`` and against the port's own
offline chunked encoder within 2e-5 (the reference's tolerance), chunk
causality, and ``aed_stream_init``'s layout and its refusal without
chunk_frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import aed as J
from mogasr_torch.am import aed as T
from mogasr_torch.am.params import from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHUNK, N_CHUNKS = 4, 3
SIZES = dict(d_model=32, enc_blocks=2, dec_blocks=1, heads=2, conv_kernel=7, chunk_frames=CHUNK)


def _pair(left_chunks, n_feats):
    """(flax model, params with every leaf random, the port's model)."""
    jm = J.AedModel(n_units=3, left_chunks=left_chunks, **SIZES)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((2, 16, n_feats)), jnp.asarray([16, 16]),
                            jnp.zeros((2, 3), jnp.int32))
    rng = np.random.default_rng(10 * left_chunks + n_feats)
    leaves, tdef = jax.tree.flatten(shapes)
    params = jax.tree.unflatten(tdef, [jnp.asarray(0.3 * rng.standard_normal(x.shape).astype(np.float32))
                                       for x in leaves])
    tm = T.AedModel(3, n_feats, left_chunks=left_chunks, **SIZES)
    tm.load_state_dict(from_flax(tm, params))
    return jm, params, tm.eval()


def _feats(n_feats, batch=2):
    T_raw = N_CHUNKS * 4 * CHUNK
    return np.random.default_rng(n_feats).standard_normal((batch, T_raw, n_feats)).astype(np.float32)


@pytest.mark.parametrize("left_chunks", [0, 1, 2])
@pytest.mark.parametrize("n_feats", [8, 9])
def test_stream_step_matches_jax_and_offline(left_chunks, n_feats):
    """Chunk by chunk, ``make_aed_stream_step`` equals JAX's step (the
    encoder and CTC outputs, and the caches after the last chunk) and the
    port's offline chunk-masked ``encode_with_ctc`` within 2e-5, which in
    turn matches flax's."""
    jm, params, tm = _pair(left_chunks, n_feats)
    feats = _feats(n_feats)
    nf = np.full((2,), feats.shape[1], np.int32)
    want_enc, _n, want_ctc = jm.apply(params, jnp.asarray(feats), jnp.asarray(nf), method=J.AedModel.encode_with_ctc)
    with torch.no_grad():
        off_enc, _n, off_ctc = tm.encode_with_ctc(torch.as_tensor(feats), torch.as_tensor(nf))
    np.testing.assert_allclose(off_enc.numpy(), np.asarray(want_enc), rtol=2e-5, atol=2e-5)
    jstep, jstate = J.make_aed_stream_step(jm, params), J.aed_stream_init(jm, 2, n_feats)
    tstep, tstate = T.make_aed_stream_step(tm), T.aed_stream_init(tm, 2, n_feats)
    raw = 4 * CHUNK
    encs, ctcs = [], []
    for c in range(N_CHUNKS):
        x = feats[:, c * raw:(c + 1) * raw]
        je, jc, jstate = jstep(jnp.asarray(x), jstate)
        te, tc, tstate = tstep(torch.as_tensor(x), tstate)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=2e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
        encs.append(te.numpy())
        ctcs.append(tc.numpy())
    np.testing.assert_allclose(np.concatenate(encs, axis=1), off_enc.numpy(), atol=2e-5)
    np.testing.assert_allclose(np.concatenate(ctcs, axis=1), off_ctc.numpy(), atol=2e-5)
    for key in ("raw", "c1", "valid"):
        np.testing.assert_allclose(tstate[key].numpy().astype(np.float32), np.asarray(jstate[key], np.float32),
                                   atol=2e-5, err_msg=key)
    for key in ("x1", "y"):
        for a, b in zip(tstate[key], jstate[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=key)


@pytest.mark.parametrize("left_chunks", [0, 1, 2])
def test_chunk_mask_and_causality(left_chunks):
    """The chunk mask equals the reference's; the chunked encoder's first two
    chunks do not move when the third chunk's input does; the offline
    encoder's do (the mask makes the difference)."""
    jm, params, tm = _pair(left_chunks, 8)
    n = 13
    c = np.arange(n) // CHUNK
    want = (c[None, :] <= c[:, None]) & (c[None, :] >= c[:, None] - left_chunks)
    np.testing.assert_array_equal(tm.encoder.chunk_mask(n, torch.device("cpu")).numpy(), want)
    feats = _feats(8)
    nf = torch.full((2,), feats.shape[1])
    pert = feats.copy()
    pert[:, 2 * 4 * CHUNK:] += 10.0
    with torch.no_grad():
        a, _ = tm.encode(torch.as_tensor(feats), nf)
        b, _ = tm.encode(torch.as_tensor(pert), nf)
    np.testing.assert_allclose(a[:, : 2 * CHUNK].numpy(), b[:, : 2 * CHUNK].numpy(), atol=1e-6)
    offline = T.AedModel(3, 8, **{**SIZES, "chunk_frames": 0})
    offline.load_state_dict(tm.state_dict())
    assert offline.encoder.chunk_mask(n, torch.device("cpu")) is None
    with torch.no_grad():
        a, _ = offline.encode(torch.as_tensor(feats), nf)
        b, _ = offline.encode(torch.as_tensor(pert), nf)
    assert float((a[:, : 2 * CHUNK] - b[:, : 2 * CHUNK]).abs().max()) > 1e-3


def test_stream_init_layout_and_refusal():
    """``aed_stream_init``'s keys, shapes and dtypes are the reference's, all
    zero (valid all False); a model without chunk_frames is refused."""
    jm, _params, tm = _pair(1, 9)
    want = J.aed_stream_init(jm, 3, 9)
    got = T.aed_stream_init(tm, 3, 9)
    assert set(got) == set(want)
    for key in ("raw", "c1", "valid"):
        assert tuple(got[key].shape) == want[key].shape and not got[key].any(), key
        assert got[key].dtype == (torch.bool if key == "valid" else torch.float32)
    for key in ("x1", "y"):
        assert [tuple(x.shape) for x in got[key]] == [x.shape for x in want[key]], key
    offline = T.AedModel(3, 9, **{**SIZES, "chunk_frames": 0})
    with pytest.raises(ValueError, match="chunk_frames"):
        T.aed_stream_init(offline, 1, 9)
    with pytest.raises(ValueError, match="chunk_frames"):
        J.aed_stream_init(J.AedModel(n_units=3, **{**SIZES, "chunk_frames": 0}), 1, 9)

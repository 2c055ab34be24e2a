"""mogasr_torch's online decoder (decoder/online.py) against the reference's
(mogasr/decoder/online.py) on the same numpy inputs: the plain chunk step
bitwise against JAX's ``_chunk_step`` (delta, started, backpointers, exit
argmax) on a small lexicon's word loop, with a beam, on skip graphs and with
streams at n_valid = 0; ``partial()``/``finalize()`` against JAX's
OnlineDecoder (path, entered and score bitwise) and ``finalize()`` against
the port's offline Viterbi (path and entered exact, the score bitwise: the
reference's own contract is exact paths and the score to 1e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.config import TopologyConfig
from mogasr.decoder import online as jax_online
from mogasr.hmm import graph as gr
from mogasr.hmm.lexicon import make_lexicon
from mogasr.hmm.topology import build_topology
from mogasr_torch.decoder import online
from mogasr_torch.decoder import viterbi as vit


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
B, T = 4, 24


@pytest.fixture(scope="module")
def topo():
    lex = make_lexicon({"ab": ["a", "b"], "ba": ["b", "a"], "aa": ["a", "a"], "bb": ["b", "b"]})
    return build_topology(lex, TopologyConfig(states_per_phone=2, sil_states=1))


def _loop_graphs(topo, skip=False):
    lex = topo.lexicon
    tokens = [(w, lex.words_to_phone_ids([w])) for w in lex.words]
    g = gr.batch_graphs([gr.loop_graph(topo, tokens=tokens, insertion_penalty=1.0)] * B)
    if skip:
        chain = g["chain_id"]
        same = np.zeros_like(chain, bool)
        same[:, 2:] = (chain[:, 2:] == chain[:, :-2]) & (chain[:, 2:] >= 0)
        g["skip_logp"] = np.where(same, np.float32(-0.1), gr.NEG_INF).astype(np.float32)
    return g


def _emit(topo, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, topo.n_pdfs)) * 2).astype(np.float32)


# the streams' lengths: one full, two ending inside the utterance, one empty
N_FRAMES = np.asarray([T, 17, 9, 0], np.int32)


def _chunks(sizes):
    off = 0
    for tc in sizes:
        yield off, tc, np.clip(N_FRAMES - off, 0, tc).astype(np.int32)
        off += tc


@pytest.mark.parametrize("skip,beam", [(False, 0.0), (False, 6.0), (True, 0.0)], ids=["loop", "beam", "skip"])
def test_chunk_step_bitwise(topo, skip, beam):
    """Three chunks, carried through both steps: every output bit for bit."""
    g = _loop_graphs(topo, skip)
    emit = _emit(topo)
    J = g["emit_id"].shape[1]
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = vit.graphs_to_torch(g, CPU)
    jd, js = jnp.full((B, J), jax_online.NEG_INF), jnp.zeros((B,), bool)
    td, ts = torch.full((B, J), online.NEG_INF), torch.zeros((B,), dtype=torch.bool)
    for off, tc, nv in _chunks([8, 8, 8]):
        jd, js, jbp, jx = jax_online._chunk_step(jd, js, jnp.asarray(emit[:, off:off + tc]), jnp.asarray(nv), jg,
                                                 acoustic_scale=0.7, beam=beam)
        td, ts, tbp, tx = online.chunk_step(td, ts, torch.as_tensor(emit[:, off:off + tc]), torch.as_tensor(nv),
                                            tg, 0.7, beam)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tbp.numpy(), np.asarray(jbp))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert not bool(ts[3]) and (td[3] == online.NEG_INF).all()  # the empty stream never started


def test_chunk_step_late_start_matches_reference(topo):
    """Streams that join in the second chunk (their first valid frame
    initializes from init_logp there) or stop after the first: bit for bit."""
    g = _loop_graphs(topo)
    emit = _emit(topo, seed=11)
    J = g["emit_id"].shape[1]
    jg, tg = {k: jnp.asarray(v) for k, v in g.items()}, vit.graphs_to_torch(g, CPU)
    jd, js = jnp.full((B, J), jax_online.NEG_INF), jnp.zeros((B,), bool)
    td, ts = torch.full((B, J), online.NEG_INF), torch.zeros((B,), dtype=torch.bool)
    # 8-frame chunks at scale 0.7: the shape and settings of the first test's
    # JAX compile
    for off, nv in ((0, np.asarray([8, 0, 8, 0], np.int32)), (8, np.asarray([8, 8, 0, 3], np.int32))):
        jd, js, jbp, jx = jax_online._chunk_step(jd, js, jnp.asarray(emit[:, off:off + 8]), jnp.asarray(nv), jg,
                                                 acoustic_scale=0.7, beam=0.0)
        td, ts, tbp, tx = online.chunk_step(td, ts, torch.as_tensor(emit[:, off:off + 8]), torch.as_tensor(nv),
                                            tg, 0.7, 0.0)
        for got, want in ((td, jd), (ts, js), (tbp, jbp), (tx, jx)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(ts.all())


def test_zero_valid_rows_keep_delta(topo):
    """A started stream with n_valid = 0 keeps its delta bit for bit."""
    g = vit.graphs_to_torch(_loop_graphs(topo), CPU)
    emit = torch.as_tensor(_emit(topo))
    d, s, _, _ = online.chunk_step(torch.full((B, g["emit_id"].shape[1]), online.NEG_INF),
                                   torch.zeros(B, dtype=torch.bool), emit[:, :5], torch.tensor([5, 5, 5, 0]), g, 1.0, 0.0)
    d2, s2, bps, _ = online.chunk_step(d, s, emit[:, 5:10], torch.tensor([0, 5, 0, 0]), g, 1.0, 0.0)
    for b in (0, 2, 3):
        assert torch.equal(d2[b], d[b]) and bool(s2[b]) == bool(s[b])
        assert (bps[:, b] == 0).all()
    assert not torch.equal(d2[1], d[1])


# the ragged chunking shares the even one's 8-frame JAX compile
@pytest.mark.parametrize("sizes", [[8, 8, 8], [8, 1, 15]], ids=["even", "ragged"])
def test_partial_and_finalize_match_reference(topo, sizes):
    g = _loop_graphs(topo)
    emit = _emit(topo, seed=7)
    ref = jax_online.OnlineDecoder({k: jnp.asarray(v) for k, v in g.items()}, acoustic_scale=0.7)
    dec = online.OnlineDecoder(vit.graphs_to_torch(g, CPU), acoustic_scale=0.7)
    for off, tc, nv in _chunks(sizes):
        ref.process(jnp.asarray(emit[:, off:off + tc]), nv)
        dec.process(torch.as_tensor(emit[:, off:off + tc]), nv)
        for want, got in zip(ref.partial(), dec.partial()):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for want, got in zip(ref.finalize(), dec.finalize()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_finalize_matches_offline_viterbi(topo):
    g = _loop_graphs(topo, skip=True)
    emit = torch.as_tensor(_emit(topo, seed=9))
    tg = vit.graphs_to_torch(g, CPU)
    off = vit.viterbi(emit, tg, torch.as_tensor(N_FRAMES), acoustic_scale=0.7)
    dec = online.OnlineDecoder(tg, acoustic_scale=0.7)
    for o, tc, nv in _chunks([5, 7, 12]):
        dec.process(emit[:, o:o + tc], nv)
    path, entered, score = dec.finalize()
    assert path.shape == (B, T) and dec.buffer_bytes > 0
    torch.testing.assert_close(path, off.path, rtol=0, atol=0)
    torch.testing.assert_close(entered, off.entered, rtol=0, atol=0)
    torch.testing.assert_close(score, off.score, rtol=0, atol=0)


def test_unsupported_device_raises(topo):
    g = vit.graphs_to_torch(_loop_graphs(topo), torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        online.OnlineDecoder(g)

"""The port's RNN-T (mogasr_torch.am.rnnt, am.rnnt_pruned, the serving
engine's RNN-T family) against the JAX package on the CPU, on the same
seeded inputs and the reference's parameters carried across by
``from_flax``: the transducer loss and its gradient on edge rows (no frames,
one frame, no labels, the longest), the pruned loss, grids and bounds
(``u_start`` identical), every decoder (host greedy, the device label loop
and frame scan, the per-utterance, batched and device beams with fusion and
biasing tables), streaming against the offline greedy, MWER's risk, and
``BatchedRnntEngine`` against the reference's engine."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import rnnt as JR
from mogasr.am import rnnt_pruned as JRP
from mogasr.config import TrainConfig as JTrainConfig
from mogasr_torch.am import rnnt as R
from mogasr_torch.am import rnnt_pruned as RP
from mogasr_torch.am.params import from_flax
from mogasr_torch.config import TrainConfig

CPU = torch.device("cpu")
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4   # the reference's loss contract; gradients against jax.grad
BEAM_ATOL = 1e-4                    # tests/test_rnnt_device_beam.py's score contract
V, D = 5, 39                        # labels (blank = V), feature width (the front end's, for the engine)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    _jax_model.cache_clear()
    jax.clear_caches()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _edge_problem(seed=0, B=5, T=9, U=4):
    """Random joint logits with edge rows: row 0 no frames, row 1 no labels,
    row 2 one frame, row 3 every frame and label."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    nf = rng.integers(2, T + 1, B).astype(np.int32)
    nl = rng.integers(1, U + 1, B).astype(np.int32)
    nf[0], nl[1], nf[2], nf[3], nl[3] = 0, 0, 1, T, U
    labels = np.full((B, U), -1, np.int32)
    for b in range(B):
        labels[b, : nl[b]] = rng.integers(0, V, nl[b])
    return logits, nf, labels, nl


def _jax_loss_grad(fn, logits, *args):
    a = [jnp.asarray(x) for x in args]
    loss = np.asarray(fn(jnp.asarray(logits), *a))
    grad = np.asarray(jax.grad(lambda x: fn(x, *a).sum())(jnp.asarray(logits)))
    return loss, grad


def _torch_loss_grad(fn, logits, *args):
    x = torch.tensor(logits, requires_grad=True)
    loss = fn(x, *(_t(a) for a in args))
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def test_rnnt_loss_and_gradient_match_jax_on_edge_rows():
    """The anti-diagonal DP: the reference's loss (its 1e-5) and jax.grad on
    every row, the row of no frames (scored on frame 0) included; the copied
    NumPy oracle agrees on each row with frames."""
    logits, nf, labels, nl = _edge_problem()
    want, want_g = _jax_loss_grad(JR.rnnt_loss, logits, nf, labels, nl)
    got, got_g = _torch_loss_grad(R.rnnt_loss, logits, nf, labels, nl)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_g, want_g, atol=GRAD_ATOL)
    for b in range(1, logits.shape[0]):
        lp = torch.log_softmax(torch.tensor(logits[b, : nf[b]]), -1).double().numpy()
        oracle = R.rnnt_loss_np(lp, list(labels[b, : nl[b]]))
        assert oracle == JR.rnnt_loss_np(lp, list(labels[b, : nl[b]]))
        np.testing.assert_allclose(got[b], oracle, rtol=LOSS_RTOL)


@pytest.mark.parametrize("band", [2, 3])
def test_pruned_grids_bounds_and_banded_loss_match_jax(band):
    """The factored grids, the bounds from their DP's gradient (u_start
    identical), and the banded loss and its gradient on the bounds (the
    feasible rows; the row of no frames too)."""
    logits, nf, labels, nl = _edge_problem(seed=1)
    B, T, U1, _ = logits.shape
    rng = np.random.default_rng(2)
    am = rng.standard_normal((B, T, V + 1)).astype(np.float32)
    lm = rng.standard_normal((B, U1, V + 1)).astype(np.float32)
    jbl, jem = JRP.rnnt_grids_simple(jnp.asarray(am), jnp.asarray(lm), jnp.asarray(labels))
    bl, em = RP.rnnt_grids_simple(_t(am), _t(lm), _t(labels))
    np.testing.assert_allclose(bl.numpy(), np.asarray(jbl), atol=1e-5)
    np.testing.assert_allclose(em.numpy(), np.asarray(jem), atol=1e-5)
    ju = np.asarray(JRP.rnnt_prune_bounds(jbl, jem, jnp.asarray(nf), jnp.asarray(nl), band))
    u = RP.rnnt_prune_bounds(bl, em, _t(nf), _t(nl), band).numpy()
    assert (u == ju).all() and u.max() > 0
    lb = rng.standard_normal((B, T, band, V + 1)).astype(np.float32)
    want, want_g = _jax_loss_grad(JRP.rnnt_loss_banded, lb, ju, nf, labels, nl)
    got, got_g = _torch_loss_grad(RP.rnnt_loss_banded, lb, u, nf, labels, nl)
    feasible = np.maximum(nl + 1 - band, 0) <= np.maximum(nf - 1, 0) * (band - 1)
    np.testing.assert_allclose(got[feasible], want[feasible], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_g[feasible], want_g[feasible], atol=GRAD_ATOL)
    # a band covering the lattice is the full loss
    full = R.rnnt_loss(_t(logits), _t(nf), _t(labels), _t(nl))
    cover = RP.rnnt_loss_banded(_t(logits), torch.zeros((B, T), dtype=torch.int64), _t(nf), _t(labels), _t(nl))
    torch.testing.assert_close(cover, full, rtol=1e-6, atol=1e-6)


def jax_rnnt_init(jm, feat_dim, seed):
    """The reference's ``init_rnnt_train_state`` parameters (its dummy
    shapes, one jitted init)."""
    init = jax.jit(lambda k, f, n, lab: jm.init(k, f, n, lab, method=JR.RnntModel.init_targets))
    return init(jax.random.key(seed), jnp.zeros((2, 8, feat_dim)), jnp.asarray([8, 8]), jnp.zeros((2, 4), jnp.int32))


@functools.lru_cache(maxsize=None)
def _jax_model(pred_arch, seed=3):
    """The reference's model (encoder 2 x 32, aux CTC) and parameters, and
    the port's twin, one of each prediction net for the whole module."""
    jm = JR.build_rnnt_model(V, JTrainConfig(nn_hidden=32, nn_layers=3), pred_arch=pred_arch)
    jp = jax_rnnt_init(jm, D, seed)
    tm = R.build_rnnt_model(V, TrainConfig(nn_hidden=32, nn_layers=3), D, pred_arch=pred_arch)
    tm.load_state_dict(from_flax(tm, jp))
    return jm, jp, tm.eval()


@pytest.fixture(scope="module", params=["stateless", "lstm"])
def models(request):
    jm, jp, tm = _jax_model(request.param)
    rng = np.random.default_rng(4)
    feats = (2.0 * rng.standard_normal((4, 12, D))).astype(np.float32)
    nf = np.asarray([12, 7, 1, 0], np.int32)
    return jm, jp, tm, feats, nf


def _same_ranked(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h for _s, h in g] == [h for _s, h in w]
        np.testing.assert_allclose([s for s, _h in g], [s for s, _h in w], atol=BEAM_ATOL)


def test_greedy_decoders_and_stream_match_jax(models):
    """The host greedy, the device label loop and frame scan, and the
    stream in ragged chunks (frame scan and label loop) give the
    reference's host-greedy tokens on every row."""
    jm, jp, tm, feats, nf = models
    want = JR.rnnt_greedy_decode(jm, jp, jnp.asarray(feats), jnp.asarray(nf))
    assert sum(map(len, want)) > 10
    assert R.rnnt_greedy_decode(tm, _t(feats), _t(nf)) == want
    for impl in ("label_loop", "frame_scan"):
        assert R.rnnt_greedy_decode_device(tm, _t(feats), _t(nf), impl=impl) == want
        stream = R.RnntDeviceStream(tm, 4, u_cap=24, impl=impl)
        for c0, width in ((0, 5), (5, 2), (7, 5)):
            stream.consume(_t(feats[:, c0:c0 + width]), np.clip(nf - c0, 0, width))
        assert stream.partial() == want


def test_beams_match_jax(models):
    """The per-utterance host beam, the batched host beam and the device
    beam: the reference's ranked label sequences, scores to its 1e-4."""
    jm, jp, tm, feats, nf = models
    kw = dict(beam_size=3, max_symbols_per_frame=2, u_cap=20)
    want = JR.rnnt_beam_decode_batch(jm, jp, jnp.asarray(feats), jnp.asarray(nf), **kw)
    _same_ranked(R.rnnt_beam_decode_batch(tm, _t(feats), _t(nf), **kw), want)
    _same_ranked(R.rnnt_beam_decode_device(tm, _t(feats), _t(nf), **kw), want)
    assert R.rnnt_beam_decode_device(tm, _t(feats), _t(nf), **kw)[3] == [(0.0, [])]
    want1 = JR.rnnt_beam_decode(jm, jp, jnp.asarray(feats[:1]), jnp.asarray(nf[:1]), **kw)
    _same_ranked([R.rnnt_beam_decode(tm, _t(feats[:1]), _t(nf[:1]), **kw)], [want1])


@pytest.mark.parametrize("table", ["fusion", "bias"])
def test_device_beam_fusion_and_bias_tables_match_the_hooks(models, table):
    """The fusion table equal to the reference's ``rnnt_fusion_matrix``; the
    device beam with the fusion or biasing tables gives the reference's
    device beam's ranked lists on the same tables, and the per-utterance
    beam with the same scores as ext_score hooks (one fusion or biasing term
    a label extension) the reference's hook beam's, scores to its 1e-4."""
    from mogasr.decoder.biasing import CompiledBiaser as JCompiledBiaser
    from mogasr.decoder.biasing import ContextBiaser as JContextBiaser
    from mogasr.lm.unit_ngram import estimate_unit_bigram as j_estimate_unit_bigram
    from mogasr.lm.unit_ngram import fusion_score as j_fusion_score
    from mogasr_torch.decoder.biasing import CompiledBiaser, ContextBiaser
    from mogasr_torch.lm.unit_ngram import estimate_unit_bigram, fusion_score

    jm, jp, tm, feats, nf = models
    rng = np.random.default_rng(6)
    seqs = [[int(u) for u in rng.integers(0, V, size=rng.integers(2, 6))] for _ in range(30)]
    kw = dict(beam_size=3, max_symbols_per_frame=2, u_cap=20)
    if table == "fusion":
        lm, jlm = estimate_unit_bigram(seqs, V), j_estimate_unit_bigram(seqs, V)
        fm, jfm = R.rnnt_fusion_matrix(tm, lm, 0.7), JR.rnnt_fusion_matrix(jm, jlm, 0.7)
        np.testing.assert_array_equal(np.asarray(fm), np.asarray(jfm))
        tables, jtables = dict(fusion=fm), dict(fusion=jfm)
        ext, jext = fusion_score(lm, 0.7), j_fusion_score(jlm, 0.7)
    else:
        phrases = [[0, 1], [1, 2, 3], [0]]
        biaser = ContextBiaser(phrases, weight=1.5, completion_scale=0.5)
        jbiaser = JContextBiaser(phrases, weight=1.5, completion_scale=0.5)
        comp, jcomp = CompiledBiaser(biaser, n_units=V), JCompiledBiaser(jbiaser, n_units=V)
        tables = dict(bias_next=comp.next_state, bias_delta=comp.delta)
        jtables = dict(bias_next=jcomp.next_state, bias_delta=jcomp.delta)
        ext, jext = biaser.score, jbiaser.score
    want = JR.rnnt_beam_decode_device(jm, jp, jnp.asarray(feats[:2]), jnp.asarray(nf[:2]), **kw, **jtables)
    assert any(h for row in want for _s, h in row)
    _same_ranked(R.rnnt_beam_decode_device(tm, _t(feats[:2]), _t(nf[:2]), **kw, **tables), want)
    want1 = JR.rnnt_beam_decode(jm, jp, jnp.asarray(feats[:1]), jnp.asarray(nf[:1]), **kw, ext_score=jext,
                                ext_weight=1.0)
    got1 = R.rnnt_beam_decode(tm, _t(feats[:1]), _t(nf[:1]), **kw, ext_score=ext, ext_weight=1.0)
    _same_ranked([got1], [want1])


def test_mwer_risk_matches_jax():
    """The MWER objective over a 3-best with a masked slot and an anchor:
    the expected risk and the loss to 1e-4; its gradient is autograd's
    through the tested loss."""
    jm, jp, tm = _jax_model("stateless")
    rng = np.random.default_rng(8)
    B, N, U, T = 2, 3, 4, 8
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    nf = np.asarray([8, 6], np.int32)
    hyps = np.full((B, N, U), -1, np.int32)
    n_hyp = np.asarray([[2, 3, 1], [4, 0, 2]], np.int32)
    for b in range(B):
        for n in range(N):
            hyps[b, n, : n_hyp[b, n]] = rng.integers(0, V, n_hyp[b, n])
    mask = np.asarray([[True, True, True], [True, False, True]])
    risks = np.asarray([[0.0, 2.0, 1.0], [3.0, 0.0, 1.0]], np.float32)
    labels = np.asarray([[1, 2, -1, -1], [0, 1, 2, 3]], np.int32)
    nl = np.asarray([2, 4], np.int32)
    args = (feats, nf, hyps, n_hyp, mask, risks, labels, nl)

    jl, jmet = jax.jit(lambda p, *a: JR.rnnt_mwer_objective(jm, p, *a))(jp, *(jnp.asarray(a) for a in args))
    loss, met = R.rnnt_mwer_objective(tm, *(_t(a) for a in args))
    np.testing.assert_allclose(met["expected_risk"].item(), float(jmet["expected_risk"]), atol=1e-4)
    np.testing.assert_allclose(met["mwer"].item(), float(jmet["mwer"]), atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-4)


def test_batched_engine_matches_reference_engine():
    """3 sessions through capacity 2 (slot reuse resets the encoder carries
    and the decode state), ragged bites: the reference's BatchedRnntEngine's
    finals, and the offline greedy's."""
    from mogasr.config import FrontendConfig as JFrontendConfig
    from mogasr.serving.engine import BatchedRnntEngine as JEngine
    from mogasr_torch.config import FrontendConfig
    from mogasr_torch.data.synthetic import make_corpus
    from mogasr_torch.frontend.streaming import StreamingFrontend
    from mogasr_torch.serving.engine import BatchedRnntEngine
    from test_torch_serving import drive

    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    jm, jp, tm = _jax_model("stateless")
    assert fcfg.feat_dim == D
    utts = make_corpus(3, words_per_utt=(1, 2), seed=5)
    sessions = [(u.utt_id, u.wave) for u in utts]

    def units(finals):
        return {sid: u for sid, (u, _a) in finals.items()}

    jeng = JEngine(jm, jp, JFrontendConfig(cmvn="sliding", cmvn_window=300), capacity=2, tick_frames=16)
    want = units(drive(jeng, sessions, seed=11, bite=(800, 4500))[0])
    assert sum(map(len, want.values())) > 10
    eng = BatchedRnntEngine(tm, fcfg, capacity=2, tick_frames=16, device=CPU)
    assert units(drive(eng, sessions, seed=11, bite=(800, 4500))[0]) == want
    for u in utts[:1]:
        fe = StreamingFrontend(fcfg, device=CPU)
        f = np.concatenate([fe.process(u.wave), fe.finalize()])
        offline = R.rnnt_greedy_decode_device(tm, _t(f[None]), _t([f.shape[0]]), max_symbols=4 * f.shape[0])
        assert offline[0] == want[u.utt_id]

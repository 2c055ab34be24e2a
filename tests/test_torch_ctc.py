"""The port's CTC family (mogasr_torch.am.ctc, the pipeline's CTC functions)
against the JAX package on the CPU: the loss and its gradient on rows
without labels, without frames and with labels that cannot fit, through
the plain recursion and through the route kernel K3 takes on the card
(``ctc_nll_fb``: the label graphs and ``am.nn_seq.FbLoglik``); greedy
decoding, the host, native and device prefix beams with unit-LM fusion and
biasing, the streaming decoder, the CTC word graph and its decode,
training steps and the warm start, and 4 utterances decoded at full width
(LstmAm 512 x 2 over the headline lexicon's phones + blank)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.am import ctc as jctc
from mogasr.am import neural as jn
from mogasr.config import BatchConfig, DecodeConfig, FrontendConfig
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr.data import synthetic as jsyn
from mogasr.decoder import biasing as jbias
from mogasr.hmm.lexicon import make_lexicon as j_make_lexicon
from mogasr.hmm.lexicon import synthetic_lexicon as j_synthetic_lexicon
from mogasr.lm import unit_ngram as jun
from mogasr_torch import pipeline as pipe
from mogasr_torch.am import ctc
from mogasr_torch.am import neural as tn
from mogasr_torch.am.nn_seq import fb_loglik
from mogasr_torch.am.params import from_flax, init_
from mogasr_torch.config import TrainConfig
from mogasr_torch.data import synthetic as syn
from mogasr_torch.decoder import biasing
from mogasr_torch.hmm.lexicon import make_lexicon, synthetic_lexicon
from mogasr_torch.lm import unit_ngram


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
# the loss: float32 sums in other orders (relative); the gradient with
# respect to the logits (absolute)
LOSS_RTOL, GRAD_ATOL = 1e-4, 1e-5
# rows: two labels; no frames; 4 labels (one repeat) in 3 frames (cannot
# fit); no labels; 3 labels in 2 frames (cannot fit); a repeat that fits
LABELS = [[0, 1, -1, -1], [2, -1, -1, -1], [1, 1, 2, 3], [-1, -1, -1, -1], [0, 1, 2, -1], [3, 3, -1, -1]]
N_LABELS = [2, 1, 4, 0, 3, 2]
N_FRAMES = [7, 0, 3, 7, 2, 5]
FIT, SHORT = [0, 1, 3, 5], [2, 4]
B, T, V = 6, 7, 5


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _edge_batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, V)).astype(np.float32), np.asarray(N_FRAMES, np.int32),
            np.asarray(LABELS, np.int32), np.asarray(N_LABELS, np.int32))


def _jax_loss_grad(logits, nf, labels, nl):
    args = [jnp.asarray(a) for a in (nf, labels, nl)]
    loss = np.asarray(jctc.ctc_loss(jnp.asarray(logits), *args))
    grad = np.asarray(jax.grad(lambda x: jctc.ctc_loss(x, *args).sum())(jnp.asarray(logits)))
    return loss, grad


def _torch_loss_grad(fn, logits):
    x = torch.tensor(logits, requires_grad=True)
    loss = fn(x)
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def test_ctc_loss_and_gradient_match_jax():
    """The plain route (the CPU's): loss and jax.grad on every row, those
    that cannot fit (loss ~1e30) included."""
    logits, nf, labels, nl = _edge_batch()
    want_loss, want_grad = _jax_loss_grad(logits, nf, labels, nl)
    got_loss, got_grad = _torch_loss_grad(
        lambda x: ctc.ctc_loss(x, torch.as_tensor(nf), torch.as_tensor(labels), torch.as_tensor(nl)), logits)
    assert want_loss[2] > 1e29 and want_loss[4] > 1e29 and np.isfinite(want_grad).all()
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_grad, want_grad, atol=GRAD_ATOL)


def test_ctc_loss_on_the_k3_route_matches_jax():
    """``ctc_nll_fb``, the route of a CUDA tensor (FbLoglik over the label
    graphs; on the CPU fb_cuda runs the plain forward-backward passes): the
    same loss on every row and the same gradient on the rows that fit. The
    rows that cannot fit get a gradient of exactly 0 (the reference's there
    is its autodiff of NEG_INF sums), never the plain recursion."""
    logits, nf, labels, nl = _edge_batch(1)
    want_loss, want_grad = _jax_loss_grad(logits, nf, labels, nl)
    got_loss, got_grad = _torch_loss_grad(
        lambda x: ctc.ctc_nll_fb(torch.log_softmax(x, -1), torch.as_tensor(nf), torch.as_tensor(labels),
                                 torch.as_tensor(nl), V - 1), logits)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert want_loss[SHORT].min() > 1e29
    np.testing.assert_allclose(got_grad[FIT], want_grad[FIT], atol=GRAD_ATOL)
    assert (got_grad[SHORT] == 0).all()
    assert ctc.frames_needed(torch.as_tensor(labels), torch.as_tensor(nl)).tolist() == [2, 1, 5, 0, 3, 3]


def test_label_graph_forward_backward_equals_the_recursion():
    """FbLoglik's plain version (autograd through the forward-backward
    passes) over ``ctc_label_graphs`` equals the plain recursion, loss and
    gradient, on the rows that fit."""
    logits, nf, labels, nl = _edge_batch(2)
    keep = [0, 1, 3, 5]
    logits, nf, labels, nl = logits[keep], nf[keep], labels[keep], nl[keep]
    graphs = ctc.ctc_label_graphs(torch.as_tensor(labels), torch.as_tensor(nl), V - 1)
    got = _torch_loss_grad(lambda x: -fb_loglik(torch.log_softmax(x, -1), graphs,
                                                torch.clamp(torch.as_tensor(nf), min=1), 1.0, use_kernels=False),
                           logits)
    want = _torch_loss_grad(lambda x: ctc.ctc_loss_plain(torch.log_softmax(x, -1), torch.as_tensor(nf),
                                                         torch.as_tensor(labels), torch.as_tensor(nl), V - 1),
                            logits)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1], want[1], atol=GRAD_ATOL)


def test_label_graphs_layout():
    """Row [3, 3] (n_labels 2) of width 2L + 1 = 9: z = b 3 b 3 b and four
    padding states; the skip into the second 3 is closed (a repeat); two
    initial and two final states; no loop arcs; padding as batch_graphs
    pads."""
    g = ctc.ctc_label_graphs(torch.as_tensor([[3, 3, -1, -1], [1, 2, -1, -1]]), torch.as_tensor([2, 2]), 4)
    neg = float(np.float32(ctc.NEG_INF))
    assert g["emit_id"].dtype == torch.int32 and all(v.dtype == torch.float32 for k, v in g.items() if k != "emit_id")
    assert g["emit_id"][0].tolist() == [4, 3, 4, 3, 4, 0, 0, 0, 0]
    assert g["skip_logp"][0].tolist() == [neg] * 9
    assert g["skip_logp"][1].tolist() == [neg, neg, neg, 0.0] + [neg] * 5
    assert g["init_logp"][0].tolist() == [0.0, 0.0] + [neg] * 7
    assert g["final_logp"][0].tolist() == [neg, neg, neg, 0.0, 0.0] + [neg] * 4
    assert g["self_logp"][0].tolist() == [0.0] * 5 + [neg] * 4
    assert g["adv_logp"][0].tolist() == [neg] + [0.0] * 4 + [neg] * 4
    assert (g["enter_logp"] == neg).all() and (g["exit_logp"] == neg).all()


def test_masked_mean_objective_matches_jax():
    """What the objective makes of the edge rows: the value on both routes,
    the gradient on the rows that fit (all of them on the plain route),
    finite, so that no NaN reaches the optimizer; the K3 route's gradient on
    the rows that cannot fit is 0."""
    logits, nf, labels, nl = _edge_batch(3)
    jargs = [jnp.asarray(a) for a in (nf, labels, nl)]

    def jobj(x):
        return jctc.masked_mean_objective(jctc.ctc_loss(x, *jargs), jargs[0], jargs[2])[0]

    want, want_grad = float(jobj(jnp.asarray(logits))), np.asarray(jax.grad(jobj)(jnp.asarray(logits)))
    targs = [torch.as_tensor(a) for a in (nf, labels, nl)]
    for rows, route in ((slice(None), lambda x: ctc.ctc_loss(x, *targs)),
                        (FIT, lambda x: ctc.ctc_nll_fb(torch.log_softmax(x, -1), *targs, V - 1))):
        x = torch.tensor(logits, requires_grad=True)
        obj, mean_nll = ctc.masked_mean_objective(route(x), targs[0], targs[2])
        obj.backward()
        np.testing.assert_allclose(obj.item(), want, rtol=LOSS_RTOL)
        np.testing.assert_allclose(x.grad.numpy()[rows], want_grad[rows], atol=GRAD_ATOL)
        assert torch.isfinite(x.grad).all() and float(mean_nll) > 1e29
    assert (x.grad[SHORT] == 0).all()


def test_k3_route_takes_no_host_sync_and_no_plain_recursion(monkeypatch):
    """The K3 route decides the rows that cannot fit on the device: it
    never calls the plain recursion and reads nothing back to the host
    (``.item()``, ``int()``, ``bool()`` of a tensor, ``nonzero``), so a
    training step pays no sync for them."""
    logits, nf, labels, nl = _edge_batch(4)

    def refuse(*_a, **_k):
        raise AssertionError("the K3 route ran the plain recursion or synced with the host")

    monkeypatch.setattr(ctc, "ctc_loss_plain", refuse)
    for name in ("item", "tolist", "nonzero", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    x = torch.tensor(logits, requires_grad=True)
    nll = ctc.ctc_nll_fb(torch.log_softmax(x, -1), *(torch.as_tensor(a) for a in (nf, labels, nl)), V - 1)
    nll.sum().backward()
    monkeypatch.undo()
    assert torch.isfinite(x.grad).all() and (x.grad[SHORT] == 0).all()


# ----------------------------------------------------------------- decoding


def _posteriors(seed, b=3, t=24, v=7):
    """Peaked random log posteriors [b, t, v] (a blank-heavy model)."""
    rng = np.random.default_rng(seed)
    logits = 2.5 * rng.standard_normal((b, t, v)).astype(np.float32)
    logits[..., v - 1] += 1.5
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1)), np.asarray([t, t - 5, 9], np.int32)


def test_greedy_decoding_matches_jax():
    logp, nf = _posteriors(0)
    frames = np.argmax(logp, -1).astype(np.int32)
    assert ctc.ctc_greedy_decode(torch.as_tensor(logp), torch.as_tensor(nf)) == \
        jctc.ctc_greedy_decode(jnp.asarray(logp), jnp.asarray(nf))
    assert ctc.ctc_greedy_decode_with_frames(torch.as_tensor(logp), nf) == \
        jctc.ctc_greedy_decode_with_frames(jnp.asarray(logp), jnp.asarray(nf))
    assert ctc.ctc_collapse_frames(torch.as_tensor(frames), nf, 6) == jctc.ctc_collapse_frames(frames, nf, 6)
    assert [ctc.collapse_ctc(frames[b, : nf[b]], 6) for b in range(3)] == \
        [jctc.collapse_ctc(frames[b, : nf[b]], 6) for b in range(3)]


def _tables(seed, n_units):
    """A unit bigram of random sequences and a biaser of two phrases, both
    packages'."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, n_units, int(rng.integers(2, 7))).tolist() for _ in range(30)]
    phrases = [[1, 2], [3, 0, 4]]
    return (unit_ngram.estimate_unit_bigram(seqs, n_units), jun.estimate_unit_bigram(seqs, n_units),
            biasing.ContextBiaser(phrases, weight=1.5), jbias.ContextBiaser(phrases, weight=1.5))


def _same_ranked(got, want):
    assert [h for _s, h in got] == [h for _s, h in want]
    np.testing.assert_allclose([s for s, _h in got], [s for s, _h in want], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_host_and_native_prefix_beams_match_jax(fused):
    """The host beam (with fusion and biasing through ext_score when fused)
    and the native C++ beam give the reference's ranked hypotheses."""
    logp, nf = _posteriors(1)
    lm, jlm, bias, jb = _tables(1, 6)
    ext = unit_ngram.compose_ext_scores([bias.score, unit_ngram.fusion_score(lm, 0.5)]) if fused else None
    jext = jun.compose_ext_scores([jb.score, jun.fusion_score(jlm, 0.5)]) if fused else None
    for b in range(3):
        lp = logp[b, : nf[b]]
        got = ctc.ctc_prefix_beam_decode(torch.as_tensor(lp), beam_size=4, ext_score=ext)
        assert len(got) == 4
        _same_ranked(got, jctc.ctc_prefix_beam_decode(lp, beam_size=4, ext_score=jext))
        if not fused:
            native = ctc.ctc_prefix_beam_decode_native(lp, beam_size=4)
            assert native is not None
            _same_ranked(native, jctc.ctc_prefix_beam_decode_native(lp, beam_size=4))
            _same_ranked(native, got)
    if not fused:
        assert ctc.ctc_beam_decode_batch(logp, nf, beam_size=4) == jctc.ctc_beam_decode_batch(logp, nf, beam_size=4)


@pytest.mark.parametrize("fusion,bias", [(False, False), (True, True)])
def test_device_prefix_beam_matches_jax(fusion, bias):
    """The batched device beam (plain PyTorch ops a frame) against JAX's
    jitted scan, with the fusion and biasing tables: the same ranked
    hypotheses, scores within 1e-4; without tables it equals the host
    beam's ranking."""
    logp, nf = _posteriors(2)
    lm, jlm, bz, jbz = _tables(2, 6)
    kw, jkw = {}, {}
    if fusion:
        kw["fusion"] = ctc.ctc_fusion_matrix(6, lm, 0.5)
        jkw["fusion"] = jctc.ctc_fusion_matrix(6, jlm, 0.5)
        np.testing.assert_array_equal(kw["fusion"], jkw["fusion"])
    if bias:
        comp, jcomp = biasing.CompiledBiaser(bz, 6), jbias.CompiledBiaser(jbz, 6)
        kw.update(bias_next=comp.next_state, bias_delta=comp.delta)
        jkw.update(bias_next=jcomp.next_state, bias_delta=jcomp.delta)
    got = ctc.ctc_prefix_beam_decode_device(torch.as_tensor(logp), torch.as_tensor(nf), beam_size=4, u_cap=24, **kw)
    want = jctc.ctc_prefix_beam_decode_device(jnp.asarray(logp), jnp.asarray(nf), beam_size=4, u_cap=24, **jkw)
    for g, w in zip(got, want):
        _same_ranked(g, w)
    if not (fusion or bias):
        for b in range(3):
            _same_ranked(got[b], ctc.ctc_prefix_beam_decode(logp[b, : nf[b]], beam_size=4))


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_stream_decoder_matches_jax(mode):
    """CtcStreamDecoder over uneven chunks (the beam with fusion and
    biasing) against the reference's, partial after every chunk."""
    logp, nf = _posteriors(3)
    lm, jlm, bz, jbz = _tables(3, 6)
    ext = unit_ngram.compose_ext_scores([bz.score, unit_ngram.fusion_score(lm, 0.5)]) if mode == "beam" else None
    jext = jun.compose_ext_scores([jbz.score, jun.fusion_score(jlm, 0.5)]) if mode == "beam" else None
    dec = ctc.CtcStreamDecoder(6, mode=mode, beam_size=4, ext_score=ext)
    jdec = jctc.CtcStreamDecoder(6, mode=mode, beam_size=4, ext_score=jext)
    lp = logp[0, : nf[0]]
    for lo, hi in ((0, 5), (5, 6), (6, 17), (17, int(nf[0]))):
        assert dec.step(torch.as_tensor(lp[lo:hi])) == jdec.step(lp[lo:hi])
    assert dec.finalize() == jdec.finalize()


def test_ctc_decode_graph_matches_jax():
    lex, jlex = synthetic_lexicon(), j_synthetic_lexicon()
    dcfg = DecodeConfig(word_insertion_penalty=1.5)
    g, jg = ctc.ctc_decode_graph(lex, dcfg), jctc.ctc_decode_graph(jlex, dcfg)
    for k in ("emit_id", "self_logp", "adv_logp", "enter_logp", "exit_logp", "init_logp", "final_logp", "chain_id",
              "skip_logp"):
        a, b = getattr(g, k), getattr(jg, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert g.labels == jg.labels
    assert ctc.ctc_token_chain([2, 2, 5], 9) == jctc.ctc_token_chain([2, 2, 5], 9)


def test_graph_decode_matches_jax():
    """decode_batch over the CTC word loop (skip transitions) on random
    log posteriors over the synthetic lexicon's phones + blank: the same
    token lists as the reference's decode_batch."""
    lex, jlex = synthetic_lexicon(), j_synthetic_lexicon()
    dcfg = DecodeConfig(word_insertion_penalty=0.5)
    rng = np.random.default_rng(4)
    Vp = lex.n_phones + 1
    logits = 3.0 * rng.standard_normal((3, 60, Vp)).astype(np.float32)
    logits[..., -1] += 2.0
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    nf = np.asarray([60, 41, 17], np.int32)
    fb = pipe.FeatBatch(["a", "b", "c"], torch.zeros((3, 60, 1)), torch.as_tensor(nf), [[], [], []])
    got = pipe.decode_batch(fb, torch.as_tensor(logp), ctc.ctc_decode_graph(lex, dcfg), dcfg)
    want = jax_pipe.decode_batch(SimpleNamespace(feats=None, n_frames=jnp.asarray(nf), size=3), jnp.asarray(logp),
                                 jctc.ctc_decode_graph(jlex, dcfg), dcfg)
    assert got == want and sum(len(h) for h in got) > 0


# ----------------------------------------------------------------- training

D = 6
TINY = dict(nn_hidden=10, nn_layers=2)


def _ctc_batches(seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        feats = rng.standard_normal((3, 13, D)).astype(np.float32)
        nf = np.asarray([13, 9, 0], np.int32)
        labels = np.asarray([[0, 3, 3, 1], [2, 4, -1, -1], [-1, -1, -1, -1]], np.int32)
        out.append((feats, nf, labels, np.asarray([4, 2, 0], np.int32)))
    return out


@pytest.mark.parametrize("arch", ["lstm", "mlp"])
def test_ctc_train_steps_match_jax(arch):
    """Three of the reference's jitted CTC steps against
    ``make_ctc_train_step`` from the same flax parameters: each step's loss
    and utt_nll (rtol 1e-5) and the parameters after the third (the
    tolerance of test_torch_nn_train: Adam normalizes near-zero gradients)."""
    cfg_kw = dict(TINY, nn_context=1) if arch == "mlp" else TINY
    jcfg = JaxTrainConfig(lr=1e-2, num_nn_steps=60, **cfg_kw)
    cfg = TrainConfig(lr=1e-2, num_nn_steps=60, **cfg_kw)
    jm = jn.build_model(arch, 6, jcfg)
    jstate = jctc.init_ctc_train_state(jm, jcfg, D, jax.random.key(3))
    tm = tn.build_model(arch, 6, cfg, D)
    tm.load_state_dict(from_flax(tm, jstate.params))
    jstep = jctc.make_ctc_train_step(jm, jcfg)
    state, step = ctc.init_ctc_train_state(tm, cfg), ctc.make_ctc_train_step(cfg)
    for k, (f, nf, lab, nl) in enumerate(_ctc_batches(5)):
        jstate, jmet = jstep(jstate, *(jnp.asarray(a) for a in (f, nf, lab, nl)))
        state, met = step(state, *(torch.as_tensor(a) for a in (f, nf, lab, nl)))
        for key in ("loss", "utt_nll"):
            np.testing.assert_allclose(met[key], float(jmet[key]), rtol=1e-5, err_msg=f"step {k} {key}")
    want = from_flax(tm, jstate.params)
    for name, value in tm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_train_ctc_units_warm_start():
    """``train_ctc_units`` with ``init_params``: every entry an MPC encoder
    of the same sizes shares is copied in and the head keeps its fresh
    weights (no steps), then two steps train it; a model that shares
    nothing stops."""
    rng = np.random.default_rng(6)
    feats = torch.as_tensor(rng.standard_normal((2, 11, D)).astype(np.float32))
    fbs = [pipe.FeatBatch(["a", "b"], feats, torch.as_tensor([11, 8], dtype=torch.int32), [["x", "y"], ["y"]])]
    enc = {"x": [0, 1], "y": [2]}

    def encode(words):
        return sum((enc[w] for w in words), [])

    cfg = TrainConfig(num_nn_steps=2, **TINY)
    pre = init_(tn.build_model("lstm", D, cfg, D), torch.Generator().manual_seed(9)).state_dict()
    logs = []
    logger = SimpleNamespace(log=logs.append)
    model, sd = pipe.train_ctc_units(fbs, encode, 3, cfg, arch="lstm", steps=0, init_params=pre, logger=logger)
    assert logs == [{"stage": "ctc_warm_start", "leaves_copied": len(pre) - 2, "leaves_total": len(pre)}]
    for name, v in sd.items():
        assert torch.equal(v, pre[name]) == (not name.startswith("head")), name
    model2, sd2 = pipe.train_ctc_units(fbs, encode, 3, cfg, arch="lstm", init_params=pre)
    assert all(torch.isfinite(v).all() for v in sd2.values()) and not torch.equal(sd2["head.weight"],
                                                                                  sd["head.weight"])
    with pytest.raises(ValueError, match="shares no"):
        pipe.train_ctc_units(fbs, encode, 3, cfg, arch="mlp", init_params=pre)


def test_pack_ctc_targets_pads_rows_with_no_labels():
    fb = pipe.FeatBatch(["a"], torch.zeros((3, 5, 2)), torch.as_tensor([5, 0, 0]), [["w"]])
    (got_fb, labels, nl), = pipe._pack_ctc_targets([fb], lambda words: [1, 1, 2])
    assert got_fb is fb and labels.tolist() == [[1, 1, 2], [-1, -1, -1], [-1, -1, -1]] and nl.tolist() == [3, 0, 0]


# ------------------------------------------------------- the slice at full width

N_UTTS = 4
HEAD_GAIN = 60.0  # a flax-initialised head gives near-uniform posteriors: scaled, the decode emits words


@pytest.fixture(scope="module")
def full_width():
    """The CTC LstmAm of TrainConfig's defaults (hidden 512, 2 LSTM layers)
    over the headline lexicon's phones + blank, flax init carried across,
    its head scaled by HEAD_GAIN; the first 4 utterances of bench.py's
    held-out set."""
    word_lex = jsyn.extended_lexicon(300)
    jlex, lex = j_make_lexicon(word_lex), make_lexicon(syn.extended_lexicon(300))
    V_ = jlex.n_phones + 1
    jm = jn.build_model("lstm", V_, JaxTrainConfig())
    fcfg = FrontendConfig()
    params = {"params": jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, 8, fcfg.feat_dim)),
                                         jnp.asarray([8, 8]))["params"]}
    params["params"]["Dense_0"]["kernel"] = params["params"]["Dense_0"]["kernel"] * HEAD_GAIN
    tm = tn.build_model("lstm", V_, TrainConfig(), fcfg.feat_dim)
    tm.load_state_dict(from_flax(tm, params))
    assert tm.hidden == 512 and tm.layers == 2
    utts = jsyn.make_corpus_v2(N_UTTS, lexicon=word_lex, speakers=jsyn.make_speakers(20), style=jsyn.CorpusStyle(),
                               seed=999, words_per_utt=(3, 9))
    utts = [(u.utt_id, u.wave, u.words) for u in utts]
    return SimpleNamespace(jlex=jlex, lex=lex, jm=jm, params=params, tm=tm, fcfg=fcfg, utts=utts,
                           bcfg=BatchConfig(batch_size=N_UTTS, bucket_boundaries=(250, 350, 450, 600)))


def test_ctc_slice_at_full_width_matches_jax(full_width):
    """4 utterances through JAX's make_ctc_scorer + decode_batch over the
    CTC word loop and through the port's: identical token lists; the
    greedy phone decodes identical too."""
    f = full_width
    dcfg = DecodeConfig()
    jgraph, graph = jctc.ctc_decode_graph(f.jlex, dcfg), ctc.ctc_decode_graph(f.lex, dcfg)
    jscore, score = jctc.make_ctc_scorer(f.jm, f.params), pipe.make_ctc_scorer(f.tm)
    want, want_greedy = [], []
    for fb in jax_pipe.featurize(f.utts, f.fcfg, f.bcfg):
        lp = jscore(fb)
        want += jax_pipe.decode_batch(fb, lp, jgraph, dcfg)
        want_greedy += jctc.ctc_greedy_decode(lp, fb.n_frames)[: fb.size]
    got, got_greedy = [], []
    for fb in map(pipe.live_rows, pipe.featurize(f.utts, f.fcfg, f.bcfg, CPU)):
        lp = score(fb)
        got += pipe.decode_batch(fb, lp, graph, dcfg)
        got_greedy += ctc.ctc_greedy_decode(lp, fb.n_frames)
    assert len(got) == N_UTTS and sum(len(h) for h in want) > 0
    assert got == want
    assert got_greedy == want_greedy

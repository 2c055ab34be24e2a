"""The port's data-parallel steps (mogasr_torch.dist.sharded) on two gloo
ranks on the CPU against the reference's sharded steps (mogasr.dist.sharded)
on a 2-device sub-mesh of the faked 8-device mesh, from the same numpy
inputs and weights (``from_flax`` of flax parameters drawn at random), at
tests/test_dist.py's tolerances: EM statistics atol 1e-5, align and decode
paths bitwise and scores atol 1e-4, Baum-Welch statistics atol 2e-5,
training losses rtol 1e-5 and parameters atol 2e-5 after two steps (the
first at the schedule's learning rate 0). Also: ragged shards (one rank's
rows all padding), AdamW's state bitwise equal on both ranks, the MPC and
SpecAugment draws of the whole batch (held to the port's local step: the
port's draws differ from JAX's by design), and the mesh helpers.

All the ranks' work is one launch (``cases.run_cases``) in a module fixture,
started before the reference's steps are compiled here."""

from __future__ import annotations

import concurrent.futures
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jpipe
from mogasr.am import aed as JA
from mogasr.am import ctc as JC
from mogasr.am import em as jem
from mogasr.am import fmllr as jfmllr
from mogasr.am import mllr as jmllr
from mogasr.am import neural as JN
from mogasr.am import rnnt as JR
from mogasr.am import train_nn as JT
from mogasr.am.gmm import GmmSet as JGmm
from mogasr.config import DecodeConfig as JDecodeConfig
from mogasr.config import MeshConfig as JMeshConfig
from mogasr.config import TopologyConfig as JTopo
from mogasr.config import TrainConfig as JTrainConfig
from mogasr.dist import mesh as JM
from mogasr.dist import sharded as JS
from mogasr.hmm import graph as jgr
from mogasr.hmm.lexicon import make_lexicon as jmake_lexicon
from mogasr.hmm.lexicon import synthetic_lexicon as jsynthetic_lexicon
from mogasr.hmm.topology import build_topology as jbuild_topology
from mogasr_torch.am import aed as TA
from mogasr_torch.am import fmllr as tfmllr
from mogasr_torch.am import mllr as tmllr
from mogasr_torch.am import neural as TN
from mogasr_torch.am import pretrain as TP
from mogasr_torch.am import rnnt as TR
from mogasr_torch.am.params import from_flax, init_
from mogasr_torch.am.train_nn import init_train_state, make_train_step
from mogasr_torch.config import MeshConfig, TrainConfig
from mogasr_torch.dist import cases, launch
from mogasr_torch.dist import mesh as TM

N_RANKS = 2
STEPS = 3
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)  # tests/test_torch_aed.py's, on 10 x Adam's first moment


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    _JSTEPS.clear()
    jax.clear_caches()


def _random_params(init, seed):
    """Flax parameters of ``init``'s tree, every leaf drawn at random (scale
    0.3): no compile, and no two leaves equal."""
    rng = np.random.default_rng(seed)
    leaves, tdef = jax.tree.flatten(jax.eval_shape(init))
    return jax.tree.unflatten(tdef, [jnp.asarray(0.3 * rng.standard_normal(x.shape).astype(np.float32))
                                     for x in leaves])


def _gmm(rng, S, K, D):
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.standard_normal((S, K, D)).astype(np.float32),
            (0.5 + rng.random((S, K, D))).astype(np.float32))


def _toy_system(rng, B=8, T=12, D=4):
    """tests/test_dist.py's decode/soft-EM system: align graphs of "ab",
    K = 2, the last row 3 frames short."""
    lex = jmake_lexicon({"ab": ["a", "b"]})
    topo = jbuild_topology(lex, JTopo(states_per_phone=1, sil_states=1))
    graphs = jgr.batch_graphs([jgr.align_graph(topo, lex.words_to_phone_ids(["ab"]))] * B)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    gmm = _gmm(rng, topo.n_pdfs, 2, D)
    nf = np.full(B, T, np.int32)
    nf[-1] = T - 3
    return gmm, feats, nf, graphs


class Case:
    """One training case: the flax model and state, the port's model with
    the same weights, the inputs, and how to make both sharded steps."""

    def __init__(self, jmodel, jstate, tmodel, inputs, factory, jfactory, pre=(), post=(), kwargs=None,
                 jpre=(), jpost=(), jkwargs=None, metrics=("loss",)):
        self.jmodel, self.jstate, self.tmodel, self.inputs = jmodel, jstate, tmodel, inputs
        self.factory, self.jfactory = factory, jfactory
        self.pre, self.post, self.kwargs = pre, post, kwargs or {}
        self.jpre, self.jpost, self.jkwargs = jpre, jpost, jkwargs or {}
        self.metrics = metrics

    def rank_case(self, cfg):
        return {"kind": "train", "factory": self.factory, "model": self.tmodel, "cfg": cfg, "inputs": self.inputs,
                "steps": STEPS, "pre": self.pre, "post": self.post, "kwargs": self.kwargs}


def _jstate(cls, params, jcfg):
    return cls(params, JT.make_optimizer(jcfg).init(params), jnp.zeros((), jnp.int32))


def _mlp_pair(n_out, cfg_kw, seed, D=5):
    jcfg = JTrainConfig(lr=1e-2, num_nn_steps=10, **cfg_kw)
    jm = JN.build_model("mlp", n_out, jcfg)
    params = _random_params(lambda: jm.init(jax.random.key(0), jnp.zeros((2, 6, D)), jnp.asarray([6, 6])), seed)
    tm = TN.build_model("mlp", n_out, TrainConfig(lr=1e-2, num_nn_steps=10, **cfg_kw), D)
    tm.load_state_dict(from_flax(tm, params))
    return jm, params, tm


CFG_KW = dict(nn_hidden=16, nn_layers=1, nn_context=1)
JCFG = JTrainConfig(lr=1e-2, num_nn_steps=10, **CFG_KW)
TCFG = TrainConfig(lr=1e-2, num_nn_steps=10, **CFG_KW)


def _training_cases():
    rng = np.random.default_rng(0)
    out = {}
    # frame CE, even and ragged (rank 1's rows all padding)
    jm, params, tm = _mlp_pair(4, CFG_KW, 1)
    feats = rng.standard_normal((8, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 4, (8, 6)).astype(np.int64)
    nf = np.full(8, 6, np.int32)
    out["ce"] = Case(jm, _jstate(JT.TrainState, params, JCFG), tm, (feats, nf, labels),
                     "make_sharded_train_step", JS.make_sharded_train_step, metrics=("loss", "frame_acc"))
    nf_r, labels_r = nf.copy(), labels.copy()
    nf_r[4:], labels_r[4:] = 0, -1
    nf_r[1], labels_r[1, 3:] = 3, -1
    out["ce_ragged"] = Case(jm, _jstate(JT.TrainState, params, JCFG), tm, (feats, nf_r, labels_r),
                            "make_sharded_train_step", JS.make_sharded_train_step, metrics=("loss", "frame_acc"))
    # CTC, even and ragged
    jm, params, tm = _mlp_pair(4, CFG_KW, 2)
    feats = rng.standard_normal((8, 10, 5)).astype(np.float32)
    nf = np.full(8, 10, np.int32)
    lab = rng.integers(0, 3, (8, 3)).astype(np.int32)
    nl = np.full(8, 3, np.int32)
    out["ctc"] = Case(jm, _jstate(JC.CtcTrainState, params, JCFG), tm, (feats, nf, lab, nl),
                      "make_sharded_ctc_train_step", JS.make_sharded_ctc_train_step)
    nf_r, nl_r, lab_r = nf.copy(), nl.copy(), lab.copy()
    nf_r[4:], nl_r[4:], lab_r[4:] = 0, 0, -1
    nl_r[2], lab_r[2, 1:] = 1, -1
    out["ctc_ragged"] = Case(jm, _jstate(JC.CtcTrainState, params, JCFG), tm, (feats, nf_r, lab_r, nl_r),
                             "make_sharded_ctc_train_step", JS.make_sharded_ctc_train_step)
    # distillation: an MlpAm student of an MlpAm teacher
    tjm, tparams, ttm = _mlp_pair(4, CFG_KW, 3)
    jm, params, tm = _mlp_pair(4, CFG_KW, 4)
    out["distill"] = Case(jm, _jstate(JC.CtcTrainState, params, JCFG), tm, (feats, nf, lab, nl),
                          "make_sharded_distill_train_step", JS.make_sharded_distill_train_step,
                          pre=(ttm,), kwargs=dict(alpha=0.6, temperature=2.0), jpre=(tjm, tparams),
                          jkwargs=dict(alpha=0.6, temperature=2.0), metrics=("loss", "kl", "ctc"))
    # RNN-T, dense and pruned
    for name, simple in (("rnnt", False), ("rnnt_pruned", True)):
        sizes = dict(enc_hidden=16, enc_layers=1, pred_hidden=8, joint_hidden=8, simple_heads=simple)
        jm = JR.RnntModel(n_labels=3, **sizes)
        params = _random_params(lambda: jm.init(jax.random.key(0), jnp.zeros((2, 8, 5)), jnp.asarray([8, 8]),
                                                jnp.zeros((2, 3), jnp.int32), method=JR.RnntModel.init_targets),
                                5 + simple)
        tm = TR.RnntModel(3, 5, **sizes)
        tm.load_state_dict(from_flax(tm, params))
        feats_r = rng.standard_normal((8, 10, 5)).astype(np.float32)
        lab_r = rng.integers(0, 3, (8, 3)).astype(np.int32)
        kw = dict(band=2) if simple else {}
        out[name] = Case(jm, _jstate(JR.RnntTrainState, params, JTrainConfig(lr=1e-2, num_nn_steps=10)), tm,
                         (feats_r, np.full(8, 10, np.int32), lab_r, np.full(8, 3, np.int32)),
                         f"make_sharded_{name}_train_step", getattr(JS, f"make_sharded_{name}_train_step"),
                         kwargs=kw, jkwargs=kw)
    # MMI on the synthetic lexicon's align and word-loop graphs
    lex = jsynthetic_lexicon()
    topo = jbuild_topology(lex, JTopo())
    mmi_kw = dict(nn_arch="mlp", **CFG_KW)
    jm, params, tm = _mlp_pair(topo.n_pdfs, mmi_kw, 7)
    B, T = 8, 40
    words = [[lex.words[b % len(lex.words)]] for b in range(B)]
    num = {k: np.asarray(v) for k, v in jpipe.build_align_graphs(words, lex, topo).items()}
    den = jgr.batch_graphs([jpipe.word_decode_graph(lex, topo, JDecodeConfig())] * B)
    priors = np.zeros(topo.n_pdfs, np.float32)
    out["nn_mmi"] = Case(jm, _jstate(JT.TrainState, params, JCFG), tm,
                         (rng.standard_normal((B, T, 5)).astype(np.float32), np.full(B, T, np.int32), num, den),
                         "make_sharded_nn_mmi_step", JS.make_sharded_nn_mmi_step, post=(torch.as_tensor(priors),),
                         jpost=(jnp.asarray(priors),), metrics=("loss", "mmi_per_frame"))
    # AED and MWER
    aed_cfg = dict(nn_hidden=16, nn_layers=1)
    jm = JA.build_aed_model(3, JTrainConfig(lr=1e-2, num_nn_steps=10, **aed_cfg))
    # flax's initialisation, as tests/test_dist.py's (init_aed_train_state): with every leaf at random,
    # gradients near zero leave Adam's normalised step to the frameworks' rounding
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((2, 16, 5)), jnp.asarray([16, 16]),
                                       jnp.zeros((2, 4), jnp.int32)))(jax.random.key(0))
    tm = TA.build_aed_model(3, TrainConfig(lr=1e-2, num_nn_steps=10, **aed_cfg), 5)
    tm.load_state_dict(from_flax(tm, params))
    aed_jcfg = JTrainConfig(lr=1e-2, num_nn_steps=10, **aed_cfg)
    feats = rng.standard_normal((8, 16, 5)).astype(np.float32)
    nf = np.full(8, 16, np.int32)
    lab = rng.integers(0, 3, (8, 3)).astype(np.int32)
    nl = np.full(8, 3, np.int32)
    out["aed"] = Case(jm, _jstate(JA.AedTrainState, params, aed_jcfg), tm, (feats, nf, lab, nl),
                      "make_sharded_aed_train_step", JS.make_sharded_aed_train_step)
    N, U = 2, 4
    hyps = np.full((8, N, U), -1, np.int32)
    n_h = np.zeros((8, N), np.int32)
    for b in range(8):
        for n in range(N):
            k = 2 + (b + n) % 3
            hyps[b, n, :k] = rng.integers(0, 3, k)
            n_h[b, n] = k
    h_mask = np.ones((8, N), bool)
    h_mask[3, 1] = False
    risks = rng.random((8, N)).astype(np.float32)
    out["aed_mwer"] = Case(jm, _jstate(JA.AedTrainState, params, aed_jcfg), tm,
                           (feats, nf, hyps, n_h, h_mask, risks, lab, nl), "make_sharded_aed_mwer_step",
                           JS.make_sharded_aed_mwer_step, kwargs=dict(ce_weight=0.1), jkwargs=dict(ce_weight=0.1),
                           metrics=("loss", "expected_risk"))
    return out


def _gmm_cases():
    rng = np.random.default_rng(1)
    out = {}
    g = _gmm(rng, 5, 2, 3)
    feats = rng.standard_normal((64, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 64).astype(np.int64)
    labels[-5:] = -1
    out["em"] = dict(kind="gmm", step="em", gmm=g, inputs=(feats, labels))
    labels2 = labels.copy()
    labels2[-3:] = -1
    out["fmllr"] = dict(kind="gmm", step="stats", gmm=g, inputs=(feats, labels2), accumulate=tfmllr.accumulate_fmllr_stats)
    out["mllr"] = dict(kind="gmm", step="stats", gmm=g, inputs=(feats, labels2), accumulate=tmllr.accumulate_mllr_stats)
    # align: tests/test_dist.py's one-component GMM
    lex = jmake_lexicon({"ab": ["a", "b"]})
    topo = jbuild_topology(lex, JTopo(states_per_phone=1, sil_states=1))
    graphs = jgr.batch_graphs([jgr.align_graph(topo, lex.words_to_phone_ids(["ab"]))] * 8)
    a_gmm = (np.ones((topo.n_pdfs, 1), np.float32), rng.standard_normal((topo.n_pdfs, 1, 4)).astype(np.float32),
             np.ones((topo.n_pdfs, 1, 4), np.float32))
    out["align"] = dict(kind="gmm", step="align", gmm=a_gmm,
                        inputs=(rng.standard_normal((8, 12, 4)).astype(np.float32), np.full(8, 12, np.int32), graphs))
    gmm, feats, nf, graphs = _toy_system(rng)
    out["soft"] = dict(kind="gmm", step="soft", gmm=gmm, inputs=(feats, nf, graphs))
    nf_r = nf.copy()
    nf_r[4:] = 0
    out["soft_ragged"] = dict(kind="gmm", step="soft", gmm=gmm, inputs=(feats, nf_r, graphs))
    out["decode"] = dict(kind="gmm", step="decode", gmm=gmm, inputs=(feats, nf, graphs))
    return out


def _mpc_and_specaug():
    """The port's MPC step and the CE step with SpecAugment: draws of the
    whole batch, held to the port's local step."""
    rng = np.random.default_rng(2)
    mpc = init_(TN.build_model("mlp", 5, TCFG, 5), torch.Generator().manual_seed(0))
    feats = rng.standard_normal((8, 30, 5)).astype(np.float32)
    nf = np.full(8, 30, np.int32)
    nf[4:] = [30, 12, 0, 7]
    ce = init_(TN.build_model("mlp", 4, TCFG, 5), torch.Generator().manual_seed(1))
    labels = rng.integers(0, 4, (8, 30)).astype(np.int64)
    labels[np.arange(30)[None, :] >= nf[:, None]] = -1
    return {"mpc": dict(kind="train", factory="make_sharded_mpc_step", model=mpc, cfg=TCFG, inputs=(feats, nf),
                        steps=STEPS),
            "ce_specaug": dict(kind="train", factory="make_sharded_train_step", model=ce, cfg=TCFG,
                               inputs=(feats, nf, labels), steps=STEPS, kwargs=dict(spec_augment=True))}


@pytest.fixture(scope="module")
def setup():
    train = _training_cases()
    rank_cases = {**_gmm_cases(), **_mpc_and_specaug()}
    for name, c in train.items():
        rank_cases[name] = c.rank_case(TCFG if not name.startswith(("rnnt", "aed")) else
                                       TrainConfig(lr=1e-2, num_nn_steps=10, nn_hidden=16, nn_layers=1))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.run_ranks, cases.run_cases, N_RANKS, device="cpu", timeout_s=240,
                         args=(rank_cases,))
    yield {"train": train, "cases": rank_cases, "future": future}
    pool.shutdown(wait=True)


def _results(setup):
    """The ranks' results (waits for the launch): called after a test's
    reference work, which overlaps the ranks'."""
    return setup["future"].result()


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() == 8, "conftest should fake 8 CPU devices"
    return JM.make_mesh(JMeshConfig(num_devices=N_RANKS))


def _jgmm(g):
    return JGmm(*(jnp.asarray(a) for a in g))


# ------------------------------------------------------------------ helpers


def test_pad_to_multiple_matches_reference():
    for n, m in ((10, 8), (10, 5), (3, 4), (0, 2)):
        a = np.arange(n)
        p, k = TM.pad_to_multiple(a, m)
        q, j = JM.pad_to_multiple(a, m)
        np.testing.assert_array_equal(p, q)
        assert k == j


def test_data_rows_blocks():
    m = TM.Mesh("data", None, (0, 1, 2, 3), 2, torch.device("cpu"))
    assert TM.data_rows(8, m) == slice(4, 6)
    assert m.shape == {"data": 4} and m.axis_names == ("data",)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        TM.data_rows(7, m)


def test_mesh_device_is_the_card_unless_the_cpu_is_asked_for():
    """The mesh factories default to "cuda": with no card that raises, and
    the CPU is taken only when the caller names it."""
    assert TM._device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert TM._device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM._device("cuda")


# ---------------------------------------------------------- training steps


_JSTEPS = {}  # the reference's compiled steps, shared by the cases of one model (even and ragged)


def _reference_steps(case, jmesh):
    """The reference's sharded step, STEPS times: (state after the first
    step, each step's metrics)."""
    key = (case.jfactory, id(case.jmodel), tuple(map(id, case.jpre + case.jpost)), tuple(sorted(case.jkwargs.items())))
    if key not in _JSTEPS:
        _JSTEPS[key] = case.jfactory(case.jmodel, *case.jpre, JCFG if case.jfactory in (
            JS.make_sharded_train_step, JS.make_sharded_ctc_train_step, JS.make_sharded_distill_train_step,
            JS.make_sharded_nn_mmi_step) else JTrainConfig(lr=1e-2, num_nn_steps=10, nn_hidden=16, nn_layers=1),
            jmesh, *case.jpost, **case.jkwargs)
    step = _JSTEPS[key]
    state = JM.replicate(case.jstate, jmesh)
    x = JM.shard_batch(tuple(case.inputs), jmesh)
    metrics, first = [], None
    for _ in range(STEPS):
        state, m = step(state, *x)
        metrics.append(m)
        first = first or state
    return first, metrics


TRAIN_CASES = ["ce", "ce_ragged", "ctc", "ctc_ragged", "distill", "rnnt", "rnnt_pruned", "nn_mmi", "aed", "aed_mwer"]


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_sharded_train_step_matches_reference(setup, jmesh, name):
    """Three steps of each factory (the first at learning rate 0): every
    metric the reference reports within rtol 1e-5 at each step; after the
    first step the parameters within atol 2e-5 and Adam's first moments
    (the clipped global gradient) within tests/test_torch_aed.py's
    tolerance; both ranks bitwise alike after the last (parameters and
    AdamW's moments). Parameters after an update at a learning rate are not
    compared: Adam's first updates are +-lr wherever the gradient is tiny,
    whatever its rounding."""
    case = setup["train"][name]
    jfirst, jmetrics = _reference_steps(case, jmesh)
    ranks = _results(setup)
    got = ranks[0][name]
    for step in range(STEPS):
        for key in case.metrics:
            np.testing.assert_allclose(got["metrics"][step][key], float(jmetrics[step][key]), rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"{name} step {step} {key}")
    want = from_flax(case.tmodel, jax.tree.map(np.asarray, jfirst.params))
    mu = from_flax(case.tmodel, jax.tree.map(np.asarray, jfirst.opt_state[1][0].mu))
    for k, v in want.items():
        np.testing.assert_allclose(got["first"]["params"][k], v.numpy(), atol=PARAM_ATOL, err_msg=f"{name} {k}")
        if k in got["first"]["moments"]:
            np.testing.assert_allclose(10 * got["first"]["moments"][k]["exp_avg"], 10 * mu[k].numpy(), **GRAD_TOL,
                                       err_msg=f"{name} {k}")
        else:  # no gradient on any rank (the MWER step leaves the CTC head alone): AdamW keeps no state
            assert not mu[k].numpy().any(), f"{name} {k}"
    assert launch.ranks_equal([r[name]["last"] for r in ranks])


# -------------------------------------------------------------- GMM steps


def _sharded_gmm_inputs(jmesh, case):
    *rest, = case["inputs"]
    return JM.shard_batch(tuple(rest), jmesh)


def test_sharded_em_matches_reference(setup, jmesh):
    case = setup["cases"]["em"]
    want = JS.make_sharded_em_step(jmesh)(JM.replicate(_jgmm(case["gmm"]), jmesh),
                                          *_sharded_gmm_inputs(jmesh, case))
    ranks = _results(setup)
    for r in ranks:
        got = r["em"]["stats"]
        np.testing.assert_allclose(got.occ, np.asarray(want.occ), atol=1e-5)
        np.testing.assert_allclose(got.sx, np.asarray(want.sx), atol=1e-5)
        np.testing.assert_allclose(float(got.loglik), float(want.loglik), rtol=1e-6)
    assert launch.ranks_equal([r["em"]["stats"] for r in ranks])


@pytest.mark.parametrize("name", ["fmllr", "mllr"])
def test_sharded_adaptation_stats_match_reference(setup, jmesh, name):
    case = setup["cases"][name]
    acc = {"fmllr": jfmllr.accumulate_fmllr_stats, "mllr": jmllr.accumulate_mllr_stats}[name]
    want = JS.make_sharded_stats_step(jmesh, acc)(JM.replicate(_jgmm(case["gmm"]), jmesh),
                                                  *_sharded_gmm_inputs(jmesh, case))
    ranks = _results(setup)
    got = ranks[0][name]["stats"]
    for g, w in zip(got, jax.tree.leaves(want)):
        scale = max(float(np.abs(np.asarray(w)).max()), 1.0)
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5 * scale)


def test_sharded_align_matches_reference(setup, jmesh):
    case = setup["cases"]["align"]
    feats, nf, graphs = case["inputs"]
    want = JS.make_sharded_align_step(jmesh)(JM.replicate(_jgmm(case["gmm"]), jmesh),
                                             *JM.shard_batch((feats, nf), jmesh), JM.shard_batch(dict(graphs), jmesh))
    ranks = _results(setup)
    path = np.concatenate([r["align"]["result"].path for r in ranks])
    score = np.concatenate([r["align"]["result"].score for r in ranks])
    np.testing.assert_array_equal(path, np.asarray(want.path))
    np.testing.assert_allclose(score, np.asarray(want.score), atol=1e-4)


@pytest.mark.parametrize("name", ["soft", "soft_ragged"])
def test_sharded_soft_em_matches_reference(setup, jmesh, name):
    case = setup["cases"][name]
    feats, nf, graphs = case["inputs"]
    want = JS.make_sharded_soft_em_step(jmesh)(JM.replicate(_jgmm(case["gmm"]), jmesh),
                                               *JM.shard_batch((feats, nf), jmesh),
                                               JM.shard_batch(dict(graphs), jmesh))
    ranks = _results(setup)
    got = ranks[0][name]["stats"]
    for field in ("occ", "sx", "sxx"):
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(want, field)), atol=2e-5)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik), rtol=1e-5)
    assert launch.ranks_equal([r[name]["stats"] for r in ranks])
    g2 = jem.m_step(_jgmm(case["gmm"]), want)
    assert np.isfinite(np.asarray(g2.means)).all()


def test_sharded_decode_matches_reference(setup, jmesh):
    case = setup["cases"]["decode"]
    feats, nf, graphs = case["inputs"]
    res, totals = JS.make_sharded_decode_step(jmesh)(JM.replicate(_jgmm(case["gmm"]), jmesh),
                                                     *JM.shard_batch((feats, nf), jmesh),
                                                     JM.shard_batch(dict(graphs), jmesh))
    ranks = _results(setup)
    np.testing.assert_array_equal(np.concatenate([r["decode"]["result"].path for r in ranks]), np.asarray(res.path))
    np.testing.assert_allclose(np.concatenate([r["decode"]["result"].score for r in ranks]), np.asarray(res.score),
                               atol=1e-4)
    for r in ranks:
        assert r["decode"]["totals"]["frames"] == int(totals["frames"]) == int(nf.sum())
        np.testing.assert_allclose(float(r["decode"]["totals"]["score"]), float(totals["score"]), rtol=1e-5)


@pytest.mark.parametrize("name", ["mpc", "ce_specaug"])
def test_sharded_draws_match_local_step(setup, name):
    """The MPC span mask and SpecAugment drawn for the whole batch from the
    step counter: the sharded step equals the port's local step (a rank
    with an empty row among its own)."""
    case = setup["cases"][name]
    model = copy.deepcopy(case["model"])
    state = init_train_state(model, TCFG)
    local = TP.make_mpc_train_step(TCFG) if name == "mpc" else make_train_step(TCFG, spec_aug=True)
    x = tuple(torch.as_tensor(a) for a in case["inputs"])
    ranks = _results(setup)
    for step in range(STEPS):
        state, m = local(state, *x)
        for key in ("loss", "masked_frames") if name == "mpc" else ("loss", "frame_acc"):
            np.testing.assert_allclose(ranks[0][name]["metrics"][step][key], m[key], rtol=LOSS_RTOL, atol=1e-6)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(ranks[0][name]["last"]["params"][k], v.numpy(), atol=PARAM_ATOL, err_msg=k)
    assert launch.ranks_equal([r[name]["last"] for r in ranks])


def test_mesh_config_and_launch_results(setup):
    ranks = _results(setup)
    assert len(ranks) == N_RANKS
    assert MeshConfig().data_axis == "data"
    assert all(sum(v for v in r["em"]["launches"].values()) == 0 for r in ranks)  # the CPU runs the plain versions

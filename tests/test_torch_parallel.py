"""The port's tensor-, expert-, sequence- and pipeline-parallel steps
(mogasr_torch.dist.{tensor,expert,sequence,pipeline}_parallel) on four gloo
ranks on the CPU, from the reference's numpy weights and inputs, at the
reference tests' tolerances:

- TP on a 2 x 2 (data, model) mesh against the reference's TP steps on a
  2 x 2 sub-mesh of the faked 8-device mesh (tests/test_tensor_parallel.py:
  scores rtol 1e-5 atol 1e-4, forward 1e-5, three AdamW steps: loss rtol
  1e-5 atol 1e-6, parameters rtol 1e-4 atol 1e-5);
- EP with one expert a rank (4) against the reference's dense per-token MoE
  and its gradients (tests/test_expert_parallel.py: rtol 1e-5 atol 1e-6,
  drops exactly the head's bias), MoeAm against the dense flax module (2e-5)
  and the reference's dense AdamW step (loss rtol 1e-5, parameters rtol
  2e-4 atol 2e-5);
- SP over 4 time shards against the reference's offline tail
  (tests/test_sequence_parallel.py: rtol 1e-4 atol 1e-6, the scorer 1e-6),
  a shard shorter than the window raising;
- PP over 4 stages against the reference's serial stack
  (tests/test_pipeline_parallel.py: forward 1e-6, the SGD step's loss rtol
  1e-6 and parameters rtol 1e-5 atol 1e-6).

The reference tests hold its sharded steps to the same dense and serial
references at these tolerances. One launch of four ranks
(``cases.parallel_cases``) in a module fixture."""

from __future__ import annotations

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import neural as JN
from mogasr.am import train_nn as JT
from mogasr.am.gmm import GmmSet as JGmm
from mogasr.config import TrainConfig as JTrainConfig
from mogasr.dist import expert_parallel as JEP
from mogasr.dist import pipeline_parallel as JPP
from mogasr.dist import tensor_parallel as JTP
from mogasr.frontend.jax_frontend import _deltas_batched, _masked_cmvn
from mogasr_torch.am import neural as TN
from mogasr_torch.am.params import from_flax
from mogasr_torch.config import TrainConfig
from mogasr_torch.dist import cases, launch
from mogasr_torch.dist import mesh as TM
from mogasr_torch.dist import tensor_parallel as TTP

N_RANKS = 4
S, K, D = 24, 4, 13                 # TP GMM: S splits over the model axis
H, F, V, E, N_TOK = 10, 16, 6, 4, 32  # toy MoE: one expert a rank, N_TOK tokens
SB, ST, SD = 3, 64, 5               # SP: T splits over 4 shards
PH, PV, MB = 12, 7, 5               # PP stack


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
    jax.clear_caches()


def _flax_pair(arch, n_out, jcfg, tcfg, seed, feat_dim, T=8):
    jm = JN.build_model(arch, n_out, jcfg)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((2, T, feat_dim)), jnp.asarray([T, T])))(jax.random.key(seed))
    params = {"params": params["params"]}  # not init's sown "losses", which apply would add to
    tm = TN.build_model(arch, n_out, tcfg, feat_dim)
    tm.load_state_dict(from_flax(tm, params))
    return jm, params, tm


def _inputs():
    rng = np.random.default_rng(0)
    x = {}
    # TP
    x["gmm"] = (rng.dirichlet(np.ones(K), size=S).astype(np.float32), rng.standard_normal((S, K, D)).astype(np.float32),
                (0.5 + rng.random((S, K, D))).astype(np.float32))
    x["tp_feats"] = rng.normal(size=(4, 6, D)).astype(np.float32)
    fwd_cfg = dict(nn_hidden=16, nn_layers=3, lr=1e-3)
    x["tp_fwd"] = _flax_pair("mlp", 10, JTrainConfig(**fwd_cfg), TrainConfig(**fwd_cfg), 2, D)
    x["tp_fwd_feats"] = rng.normal(size=(4, 8, D)).astype(np.float32)
    train_cfg = dict(nn_hidden=16, nn_layers=2, lr=1e-3)
    x["tp_train_cfg"] = (JTrainConfig(**train_cfg), TrainConfig(**train_cfg))
    x["tp_train"] = _flax_pair("mlp", 10, *x["tp_train_cfg"], 5, D)
    x["tp_train_feats"] = rng.normal(size=(4, 8, D)).astype(np.float32)
    x["tp_train_labels"] = rng.integers(0, 10, (4, 8)).astype(np.int64)
    # EP toy: the reference's init, one draw per case (compiled once)
    moe_init = jax.jit(JEP.init_moe_params, static_argnums=(1, 2, 3, 4))
    for name, seed in (("toy", 0), ("toy_drop", 1), ("toy_train", 2), ("toy_grads", 3)):
        params = {k: np.asarray(v) for k, v in moe_init(jax.random.key(seed), E, H, F, V).items()}
        r = np.random.default_rng(seed)
        x[name] = (params, r.standard_normal((N_TOK, H)).astype(np.float32), r.integers(0, V, size=(N_TOK,)))
    # MoeAm: its dense flax module
    moe_kw = dict(nn_arch="moe", nn_hidden=16, nn_layers=2, nn_context=1, nn_experts=E, num_nn_steps=10)
    x["moe_cfg"] = (JTrainConfig(**moe_kw), TrainConfig(**moe_kw))
    x["moe"] = _flax_pair("moe", 7, *x["moe_cfg"], 4, 13, T=12)
    r = np.random.default_rng(4)
    x["moe_feats"] = r.standard_normal((8, 12, 13)).astype(np.float32)
    x["moe_nf"] = r.integers(6, 13, size=(8,)).astype(np.int32)
    labels = r.integers(0, 7, size=(8, 12))
    labels[np.arange(12)[None, :] >= x["moe_nf"][:, None]] = -1
    x["moe_labels"] = labels.astype(np.int64)
    x["moe_pad_feats"] = r.standard_normal((8, 24, 13)).astype(np.float32)
    # SP
    r = np.random.default_rng(5)
    x["sp_base"] = r.standard_normal((SB, ST, SD)).astype(np.float32)
    x["sp_nf"] = [np.asarray(n, np.int32) for n in ([64, 64, 64], [64, 37, 5], [1, 64, 23], [40, 64, 9])]
    x["sp_W"] = (r.standard_normal((SD * 3, 7)) * 0.3).astype(np.float32)
    x["sp_b"] = r.standard_normal((7,)).astype(np.float32)
    # PP: the reference's stage stack
    pp_init = jax.jit(JPP.init_pp_params, static_argnums=(1, 2, 3))
    x["pp"] = {M: {k: np.asarray(v) for k, v in pp_init(jax.random.key(M), N_RANKS, PH, PV).items()}
               for M in (6, 1, 4, 5)}
    r = np.random.default_rng(6)
    x["pp_x"] = {M: r.standard_normal((M, MB, PH)).astype(np.float32) for M in (6, 1, 4)}
    x["pp_y"] = r.integers(0, PV, size=(4, MB))
    return x


def _rank_kwargs(x):
    mlp3, mlp2, moe = x["tp_fwd"][2], x["tp_train"][2], x["moe"][2]
    T = x["moe_feats"].shape[1]
    return dict(
        tp=dict(n_data=2, n_model=2, score=[(x["gmm"], x["tp_feats"], "sum"), (x["gmm"], x["tp_feats"], "max")],
                forward=(mlp3, x["tp_fwd_feats"], np.full(4, 8, np.int32)),
                train=(mlp2, x["tp_train_cfg"][1], x["tp_train_feats"], np.full(4, 8, np.int32),
                       x["tp_train_labels"], 3)),
        ep=dict(toy=(x["toy"][0], x["toy"][1], N_TOK // E), toy_drop=(x["toy_drop"][0], x["toy_drop"][1], 1),
                toy_train=(*x["toy_train"], N_TOK // E, 5e-2, 10), toy_grads=(*x["toy_grads"], N_TOK // E),
                am_forward=(moe, x["moe_feats"], x["moe_nf"], T),
                am_padding=(moe, x["moe_pad_feats"], np.full(8, 12, np.int32), 12, 12),
                am_train=(moe, x["moe_cfg"][1], x["moe_feats"], x["moe_nf"], x["moe_labels"], T)),
        sp=dict(tails=[(x["sp_base"], nf, True) for nf in x["sp_nf"][:3]] + [(x["sp_base"], x["sp_nf"][3], False)],
                score=(x["sp_base"], np.asarray([64, 50, 17], np.int32), x["sp_W"], x["sp_b"]),
                short=(np.zeros((1, 4, 4), np.float32), np.asarray([4], np.int32))),
        pp=dict(forwards=[(x["pp"][6], x["pp_x"][6]), (x["pp"][1], x["pp_x"][1])],
                train=(x["pp"][4], x["pp_x"][4], x["pp_y"], 1e-2),
                descent=(x["pp"][5], x["pp_x"][4], x["pp_y"], 5e-2, 8)))


@pytest.fixture(scope="module")
def setup():
    x = _inputs()
    kw = _rank_kwargs(x)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.run_ranks, cases.parallel_cases, N_RANKS, device="cpu", timeout_s=240,
                         args=(kw["tp"], kw["ep"], kw["sp"], kw["pp"]))
    yield x, future
    pool.shutdown(wait=True)


def _results(setup):
    """The ranks' results (waits for the launch): called after a test's
    reference work, which overlaps the ranks'."""
    return setup[1].result()


@pytest.fixture(scope="module")
def x(setup):
    return setup[0]


# ---------------------------------------------------------------------- TP


@pytest.fixture(scope="module")
def jtp_mesh():
    return JTP.make_tp_mesh(2, 2, devices=jax.devices()[:4])


@pytest.mark.parametrize("i,mode", [(0, "sum"), (1, "max")])
def test_tp_score_matches_reference(setup, x, jtp_mesh, i, mode):
    want = JTP.make_tp_score_step(jtp_mesh, mode=mode)(JTP.shard_gmm_states(JGmm(*map(jnp.asarray, x["gmm"])),
                                                                            jtp_mesh), jnp.asarray(x["tp_feats"]))
    ranks = _results(setup)
    for r in ranks:
        assert r["tp"]["score"][i].shape == (4, 6, S)
        np.testing.assert_allclose(r["tp"]["score"][i], np.asarray(want), rtol=1e-5, atol=1e-4)


def test_mlp_shardings_alternate_col_row(x):
    fake = TTP.TpMesh(TM.Mesh("data", None, (0,), 0, torch.device("cpu")),
                      TM.Mesh("model", None, (0, 1), 0, torch.device("cpu")))
    dims = TTP.mlp_shardings(x["tp_train"][2].state_dict(), fake)
    assert dims["dense.0.weight"] == 0 and dims["dense.0.bias"] == 0       # column-parallel
    assert dims["dense.1.weight"] == 1 and dims["dense.1.bias"] is None    # row-parallel
    assert dims["norms.0.weight"] is None
    assert dims["head.weight"] == 0  # Dense_2: column-parallel, 10 pdfs split over 2


def test_tp_forward_matches_reference(setup, x, jtp_mesh):
    jm, params, _ = x["tp_fwd"]
    nf = jnp.full((4,), 8, jnp.int32)
    st = JTP.shard_mlp_state(JT.TrainState(params, None, jnp.zeros((), jnp.int32)), jtp_mesh)
    want = JTP.make_tp_forward(jm, jtp_mesh)(st.params, jnp.asarray(x["tp_fwd_feats"]), nf)
    ranks = _results(setup)
    np.testing.assert_allclose(ranks[0]["tp"]["forward"], np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tp_train_step_matches_reference(setup, x, jtp_mesh):
    """Three AdamW steps on the 2 x 2 mesh: the reference's TP step."""
    jm, params, tm = x["tp_train"]
    jcfg = x["tp_train_cfg"][0]
    state = JTP.shard_mlp_state(JT.TrainState(params, JT.make_optimizer(jcfg).init(params),
                                              jnp.zeros((), jnp.int32)), jtp_mesh)
    step = JTP.make_tp_train_step(jm, jcfg, jtp_mesh)
    args = (jnp.asarray(x["tp_train_feats"]), jnp.full((4,), 8, jnp.int32), jnp.asarray(x["tp_train_labels"]))
    for _ in range(3):
        state, m = step(state, *args)
    ranks = _results(setup)
    for r in ranks:
        got = r["tp"]["train"]
        np.testing.assert_allclose(got["metrics"][-1]["loss"], float(m["loss"]), rtol=1e-5, atol=1e-6)
        want = from_flax(tm, jax.tree.map(np.asarray, state.params))
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        assert got["step"] == 3 and got["dense0_slice"] == (8, 9 * D)  # 16 outputs over 2, 9 spliced frames
    assert launch.ranks_equal([r["tp"]["train"]["params"] for r in ranks])


# ---------------------------------------------------------------------- EP


def test_moe_forward_equals_dense_reference(setup, x):
    params, xs, _ = x["toy"]
    want = JEP.moe_dense_reference({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xs))
    ranks = _results(setup)
    got = ranks[0]["ep"]["toy"]
    assert float(got["dropped"]) == 0.0 and float(got["lb"]) > 0.0
    np.testing.assert_allclose(got["logits"], np.asarray(want), rtol=1e-5, atol=1e-6)


def test_moe_capacity_drop_is_exact_zero(setup, x):
    """Capacity 1: per source rank one token an expert survives; a dropped
    token's logits are the head's bias exactly."""
    params, xs, _ = x["toy_drop"]
    ranks = _results(setup)
    got = ranks[0]["ep"]["toy_drop"]
    assert 0.0 < float(got["dropped"]) < 1.0
    e = np.argmax(xs @ params["Wr"], axis=-1)
    n_loc = N_TOK // E
    n_dropped = 0
    for s in range(E):
        seen = set()
        for i in range(s * n_loc, (s + 1) * n_loc):
            if e[i] in seen:
                np.testing.assert_allclose(got["logits"][i], params["bo"], rtol=0, atol=0)
                n_dropped += 1
            seen.add(e[i])
    assert n_dropped > 0


def test_ep_train_step_improves_and_keeps_experts_split(setup):
    ranks = _results(setup)
    got = ranks[0]["ep"]["toy_train"]
    assert got["losses"][-1] < got["losses"][0]
    assert got["W1_slice"] == (1, H, F)
    assert all(r["ep"]["toy_train"]["losses"] == got["losses"] for r in ranks)


def test_ep_grads_match_dense_reference(setup, x):
    params, xs, ys = x["toy_grads"]

    def dense_loss(p, xx, yy):
        logp = jax.nn.log_softmax(JEP.moe_dense_reference(p, xx), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, yy[:, None], axis=-1))

    want = jax.grad(dense_loss)({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xs), jnp.asarray(ys))
    ranks = _results(setup)
    for k in want:
        np.testing.assert_allclose(ranks[0]["ep"]["toy_grads"][k], np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_moe_am_ep_forward_equals_dense_apply(setup, x):
    jm, params, _ = x["moe"]
    want = np.asarray(jm.apply(params, jnp.asarray(x["moe_feats"]), jnp.asarray(x["moe_nf"])))
    vmask = np.arange(x["moe_feats"].shape[1])[None, :] < x["moe_nf"][:, None]
    ranks = _results(setup)
    np.testing.assert_allclose(ranks[0]["ep"]["am_forward"][vmask], want[vmask], rtol=2e-5, atol=2e-5)


def test_moe_am_ep_padding_never_consumes_capacity(setup):
    ranks = _results(setup)
    got = ranks[0]["ep"]["am_padding"]
    np.testing.assert_allclose(got["padded"], got["tight"], rtol=2e-5, atol=2e-5)


def test_moe_am_ep_train_step_matches_dense_step(setup, x):
    """One AdamW step (CE + load balance, gradients through both all-to-alls):
    the reference's dense make_train_step."""
    jm, params, tm = x["moe"]
    jcfg = x["moe_cfg"][0]
    state = JT.TrainState(params, JT.make_optimizer(jcfg).init(params), jnp.zeros((), jnp.int32))
    state, m = JT.make_train_step(jm, jcfg)(state, jnp.asarray(x["moe_feats"]), jnp.asarray(x["moe_nf"]),
                                            jnp.asarray(x["moe_labels"]))
    ranks = _results(setup)
    got = ranks[0]["ep"]["am_train"]
    for key in ("loss", "ce", "frame_acc"):
        np.testing.assert_allclose(got["metrics"][key], float(m[key]), rtol=1e-5, err_msg=key)
    for k, v in from_flax(tm, jax.tree.map(np.asarray, state.params)).items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), rtol=2e-4, atol=2e-5, err_msg=k)
    assert got["W1_slice"] == (1, 16, 32)
    assert launch.ranks_equal([{k: v for k, v in r["ep"]["am_train"]["params"].items()} for r in ranks])


# ---------------------------------------------------------------------- SP


def _offline_tail(base, n_frames, norm_var=True):
    feats, prev = [base], base
    for _ in range(2):
        prev = _deltas_batched(prev, n_frames, 2)
        feats.append(prev)
    out = jnp.concatenate(feats, axis=-1)
    mask = jnp.arange(base.shape[1])[None, :] < n_frames[:, None]
    return _masked_cmvn(out, mask.astype(jnp.float32), norm_var)


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_sp_tail_equals_offline(setup, x, i):
    nf = x["sp_nf"][i]
    want = _offline_tail(jnp.asarray(x["sp_base"]), jnp.asarray(nf), norm_var=i < 3)
    ranks = _results(setup)
    for r in ranks:
        np.testing.assert_allclose(r["sp"]["tails"][i], np.asarray(want), rtol=1e-4, atol=1e-6)


def test_sp_score_step_matches_offline_chain(setup, x):
    nf = jnp.asarray([64, 50, 17], jnp.int32)
    feats = _offline_tail(jnp.asarray(x["sp_base"]), nf)
    want = (feats.reshape(-1, SD * 3) @ x["sp_W"] + x["sp_b"]).reshape(SB, ST, -1)
    ranks = _results(setup)
    np.testing.assert_allclose(ranks[0]["sp"]["score"], np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sp_shard_shorter_than_window_fails_loudly(setup):
    ranks = _results(setup)
    assert all("delta window" in r["sp"]["short"] for r in ranks)


# ---------------------------------------------------------------------- PP


@pytest.mark.parametrize("i,M", [(0, 6), (1, 1)])
def test_pp_forward_equals_serial(setup, x, i, M):
    want = JPP.serial_forward({k: jnp.asarray(v) for k, v in x["pp"][M].items()},
                              jnp.asarray(x["pp_x"][M]).reshape(-1, PH)).reshape(M, MB, PV)
    ranks = _results(setup)
    for r in ranks:
        np.testing.assert_allclose(r["pp"]["forwards"][i], np.asarray(want), rtol=1e-6, atol=1e-6)


def test_pp_train_step_matches_serial_grads(setup, x):
    params = {k: jnp.asarray(v) for k, v in x["pp"][4].items()}

    def serial_loss(p, xx, yy):
        logp = jax.nn.log_softmax(JPP.serial_forward(p, xx.reshape(-1, PH)), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, yy.reshape(-1)[:, None], axis=-1))

    want_loss, grads = jax.value_and_grad(serial_loss)(params, jnp.asarray(x["pp_x"][4]), jnp.asarray(x["pp_y"]))
    ranks = _results(setup)
    got = ranks[0]["pp"]["train"]
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=1e-6)
    for k in ("W", "b", "Wo", "bo"):
        np.testing.assert_allclose(got["params"][k], np.asarray(params[k] - 1e-2 * grads[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_pp_loss_decreases(setup):
    ranks = _results(setup)
    losses = ranks[0]["pp"]["descent"]
    assert losses[-1] < losses[0]


def test_parallel_cases_ran_on_the_cpu(setup):
    ranks = _results(setup)
    assert len(ranks) == N_RANKS
    assert all(not any(r["launches"].values()) for r in ranks)


def test_tp_mesh_and_gmm_blocks(setup, x):
    ranks = _results(setup)
    assert ranks[0]["tp"]["shape"] == {"data": 2, "model": 2}
    fake = TTP.TpMesh(TM.Mesh("data", None, (1, 3), 0, torch.device("cpu")),
                      TM.Mesh("model", None, (0, 1), 1, torch.device("cpu")))
    g = TTP.shard_gmm_states(x["gmm"], fake)
    assert g.means.shape[0] == S // 2
    np.testing.assert_array_equal(g.means.numpy(), x["gmm"][1][S // 2:])

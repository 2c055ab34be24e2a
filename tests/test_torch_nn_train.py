"""The port's neural-AM training (mogasr_torch.am.train_nn, .pretrain,
utils.checkpoint.average_checkpoints) against the JAX package on the CPU:
the learning rate of every step against the reference's optax chain, the
first step's gradients and the parameters after three steps of the
reference's ``make_train_step`` for MlpAm, LstmAm, MoeAm (with its
load-balance loss) and ConformerAm, the SpecAugment and MPC mask geometry,
MPC's objective and transfer, checkpoint averaging, and the shared check
that stops a kernel wrapper from dropping a gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am import neural as jn
from mogasr.am import pretrain as jpre
from mogasr.am import train_nn as jtrain
from mogasr.config import TrainConfig as JaxTrainConfig
from mogasr.utils import checkpoint as jckpt
from mogasr_torch import _cuda
from mogasr_torch.am import neural as tn
from mogasr_torch.am import pretrain as tpre
from mogasr_torch.am import train_nn as ttrain
from mogasr_torch.am.params import from_flax, init_
from mogasr_torch.config import TrainConfig
from mogasr_torch.utils import checkpoint as ckpt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T, D, P = 3, 13, 6, 7
# First-step gradients: float32 sums in two orders, rtol 1e-4, atol 1e-6.
# After three steps (lr 0, lr/3, 2lr/3 at lr 1e-2 under a 60-step schedule,
# warmup 3): Adam normalizes each gradient, so a gradient entry near
# eps = 1e-8 moves by up to ~lr where the two packages' float32 sums differ
# in its last bits; the port reads at most 6.9e-7 on a CPU, held at 1e-5.
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = {
    "mlp": dict(nn_hidden=12, nn_layers=2, nn_context=1),
    "lstm": dict(nn_hidden=10, nn_layers=2),
    "moe": dict(nn_hidden=8, nn_layers=3, nn_context=1, nn_experts=3),
    "conformer": dict(nn_hidden=16, nn_layers=1),
}


def _batch(seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    nf = np.asarray([T, 9, 4], np.int32)
    labels = rng.integers(0, P, (B, T)).astype(np.int32)
    labels[np.arange(T)[None, :] >= nf[:, None]] = -1
    return feats, nf, labels


def _sd(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("steps", [1, 2, 20, 100])
def test_learning_rate_matches_optax_chain(steps):
    """With a unit gradient on a zero scalar, the reference's chain moves
    it by -lr(k) / (1 + eps) at step k (Adam's first moment over its root
    second moment is 1; no decay on a zero parameter). optax evaluates the
    schedule in float32: its values sit up to 1.0e-5 (relative) from the
    port's float64 ones, and 1.3e-8 of the peak near the end of the decay."""
    jcfg = JaxTrainConfig(lr=3e-3, num_nn_steps=steps)
    opt = jtrain.make_optimizer(jcfg)
    p = {"w": jnp.zeros(())}
    state = opt.init(p)
    want = []
    for _ in range(steps + 3):
        upd, state = opt.update({"w": jnp.ones(())}, state, p)
        want.append(-float(upd["w"]) * (1 + 1e-8))
    lr = ttrain.lr_schedule(TrainConfig(lr=3e-3, num_nn_steps=steps))
    np.testing.assert_allclose([lr(k) for k in range(steps + 3)], want, rtol=2e-5, atol=3e-3 * 1e-6)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_steps_match_optax(arch):
    """Three steps of the reference's jitted ``make_train_step`` (its loss:
    CE plus moe_lb_weight times the sown load-balance terms) against
    ``make_train_step``: the metrics of each step, the first step's
    gradients (after clipping, as Adam's first moments hold them) and the
    parameters after the third. The auxiliary losses: one per MoeAm block."""
    jcfg = JaxTrainConfig(lr=1e-2, num_nn_steps=60, **ARCHS[arch])
    cfg = TrainConfig(lr=1e-2, num_nn_steps=60, **ARCHS[arch])
    jm = jn.build_model(arch, P, jcfg)
    params = {"params": jax.jit(jm.init)(jax.random.key(1), jnp.zeros((2, 8, D)), jnp.asarray([8, 8]))["params"]}
    jstate = jtrain.TrainState(params, jtrain.make_optimizer(jcfg).init(params), jnp.zeros((), jnp.int32))
    tm = tn.build_model(arch, P, cfg, D)
    tm.load_state_dict(from_flax(tm, jstate.params))
    feats, nf, _labels = _batch(2)
    logits, aux = ttrain.train_logits(tm, torch.as_tensor(feats), torch.as_tensor(nf))
    assert logits.shape == (B, T, P) and len(aux) == (ARCHS[arch]["nn_layers"] - 1 if arch == "moe" else 0)

    jstep = jtrain.make_train_step(jm, jcfg)
    state, step = ttrain.init_train_state(tm, cfg), ttrain.make_train_step(cfg)
    for k in range(3):
        fk, nk, lk = _batch(10 + k)
        jstate, jmet = jstep(jstate, jnp.asarray(fk), jnp.asarray(nk), jnp.asarray(lk))
        state, met = step(state, torch.as_tensor(fk), torch.as_tensor(nk), torch.as_tensor(lk))
        for key in ("loss", "ce", "frame_acc"):
            np.testing.assert_allclose(met[key], float(jmet[key]), rtol=1e-5, err_msg=f"step {k} {key}")
        if k == 0:
            # the first step's clipped gradients, in Adam's first moments (0.1 g after one step)
            mu = from_flax(tm, jstate.opt_state[1][0].mu)
            for name, p in tm.named_parameters():
                np.testing.assert_allclose(10 * state.opt.state[p]["exp_avg"].numpy(), 10 * mu[name].numpy(),
                                           err_msg=name, **GRAD_TOL)
    assert state.step == int(jstate.step) == 3
    want = from_flax(tm, jstate.params)
    for name, value in _sd(tm).items():
        np.testing.assert_allclose(value, want[name].numpy(), err_msg=name, **PARAM_TOL)


def test_lstm_training_forward_runs_the_plain_recurrence():
    """LstmAm and BlstmAm train on the plain recurrence under autograd:
    every parameter gets a gradient; the eval step scores without one."""
    for arch in ("lstm", "blstm"):
        tm = init_(tn.build_model(arch, P, TrainConfig(nn_hidden=6, nn_layers=2), D), torch.Generator().manual_seed(0))
        feats, nf, labels = (torch.as_tensor(a) for a in _batch(3))
        logits, _aux = ttrain.train_logits(tm, feats, nf)
        loss, acc = tn.frame_ce_loss(logits, labels)
        loss.backward()
        assert all(p.grad is not None and float(p.grad.abs().sum()) > 0 for p in tm.parameters())
        assert ttrain.make_eval_step()(tm, feats, nf, labels) == {"loss": loss.item(), "frame_acc": acc.item()}


def test_refuse_grad_names_the_kernel_and_the_way_out():
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    _cuda.refuse_grad("K9", "do this instead", x, None)  # nothing needs a gradient
    with torch.no_grad():
        _cuda.refuse_grad("K9", "do this instead", x, w)  # grad mode off
    with pytest.raises(RuntimeError, match=r"K9 has no backward.*do this instead"):
        _cuda.refuse_grad("K9", "do this instead", x, w)


def _mask_geometry(out, nf, n_time, n_feat, tw, fw):
    """(time-masked frames per row, feature-masked columns per row) of a
    masked all-ones input; every zero lies in one or the other."""
    zero = out == 0
    t_masked = zero.all(axis=2)
    f_masked = zero.all(axis=1)
    assert (zero == (t_masked[:, :, None] | f_masked[:, None, :])).all()
    for b, n in enumerate(nf):
        assert not t_masked[b, n:].any()  # padding is never time-masked
        assert int(t_masked[b].sum()) <= n_time * tw[b] and int(f_masked[b].sum()) <= n_feat * fw
        if n > 0:
            assert int(t_masked[b].sum()) >= min(tw[b], n) and int(f_masked[b].sum()) >= fw
    return t_masked.sum(1), f_masked.sum(1)


def test_spec_augment_geometry_as_the_reference():
    """Widths and caps, per-utterance and static, and no time mask past
    n_frames, in both packages (their draws differ: jax.random against a
    torch.Generator)."""
    Bs, Ts, Ds = 4, 120, 40
    nf = np.asarray([120, 70, 9, 1], np.int32)
    ones = np.ones((Bs, Ts, Ds), np.float32)
    tw_static = max(min(20, Ts // 8), 1)
    tw = np.maximum(np.minimum(tw_static, nf // 8), 1)
    fw = max(min(8, Ds // 8), 1)
    got = tn.spec_augment(torch.as_tensor(ones), torch.as_tensor(nf), ttrain.step_generator(TrainConfig(), 3))
    _mask_geometry(got.numpy(), nf, 2, 2, tw, fw)
    want = np.asarray(jn.spec_augment(jnp.asarray(ones), jnp.asarray(nf), jax.random.key(3)))
    _mask_geometry(want, nf, 2, 2, tw, fw)
    # the same step draws the same masks; another step others
    again = tn.spec_augment(torch.as_tensor(ones), torch.as_tensor(nf), ttrain.step_generator(TrainConfig(), 3))
    other = tn.spec_augment(torch.as_tensor(ones), torch.as_tensor(nf), ttrain.step_generator(TrainConfig(), 4))
    assert torch.equal(got, again) and not torch.equal(got, other)


def test_mpc_masks_objective_and_transfer_match_jax():
    """span_time_mask's geometry in both packages; mpc_objective on one mask
    (numpy) against the reference's; transfer_pretrained copies what the
    reference's copies (every leaf but the head's)."""
    cfg_kw = dict(nn_hidden=8, nn_layers=2, nn_context=1)
    feats, nf, _labels = _batch(5)
    n_masks, width = 4, 3
    m = tpre.span_time_mask(ttrain.step_generator(TrainConfig(), 0), torch.as_tensor(nf), T, n_masks, width).numpy()
    jmask = np.asarray(jpre.span_time_mask(jax.random.key(0), jnp.asarray(nf), T, n_masks, width))
    for mask in (m, jmask):
        assert mask.shape == (B, T) and mask.dtype == bool
        for b, n in enumerate(nf):
            assert not mask[b, n:].any() and 1 <= int(mask[b].sum()) <= n_masks * width
    jm = jn.build_model("mlp", D, JaxTrainConfig(**cfg_kw))
    dummy = (jnp.zeros((2, 8, D)), jnp.asarray([8, 8]))
    jparams = jax.jit(jm.init)(jax.random.key(0), *dummy)  # what init_mpc_state draws
    tm = tn.build_model("mlp", D, TrainConfig(**cfg_kw), D)
    tm.load_state_dict(from_flax(tm, jparams))
    jloss, jn_ = jax.jit(lambda p, *a: jpre.mpc_objective(jm, p, *a))(
        jparams, jnp.asarray(feats), jnp.asarray(nf), jnp.asarray(m))
    loss, n = tpre.mpc_objective(tm, torch.as_tensor(feats), torch.as_tensor(nf), torch.as_tensor(m))
    assert int(n) == int(jn_) == int(m.sum())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    # the supervised model's tree: the MPC tree with a P-wide head (the transfer reads paths and shapes)
    head = f"Dense_{cfg_kw['nn_layers']}"
    tparams = {"params": {**jparams["params"], head: {"kernel": jnp.zeros((8, P)), "bias": jnp.zeros(P)}}}
    _merged, jcopied, jtotal = jpre.transfer_pretrained(jparams, tparams)
    target = init_(tn.build_model("mlp", P, TrainConfig(**cfg_kw), D), torch.Generator().manual_seed(7))
    merged, copied, total = tpre.transfer_pretrained(tm.state_dict(), target.state_dict())
    assert (copied, total) == (jcopied, jtotal)
    assert copied == total - 2 and torch.equal(merged["head.weight"], target.state_dict()["head.weight"])
    assert torch.equal(merged["dense.0.weight"], tm.state_dict()["dense.0.weight"])


def test_pretrain_mpc_runs_and_learns():
    from mogasr_torch.pipeline import FeatBatch

    feats, nf, _labels = _batch(6)
    fb = FeatBatch(["a", "b", "c"], torch.as_tensor(feats), torch.as_tensor(nf), [[], [], []])
    cfg = TrainConfig(nn_hidden=8, nn_layers=2, lr=3e-2, num_nn_steps=12)
    model, sd = tpre.pretrain_mpc([fb], cfg, arch="mlp")
    assert isinstance(model, tn.MlpAm) and model.head.out_features == D and set(sd) == set(model.state_dict())
    state = ttrain.init_train_state(model, cfg)
    losses = [tpre.make_mpc_train_step(cfg)(state, fb.feats, fb.n_frames)[1]["loss"] for _ in range(3)]
    assert np.isfinite(losses).all()


def test_average_checkpoints_matches_jax(tmp_path):
    """The last two of three steps: float leaves averaged, integer leaves
    the newest's, in both packages' formats."""
    rng = np.random.default_rng(0)
    trees = [{"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                         "b": rng.standard_normal(4).astype(np.float32)},
              "log_priors": rng.standard_normal(5).astype(np.float32), "count": np.asarray(s, np.int32)}
             for s in (1, 2, 3)]
    for s, tree in zip((1, 2, 3), trees):
        ckpt.save_checkpoint(str(tmp_path / "port"), tree, step=s)
        jckpt.save_checkpoint(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, tree), step=s)
    got = ckpt.average_checkpoints(str(tmp_path / "port"), last_k=2)
    want = jckpt.average_checkpoints(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, trees[0]), last_k=2)
    for path in (("params", "w"), ("params", "b"), ("log_priors",), ("count",)):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.asarray(w).dtype
    assert int(got["count"]) == 3
    np.testing.assert_array_equal(ckpt.average_checkpoints(str(tmp_path / "port"))["log_priors"],
                                  (trees[0]["log_priors"] + trees[1]["log_priors"] + trees[2]["log_priors"]) / 3)
    with pytest.raises(FileNotFoundError):
        ckpt.average_checkpoints(str(tmp_path / "none"))

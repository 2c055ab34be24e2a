"""The port's device feature tail (frontend/device_tail.py) against the
reference's (mogasr/frontend/device_tail.py) on the same seeded numpy rows:
the delta tail's rows, counts and carries exact; the CMVN rows (none, global,
sliding with and without variance) within the reference's own contract
against the host path (rtol 1e-5, atol 1e-6, tests/test_device_tail.py),
their counts exact; the queue's contents exact. Ragged counts, rows at 0 and
final flushes that reset a slot for its next session."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.config import FrontendConfig as JaxFrontendConfig
from mogasr.frontend import device_tail as JDT
from mogasr_torch.config import FrontendConfig
from mogasr_torch.frontend import device_tail as DT


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6   # the reference's device-vs-host CMVN contract
B, F = 4, 8


def _schedule(rng, steps):
    """Per step: rows [B, F, 13], counts [B] (some 0), final flags [B]."""
    for i in range(steps):
        n = rng.integers(0, F + 1, size=B).astype(np.int32)
        n[i % B] = 0                      # a row without frames every step
        final = rng.random(B) < 0.15
        yield (rng.standard_normal((B, F, 13)) * 3 + 1).astype(np.float32), n, final


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# window 2 (the serving config's): its products i * (fwd - bwd) are exact,
# so XLA's contraction of the reference's sum into FMAs moves no bit
@pytest.mark.parametrize("order,window", [(2, 2), (1, 2)])
def test_tail_step_matches_reference(order, window):
    cfg = FrontendConfig(delta_order=order, delta_window=window)
    jcfg = JaxFrontendConfig(delta_order=order, delta_window=window)
    st, jst = DT.tail_init(cfg, B, F, CPU), JDT.tail_init(jcfg, B, F)
    emitted = 0
    for rows, n, final in _schedule(np.random.default_rng(order * 10 + window), 14):
        st, out, n_out = DT.tail_step(cfg, st, rows, n, final)
        jst, jout, jn_out = JDT.tail_step(jcfg, jst, rows, n, final)
        np.testing.assert_array_equal(_np(n_out), _np(jn_out))
        np.testing.assert_array_equal(_np(out), _np(jout))
        for a, b in zip(st, jst):
            np.testing.assert_array_equal(_np(a), _np(b))
        emitted += int(_np(n_out).sum())
    assert emitted > 100


@pytest.mark.parametrize("cmvn,norm_var", [("none", False), ("global", False), ("sliding", False),
                                           ("sliding", True)])
def test_feat_tail_step_matches_reference(cmvn, norm_var):
    cfg = FrontendConfig(cmvn=cmvn, cmvn_window=12, cmvn_norm_var=norm_var)
    jcfg = JaxFrontendConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(7)
    mean = rng.standard_normal(cfg.feat_dim).astype(np.float32) if cmvn == "global" else None
    istd = (0.5 + rng.random(cfg.feat_dim)).astype(np.float32) if cmvn == "global" else None
    st, jst = DT.feat_tail_init(cfg, B, F, CPU), JDT.feat_tail_init(jcfg, B, F)
    rows_out = 0
    for rows, n, final in _schedule(rng, 16):
        st, out, n_out = DT.feat_tail_step(cfg, st, rows, n, final, mean, istd)
        jst, jout, jn_out = JDT.feat_tail_step(jcfg, jst, rows, n, final, mean, istd)
        np.testing.assert_array_equal(_np(n_out), _np(jn_out))
        np.testing.assert_allclose(_np(out), _np(jout), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(_np(st.ch), _np(jst.ch))
        np.testing.assert_array_equal(_np(st.tail.valid), _np(jst.tail.valid))
        np.testing.assert_array_equal(_np(st.tail.buf), _np(jst.tail.buf))
        rows_out += int(_np(n_out).sum())
    assert rows_out > 100


def test_queue_append_and_pop_match_reference():
    rng = np.random.default_rng(3)
    Q, D = 2 * F + 4, 5
    q, jq = torch.zeros((B, Q, D)), jnp.zeros((B, Q, D), jnp.float32)
    qlen = np.zeros(B, np.int64)
    for _ in range(10):
        take = np.minimum(qlen, rng.integers(0, F + 1, size=B))
        feats, q = DT._q_pop_core(q, torch.as_tensor(take), F)
        jfeats, jq = JDT._q_pop_core(jq, jnp.asarray(take), F)
        np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
        qlen = qlen - take
        n = np.minimum(rng.integers(0, F + 5, size=B), Q - qlen)
        rows = rng.standard_normal((B, F + 4, D)).astype(np.float32)
        q = DT._q_append_core(q, torch.as_tensor(qlen), torch.as_tensor(rows), torch.as_tensor(n))
        jq = JDT._q_append_core(jq, jnp.asarray(qlen), jnp.asarray(rows), jnp.asarray(n))
        qlen = qlen + n
        for b in range(B):  # the live rows; past qlen both keep what the shifts left
            np.testing.assert_array_equal(q[b, :qlen[b]].numpy(), np.asarray(jq)[b, :qlen[b]])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_step_refuses_more_rows_than_its_chunk():
    cfg = FrontendConfig()
    st = DT.tail_init(cfg, 2, 4, CPU)
    with pytest.raises(ValueError, match="chunks of 4"):
        DT.tail_step(cfg, st, np.zeros((2, 5, cfg.base_dim), np.float32), [5, 5])

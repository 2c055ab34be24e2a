"""mogasr_torch GMM scorer against the JAX scorer, the interpret-mode Pallas
kernels (the chunked and int8 arms) and the golden logliks; weight transfer;
the kernels' layouts (chunked, wide, int8, and the panels K1 and K1w read)
against the reference's arrays; an emulated 3xTF32 scorer (the route the
card ruled out for the float32 arms) against JAX; the kernel wrapper's CPU
dispatch. Inputs are numpy
arrays from a seed, handed to both packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.am.gmm import GmmSet as JaxGmmSet
from mogasr.am.gmm import gmm_loglik as jax_gmm_loglik
from mogasr.am.gmm import natural_params as jax_natural_params
from mogasr.am.gmm import quadratic_features
from mogasr.am.gmm_pallas import gmm_loglik_pallas, transposed_natural_params
from mogasr_torch.am import gmm_cuda
from mogasr_torch.am.gmm import (
    GmmSet,
    component_major,
    gmm_from_numpy,
    gmm_loglik,
    int8_params,
    natural_params,
    quantize_int8,
)


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
HEADLINE_GMM = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "headline", "gmm.npz")
# The card's kernels against the plain scorer (chip_smoke.py's K1_ATOL, K1_RTOL).
K1_ATOL, K1_RTOL = 1e-3, 1e-4
# Both sides compute in float32 and differ only in summation order: the
# measured gap is 1.5e-5 on logliks of magnitude 40-130.
ATOL, RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def system():
    """A small GMM (S=20, K=4, D=39) and N=100 frames, each drawn from one
    of its components, as numpy arrays."""
    rng = np.random.default_rng(0)
    S, K, D, N = 20, 4, 39, 100
    w = rng.dirichlet(np.ones(K), size=S).astype(np.float32)
    mu = rng.standard_normal((S, K, D)).astype(np.float32)
    var = (0.5 + rng.random((S, K, D))).astype(np.float32)
    st, comp = rng.integers(0, S, N), rng.integers(0, K, N)
    x = (mu[st, comp] + np.sqrt(var[st, comp]) * rng.standard_normal((N, D))).astype(np.float32)
    return w, mu, var, x


def _jax_gmm(w, mu, var):
    return JaxGmmSet(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_plain_matches_jax(system, mode):
    w, mu, var, x = system
    want = np.asarray(jax_gmm_loglik(jnp.asarray(x), _jax_gmm(w, mu, var), mode=mode))
    got = gmm_loglik(torch.as_tensor(x), gmm_from_numpy(w, mu, var, CPU), mode=mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_plain_matches_pallas_interpret(system, mode):
    w, mu, var, x = system
    want = np.asarray(gmm_loglik_pallas(
        jnp.asarray(x), _jax_gmm(w, mu, var), tile_m=64, interpret=True, mode=mode))
    got = gmm_loglik(torch.as_tensor(x), gmm_from_numpy(w, mu, var, CPU), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_plain_matches_golden():
    data = np.load(FIXTURE)
    g = gmm_from_numpy(data["gmm_w"], data["gmm_mu"], data["gmm_var"], CPU)
    got = gmm_loglik(torch.as_tensor(data["feats"][:50]), g)
    # the reference's own golden tolerance (tests/test_golden.py)
    np.testing.assert_allclose(got.numpy(), data["loglik"], atol=1e-3, rtol=1e-4)


def test_gmm_from_numpy_round_trip(system):
    w, mu, var, _x = system
    jg = _jax_gmm(w, mu, var)
    g = gmm_from_numpy(np.asarray(jg.weights), np.asarray(jg.means), np.asarray(jg.vars), CPU)
    assert isinstance(g, GmmSet)
    assert (g.n_states, g.n_components, g.feat_dim) == mu.shape
    for ours, theirs in zip(g, jg):
        assert ours.dtype == torch.float32 and ours.device == CPU
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_bf16_max_picks_the_same_states_as_jax(system):
    """The two bf16 paths round c differently (the reference splits it into
    a bf16 hi/lo pair, the port keeps it float32), so compare decisions."""
    w, mu, var, x = system
    want = np.asarray(gmm_loglik_pallas(
        jnp.asarray(x), _jax_gmm(w, mu, var), tile_m=64, interpret=True,
        compute_dtype="bfloat16", mode="max"))
    got = gmm_loglik(torch.as_tensor(x), gmm_from_numpy(w, mu, var, CPU),
                     mode="max", compute_dtype="bfloat16").numpy()
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_fused_wrapper_takes_plain_version_on_cpu(system, compute_dtype, mode):
    w, mu, var, x = system
    g = gmm_from_numpy(w, mu, var, CPU)
    before = gmm_cuda.LAUNCHES
    feats = torch.as_tensor(x).reshape(4, 25, -1)
    got = gmm_cuda.gmm_loglik_batched(feats, g, compute_dtype=compute_dtype, mode=mode)
    want = gmm_loglik(torch.as_tensor(x), g, mode=mode, compute_dtype=compute_dtype)
    assert torch.equal(got.reshape(100, -1), want)
    assert gmm_cuda.LAUNCHES == before


def test_bad_arguments_raise(system):
    w, mu, var, x = system
    g = gmm_from_numpy(w, mu, var, CPU)
    with pytest.raises(ValueError):
        gmm_cuda.gmm_loglik_fused(torch.as_tensor(x), g, mode="mean")
    with pytest.raises(ValueError):
        gmm_cuda.gmm_loglik_fused(torch.as_tensor(x), g, compute_dtype="int4")
    with pytest.raises(ValueError):
        gmm_cuda.gmm_loglik_fused(torch.as_tensor(x), g, layout="tiled")
    with pytest.raises(ValueError):  # the wide layout is float32 / bfloat16 only
        gmm_cuda.gmm_loglik_fused(torch.as_tensor(x), g, compute_dtype="int8", layout="wide")
    with pytest.raises(ValueError):
        gmm_cuda.gmm_loglik_fused(torch.as_tensor(x), g, layout="wide", kc=5)  # K = 4


def test_int8_max_mode_raises(system):
    """int8 folds in sum mode only, as gmm_pallas.py:391-392."""
    w, mu, var, x = system
    g = gmm_from_numpy(w, mu, var, CPU)
    with pytest.raises(NotImplementedError):
        gmm_loglik(torch.as_tensor(x), g, mode="max", compute_dtype="int8")
    with pytest.raises(NotImplementedError):
        gmm_cuda.gmm_loglik_fused(torch.as_tensor(x), g, compute_dtype="int8", mode="max")
    with pytest.raises(NotImplementedError):
        gmm_loglik_pallas(jnp.asarray(x), _jax_gmm(w, mu, var), compute_dtype="int8", mode="max")


@pytest.mark.parametrize("n_rows", [100, 7])
def test_plain_int8_matches_pallas_interpret(system, n_rows):
    """The plain int8 scorer against the interpret-mode K5: the same
    quantized operands and integer products, dequantized in the same order;
    only the logsumexp's order differs."""
    w, mu, var, x = system
    x = x[:n_rows]
    want = np.asarray(gmm_loglik_pallas(
        jnp.asarray(x), _jax_gmm(w, mu, var), tile_m=64, interpret=True, compute_dtype="int8"))
    got = gmm_loglik(torch.as_tensor(x), gmm_from_numpy(w, mu, var, CPU), compute_dtype="int8")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _jax_ab_t(w, mu, var):
    """The reference's component-major ab_t [K, 2D, S] and c_t [K, S]."""
    ab_t, c_t = transposed_natural_params(_jax_gmm(w, mu, var))
    return np.array(ab_t), np.array(c_t)


def test_int8_quantization_matches_jax(system):
    """quantize_int8 on the reference's own ab_t and x2 gives, bitwise, the
    arrays gmm_pallas.py:238-244 builds (there padded to 128 lanes and a
    multiple of the tiles, which leaves every scale unchanged)."""
    w, mu, var, x = system
    ab_t, _c = _jax_ab_t(w, mu, var)
    K, R, S = ab_t.shape
    k_pad, r, s_pad = K + 3, 128, S + 5
    abf = jnp.zeros((k_pad, r, s_pad), jnp.float32).at[:K, :R, :S].set(ab_t)
    sab = jnp.maximum(jnp.max(jnp.abs(abf), axis=1, keepdims=True), 1e-10) / 127.0
    abp = jnp.clip(jnp.round(abf / sab), -127, 127).astype(jnp.int8)
    qab, sab_t = quantize_int8(torch.as_tensor(ab_t), dim=1)
    assert qab.dtype == torch.int8 and sab_t.dtype == torch.float32
    np.testing.assert_array_equal(qab.numpy(), np.asarray(abp)[:K, :R, :S])
    np.testing.assert_array_equal(sab_t.numpy(), np.asarray(sab)[:K, 0, :S])

    x2 = np.array(quadratic_features(jnp.asarray(x)))
    x2f = jnp.zeros((x.shape[0] + 12, r), jnp.float32).at[: x.shape[0], :R].set(x2)
    sx = jnp.maximum(jnp.max(jnp.abs(x2f), axis=1, keepdims=True), 1e-10) / 127.0
    x2p = jnp.clip(jnp.round(x2f / sx), -127, 127).astype(jnp.int8)
    qx, sx_t = quantize_int8(torch.as_tensor(x2), dim=1)
    np.testing.assert_array_equal(qx.numpy(), np.asarray(x2p)[: x.shape[0], :R])
    np.testing.assert_array_equal(sx_t.numpy(), np.asarray(sx)[: x.shape[0], 0])


def test_int8_kernel_params(system):
    """K5's parameters: the int8 panels (one [64, Rp] image per component
    and 64-state tile, Rp = 96 at D = 39), the scales and c."""
    w, mu, var, _x = system
    S, K, D = mu.shape
    params = gmm_cuda.kernel_params(gmm_from_numpy(w, mu, var, CPU), "int8")
    assert isinstance(params, gmm_cuda.Int8Params)
    rp = gmm_cuda.padded_rows(D, gmm_cuda.INT8_R_ALIGN)
    assert rp == 96 and params.panels.shape == (K * -(-S // 64), 64 * rp) and params.panels.dtype == torch.int8
    assert params.sab.shape == params.c_t.shape == (K, S)
    assert all(p.is_contiguous() for p in params)
    # the int8 model is 4x smaller than the float32 one
    assert params.panels.element_size() * 4 == gmm_cuda.kernel_params(
        gmm_from_numpy(w, mu, var, CPU)).panels.element_size()


def _read_int8_panels(panels, K, R, S, rc):
    """The int8 image of K5's panels read back into qab [K, R, S]: element
    (s, r) of a chunk at ((s // 8 * rc // 16 + r // 16) * 8 + s % 8) * 16 + r % 16."""
    n_st = -(-S // 64)
    chunks = panels.numpy().reshape(K, n_st, -1, 64 // 8, rc // 16, 8, 16)  # k, j, chunk, s//8, r//16, s%8, r%16
    tiles = chunks.transpose(0, 2, 4, 6, 1, 3, 5).reshape(K, -1, n_st * 64)  # k, r, s
    return tiles[:, :R, :S], tiles


@pytest.mark.parametrize("D,n_chunks,rc", [(39, 1, 96), (120, 2, 128), (65, 2, 96)])
def test_int8_image_matches_jax(system, D, n_chunks, rc):
    """The int8 wgmma image that kernel_params(gmm, "int8") builds, read back
    on the CPU: the 2D rows in equal chunks of a multiple of 32 (one of 96 at
    D = 39, two of 128 at 120, two of 96 at 65), zero past 2D and past S;
    within them bitwise int8_params' qab and the reference's abp
    (gmm_pallas.py:240-244)."""
    w, mu, var, _x = system
    rng = np.random.default_rng(D)
    mu = np.concatenate([mu, rng.standard_normal(mu.shape[:2] + (D,)).astype(np.float32)], -1)[..., :D]
    var = np.concatenate([var, 0.5 + rng.random(var.shape[:2] + (D,)).astype(np.float32)], -1)[..., :D]
    g = gmm_from_numpy(w, mu, var, CPU)
    K, R, S = mu.shape[1], 2 * D, mu.shape[0]
    assert gmm_cuda.row_chunks(D, gmm_cuda.INT8_R_ALIGN) == (n_chunks, rc)
    params = gmm_cuda.kernel_params(g, "int8")
    qab, tiles = _read_int8_panels(params.panels, K, R, S, rc)
    assert tiles.shape[1] == n_chunks * rc and not tiles[:, R:].any() and not tiles[:, :, S:].any()
    np.testing.assert_array_equal(qab, int8_params(g)[0].numpy())
    ab_t, _c = _jax_ab_t(w, mu, var)
    abf = jnp.zeros((K, 128 * -(-R // 128), S), jnp.float32).at[:, :R, :].set(ab_t)
    sab = jnp.maximum(jnp.max(jnp.abs(abf), axis=1, keepdims=True), 1e-10) / 127.0
    abp = jnp.clip(jnp.round(abf / sab), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(qab, np.asarray(abp)[:, :R, :])
    np.testing.assert_array_equal(params.sab.numpy(), np.asarray(sab)[:, 0, :])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kc", [1, 3, 4])
def test_wide_layout_matches_jax(system, compute_dtype, kc):
    """The wide panel [n_kc, 2D, n_st * kc * TS] is, bitwise, the reference's
    reshape/transpose of gmm_pallas.py:300-304 applied to its ab_t at the
    port's tile width (the port keeps c out of the panel and R = 2D rows)."""
    w, mu, var, _x = system
    ab_t, _c = _jax_ab_t(w, mu, var)
    K, R, S = ab_t.shape
    ts = gmm_cuda.WIDE_TS
    k_pad, s_pad = -(-K // kc) * kc, -(-S // ts) * ts
    n_kc, n_st = k_pad // kc, s_pad // ts
    dt = jnp.float32 if compute_dtype == "float32" else jnp.bfloat16
    abp = jnp.zeros((k_pad, R, s_pad), dt).at[:K, :, :S].set(jnp.asarray(ab_t).astype(dt))
    want = abp.reshape(n_kc, kc, R, n_st, ts).transpose(0, 2, 3, 1, 4).reshape(n_kc, R, n_st * kc * ts)
    g = gmm_from_numpy(w, mu, var, CPU)
    params = gmm_cuda.kernel_params(g, compute_dtype, "wide", kc)
    assert isinstance(params, gmm_cuda.WideParams) and params.kc == kc
    # on the reference's ab_t, and on the port's (held to JAX's bitwise in
    # test_kernel_params_layout_matches_jax)
    for a in (torch.as_tensor(ab_t), component_major(g)[0]):
        got = gmm_cuda.wide_layout(a.to(gmm_cuda.COMPUTE_DTYPES[compute_dtype]), kc)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_default_kc_follows_reference():
    assert gmm_cuda.default_kc("bfloat16", "sum", 16) == 8
    assert gmm_cuda.default_kc("bfloat16", "max", 16) == 16
    assert gmm_cuda.default_kc("float32", "sum", 16) == 16
    assert gmm_cuda.default_kc("float32", "max", 4) == 4


@pytest.mark.parametrize("compute_dtype,mode,layout", [
    ("int8", "sum", "chunked"), ("float32", "sum", "wide"), ("bfloat16", "max", "wide")])
def test_int8_and_wide_wrappers_take_plain_version_on_cpu(system, compute_dtype, mode, layout):
    w, mu, var, x = system
    g = gmm_from_numpy(w, mu, var, CPU)
    before = (gmm_cuda.LAUNCHES, gmm_cuda.WIDE_LAUNCHES, gmm_cuda.INT8_LAUNCHES)
    got = gmm_cuda.gmm_loglik_batched(torch.as_tensor(x).reshape(4, 25, -1), g, compute_dtype=compute_dtype,
                                      mode=mode, layout=layout)
    want = gmm_loglik(torch.as_tensor(x), g, mode=mode, compute_dtype=compute_dtype)
    assert torch.equal(got.reshape(100, -1), want)
    assert (gmm_cuda.LAUNCHES, gmm_cuda.WIDE_LAUNCHES, gmm_cuda.INT8_LAUNCHES) == before


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kernel_params_layout_matches_jax(system, compute_dtype):
    """The kernels' component-major layout holds JAX's natural parameters:
    ab_t[k, r, s] = ab[r, s*K + k] (in the compute dtype), c_t[k, s] = c[s*K + k]."""
    w, mu, var, _x = system
    S, K, D = mu.shape
    nat = jax_natural_params(_jax_gmm(w, mu, var))
    g = gmm_from_numpy(w, mu, var, CPU)
    params = gmm_cuda.kernel_params(g, compute_dtype)
    ab_t, c_t = component_major(g)[0].to(gmm_cuda.COMPUTE_DTYPES[compute_dtype]), params.c_t
    assert c_t.is_contiguous() and c_t.dtype == torch.float32
    assert torch.equal(c_t, component_major(g)[1])
    want_ab = torch.as_tensor(np.asarray(nat.ab).reshape(2 * D, S, K).transpose(2, 0, 1).copy())
    want_c = np.asarray(nat.c).reshape(S, K).T
    torch.testing.assert_close(ab_t, want_ab.to(ab_t.dtype), atol=0, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), want_c, atol=ATOL, rtol=RTOL)


def tf32_split(v: torch.Tensor):
    """(hi, lo) of float32 ``v`` for 3xTF32 products: hi is v rounded to TF32
    (10 mantissa bits) to nearest, ties away from zero, as the card's
    ``cvt.rna.tf32.f32``; lo is the same rounding of v - hi, which float32
    holds exactly. Done in int64 on the float32 bits (torch has no uint32
    arithmetic)."""

    def rna(a: torch.Tensor) -> torch.Tensor:
        bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        bits = (bits + 0x1000) & 0xFFFFE000  # + half of the 13 dropped bits, then drop them
        return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)

    v = v.to(torch.float32)
    hi = rna(v)
    return hi, rna(v - hi)


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi keeps 10 mantissa bits (its low 13 bits zero), rounded to nearest
    with ties away from zero as cvt.rna.tf32.f32; |v - hi - lo| <= 2**-22 |v|."""
    ties = np.array([0x3F801000, 0xBF801000, 0x3F803000, 0x3F800FFF, 0x3F801001], np.uint32)
    hi, lo = tf32_split(torch.as_tensor(ties.view(np.float32)))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  np.array([0x3F802000, 0xBF802000, 0x3F804000, 0x3F800000, 0x3F802000], np.uint32))
    v = torch.as_tensor((np.random.default_rng(3).standard_normal(20000)
                         * np.exp(np.random.default_rng(4).uniform(-20, 20, 20000))).astype(np.float32))
    hi, lo = tf32_split(v)
    for part in (hi, lo):
        assert part.dtype == torch.float32 and not (part.view(torch.int32) & 0x1FFF).any()
    gap = (v.double() - hi.double() - lo.double()).abs()
    assert bool((gap <= 2.0 ** -22 * v.double().abs()).all())


def _tf32_scorer(x, g, mode, n_terms):
    """The tensor cores' float32 arm, emulated: operands split by tf32_split,
    products exact, summed in float32; 3 terms (lo.hi + hi.lo + hi.hi) or 1
    (hi.hi, plain TF32). c added in float32, then the fold."""
    S, K, D = g.means.shape
    nat = natural_params(g)
    x2 = torch.cat([x * x, x], dim=-1)
    (xh, xl), (ah, al) = tf32_split(x2), tf32_split(nat.ab)
    acc = xh @ ah if n_terms == 1 else (xl @ ah + xh @ al) + xh @ ah
    scores = (acc + nat.c).reshape(-1, S, K)
    return scores.amax(-1) if mode == "max" else torch.logsumexp(scores, -1)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_3xtf32_scorer_holds_the_k1_tolerance(mode):
    """3xTF32 products, emulated on the headline GMM (1168 x 16 x 39) and 32
    golden frames with IEEE float32 sums, sit within K1's tolerance of JAX's
    float32 scorer; 1xTF32 does not, so the tolerance tells the two apart.
    (The emulation does not model the tensor cores' truncating accumulation,
    which ruled 3xTF32 out on the card.)"""
    h = np.load(HEADLINE_GMM)
    x = np.load(FIXTURE)["feats"][:32].astype(np.float32)
    want = np.asarray(jax_gmm_loglik(jnp.asarray(x), _jax_gmm(h["weights"], h["means"], h["vars"]), mode=mode))
    g = gmm_from_numpy(h["weights"], h["means"], h["vars"], CPU)
    got3 = _tf32_scorer(torch.as_tensor(x), g, mode, 3).numpy()
    got1 = _tf32_scorer(torch.as_tensor(x), g, mode, 1).numpy()
    np.testing.assert_allclose(got3, want, atol=K1_ATOL, rtol=K1_RTOL)
    assert not np.allclose(got1, want, atol=K1_ATOL, rtol=K1_RTOL)


def _image_np(tiles, rc):
    """[P, Rp, 64] bf16 panels -> [P, Rp * 64], each chunk of rc rows K-major
    in 8-row groups of 16-byte (8-element) column chunks: element (s, r) of
    a chunk at ((s // 8 * rc // 8 + r // 8) * 8 + s % 8) * 8 + r % 8."""
    P, rp, ts = tiles.shape
    return tiles.reshape(-1, rc // 8, 8, ts // 8, 8).transpose(0, 3, 1, 4, 2).reshape(P, rp * ts)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,kc", [("chunked", None), ("wide", 3), ("wide", 4)])
@pytest.mark.parametrize("D,n_chunks,rc", [(39, 1, 80), (120, 2, 128), (65, 2, 80)])
def test_kernel_panels_match_jax(system, compute_dtype, layout, kc, D, n_chunks, rc):
    """The panels K1 and K1w read are, bitwise, the reference's arrays cut
    into [Rp, 64] slices: transposed_natural_params (chunked) or its wide
    reshape (gmm_pallas.py:300-304), states padded to 64 and rows 2D to Rp
    with zeros, in equal chunks of at most 128 rows (a multiple of 16: one
    at D = 39, MFCC with deltas; two at D = 120, fbank with deltas);
    float32 chunks as they are (FMA), bf16 ones transposed to K-major in the
    wgmma image."""
    w, mu, var, _x = system
    rng = np.random.default_rng(D)
    mu = np.concatenate([mu, rng.standard_normal(mu.shape[:2] + (D,)).astype(np.float32)], -1)[..., :D]
    var = np.concatenate([var, 0.5 + rng.random(var.shape[:2] + (D,)).astype(np.float32)], -1)[..., :D]
    ab_t, _c = _jax_ab_t(w, mu, var)
    K, R, S = ab_t.shape
    ts, rp = gmm_cuda.WIDE_TS, gmm_cuda.padded_rows(R // 2)
    assert ts == 64 and gmm_cuda.row_chunks(D) == (n_chunks, rc) and rp == n_chunks * rc
    dt = jnp.float32 if compute_dtype == "float32" else jnp.bfloat16
    if layout == "wide":
        k_pad, s_pad = -(-K // kc) * kc, -(-S // ts) * ts
        n_kc, n_st = k_pad // kc, s_pad // ts
        abp = jnp.zeros((k_pad, R, s_pad), dt).at[:K, :, :S].set(jnp.asarray(ab_t).astype(dt))
        wide = abp.reshape(n_kc, kc, R, n_st, ts).transpose(0, 2, 3, 1, 4).reshape(n_kc, R, n_st * kc * ts)
        slices = np.asarray(wide.astype(jnp.float32)).reshape(n_kc, R, n_st * kc, ts).transpose(0, 2, 1, 3)
    else:
        n_st = -(-S // ts)
        abp = np.zeros((K, R, n_st * ts), np.float32)
        abp[:, :, :S] = np.asarray(jnp.asarray(ab_t).astype(dt).astype(jnp.float32))
        slices = abp.reshape(K, R, n_st, ts).transpose(0, 2, 1, 3)
    tiles = np.zeros(slices.shape[:2] + (rp, ts), np.float32)
    tiles[:, :, :R] = slices
    tiles = tiles.reshape(-1, rp, ts)
    want = tiles.reshape(len(tiles), -1) if compute_dtype == "float32" else _image_np(tiles, rc)
    params = gmm_cuda.kernel_params(gmm_from_numpy(w, mu, var, CPU), compute_dtype, layout, kc)
    assert params.panels.is_contiguous() and params.panels.dtype == gmm_cuda.COMPUTE_DTYPES[compute_dtype]
    np.testing.assert_array_equal(params.panels.float().numpy().view(np.uint32), want.view(np.uint32))

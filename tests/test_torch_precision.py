"""The bf16 precision policies on the port's own paths, on the CPU.

Under ``bf16_store`` and ``bf16_refined`` the ``cuda`` backend runs the
mixed-precision variants of the blocked Cholesky, the dense trsm and
``interp_solve``: bf16 operands, float32 sums and state, Θ stored in bf16.
On CPU tensors those wrappers run their plain versions (``kernels.ref``
with ``compute_dtype``), which are held here to the JAX package's Pallas
kernels in interpret mode (``compute_dtype="bfloat16"``,
``accum_dtype="float32"``) on the same numpy inputs; then the engine on
both backends against the JAX engine, and the contracts of
``tests/test_precision.py``'s bf16 tests on the port's paths.

Tolerances, max |Δ| / max |JAX| unless stated:

* Cholesky and trsm, 1e-5: both sides round the same operands to bf16 and
  multiply them at float32, where a product of two bf16 values is exact;
  only the order of the float32 sums differs (ATen against XLA), and a
  float32 value one bit apart can round to the other bf16 neighbour, which
  these small, well-conditioned inputs leave far below 1e-5 (measured
  ≤ 1e-7).  A missing rounding would show the bf16 error itself, ≥ 5e-4.
* ``interp_solve``: XLA evaluates the interpreted kernel's bf16 arithmetic
  with roundings of its own, so JAX and the port agree only to the bf16
  error of the solution (measured up to 4.6e-3 apart, each 5e-3 from the
  float64 solve).  So the port is held to 1e-6 of a numpy emulation of the
  Pallas kernel's stated arithmetic (bf16 Horner rounding every step from
  x rounded to bf16, float32 diagonal tiles inverted at float64 and
  rounded, every operand rounded before its product; measured ≤ 4e-8),
  and both the port and JAX to 2e-2 of the float64 solve.
* Engine curves: within the reference test's own bound (rtol 2e-2, atol
  2e-3) of JAX's, and under ``bf16_refined`` the same argmin.  Under
  ``bf16_store`` the argmin is not compared: the unrefined curve carries
  the sweep's bf16 rounding noise (±1e-3 on this problem, where fp32's
  best two λs lie 6e-7 apart), so its argmin moves with any difference in
  rounding, such as the few Horner values XLA rounds otherwise; the JAX
  package holds ``bf16_store``'s argmin to nothing either
  (``tests/test_precision.py:188``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.kernels.chol_blocked import cholesky_blocked as j_chol  # noqa: E402
from repro.kernels.poly_interp import interp_solve as j_interp  # noqa: E402
from repro.kernels.trsm import solve_lower_blocked as j_trsm  # noqa: E402
from repro.testing import strategies as props  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backends, engine, packing, picholesky  # noqa: E402
from repro_torch.core.precision import PRESETS, resolve_precision  # noqa: E402
from repro_torch.kernels import (LAUNCHES, chol_blocked, poly_interp,  # noqa: E402
                                 reset_launches, trsm)

BF, F32 = torch.bfloat16, torch.float32
KERNEL_RTOL = 1e-5
EMULATION_RTOL = 1e-6
SOLVE_RTOL = 2e-2
CURVE_RTOL, CURVE_ATOL = 2e-2, 2e-3
SHAPES = [(48, 8), (48, 16), (64, 8), (64, 16)]
LAMS = np.array([0.1, 0.5, 2.0])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _bf(a):
    """numpy values rounded to bf16 (to nearest even), as float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).double().numpy()


def _spd32(h, seed):
    x = np.random.default_rng(seed).standard_normal((2 * h, h))
    return (x.T @ x / h + np.eye(h)).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    reset_launches()
    yield
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


# ------------------------------------------------------------ policy object


def test_policy_methods_match_reference():
    for name, pol in PRESETS.items():
        jpol = jprec.PRESETS[name]
        assert pol.is_native == jpol.is_native
        assert pol.descriptor() == jpol.descriptor()
        for dt in ("float32", "float64"):
            assert pol.bytes_ratio(dt) == jpol.bytes_ratio(dt)
    assert PRESETS["bf16_refined"].bytes_ratio(torch.float32) == 2.0
    assert PRESETS["bf16_store"].descriptor() != \
        PRESETS["bf16_refined"].descriptor()


# --------------------------------------- plain mixed versions against Pallas


@pytest.mark.parametrize("h,block", SHAPES)
def test_mixed_cholesky_matches_pallas(h, block):
    a = np.stack([_spd32(h, h + s) for s in range(2)])
    want = np.stack([np.asarray(j_chol(jnp.asarray(m), block,
                                       compute_dtype="bfloat16",
                                       accum_dtype="float32")) for m in a])
    got = chol_blocked.cholesky_blocked(torch.from_numpy(a), block,
                                        compute_dtype=BF)
    assert got.dtype == F32
    assert _rel(got, want) <= KERNEL_RTOL
    exact = np.linalg.cholesky(a.astype(np.float64))
    assert _rel(got, exact) > 1e-4          # the operands really were bf16


@pytest.mark.parametrize("transpose", [False, True], ids=["L", "LT"])
@pytest.mark.parametrize("h,block", SHAPES)
def test_mixed_trsm_matches_pallas(h, block, transpose):
    l = np.linalg.cholesky(_spd32(h, h).astype(np.float64)).astype(np.float32)
    g = np.random.default_rng(h + 1).standard_normal((h, 2)).astype(np.float32)
    want = j_trsm(jnp.asarray(l), jnp.asarray(g), block, transpose=transpose,
                  compute_dtype="bfloat16", accum_dtype="float32")
    got = trsm.solve_lower_blocked(torch.from_numpy(l), torch.from_numpy(g),
                                   block, transpose=transpose,
                                   compute_dtype=BF)
    assert got.dtype == F32
    assert _rel(got, want) <= KERNEL_RTOL
    # a 64-bit factor and rhs are cast to the accumulation dtype first
    got64 = trsm.solve_lower_blocked(
        torch.from_numpy(l).double(), torch.from_numpy(g).double(), block,
        transpose=transpose, compute_dtype=BF)
    assert got64.dtype == F32 and torch.equal(got64, got)


@functools.lru_cache(maxsize=None)
def _interp_case(h, block):
    """A bf16 Θ of three packed lower factors, so L(λ) = L₀ + 0.1 λ L₁ +
    0.01 λ² L₂ is well conditioned at every λ of LAMS; g (h,) float32."""
    def factor(seed):
        x = np.random.default_rng(seed).standard_normal((2 * h, h))
        return np.linalg.cholesky(x.T @ x / h + np.eye(h))
    vecs = [packing.pack_tril(torch.from_numpy(factor(h + s)), block)
            for s in range(3)]
    theta = torch.stack([vecs[0], 0.1 * vecs[1], 0.01 * vecs[2]]).to(BF)
    g = np.random.default_rng(h + 2).standard_normal(h).astype(np.float32)
    return theta, g


def _emulate_interp(theta, lam, g, h, block):
    """The Pallas kernel's stated arithmetic in numpy (float64 sums of
    exact bf16 products): off-diagonal tiles by bf16 Horner, every step
    rounded, from x rounded to bf16; diagonal tiles by float32 Horner,
    identity-padded, inverted and rounded to bf16; the solved segments and
    g_i − acc_i rounded to bf16 before their products."""
    th = theta.double().numpy().reshape(theta.shape[0], -1, block, block)
    nt, degree = packing.num_tiles(h, block), theta.shape[0] - 1
    pmap = packing.tile_pos_map(h, block)
    x32, xb = np.float32(lam), _bf(np.float32(lam))

    def tile(p):
        v = th[degree, p]
        for k in range(degree - 1, -1, -1):
            v = _bf(_bf(v * xb) + th[k, p])
        return v

    inv = []
    tail = packing._identity_tail(h, block)
    for i in range(nt):
        d = th[degree, pmap[i, i]].astype(np.float32)
        for k in range(degree - 1, -1, -1):
            d = (d * x32 + th[k, pmap[i, i]].astype(np.float32)
                 ).astype(np.float32)
        d = np.tril(d) + (tail if i == nt - 1 else 0)
        inv.append(_bf(np.linalg.inv(d.astype(np.float64)).astype(np.float32)))
    hp = nt * block
    gp = np.zeros(hp)
    gp[:h] = g
    w = np.zeros(hp)
    seg = [slice(i * block, (i + 1) * block) for i in range(nt)]
    for i in range(nt):
        acc = sum((tile(pmap[i, t]) @ _bf(w[seg[t]]) for t in range(i)),
                  np.zeros(block))
        w[seg[i]] = (inv[i] @ _bf(gp[seg[i]] - acc)).astype(np.float32)
    for i in range(nt - 1, -1, -1):
        acc = sum((tile(pmap[t, i]).T @ _bf(w[seg[t]])
                   for t in range(i + 1, nt)), np.zeros(block))
        w[seg[i]] = (inv[i].T @ _bf(w[seg[i]] - acc)).astype(np.float32)
    return w[:h]


@pytest.mark.parametrize("h,block", SHAPES)
def test_mixed_interp_solve_matches_pallas(h, block):
    theta, g = _interp_case(h, block)
    got = poly_interp.interp_solve(theta, torch.from_numpy(LAMS).float(),
                                   torch.from_numpy(g), h, block,
                                   compute_dtype=BF, accum_dtype=F32)
    assert got.dtype == F32
    jt = jnp.asarray(theta.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(j_interp(jt, jnp.asarray(LAMS, jnp.float32),
                               jnp.asarray(g), h, block,
                               compute_dtype="bfloat16",
                               accum_dtype="float32"))
    f64 = np.asarray(j_interp(jnp.asarray(theta.double().numpy()),
                              jnp.asarray(LAMS), jnp.asarray(g, jnp.float64),
                              h, block))
    for q, lam in enumerate(LAMS):
        assert _rel(got[q], _emulate_interp(theta, lam, g, h, block)) \
            <= EMULATION_RTOL
    assert _rel(got, f64) <= SOLVE_RTOL and _rel(want, f64) <= SOLVE_RTOL
    assert _rel(got, f64) > 1e-4            # the sweep really ran in bf16


def test_mixed_interp_solve_per_lambda_rhs():
    """``rhs_per_lam`` (the refinement's residuals) solves each λ's own
    right-hand side: the same as one call per λ with that rhs shared."""
    h, block = 48, 8
    theta, _ = _interp_case(h, block)
    lams = torch.from_numpy(LAMS).float()
    rhs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, h)).astype(np.float32))
    got = poly_interp.interp_solve(theta, lams, rhs, h, block,
                                   rhs_per_lam=True, compute_dtype=BF)
    for q in range(3):
        one = poly_interp.interp_solve(theta, lams[q:q + 1], rhs[q], h,
                                       block, compute_dtype=BF)
        assert torch.equal(got[q], one[0])


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def folds64():
    """The reference test's kernel-path problem: h=64, k=5, float32 data."""
    jf = props.regression_folds(h=64, n=192, k=5, seed=11,
                                dtype=jnp.float32)
    return jf, convert.folds_from_numpy(jf, device="cpu"), np.asarray(
        props.log_grid(31))


@functools.lru_cache(maxsize=None)
def _jax_run(backend, policy):
    jf = props.regression_folds(h=64, n=192, k=5, seed=11,
                                dtype=jnp.float32)
    return jengine.CVEngine(jengine.PiCholeskyStrategy(g=4, block=16),
                            backend=backend, block=16,
                            precision=policy).run(jf, props.log_grid(31))


def _port_run(folds, lams, backend, policy):
    return engine.CVEngine(engine.make_strategy("picholesky", g=4, block=16),
                           backend=backend, block=16, precision=policy,
                           device="cpu").run(folds, lams)


@pytest.mark.parametrize("policy", ["bf16_store", "bf16_refined"])
@pytest.mark.parametrize("backend,jax_backend", [("cuda", "pallas"),
                                                 ("reference", "reference")])
def test_engine_matches_jax_under_bf16(folds64, backend, jax_backend,
                                       policy):
    """The cuda backend (its mixed variants' plain versions on the CPU)
    against the JAX Pallas engine in interpret mode, and the reference
    backends against each other: curves within the bound, and under
    ``bf16_refined`` the same λ* (see the module docstring)."""
    _, folds, lams = folds64
    got = _port_run(folds, lams, backend, policy)
    want = _jax_run(jax_backend, policy)
    assert got.extras["engine"]["precision"] == policy
    np.testing.assert_allclose(got.errors, np.asarray(want.errors),
                               rtol=CURVE_RTOL, atol=CURVE_ATOL)
    if policy == "bf16_refined":
        assert int(np.argmin(got.errors)) == int(np.argmin(want.errors))
        assert got.best_lam == float(want.best_lam)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_bf16_refined_reproduces_fp32_argmin(folds64, backend):
    """``bf16_refined`` selects the port's own fp32 λ* (not the reference's
    ``[reference-144-32]`` case, which the JAX package breaks), its curve
    within the bound of fp32's and closer to it than ``bf16_store``'s."""
    _, folds, lams = folds64
    r32 = _port_run(folds, lams, backend, "fp32")
    r16 = _port_run(folds, lams, backend, "bf16_refined")
    r_store = _port_run(folds, lams, backend, "bf16_store")
    assert r16.best_lam == r32.best_lam
    np.testing.assert_allclose(r16.errors, r32.errors, rtol=CURVE_RTOL,
                               atol=CURVE_ATOL)
    d_store = np.max(np.abs(r_store.errors - r32.errors))
    d_ref = np.max(np.abs(r16.errors - r32.errors))
    assert d_ref < d_store, (d_ref, d_store)


def test_bf16_engine_on_float64_data_scores_at_float64():
    """Float32 solutions of a mixed policy on float64 folds score at
    float64 (θ promoted, as ``jnp`` promotes), on both backends alike."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((160, 24))
    y = x @ rng.standard_normal(24) + rng.standard_normal(160)
    from repro_torch.core import cv
    folds = cv.make_folds(x, y, 4, device="cpu")
    lams = np.logspace(-2, 1, 9)
    runs = [cv.cv_picholesky(folds, lams, block=8, backend=bk,
                             precision="bf16_refined", device="cpu")
            for bk in ("cuda", "reference")]
    for r in runs:
        assert r.errors.dtype == np.float64 and np.isfinite(r.errors).all()
    np.testing.assert_allclose(runs[0].errors, runs[1].errors,
                               rtol=CURVE_RTOL, atol=CURVE_ATOL)


# ------------------------------------------------------------- refinement


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_refinement_recovers_fp32_accuracy(backend):
    """One fp32 residual sweep contracts the bf16 interp_solve error by at
    least 10× (the ``bf16_refined`` mechanism); ``iters=0`` or a policy
    without refinement returns the same tensor."""
    h, block = 48, 8
    a = torch.from_numpy(np.asarray(props.spd_matrix(h, dtype=jnp.float32)))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        h).astype(np.float32))
    sample = picholesky.choose_sample_lambdas(1e-2, 1e1, 5, device="cpu")
    lams = torch.logspace(-2, 1, 9, dtype=torch.float64)

    def bk(policy):
        return backends.resolve_backend(backend, block=block,
                                        precision=policy, device="cpu")

    model32 = picholesky.fit(a, sample, 2, block=block, backend=bk("fp32"))
    ref = model32.solve(lams, g, backend=bk("fp32"))
    model16 = picholesky.fit(a, sample, 2, block=block,
                             backend=bk("bf16_store"))
    raw = model16.solve(lams, g, backend=bk("bf16_store"))
    refined = picholesky.refine_solutions(model16, a, g, lams, raw,
                                          backend=bk("bf16_refined"))
    err_raw = float((raw - ref).norm())
    err_ref = float((refined - ref).norm())
    assert err_ref < err_raw / 10, (err_raw, err_ref)
    assert picholesky.refine_solutions(model16, a, g, lams, raw,
                                       backend=bk("bf16_store")) is raw
    assert picholesky.refine_solutions(model16, a, g, lams, raw, iters=0,
                                       backend=bk("bf16_refined")) is raw
    # a scalar λ: (h,) in, (h,) out, the same as the grid's entry
    one = picholesky.refine_solutions(model16, a, g, lams[3], raw[3],
                                      backend=bk("bf16_refined"))
    assert one.shape == (h,)
    torch.testing.assert_close(one, refined[3], rtol=1e-5, atol=1e-6)


def test_refinement_batched_over_folds_is_per_fold():
    """Folds are a batch dimension of ``refine_solutions``: one call on
    (k, …) equals k calls on one fold each."""
    h, block = 32, 8
    a = torch.stack([torch.from_numpy(np.asarray(props.spd_matrix(
        h, seed=s, dtype=jnp.float32))) for s in range(3)])
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, h)).astype(np.float32))
    sample = picholesky.choose_sample_lambdas(1e-2, 1e1, 5, device="cpu")
    lams = torch.logspace(-2, 1, 5, dtype=torch.float64)
    bk = backends.resolve_backend("cuda", block=block,
                                  precision="bf16_refined", device="cpu")
    model = picholesky.fit(a, sample, 2, block=block, backend=bk)
    raw = model.solve(lams, g, backend=bk)
    both = picholesky.refine_solutions(model, a, g, lams, raw, backend=bk)
    for f in range(3):
        one = picholesky.PiCholesky(model.theta[f], model.center, h, block)
        torch.testing.assert_close(
            both[f], picholesky.refine_solutions(one, a[f], g[f], lams,
                                                 raw[f], backend=bk),
            rtol=1e-5, atol=1e-6)


def test_bf16_packed_solve_accumulates_in_fp32():
    """The reference backend's packed solve of a bf16-stored factor returns
    fp32 solutions within bf16 rounding of the exact solve (accumulation
    never in bf16); the cuda backend has no mixed packed trsm yet and
    refuses (``tests/test_torch_device.py``)."""
    h, block = 32, 8
    a = np.asarray(props.spd_matrix(h, dtype=jnp.float32), np.float64)
    l = torch.from_numpy(np.linalg.cholesky(a)).float()
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        h).astype(np.float32))
    pf = packing.PackedFactor.from_dense(l, block).astype(BF)
    bk = backends.resolve_backend("reference", precision="bf16_store",
                                  device="cpu")
    out = bk.solve_packed(pf, g)
    assert out.dtype == F32
    exact = np.linalg.solve(a, g.double().numpy())
    assert _rel(out, exact) < 5e-2


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_refinement_composes_with_chunking(backend):
    """The per-chunk refinement keeps chunked == unchunked (same policy
    both sides: the same arithmetic per λ)."""
    jf = props.regression_folds(h=32, k=4, dtype=jnp.float32)
    folds = convert.folds_from_numpy(jf, device="cpu")
    lams = np.asarray(props.log_grid(31))

    def run(chunk):
        return engine.CVEngine(
            engine.make_strategy("picholesky", g=4, block=8),
            backend=backend, block=8, precision="bf16_refined",
            lam_chunk=chunk, device="cpu").run(folds, lams)

    np.testing.assert_allclose(run(7).errors, run(None).errors, rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------- storage and chunk


def test_auto_chunk_doubles_under_bf16_storage():
    strat = engine.make_strategy("picholesky", g=4, block=16)
    c32 = engine.CVEngine(strat, precision="fp32",
                          device="cpu")._resolve_chunk(64, torch.float32)
    c16 = engine.CVEngine(strat, precision="bf16_store",
                          device="cpu")._resolve_chunk(64, torch.float32)
    assert c16 == 2 * c32
    jstrat = jengine.PiCholeskyStrategy(g=4, block=16)
    assert c16 == jengine.CVEngine(jstrat, precision="bf16_store"
                                   )._resolve_chunk(10_000, 64, jnp.float32)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_fit_stores_theta_in_bf16_with_fp32_center(backend):
    """Θ at the store dtype (bf16), the center at the fit dtype (float32),
    and Θ the bf16 rounding of the float32 fit of the same anchors (on the
    cuda backend the anchors come from the mixed Cholesky); on the
    reference backend also within bf16 rounding of the native fit, as the
    JAX test holds it."""
    a = torch.from_numpy(np.asarray(props.spd_matrix(32)))        # float64
    sample = picholesky.choose_sample_lambdas(1e-2, 1.0, 4, device="cpu")

    def bk(policy):
        return backends.resolve_backend(backend, block=8, precision=policy,
                                        device="cpu")

    native = picholesky.fit(a, sample, 2, block=8, backend=bk("native"))
    assert native.theta.dtype == torch.float64
    half = picholesky.fit(a, sample, 2, block=8, backend=bk("bf16_store"))
    assert half.theta.dtype == BF
    assert half.center.dtype == F32
    eye = torch.eye(32, dtype=a.dtype)
    anchors = bk("bf16_store").cholesky(a + sample[:, None, None] * eye)
    fit32 = picholesky.fit(None, sample, 2, block=8, factors=anchors,
                           backend=bk("fp32"))
    assert fit32.theta.dtype == F32
    assert torch.equal(half.theta, fit32.theta.to(BF))
    if backend == "reference":
        np.testing.assert_allclose(half.theta.double().numpy(),
                                   native.theta.numpy(), rtol=1e-2,
                                   atol=1e-2)
    assert resolve_precision("bf16_store").bytes_ratio(torch.float32) == 2.0

"""The dense-factor and packed-factor routes of the port against the JAX
package, float64: the kernels ``unpack_tril``, ``interp_factors`` and the
packed trsm (their CPU paths are the plain versions) against the Pallas
kernels in interpret mode; ``eval_factor`` / ``evaluate`` and the packed
evaluations; ``solve_packed`` with one right-hand side shared by a batch of
factors; the host-loop CV drivers; the damped Gauss–Newton head.

Tolerances: unpacking moves values, so it is exact.  Horner, the packed
trsm and the drivers run the same float64 arithmetic on both sides in
another summation order (XLA vs ATen) and, for the kernel's plain
substitution, with a triangular solve per diagonal tile where the Pallas
kernel multiplies by the pre-inverted tile; they agree to a few ulps times
the conditioning, so 1e-10 relative to the largest value leaves orders of
magnitude of room (the CV curves, 1e-9, as in test_torch_engine.py).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cv as jcv  # noqa: E402
from repro.core import cv_host as jhost  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import picholesky as jpi  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro.kernels.packed_trsm import solve_lower_packed as j_lower_packed  # noqa: E402
from repro.kernels.packed_trsm import solve_packed as j_solve_packed  # noqa: E402
from repro.kernels.poly_interp import interp_factors as j_interp_factors  # noqa: E402
from repro.kernels.tri_pack import unpack_tril as j_unpack  # noqa: E402
from repro.optim import gauss_newton as jgn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backends, cv_host, engine, packing  # noqa: E402
from repro_torch.core import picholesky as tpi  # noqa: E402
from repro_torch.core import solvers  # noqa: E402
from repro_torch.kernels import (LAUNCHES, packed_trsm, poly_interp,  # noqa: E402
                                 reset_launches, tri_pack)
from repro_torch.optim import GNState, damped_gauss_newton_head  # noqa: E402

RTOL = 1e-10
CURVE_RTOL = 1e-9
SHAPES = [(32, 8), (32, 16), (37, 8), (37, 16), (48, 8), (48, 16)]
SAMPLES = np.logspace(-3, 2, 4)
FIXTURE = Path(__file__).parent / "data" / "torch_table4.npz"


def _spd(h, seed):
    x = np.random.default_rng(seed).standard_normal((2 * h, h))
    return x.T @ x + h * np.eye(h)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _packed_factors(h, block, seeds):
    """(n, P) packed Cholesky factors of SPD matrices, as numpy."""
    ls = np.stack([np.linalg.cholesky(_spd(h, s)) for s in seeds])
    return packing.pack_tril(torch.from_numpy(ls), block).numpy()


def _backend(name):
    return backends.resolve_backend(name, device="cpu")


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    reset_launches()
    yield
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


# ----------------------------------------------------------------- kernels


@pytest.mark.parametrize("h,block", SHAPES)
def test_unpack_tril_exact(h, block):
    vec = _packed_factors(h, block, (h, h + 1))
    want = np.stack([np.asarray(j_unpack(jnp.asarray(v), h, block))
                     for v in vec])
    t = torch.from_numpy(vec)
    np.testing.assert_array_equal(tri_pack.unpack_tril(t, h, block).numpy(),
                                  want)
    for name in ("reference", "cuda"):
        np.testing.assert_array_equal(
            _backend(name).unpack_tril(t, h, block).numpy(), want)


@pytest.mark.parametrize("h,block", SHAPES)
def test_interp_factors(h, block):
    """Θ fitted by the JAX package for two folds and carried across; a λ
    grid that leaves the sample range on both sides."""
    models = [jpi.fit(jnp.asarray(_spd(h, s)), jnp.asarray(SAMPLES), 2,
                      block=block, basis="centered") for s in (h, h + 2)]
    theta = torch.stack([convert.picholesky_from_numpy(m, device="cpu").theta
                         for m in models])
    center = float(models[0].center)
    lams = np.array([1e-4, 0.02, 3.0, 250.0])
    want = np.stack([np.asarray(j_interp_factors(
        m.theta, jnp.asarray(lams), h, block, center=m.center))
        for m in models])
    got = poly_interp.interp_factors(theta, torch.from_numpy(lams), h, block,
                                     center=center)
    assert got.shape == (2, 4, h, h)
    assert _rel(got.numpy(), want) <= RTOL
    for name in ("reference", "cuda"):
        out = _backend(name).interp_factors(
            theta, torch.from_numpy(lams), h=h, block=block, center=center)
        assert _rel(out.numpy(), want) <= RTOL


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("h,block", SHAPES)
def test_solve_lower_packed(h, block, transpose):
    vec = _packed_factors(h, block, (3, 4))
    g = np.random.default_rng(h).standard_normal((2, h, 3))
    got = packed_trsm.solve_lower_packed(torch.from_numpy(vec),
                                         torch.from_numpy(g), h, block,
                                         transpose=transpose).numpy()
    for b in range(2):
        want = np.asarray(j_lower_packed(jnp.asarray(vec[b]),
                                         jnp.asarray(g[b]), h, block,
                                         transpose=transpose))
        assert _rel(got[b], want) <= RTOL
    # the vector form squeezes like the reference
    one = packed_trsm.solve_lower_packed(torch.from_numpy(vec[0]),
                                         torch.from_numpy(g[0, :, 0]), h,
                                         block, transpose=transpose)
    assert one.shape == (h,)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("h,block", SHAPES)
def test_solve_packed_shared_rhs(h, block, backend):
    """A batch of three packed factors, one g shared by all of them."""
    vec = _packed_factors(h, block, (5, 6, 7))
    g = np.random.default_rng(h + 1).standard_normal(h)
    pf = packing.PackedFactor(torch.from_numpy(vec), h, block)
    got = solvers.solve_packed(pf, torch.from_numpy(g), backend=backend)
    assert got.shape == (3, h)
    want = np.stack([np.asarray(j_solve_packed(jnp.asarray(v), jnp.asarray(g),
                                               h, block)) for v in vec])
    assert _rel(got.numpy(), want) <= RTOL
    # the kernel wrapper, with g written out over the batch
    wrapped = packed_trsm.solve_packed(torch.from_numpy(vec),
                                       torch.from_numpy(g).expand(3, h), h,
                                       block)
    assert _rel(wrapped.numpy(), want) <= RTOL


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_solve_packed_batched_factors_share_one_rhs(backend):
    """Regression: ``solve_packed`` batches over the factors' leading
    dimensions and shares one g (the reference's ``vmap(in_axes=(0,
    None))``; ``tests/test_packed_pipeline.py::
    test_solve_packed_batched_factors``); the reference backend used to
    index g as if it carried the factors' batch, and the kernel backend
    refused the call."""
    h, block, q = 32, 8, 5
    a = _spd(h, 9)
    lams = np.logspace(-2, 0, q)
    ls = np.stack([np.linalg.cholesky(a + lam * np.eye(h)) for lam in lams])
    g = np.random.default_rng(3).standard_normal(h)
    jpf = jpack.PackedFactor(vec=jpack.pack_tril(jnp.asarray(ls), block),
                             h=h, block=block)
    want = np.asarray(jsolvers.solve_packed(jpf, jnp.asarray(g)))
    pf = convert.packed_factor_from_numpy(jpf, device="cpu")
    got = solvers.solve_packed(pf, torch.from_numpy(g), backend=backend)
    assert got.shape == (q, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # multi-column g is shared the same way, and a (…, h) g is refused
    g2 = np.stack([g, -2 * g], axis=1)
    two = solvers.solve_packed(pf, torch.from_numpy(g2), backend=backend)
    assert two.shape == (q, h, 2)
    np.testing.assert_allclose(two[..., 1].numpy(), -2 * want, rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="shared"):
        solvers.solve_packed(pf, torch.zeros(q, h, dtype=torch.float64),
                             backend=backend)


def test_kernel_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor off the CPU goes to the kernel path, whose checks refuse a
    tensor that is not on a CUDA device — no fallback."""
    h, block = 32, 16
    p_size = packing.packed_size(h, block)
    vec = torch.empty(2, p_size, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tri_pack.unpack_tril(vec, h, block)
    theta = torch.empty(2, 3, p_size, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        poly_interp.interp_factors(theta, torch.ones(2, device="meta",
                                                     dtype=torch.float64),
                                   h, block)
    with pytest.raises(ValueError, match="CUDA tensor"):
        packed_trsm.solve_lower_packed(
            vec, torch.empty(2, h, device="meta", dtype=torch.float64), h,
            block)


# ------------------------------------------------------- factor evaluation


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("h,block", [(37, 8), (48, 16)])
def test_eval_factor_and_evaluate(h, block, backend):
    a = _spd(h, 11)
    jm = jpi.fit(jnp.asarray(a), jnp.asarray(SAMPLES), 2, block=block)
    tm = tpi.fit(torch.from_numpy(a), torch.from_numpy(SAMPLES), 2,
                 block=block, backend=backend)
    lams = np.array([2e-3, 0.5, 30.0])
    # a Python float is float64, as in the reference's 64-bit mode
    one = tm.eval_factor(0.5, backend=backend)
    assert one.shape == (h, h) and one.dtype == torch.float64
    assert _rel(one.numpy(), np.asarray(jm.eval_factor(0.5))) <= RTOL
    many = tm.eval_factor(torch.from_numpy(lams), backend=backend)
    want = np.asarray(jm.eval_factor(jnp.asarray(lams)))
    assert many.shape == (3, h, h)
    assert _rel(many.numpy(), want) <= RTOL
    assert _rel(tpi.evaluate(tm, torch.from_numpy(lams)).numpy(),
                np.asarray(jpi.evaluate(jm, jnp.asarray(lams)))) <= RTOL
    pf = tm.eval_packed_factor(torch.from_numpy(lams))
    jpf = jm.eval_packed_factor(jnp.asarray(lams))
    assert (pf.h, pf.block) == (jpf.h, jpf.block)
    assert _rel(pf.vec.numpy(), np.asarray(jpf.vec)) <= RTOL
    assert _rel(tpi.evaluate_packed(tm, torch.from_numpy(lams)).vec.numpy(),
                np.asarray(jpi.evaluate_packed(jm, jnp.asarray(lams)).vec)
                ) <= RTOL
    # the dense and the packed route give the same solutions
    g = np.random.default_rng(12).standard_normal(h)
    dense = solvers.solve_from_factor(many, torch.from_numpy(g).expand(3, h),
                                      backend=backend)
    packed = solvers.solve_from_factor(pf, torch.from_numpy(g),
                                       backend=backend)
    swept = solvers.solve_interpolant_sweep(tm, torch.from_numpy(lams),
                                            torch.from_numpy(g),
                                            backend=backend)
    want = np.asarray(jsolvers.solve_interpolant_sweep(
        jm, jnp.asarray(lams), jnp.asarray(g)))
    for got in (dense, packed, swept):
        assert _rel(got.numpy(), want) <= RTOL


def test_eval_factor_batched_folds():
    """Leading dimensions of Θ are folds: a scalar λ gives (…, h, h)."""
    h, block = 37, 8
    a = np.stack([_spd(h, 13), _spd(h, 14)])
    tm = tpi.fit(torch.from_numpy(a), torch.from_numpy(SAMPLES), 2,
                 block=block)
    got = tm.eval_factor(0.3)
    assert got.shape == (2, h, h)
    for f in range(2):
        jm = jpi.fit(jnp.asarray(a[f]), jnp.asarray(SAMPLES), 2, block=block)
        assert _rel(got[f].numpy(), np.asarray(jm.eval_factor(0.3))) <= RTOL


def test_sample_lambdas_default_to_the_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpi.choose_sample_lambdas(1e-3, 1.0, 4)
    assert tpi.choose_sample_lambdas(1e-3, 1.0, 4,
                                     device="cpu").device.type == "cpu"


# ------------------------------------------------------- host CV drivers


@pytest.fixture(scope="module")
def table4():
    """The Table-4 fixture's data (n=420, h=144, interior λ*) as folds of
    both packages."""
    data = np.load(FIXTURE)
    k = int(data["k"])
    jf = jcv.make_folds(jnp.asarray(data["x"]), jnp.asarray(data["y"]), k)
    return (jf, convert.folds_from_numpy(jf, device="cpu"),
            np.asarray(data["lams"]), int(data["g"]), int(data["block"]))


def _host_runs(name, g, block):
    if name == "exact":
        return (lambda jf, lams: jhost.host_cv_exact_cholesky(jf, lams),
                lambda tf, lams, bk: cv_host.host_cv_exact_cholesky(
                    tf, lams, backend=bk))
    if name == "picholesky":
        return (lambda jf, lams: jhost.host_cv_picholesky(jf, lams, g,
                                                          block=block),
                lambda tf, lams, bk: cv_host.host_cv_picholesky(
                    tf, lams, g, block=block, backend=bk))
    return (lambda jf, lams: jhost.host_cv_pinrmse(jf, lams, g),
            lambda tf, lams, bk: cv_host.host_cv_pinrmse(tf, lams, g,
                                                         backend=bk))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name", ["exact", "picholesky", "pinrmse"])
def test_host_drivers_match_jax(table4, name, backend):
    jf, tf, lams, g, block = table4
    jrun, trun = _host_runs(name, g, block)
    want = jrun(jf, jnp.asarray(lams))
    got = trun(tf, lams, backend)
    np.testing.assert_allclose(got.errors, np.asarray(want.errors),
                               rtol=CURVE_RTOL)
    assert int(np.argmin(got.errors)) == int(np.argmin(want.errors))
    assert got.best_lam == float(want.best_lam)
    assert got.n_exact_chol == want.n_exact_chol
    if name != "exact":
        np.testing.assert_allclose(got.extras["sample_lams"],
                                   np.asarray(want.extras["sample_lams"]),
                                   rtol=4e-15)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name", ["exact", "picholesky"])
def test_host_drivers_match_port_engine(table4, name, backend):
    """The host loop (folds one at a time, dense factors) is the engine's
    oracle: same curve and λ* as the batched, λ-chunked engine."""
    _, tf, lams, g, block = table4
    _, trun = _host_runs(name, g, block)
    strategy = (engine.make_strategy("exact") if name == "exact" else
                engine.make_strategy("picholesky", g=g, block=block))
    want = engine.CVEngine(strategy, backend=backend, block=block,
                           device="cpu").run(tf, lams)
    got = trun(tf, lams, backend)
    np.testing.assert_allclose(got.errors, want.errors, rtol=CURVE_RTOL)
    assert int(np.argmin(got.errors)) == int(np.argmin(want.errors))


def test_host_drivers_ragged_tiles():
    """h % block ≠ 0 through the dense route on both backends."""
    rng = np.random.default_rng(21)
    x, y = rng.standard_normal((150, 37)), rng.standard_normal(150)
    jf = jcv.make_folds(jnp.asarray(x), jnp.asarray(y), 3)
    tf = convert.folds_from_numpy(jf, device="cpu")
    lams = np.logspace(-2, 2, 9)
    want = jhost.host_cv_picholesky(jf, jnp.asarray(lams), 4, block=16)
    for backend in ("reference", "cuda"):
        got = cv_host.host_cv_picholesky(tf, lams, 4, block=16,
                                         backend=backend)
        np.testing.assert_allclose(got.errors, np.asarray(want.errors),
                                   rtol=CURVE_RTOL)


# ---------------------------------------------------- Gauss–Newton head


def _quadratic_problem(d, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(4 * d, d)
    return x.T @ x / 4 + np.eye(d), rs.randn(d)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_gauss_newton_steps_match_reference(backend):
    a, b = _quadratic_problem(40, 1)
    jstate, jstep = jgn.damped_gauss_newton_head(jnp.asarray(a), (1e-2, 1e0),
                                                 g_samples=6, block=8)
    tstate, tstep = damped_gauss_newton_head(torch.from_numpy(a), (1e-2, 1e0),
                                             g_samples=6, block=8,
                                             backend=backend)
    assert isinstance(tstate, GNState)
    assert _rel(tstate.model.theta.numpy(), jstate.model.theta) <= RTOL
    assert float(tstate.lam) == pytest.approx(float(jstate.lam), rel=1e-15)
    # carried across, the reference's own state steps the same way
    carried = convert.gn_state_from_numpy(jstate, device="cpu")
    for lam in (0.013, 0.2, 0.9, 1e3, 1e-5):
        jd, jstate = jstep(jstate, jnp.asarray(b), jnp.asarray(lam))
        td, tstate = tstep(tstate, torch.from_numpy(b), lam)
        cd, carried = tstep(carried, torch.from_numpy(b), lam)
        assert td.shape == (40,)
        assert _rel(td.numpy(), jd) <= RTOL
        assert _rel(cd.numpy(), jd) <= RTOL
        assert float(tstate.lam) == float(jstate.lam) == float(carried.lam)


def test_gauss_newton_solves_damped_system_and_clips():
    """The reference's own checks (tests/test_optim.py) on the port."""
    a, b = _quadratic_problem(32, 1)
    state, step = damped_gauss_newton_head(torch.from_numpy(a), (1e-2, 1e0),
                                           g_samples=6, block=8)
    delta, state = step(state, torch.from_numpy(b), 0.2)
    expect = np.linalg.solve(a + 0.2 * np.eye(32), b)
    assert np.linalg.norm(delta.numpy() - expect) / np.linalg.norm(expect) \
        < 1e-2
    delta, state = step(state, torch.from_numpy(b), 1e3)
    assert float(state.lam) <= 1.0 + 1e-9
    assert bool(torch.isfinite(delta).all())

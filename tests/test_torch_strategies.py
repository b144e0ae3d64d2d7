"""The paper's other CV algorithms in the port against the JAX package, on
the same folds: warm-start, PINRMSE, MChol, the SVD family (full,
truncated, randomized on JAX's own test matrix), low-rank ACV and the
host-loop SVD oracle; ``n_exact_chol`` and ``extras['sample_lams']``;
``make_low_rank_dataset``'s checks and properties.  Every Cholesky-based
algorithm runs on both backends (the kernel backend on its plain versions
here)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cv as jcv, cv_host as jhost  # noqa: E402
from repro.core import engine as jengine, solvers as jsolvers  # noqa: E402
from repro.core.precision import PRESETS as JPRESETS  # noqa: E402
from repro.data import make_low_rank_dataset as jlow_rank  # noqa: E402
from repro.data import make_regression_dataset  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cv, cv_host, engine, solvers  # noqa: E402
from repro_torch.core.backends import CountingBackend  # noqa: E402
from repro_torch.core.backends import ReferenceBackend  # noqa: E402
from repro_torch.core.precision import PRESETS  # noqa: E402
from repro_torch.data import make_low_rank_dataset  # noqa: E402

#: same float64 algorithm on both sides, other summation orders (measured
#: ≤ 1e-13 for PINRMSE, the SVD family, low rank and MChol)
CURVE_RTOL = 1e-9
#: Warm-start: the damped residual fit Δθ = (VᵀV + μ·diag(VᵀV))⁻¹ VᵀR with
#: μ = 1e-6 is regularized by μ alone in the directions its g_rest nodes do
#: not see (all but g_rest of the r + 1 = 3), where round-off is amplified
#: up to ~1/μ.  The port applies that solve to Vᵀ on the host, then to the
#: residuals (the reference solves against VᵀR): the same sum in another
#: order.  test_warmstart_tolerance_across_problems holds these over other
#: seeds, widths and grids: g_rest ≥ 2 stays within the engine's 1e-9;
#: g_rest 1 (one node for three coefficients) needs 1e-6.
WARM_RTOL = {1: 1e-6, 2: 1e-9, 3: 1e-9}
H, BLOCK, K, Q = 40, 16, 4, 7
LAMS = np.logspace(-3, 2, Q)
BACKENDS = ["reference", "cuda"]
CHUNKS = [None, 3, "auto"]
#: the reported sample shifts: 10 ** (log λ / log 10) in another order
#: than XLA's, a few ulps (the bound test_torch_factor_path.py holds)
SAMPLE_RTOL = 4e-15


@pytest.fixture(scope="module")
def folds():
    x, y = make_regression_dataset(jax.random.PRNGKey(3), 240, H,
                                   dtype=jnp.float64)
    jf = jcv.make_folds(x, y, K)
    return jf, convert.folds_from_numpy(jf, device="cpu")


@pytest.fixture(scope="module")
def low_rank_folds():
    x, y = jlow_rank(jax.random.PRNGKey(3), 32, 96, 8, dtype=jnp.float64)
    jf = jcv.make_folds(x, y, 4)
    return jf, convert.folds_from_numpy(jf, device="cpu")


_JAX: dict = {}


def _jax_run(jf, name, **params):
    """The JAX engine's result for (name, params), computed once."""
    key = (id(jf), name, tuple(sorted(params.items())))
    if key not in _JAX:
        _JAX[key] = jengine.CVEngine(
            jengine.make_strategy(name, **params), backend="reference",
            lam_chunk=None).run(jf, jnp.asarray(LAMS))
    return _JAX[key]


def _assert_same(res, want, rtol=CURVE_RTOL):
    np.testing.assert_allclose(res.errors, np.asarray(want.errors), rtol=rtol)
    assert res.best_lam == want.best_lam
    assert res.n_exact_chol == want.n_exact_chol


@pytest.mark.parametrize("g_rest", [1, 2, 3])
@pytest.mark.parametrize("lam_chunk", CHUNKS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_warmstart_matches_jax(folds, backend, lam_chunk, g_rest):
    jf, tf = folds
    strat = engine.make_strategy("picholesky_warmstart", g_rest=g_rest,
                                 block=BLOCK)
    res = engine.CVEngine(strat, backend=backend, block=BLOCK,
                          lam_chunk=lam_chunk, device="cpu").run(tf, LAMS)
    want = _jax_run(jf, "picholesky_warmstart", g_rest=g_rest, block=BLOCK)
    _assert_same(res, want, WARM_RTOL[g_rest])
    assert res.n_exact_chol == 4 + K * g_rest


@pytest.mark.parametrize("g_rest", [1, 2, 3])
@pytest.mark.parametrize("seed, h, lo, hi", [(0, 40, -3, 0), (1, 64, -3, 0),
                                             (0, 96, -4, 1), (1, 40, -3, 2)])
def test_warmstart_tolerance_across_problems(seed, h, lo, hi, g_rest):
    """WARM_RTOL on other data, widths and λ ranges than the fixture's
    (13 λs, 4 folds, block 16)."""
    x, y = make_regression_dataset(jax.random.PRNGKey(seed), 6 * h, h,
                                   dtype=jnp.float64)
    jf = jcv.make_folds(x, y, 4)
    lams = np.logspace(lo, hi, 13)
    res = engine.CVEngine(
        engine.make_strategy("picholesky_warmstart", g_rest=g_rest,
                             block=BLOCK), backend="cuda", block=BLOCK,
        device="cpu").run(convert.folds_from_numpy(jf, device="cpu"), lams)
    want = jengine.CVEngine(
        jengine.make_strategy("picholesky_warmstart", g_rest=g_rest,
                              block=BLOCK), backend="reference",
        lam_chunk=None).run(jf, jnp.asarray(lams))
    _assert_same(res, want, WARM_RTOL[g_rest])


def test_warmstart_driver_reports_anchor_shifts(folds):
    jf, tf = folds
    res = cv.cv_picholesky_warmstart(tf, LAMS, g_first=4, g_rest=2,
                                     block=BLOCK, device="cpu")
    want = jcv.cv_picholesky_warmstart(jf, jnp.asarray(LAMS), g_first=4,
                                       g_rest=2, block=BLOCK)
    _assert_same(res, want, WARM_RTOL[2])
    np.testing.assert_allclose(res.extras["sample_lams"],
                               np.asarray(want.extras["sample_lams"]),
                               rtol=SAMPLE_RTOL)


@pytest.mark.parametrize("lam_chunk", CHUNKS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_pinrmse_matches_jax(folds, backend, lam_chunk):
    jf, tf = folds
    res = engine.CVEngine(engine.make_strategy("pinrmse"), backend=backend,
                          lam_chunk=lam_chunk, device="cpu").run(tf, LAMS)
    _assert_same(res, _jax_run(jf, "pinrmse"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_pinrmse_driver_and_host_oracle(folds, backend):
    jf, tf = folds
    res = cv.cv_pinrmse(tf, LAMS, g=4, degree=2, backend=backend,
                        device="cpu")
    want = jcv.cv_pinrmse(jf, jnp.asarray(LAMS), g=4, degree=2)
    _assert_same(res, want)
    np.testing.assert_allclose(res.extras["sample_lams"],
                               np.asarray(want.extras["sample_lams"]),
                               rtol=SAMPLE_RTOL)
    host = cv_host.host_cv_pinrmse(tf, LAMS, g=4, degree=2, backend=backend)
    np.testing.assert_allclose(res.errors, host.errors, rtol=CURVE_RTOL)


@pytest.mark.parametrize("c, s, s0", [(0.0, 1.5, 0.05), (-1.5, 1.5, 0.0025)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_multilevel_cholesky_matches_jax(folds, backend, c, s, s0):
    """The same visited λs (compared as floats, bit for bit), the same
    errors and ``n_chol``; the visit order is the search's."""
    jf, tf = folds
    res = cv.cv_multilevel_cholesky(tf, c, s, s0, backend=backend,
                                    device="cpu")
    want = jcv.cv_multilevel_cholesky(jf, c, s, s0)
    np.testing.assert_array_equal(res.lams, np.asarray(want.lams))
    np.testing.assert_allclose(res.errors, np.asarray(want.errors),
                               rtol=CURVE_RTOL)
    assert res.best_lam == want.best_lam
    assert res.n_exact_chol == want.n_exact_chol
    visited = res.extras["visited_lams"]
    assert sorted(visited) == list(res.lams)
    assert visited[:3] == [10.0 ** (c - s), 10.0 ** c, 10.0 ** (c + s)]
    assert res.n_exact_chol == K * len(visited)


def _omega(k_trunc, seed=5):
    """JAX's r-SVD test matrix for key ``seed`` (solvers.py:140)."""
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.normal(key, (H, k_trunc + 10),
                                             jnp.float64))


@pytest.mark.parametrize("mode, k_trunc", [("full", 0), ("truncated", 10),
                                           ("randomized", 10)])
@pytest.mark.parametrize("lam_chunk", [None, 3])
def test_svd_matches_jax(folds, mode, k_trunc, lam_chunk):
    jf, tf = folds
    key, omega = _omega(k_trunc)
    strat = engine.make_strategy(
        "svd", mode=mode, k_trunc=k_trunc,
        omega=torch.tensor(omega) if mode == "randomized" else None)
    res = engine.CVEngine(strat, lam_chunk=lam_chunk,
                          device="cpu").run(tf, LAMS)
    want = jengine.CVEngine(
        jengine.make_strategy("svd", mode=mode, k_trunc=k_trunc,
                              key=key if mode == "randomized" else None),
        lam_chunk=None).run(jf, jnp.asarray(LAMS))
    _assert_same(res, want)
    assert res.n_exact_chol == 0


@pytest.mark.parametrize("mode, k_trunc", [("full", 0), ("truncated", 10),
                                           ("randomized", 10)])
def test_host_cv_svd_matches_jax(folds, mode, k_trunc):
    jf, tf = folds
    key, omega = _omega(k_trunc)
    res = cv_host.host_cv_svd(tf, LAMS, mode, k_trunc,
                              torch.tensor(omega))
    want = jhost.host_cv_svd(jf, jnp.asarray(LAMS), mode, k_trunc, key)
    _assert_same(res, want)
    drv = cv.cv_svd(tf, LAMS, mode, k_trunc, torch.tensor(omega),
                    device="cpu")
    np.testing.assert_allclose(drv.errors, res.errors, rtol=CURVE_RTOL)


def test_full_svd_equals_exact_ridge(folds):
    """The SVD route is the exact ridge path by another route."""
    _, tf = folds
    svd = cv.cv_svd(tf, LAMS, device="cpu")
    exact = cv.cv_exact_cholesky(tf, LAMS, device="cpu")
    np.testing.assert_allclose(svd.errors, exact.errors, rtol=CURVE_RTOL)


def test_svd_solvers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((60, H))
    y = rng.standard_normal(60)
    lams = np.logspace(-2, 1, 5)
    xt, yt, lt = (torch.from_numpy(a) for a in (x, y, lams))
    xj, yj, lj = (jnp.asarray(a) for a in (x, y, lams))
    key, omega = _omega(12)
    for got, want in (
            (solvers.solve_svd(xt, yt, lt), jsolvers.solve_svd(xj, yj, lj)),
            (solvers.solve_truncated_svd(xt, yt, lt, 12),
             jsolvers.solve_truncated_svd(xj, yj, lj, 12)),
            (solvers.solve_randomized_svd(xt, yt, lt, 12,
                                          omega=torch.tensor(omega)),
             jsolvers.solve_randomized_svd(xj, yj, lj, 12, key))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)
    q = solvers.randomized_range_finder(xt, 12, omega=torch.tensor(omega))
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(22), atol=1e-12)
    with pytest.raises(ValueError, match="omega must be"):
        solvers.randomized_range_finder(xt, 12, omega=torch.zeros(H, 5))
    with pytest.raises(ValueError, match="unknown SVD mode"):
        solvers.svd_ridge_factors(xt, yt, "qr")
    # a generator seeds the test matrix: the same seed, the same basis
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    torch.testing.assert_close(solvers.randomized_range_finder(xt, 12, g1),
                               solvers.randomized_range_finder(xt, 12, g2),
                               rtol=0, atol=0)
    # by default a generator seeded 0 on x's device
    torch.testing.assert_close(
        solvers.randomized_range_finder(xt, 12),
        solvers.randomized_range_finder(xt, 12,
                                        torch.Generator().manual_seed(0)),
        rtol=0, atol=0)


@pytest.mark.parametrize("rank", [None, 64, 5])
@pytest.mark.parametrize("lam_chunk", [None, 3])
def test_low_rank_matches_jax(low_rank_folds, rank, lam_chunk):
    jf, tf = low_rank_folds
    res = engine.CVEngine(engine.make_strategy("low_rank", rank=rank),
                          lam_chunk=lam_chunk, device="cpu").run(tf, LAMS)
    _assert_same(res, _jax_run(jf, "low_rank", rank=rank))


@pytest.mark.parametrize("backend", BACKENDS)
def test_low_rank_full_rank_equals_exact(low_rank_folds, backend):
    """rank=None (and any rank ≥ rank(X)) is the exact ridge path: the
    reference's own claim (src/repro/core/engine.py:497)."""
    _, tf = low_rank_folds
    exact = cv.cv_exact_cholesky(tf, LAMS, backend=backend, device="cpu")
    for rank in (None, 24):          # n_tr = 24 rows per fold
        res = engine.CVEngine(engine.make_strategy("low_rank", rank=rank),
                              backend=backend, device="cpu").run(tf, LAMS)
        np.testing.assert_allclose(res.errors, exact.errors, rtol=CURVE_RTOL)
        assert res.best_lam == exact.best_lam


def test_low_rank_descriptor_and_counts(low_rank_folds):
    _, tf = low_rank_folds
    assert engine.LowRankStrategy().descriptor() == "lowrank/rfull"
    assert engine.LowRankStrategy(rank=8).descriptor() == "lowrank/r8"
    for name in ("low_rank", "svd"):
        bk = CountingBackend(ReferenceBackend())
        res = engine.CVEngine(name, backend=bk, device="cpu").run(tf, LAMS)
        assert bk.n_cholesky == 0 and res.n_exact_chol == 0


def test_low_rank_factors_under_bf16_store(low_rank_folds):
    """vt and evals stored at the policy's storage dtype (bf16), evals
    zeroed beyond the rank, as the reference stores them; the sweep
    computes at the accumulation dtype."""
    jf, tf = low_rank_folds
    x = tf.x_folds[1:].reshape(-1, 96)
    got = solvers.lowrank_ridge_factors(x, 6, precision=PRESETS["bf16_store"])
    want = jsolvers.lowrank_ridge_factors(jnp.asarray(x.numpy()), 6,
                                          precision=JPRESETS["bf16_store"])
    assert got.vt.dtype == got.evals.dtype == torch.bfloat16
    assert str(want.vt.dtype) == "bfloat16"
    ev = got.evals.float().numpy()
    assert (ev[6:] == 0).all() and (ev[:6] > 0).all()
    np.testing.assert_allclose(ev, np.asarray(want.evals, np.float32),
                               rtol=2.0 ** -8)
    g = tf.grad - tf.fold_grad[0]
    th = solvers.lowrank_ridge_sweep(got, g, torch.tensor([0.5]),
                                     compute_dtype=torch.float32)
    assert th.dtype == torch.float32 and th.shape == (1, 96)


def test_strategy_registry_lists_the_ported_strategies():
    assert set(engine.STRATEGIES) == set(jengine.STRATEGIES)
    with pytest.raises(ValueError, match="unknown strategy"):
        engine.make_strategy("picholesky_sketchy")


def test_make_low_rank_dataset_checks_and_rank():
    x, y = make_low_rank_dataset(32, 96, 8, seed=0, dtype=torch.float64,
                                 device="cpu")
    assert x.shape == (32, 96) and y.shape == (32,)
    assert x.dtype == y.dtype == torch.float64 and x.device.type == "cpu"
    s = torch.linalg.svdvals(x)
    assert s[7] > 50 * s[8]                 # numerical rank 8
    x2, y2 = make_low_rank_dataset(32, 96, 8, seed=0, dtype=torch.float64,
                                   device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    x3, _ = make_low_rank_dataset(32, 96, 8, seed=1, dtype=torch.float64,
                                  device="cpu")
    assert not torch.equal(x, x3)
    for bad in (0, 33):
        with pytest.raises(ValueError, match="rank"):
            make_low_rank_dataset(32, 96, bad, device="cpu")


def test_make_low_rank_dataset_distribution():
    """The planted structure, as the JAX construction makes it: the tail
    singular values sit near tail_scale·(√n + √h), the signal ones near
    √(n·h/r)·… far above; the labels' noise has the requested scale."""
    n, h, r = 200, 400, 10
    x, y = make_low_rank_dataset(n, h, r, seed=2, tail_scale=1e-3,
                                 noise=0.5, dtype=torch.float64,
                                 device="cpu")
    s = torch.linalg.svdvals(x)
    tail = float(s[r:].max())
    assert 1e-3 * (np.sqrt(h) - np.sqrt(n)) * 0.8 < tail \
        < 1e-3 * (np.sqrt(n) + np.sqrt(h)) * 1.2
    assert float(s[r - 1]) > 500 * tail
    # y = X θ + noise with θ in the row space: the residual of y's least
    # squares fit on the top-r right singular vectors is the noise
    _, _, vt = torch.linalg.svd(x, full_matrices=False)
    xr = x @ vt[:r].T
    coef = torch.linalg.lstsq(xr, y[:, None]).solution
    resid = y - (xr @ coef)[:, 0]
    assert 0.4 < float(resid.std()) < 0.6

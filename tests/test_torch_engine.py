"""The port's CVEngine against the JAX engine on the same folds: the exact
and piCholesky curves within 1e-9 relative and the same argmin, for every
λ-chunking (including a last chunk that is edge-padded), on the reference
backend and on the kernel backend (plain versions on the CPU).  Plus the
engine's guards."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cv as jcv  # noqa: E402
from repro.core.engine import CVEngine as JEngine  # noqa: E402
from repro.data import make_regression_dataset  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine, folds as tfolds  # noqa: E402
from repro_torch.core.engine import CVEngine  # noqa: E402

#: same float64 algorithm on both sides, other summation orders (measured
#: ~1e-13 on this problem)
CURVE_RTOL = 1e-9
H, BLOCK, K, Q = 40, 16, 4, 7


@pytest.fixture(scope="module")
def problem():
    x, y = make_regression_dataset(jax.random.PRNGKey(3), 240, H,
                                   dtype=jnp.float64)
    jf = jcv.make_folds(x, y, K)
    lams = np.logspace(-3, 2, Q)
    ref = {
        "exact": JEngine("exact", backend="reference", lam_chunk=None
                         ).run(jf, jnp.asarray(lams)),
        "picholesky": JEngine(
            jcv.make_strategy("picholesky", g=4, block=BLOCK),
            backend="reference", lam_chunk=None).run(jf, jnp.asarray(lams)),
    }
    return convert.folds_from_numpy(jf, device="cpu"), lams, ref


def _strategy(name):
    if name == "exact":
        return engine.make_strategy("exact")
    return engine.make_strategy("picholesky", g=4, block=BLOCK)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("lam_chunk", [None, 3, "auto"])
@pytest.mark.parametrize("name", ["exact", "picholesky"])
def test_run_matches_jax_engine(problem, name, lam_chunk, backend):
    folds, lams, ref = problem
    res = CVEngine(_strategy(name), backend=backend, block=BLOCK,
                   lam_chunk=lam_chunk, device="cpu").run(folds, lams)
    np.testing.assert_allclose(res.errors, np.asarray(ref[name].errors),
                               rtol=CURVE_RTOL)
    assert int(np.argmin(res.errors)) == int(np.argmin(ref[name].errors))
    assert res.best_lam == ref[name].best_lam
    assert res.n_exact_chol == ref[name].n_exact_chol
    eng = res.extras["engine"]
    assert eng == dict(strategy=name, backend=backend, precision="native",
                       lam_chunk=lam_chunk, device="cpu", mesh=None,
                       donated=False)


def test_chunking_matches_jax_helpers():
    lams = np.logspace(-3, 0, 31)
    for chunk in (1, 3, 4, 31, 40):
        got, q = engine.chunk_lams(torch.from_numpy(lams), chunk)
        want, qj = jshard.chunk_lams(jnp.asarray(lams), chunk)
        assert q == qj == 31
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert engine.LAM_CHUNK_BUDGET_BYTES == 16 * 1024 * 1024
    for h, block in ((1024, 128), (144, 32), (40, 16)):
        for tdt, jdt in ((torch.float64, jnp.float64),
                         (torch.float32, jnp.float32)):
            assert engine.auto_lam_chunk(
                h, block, tdt, engine.LAM_CHUNK_BUDGET_BYTES) == \
                jshard.auto_lam_chunk(h, block, jdt,
                                      engine.LAM_CHUNK_BUDGET_BYTES)
    assert engine.auto_lam_chunk(1024, 128, torch.float64,
                                 engine.LAM_CHUNK_BUDGET_BYTES) == 3


def test_holdout_nrmse_uses_population_std(problem):
    from repro.core.folds import holdout_nrmse as jnrmse
    folds, _, _ = problem
    theta = torch.from_numpy(np.random.default_rng(0).standard_normal(H))
    x, y = folds.x_folds[1], folds.y_folds[1]
    got = float(tfolds.holdout_nrmse(theta, x, y))
    want = float(jnrmse(jnp.asarray(theta.numpy()), jnp.asarray(x.numpy()),
                        jnp.asarray(y.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-13)


@pytest.mark.parametrize("bad", [np.zeros(0), np.ones((2, 3))],
                         ids=["q0", "2d"])
def test_degenerate_grids_raise(problem, bad):
    folds, _, _ = problem
    with pytest.raises(ValueError, match="λ grid"):
        CVEngine("exact", device="cpu").run(folds, bad)


def test_all_nan_curve_raises(problem):
    folds, lams, _ = problem
    poisoned = tfolds.FoldData(folds.hess, folds.grad, folds.fold_hess,
                               folds.fold_grad, folds.x_folds,
                               torch.full_like(folds.y_folds, float("nan")))
    with pytest.raises(FloatingPointError, match="no finite value"):
        CVEngine("picholesky", block=BLOCK, device="cpu").run(poisoned, lams)
    with pytest.raises(ValueError, match="empty"):
        tfolds.CVResult.from_errors([], [], 0)


def test_partially_nan_curve_ranks_finite_entries():
    res = tfolds.CVResult.from_errors([1.0, 2.0, 3.0], [np.nan, 0.5, 0.2], 3)
    assert res.best_lam == 3.0 and res.best_error == 0.2


def test_unknown_strategy_and_chunk_raise(problem):
    folds, lams, _ = problem
    with pytest.raises(ValueError, match="unknown strategy"):
        CVEngine("picholesky_sketchy", device="cpu")
    with pytest.raises(ValueError, match="needs a SketchPlan"):
        CVEngine("picholesky_sketched", device="cpu")   # no plan given
    with pytest.raises(ValueError, match="lam_chunk"):
        CVEngine("exact", lam_chunk=0, device="cpu").run(folds, lams)

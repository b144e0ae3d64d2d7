"""The port's sketched anchors (``repro_torch.core.sketch`` and the
``picholesky_sketched`` strategy) against the JAX package.

torch cannot reproduce ``jax.random``, so every parity case makes the JAX
package's own draws here (the same key and splits as
``src/repro/core/sketch.py``) and hands them to the port's
:func:`~repro_torch.core.sketch.sketch_rows` / ``sketched_gram`` or to the
strategy's ``draws=``.  The port's own draws are held to the properties
instead: reproducible per (seed, fold), seed-sensitive, a PSD gram, and an
IHS error that contracts geometrically.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.testing import strategies as props  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine, picholesky, solvers  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402

#: the same float64 sums on both sides in other orders (measured ≤ 4e-16
#: of the gram's largest entry)
GRAM_RTOL = 1e-12
#: the sketched engine's curve: anchors, Θ fit, interp_solve and the IHS
#: sweeps in float64, other summation orders
CURVE_RTOL = 1e-9
LAMS = np.asarray(props.log_grid(17))
DESIGNS = props.TALL_SKINNY_DESIGNS[:2]


@pytest.fixture(scope="module", params=range(len(DESIGNS)),
                ids=[f"h{d['h']}n{d['n']}" for d in DESIGNS])
def folds(request):
    jf = props.tall_skinny_folds(**DESIGNS[request.param])
    return jf, convert.folds_from_numpy(jf, device="cpu")


def _train_rows(x_folds: np.ndarray, f: int) -> np.ndarray:
    """Fold f's training rows in the engine's order, (f + 1 + j) % k."""
    k = x_folds.shape[0]
    return np.concatenate([x_folds[(f + 1 + j) % k] for j in range(k - 1)])


def _jax_draws(plan: jsk.SketchPlan, n: int, f: int) -> dict:
    """The JAX package's draws of fold f, as ``sketch.py:135-158`` makes
    them, in the port's layout."""
    key = plan.key_for(f)
    if plan.method == "gaussian":
        d = dict(g=jax.random.normal(key, (plan.m, n), dtype=jnp.float64))
    elif plan.method == "srht":
        k_sign, k_rows = jax.random.split(key)
        n2 = jsk.next_pow2(n)
        d = dict(signs=jax.random.rademacher(k_sign, (n,),
                                             dtype=jnp.float64),
                 rows=jax.random.choice(k_rows, n2, (min(plan.m, n2),),
                                        replace=False))
    else:
        k_bucket, k_sign = jax.random.split(key)
        d = dict(buckets=jax.random.randint(k_bucket, (n,), 0, plan.m),
                 signs=jax.random.rademacher(k_sign, (n,),
                                             dtype=jnp.float64))
    return {name: torch.from_numpy(np.array(v)) for name, v in d.items()}


def _plans(cfg):
    return jsk.SketchPlan(**cfg), sk.SketchPlan(**cfg)


@pytest.mark.parametrize("cfg", props.SKETCH_PLAN_CONFIGS,
                         ids=lambda c: f"{c['method']}-m{c['m']}")
def test_sketch_rows_and_gram_match_jax_draws(folds, cfg):
    jf, _ = folds
    jplan, plan = _plans(cfg)
    f = 1
    x = _train_rows(np.asarray(jf.x_folds), f)
    draws = _jax_draws(jplan, x.shape[0], f)
    want_rows = np.asarray(jsk.sketch_rows(jplan, jnp.asarray(x),
                                           jplan.key_for(f)))
    got_rows = sk.sketch_rows(plan, torch.from_numpy(x), draws).numpy()
    assert got_rows.shape == want_rows.shape
    np.testing.assert_allclose(got_rows, want_rows,
                               atol=GRAM_RTOL * np.abs(want_rows).max())
    want = np.asarray(jsk.sketched_gram(jplan, jnp.asarray(x), f))
    got = sk.sketched_gram(plan, torch.from_numpy(x), f, draws=draws).numpy()
    np.testing.assert_allclose(got, want, atol=GRAM_RTOL * np.abs(want).max())
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("n", [1, 2, 64, 256])
def test_fwht_is_its_own_inverse_and_matches_jax(n):
    x = np.random.default_rng(n).normal(size=(n, 3))
    y = sk.fwht(torch.from_numpy(x))
    np.testing.assert_allclose(sk.fwht(y).numpy(), x, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), np.asarray(jsk.fwht(
        jnp.asarray(x))), atol=1e-13)
    np.testing.assert_allclose(np.linalg.norm(y.numpy()), np.linalg.norm(x),
                               rtol=1e-13)
    with pytest.raises(ValueError, match="power-of-two"):
        sk.fwht(torch.zeros(3 * n, 2, dtype=torch.float64))


def test_plan_validation_descriptor_and_json_equal_jax():
    for cfg in props.SKETCH_PLAN_CONFIGS:
        jplan, plan = _plans(cfg)
        assert plan.descriptor() == jplan.descriptor()
        assert plan.to_json() == jplan.to_json()
        assert sk.SketchPlan.from_json(jplan.to_json()) == plan
    assert sk.as_plan(None) is None
    assert sk.as_plan(dict(method="gaussian", m=64)) == sk.SketchPlan(
        method="gaussian", m=64)
    for bad, match in ((dict(method="subgaussian"), "method"),
                       (dict(m=0), "m"), (dict(ihs_iters=-1), "ihs_iters")):
        with pytest.raises(ValueError, match=match):
            jsk.SketchPlan(**bad)
        with pytest.raises(ValueError, match=match):
            sk.SketchPlan(**bad)
    with pytest.raises(TypeError, match="SketchPlan"):
        sk.as_plan("countsketch/m256")


@pytest.mark.parametrize("method", sk.SKETCH_METHODS)
def test_own_draws_reproducible_seed_sensitive_and_psd(folds, method):
    _, tf = folds
    x = tf.x_folds.reshape(-1, tf.x_folds.shape[-1])
    plan = sk.SketchPlan(method=method, m=256, seed=3)
    a = sk.sketched_gram(plan, x, 0)
    np.testing.assert_array_equal(a.numpy(),
                                  sk.sketched_gram(plan, x, 0).numpy())
    assert not torch.equal(a, sk.sketched_gram(plan, x, 1))
    assert not torch.equal(a, sk.sketched_gram(
        sk.SketchPlan(method=method, m=256, seed=4), x, 0))
    assert float(torch.linalg.eigvalsh(a).min()) > -1e-10 * float(
        a.abs().max())


def test_countsketch_sums_each_bucket_in_row_order():
    """The fixed-order reduction is the sequential row-order sum (what a
    one-thread scatter-add would give), bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 7))
    buckets = rng.integers(0, 37, size=500)
    signs = rng.choice([-1.0, 1.0], size=500)
    want = np.zeros((37, 7))
    for i in range(500):
        want[buckets[i]] += signs[i] * x[i]
    got = sk.sketch_rows(sk.SketchPlan(method="countsketch", m=37),
                         torch.from_numpy(x),
                         dict(buckets=torch.from_numpy(buckets),
                              signs=torch.from_numpy(signs))).numpy()
    np.testing.assert_array_equal(got, want)


_JAX: dict = {}


def _jax_sketched(jf, cfg):
    key = (id(jf), tuple(sorted(cfg.items())))
    if key not in _JAX:
        strat = jengine.PiCholeskySketched(g=4, block=8,
                                           sketch=jsk.SketchPlan(**cfg))
        _JAX[key] = jengine.CVEngine(strat, backend="reference",
                                     lam_chunk=None).run(jf, jnp.asarray(LAMS))
    return _JAX[key]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("cfg", [props.SKETCH_PLAN_CONFIGS[i]
                                 for i in (0, 2, 4)],
                         ids=lambda c: c["method"])
def test_sketched_engine_matches_jax_on_its_draws(folds, cfg, backend):
    jf, tf = folds
    jplan = jsk.SketchPlan(**cfg)
    x = np.asarray(jf.x_folds)
    k = x.shape[0]
    n_tr = (k - 1) * x.shape[1]
    draws = tuple(_jax_draws(jplan, n_tr, f) for f in range(k))
    strat = engine.PiCholeskySketched(g=4, block=8, draws=draws,
                                      sketch=sk.SketchPlan(**cfg))
    res = engine.CVEngine(strat, backend=backend, block=8,
                          device="cpu").run(tf, LAMS)
    want = _jax_sketched(jf, cfg)
    np.testing.assert_allclose(res.errors, np.asarray(want.errors),
                               rtol=CURVE_RTOL)
    assert res.best_lam == want.best_lam
    assert res.n_exact_chol == want.n_exact_chol
    assert strat.cache_meta(torch.from_numpy(LAMS)) is None   # draws given


def test_ihs_error_contracts_geometrically(folds):
    """The IHS contract (arXiv:1411.0347, ``tests/test_sketch.py:175``) on
    the port's own draws: preconditioning with the interpolated sketched
    factor and exact residuals contracts the solve error geometrically."""
    _, tf = folds
    x = tf.x_folds[1:].reshape(-1, tf.x_folds.shape[-1])
    y = tf.y_folds[1:].reshape(-1)
    h_tr, g_tr = x.T @ x, x.T @ y
    plan = sk.SketchPlan(method="gaussian", m=384, seed=0)
    h_sk = sk.sketched_gram(plan, x, 0)
    anchors = picholesky.choose_sample_lambdas(1e-3, 1e2, 4, device="cpu")
    model = picholesky.fit(h_sk, anchors, 2, block=8)
    lams = torch.logspace(-3, 2, 5, dtype=torch.float64)
    exact = solvers.solve_cholesky_sweep(h_tr, g_tr, lams)
    scale = float(torch.linalg.vector_norm(exact))
    theta0 = model.solve(lams, g_tr)
    errs = []
    for iters in range(4):
        th = picholesky.refine_solutions(model, h_tr, g_tr, lams, theta0,
                                         iters=iters)
        errs.append(float(torch.linalg.vector_norm(th - exact)) / scale)
    for prev, cur in zip(errs, errs[1:]):
        assert cur < 0.9 * prev + 1e-12, errs
    assert errs[3] < 0.2 * errs[0], errs


def test_engine_sketch_wiring_and_refusals():
    plan = sk.SketchPlan(method="srht", m=128, seed=0, ihs_iters=1)
    eng = engine.CVEngine("picholesky", sketch=plan.to_json(), device="cpu")
    assert isinstance(eng.strategy, engine.PiCholeskySketched)
    assert eng.strategy.sketch == plan and eng.sketch == plan
    base = engine.make_strategy("picholesky", g=5, degree=3, block=8)
    up = engine.CVEngine(base, sketch=plan, device="cpu").strategy
    assert (up.g, up.degree, up.block, up.sketch) == (5, 3, 8, plan)
    bare = engine.PiCholeskySketched(block=8)
    assert engine.CVEngine(bare, sketch=plan,
                           device="cpu").strategy.sketch == plan
    with pytest.raises(ValueError, match="conflicting sketch plans"):
        engine.CVEngine(engine.PiCholeskySketched(sketch=plan),
                        sketch=dict(method="srht", m=64), device="cpu")
    with pytest.raises(ValueError, match="needs the picholesky strategy"):
        engine.CVEngine("exact", sketch=plan, device="cpu")
    with pytest.raises(ValueError, match="needs a SketchPlan"):
        engine.CVEngine(bare, device="cpu")
    meta = engine.CVEngine(engine.make_strategy("picholesky", block=8),
                           sketch=plan, device="cpu").strategy.cache_meta(
        torch.from_numpy(LAMS))
    assert meta["sketch"] == plan.descriptor() == jsk.SketchPlan(
        **plan.to_json()).descriptor()

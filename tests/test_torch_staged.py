"""The port's staged engine surface against the JAX package on the same
folds: ``sweep_async`` (pipelined against serial, cold and warm), its
early stopping and refusals, ``run_async``, the adaptive ``search``,
``with_interpolant`` / ``select_interpolant`` and ``advise_anchor``.

On the CPU "pipelined" and "serial" run the same eager operations (the
serial order adds a device synchronization per stage only on the card), so
their bit equality here holds the code paths; the card test holds it
where streams run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import factor_cache as jfc  # noqa: E402
from repro.testing import strategies as props  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine, factor_cache as fc  # noqa: E402
from repro_torch.core.backends import CountingBackend, \
    resolve_backend  # noqa: E402
from repro_torch.core.folds import FoldData  # noqa: E402
from repro_torch.distributed.sharding import cv_mesh  # noqa: E402

H, BLOCK, G = 24, 8, 4
LAMS = np.asarray(props.log_grid(17))
#: the staged sweep against run(): the same operations on every fold at
#: once in both, so the same bits are expected; held to 1e-12 as the
#: reference holds it (tests/test_async_sweep.py:99-101)
ASYNC_RTOL = 1e-12
#: anchor-advice scores: the O(d⁶) bound operators (pinv, lstsq, 2-norms
#: of d² × d² matrices on the probe) in float64, other LAPACK paths
ADVICE_RTOL = 1e-10


@pytest.fixture(scope="module")
def folds():
    jf = props.regression_folds(h=H, n=200, k=4, seed=1)
    return jf, convert.folds_from_numpy(jf, device="cpu")


def _strat(name="picholesky", **kw):
    if name == "picholesky":
        kw.setdefault("g", G)
        kw.setdefault("block", BLOCK)
    return engine.make_strategy(name, **kw)


def _jstrat(name="picholesky", **kw):
    if name == "picholesky":
        kw.setdefault("g", G)
        kw.setdefault("block", BLOCK)
    return jengine.make_strategy(name, **kw)


def _engine(name="picholesky", backend="reference", **kw):
    kw.setdefault("lam_chunk", 4)
    return engine.CVEngine(_strat(name), backend=backend, block=BLOCK,
                           device="cpu", **kw)


def _curve(chunks):
    return np.concatenate([c.fold_errors for c in chunks], axis=1)


# ------------------------------------------------------------ staged sweep


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name", ["picholesky", "exact"])
def test_pipelined_equals_serial_bitwise(folds, name, warm):
    _, tf = folds
    cache = fc.FactorCache() if warm else None
    if warm:
        _engine(name, cache=cache).run(tf, LAMS)       # populate
    eng = _engine(name, cache=cache)
    pipe = list(eng.sweep_async(tf, LAMS, pipelined=True))
    serial = list(eng.sweep_async(tf, LAMS, pipelined=False))
    assert len(pipe) == len(serial) == -(-len(LAMS) // 4)
    np.testing.assert_array_equal(_curve(pipe), _curve(serial))
    assert [c.best_lam for c in pipe] == [c.best_lam for c in serial]
    assert pipe[-1].n_exact_chol == serial[-1].n_exact_chol
    if not warm:
        assert pipe[-1].cache is None
    elif name == "picholesky":
        assert pipe[-1].cache["status"] == "hit"
        assert pipe[-1].n_exact_chol == 0


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("name", ["picholesky", "exact",
                                  "picholesky_warmstart"])
def test_run_async_matches_run(folds, name, chunk):
    jf, tf = folds
    eng = _engine(name, lam_chunk=chunk)
    r = eng.run(tf, LAMS)
    ra = eng.run_async(tf, LAMS)
    np.testing.assert_allclose(ra.errors, r.errors, rtol=ASYNC_RTOL)
    assert ra.best_lam == r.best_lam and ra.n_exact_chol == r.n_exact_chol
    info = ra.extras["engine"]["async"]
    assert info["lams_evaluated"] == len(LAMS) and not info["stopped"]
    jr = jengine.CVEngine(_jstrat(name), backend="reference",
                          lam_chunk=chunk).run_async(jf, jnp.asarray(LAMS))
    np.testing.assert_allclose(ra.errors, np.asarray(jr.errors), rtol=1e-9)
    assert ra.best_lam == jr.best_lam
    assert info["chunks_total"] == jr.extras["engine"]["async"][
        "chunks_total"]


@pytest.mark.parametrize("patience", [1, 2])
def test_early_stop_at_zero_tolerance_keeps_the_argmin(folds, patience):
    jf, tf = folds
    eng = _engine(lam_chunk=2)
    full = eng.run(tf, LAMS)
    parts = list(eng.sweep_async(tf, LAMS, stop_tol=0.0,
                                 stop_patience=patience))
    prefix = np.concatenate([c.errors for c in parts])
    np.testing.assert_array_equal(prefix, full.errors[:prefix.shape[0]])
    assert parts[-1].best_lam == full.best_lam
    jparts = list(jengine.CVEngine(_jstrat(), backend="reference",
                                   lam_chunk=2).sweep_async(
        jf, jnp.asarray(LAMS), stop_tol=0.0, stop_patience=patience))
    assert len(parts) == len(jparts)
    assert parts[-1].stopped == jparts[-1].stopped
    res = eng.run_async(tf, LAMS, stop_tol=0.0, stop_patience=patience)
    assert res.extras["engine"]["async"]["chunks_evaluated"] == len(parts)
    assert res.best_lam == full.best_lam


def _nan_folds(tf):
    return FoldData(tf.hess, tf.grad, tf.fold_hess, tf.fold_grad,
                    tf.x_folds, torch.full_like(tf.y_folds, float("nan")))


@pytest.mark.parametrize("stop_tol", [None, 0.0])
def test_non_finite_chunks_are_refused(folds, stop_tol):
    _, tf = folds
    eng = _engine()
    with pytest.raises(FloatingPointError, match="non-finite|no finite"):
        list(eng.sweep_async(_nan_folds(tf), LAMS, stop_tol=stop_tol))


def test_sweep_argument_checks(folds):
    _, tf = folds
    eng = _engine()
    for kw, match in ((dict(stop_tol=-1.0), "stop_tol"),
                      (dict(stop_patience=0), "stop_patience")):
        with pytest.raises(ValueError, match=match):
            list(eng.sweep_async(tf, LAMS, **kw))
    with pytest.raises(ValueError, match="empty"):
        list(eng.sweep_async(tf, np.empty(0)))
    for kw, match in ((dict(tol_decades=0), "tol_decades"),
                      (dict(plateau_tol=-1), "plateau_tol"),
                      (dict(plateau_patience=0), "plateau_patience"),
                      (dict(max_waves=0), "max_waves"),
                      (dict(wave=2), "wave")):
        with pytest.raises(ValueError, match=match):
            eng.search(tf, LAMS, **kw)
    with pytest.raises(ValueError, match="positive"):
        eng.search(tf, np.asarray([-1.0, 1.0]))
    for name in ("mesh", "tune"):
        with pytest.raises(ValueError, match=name):
            engine.CVEngine("exact", device="cpu", **{name: "bogus"})
    # a fold axis that does not divide k is refused before any work
    k = tf.fold_hess.shape[0]
    bad = cv_mesh([torch.device("cpu")] * (k + 1), k + 1, 1)
    eng_bad = engine.CVEngine("exact", device="cpu", mesh=bad)
    with pytest.raises(ValueError, match="not divisible"):
        list(eng_bad.sweep_async(tf, LAMS))
    with pytest.raises(ValueError, match="not divisible"):
        eng_bad.search(tf, LAMS)


def test_single_lam_grid_consistent_and_search_refuses(folds):
    """The contract of the reference's test of this name
    (``tests/test_search.py:196``) on the port's own paths: q = 1 is a
    point evaluation (run, run_async and run_batch agree on the exact
    strategy), search refuses, and picholesky on q = 1 — every anchor on
    the same λ, a singular fit — is flagged, never a silent pick."""
    _, tf = folds
    one = np.asarray([0.1])
    r = _engine("exact").run(tf, one)
    ra = _engine("exact").run_async(tf, one, stop_tol=0.0, stop_patience=2)
    (rb,) = _engine("exact").run_batch([(tf, one)])
    assert r.best_lam == ra.best_lam == rb.best_lam == 0.1
    np.testing.assert_array_equal(r.errors, ra.errors)
    np.testing.assert_array_equal(r.errors, rb.errors)
    assert not ra.extras["engine"]["async"]["stopped"]
    with pytest.raises(ValueError, match="single λ"):
        _engine().search(tf, one)
    with pytest.raises(FloatingPointError, match="distinct sample shifts"):
        _engine().run(tf, one)


# ------------------------------------------------------------------ search


_JSEARCH: dict = {}


def _jax_search(jf, wave):
    if wave not in _JSEARCH:
        _JSEARCH[wave] = jengine.CVEngine(
            _jstrat(), backend="reference").search(jf, jnp.asarray(LAMS),
                                                   wave=wave)
    return _JSEARCH[wave]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("wave", [None, 4, 8])
def test_search_evaluates_the_same_lams_as_jax(folds, wave, backend):
    jf, tf = folds
    res = engine.CVEngine(_strat(), backend=backend, block=BLOCK,
                          device="cpu").search(tf, LAMS, wave=wave)
    want = _jax_search(jf, wave)
    assert set(res.lams.tolist()) == set(np.asarray(want.lams).tolist())
    np.testing.assert_array_equal(res.lams, np.asarray(want.lams))
    np.testing.assert_allclose(res.errors, np.asarray(want.errors),
                               rtol=1e-9)
    assert res.best_lam == want.best_lam
    s, js = res.extras["engine"]["search"], want.extras["engine"]["search"]
    assert (s["wave"], s["waves"], s["stopped_on"]) == \
        (js["wave"], js["waves"], js["stopped_on"])
    assert s["lams_evaluated"] < 4 * len(LAMS)


def test_search_on_a_warm_cache_factors_nothing(folds):
    _, tf = folds
    cache = fc.FactorCache()
    _engine(cache=cache).run(tf, LAMS)
    bk = CountingBackend(resolve_backend("reference"))
    res = engine.CVEngine(_strat(), backend=bk, block=BLOCK, device="cpu",
                          cache=cache).search(tf, LAMS)
    assert bk.n_cholesky == 0 and res.n_exact_chol == 0
    assert res.extras["engine"]["cache"]["status"] == "hit"
    assert bk.stage_count("fold_errors", "interp_solve") == \
        res.extras["engine"]["search"]["waves"]


# ------------------------------------------- interpolant choice and advice


@pytest.mark.parametrize("degrees,bases", [
    (None, ("monomial", "centered")), ((1, 2), ("monomial",))])
def test_select_interpolant_makes_jax_choice(folds, degrees, bases):
    jf, tf = folds
    jcache, cache = jfc.FactorCache(), fc.FactorCache()
    jeng = jengine.CVEngine(_jstrat(g=5), backend="reference", cache=jcache,
                            cache_anchors=True)
    bk = CountingBackend(resolve_backend("reference"))
    eng = engine.CVEngine(_strat(g=5), backend=bk, block=BLOCK,
                          device="cpu", cache=cache, cache_anchors=True)
    jsel = jeng.select_interpolant(jf, jnp.asarray(LAMS), degrees=degrees,
                                   bases=bases)
    sel = eng.select_interpolant(tf, LAMS, degrees=degrees, bases=bases)
    assert (sel["degree"], sel["basis"]) == (jsel["degree"], jsel["basis"])
    assert sel["anchor_status"] == jsel["anchor_status"] == "cold+cached"
    assert set(sel["scores"]) == set(jsel["scores"])
    n_cold = bk.n_cholesky
    again = eng.select_interpolant(tf, LAMS, degrees=degrees, bases=bases)
    assert again["anchor_status"] == "anchors" and bk.n_cholesky == n_cold
    # the sweep at the chosen interpolant refits from the parked anchors
    derived = eng.with_interpolant(sel["degree"], sel["basis"])
    assert eng.with_interpolant(sel["degree"], sel["basis"]) is derived
    r = derived.run(tf, LAMS)
    assert bk.n_cholesky == n_cold
    assert r.extras["engine"]["cache"]["status"] in ("refit", "hit")
    if degrees is None:        # search selects over the default set
        chosen = eng.search(tf, LAMS, select_interp=True).extras[
            "engine"]["interp_selection"]
        assert (chosen["degree"], chosen["basis"]) == \
            (sel["degree"], sel["basis"])
    with pytest.raises(ValueError, match="picholesky"):
        _engine("exact").with_interpolant(2, "monomial")
    with pytest.raises(ValueError, match="picholesky"):
        _engine("exact").select_interpolant(tf, LAMS)


@pytest.mark.parametrize("probe_dim", [4, 7])
def test_advise_anchor_proposes_the_jax_anchor(folds, probe_dim):
    jf, tf = folds
    want = jengine.CVEngine(_jstrat(), backend="reference").advise_anchor(
        jf, jnp.asarray(LAMS), probe_dim=probe_dim)
    got = _engine().advise_anchor(tf, LAMS, probe_dim=probe_dim)
    assert got["worst"] == want["worst"]
    assert got["proposal"] == pytest.approx(want["proposal"], rel=1e-12)
    np.testing.assert_allclose(got["scores"], want["scores"],
                               rtol=ADVICE_RTOL)
    np.testing.assert_allclose(got["intervals"], want["intervals"],
                               rtol=1e-14)
    assert got["probe_dim"] == probe_dim
    with pytest.raises(ValueError, match="anchored"):
        _engine("exact").advise_anchor(tf, LAMS)

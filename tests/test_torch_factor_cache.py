"""The port's warm-replay factor cache (``repro_torch.core.factor_cache``)
and its checkpoint store (``repro_torch.checkpoint``) against the JAX
package, on folds the JAX package made.

Digests: ``make_key`` hashes the same strings and bytes as the reference,
so on the same numpy Hessians, anchors, parameters and descriptors both
packages compute the same three digests.  (Inside the engines the anchor
grids are computed by each package and may differ in the last bit, so the
engines' own keys are compared through their fold hashes.)
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import factor_cache as jfc  # noqa: E402
from repro.core.precision import PRESETS as JPRESETS  # noqa: E402
from repro.testing import strategies as props  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, \
    tree_leaves  # noqa: E402
from repro_torch.core import engine, factor_cache as fc, packing, \
    picholesky  # noqa: E402
from repro_torch.core.backends import CountingBackend, \
    resolve_backend  # noqa: E402
from repro_torch.core.precision import PRESETS  # noqa: E402

H, BLOCK, G = 24, 8, 4
LAMS = np.asarray(props.log_grid(17))
#: the port's Θ refit against the JAX package's: one least-squares product
#: per fold in float64, other summation orders
THETA_RTOL = 1e-12


@pytest.fixture(scope="module")
def folds():
    jf = props.regression_folds(h=H, n=200, k=4, seed=1)
    return jf, convert.folds_from_numpy(jf, device="cpu")


@pytest.fixture(scope="module")
def folds2():
    jf = props.regression_folds(h=H, n=200, k=4, seed=2)
    return jf, convert.folds_from_numpy(jf, device="cpu")


def _strat(name="picholesky", **kw):
    if name == "low_rank":
        return engine.make_strategy(name, **kw)
    kw.setdefault("block", BLOCK)
    if name == "picholesky":
        kw.setdefault("g", G)
    return engine.make_strategy(name, **kw)


def _jstrat(name="picholesky", **kw):
    if name == "low_rank":
        return jengine.make_strategy(name, **kw)
    kw.setdefault("block", BLOCK)
    if name == "picholesky":
        kw.setdefault("g", G)
    return jengine.make_strategy(name, **kw)


def _engine(cache, backend="reference", strat=None, **kw):
    return engine.CVEngine(strat or _strat(), backend=backend, block=BLOCK,
                           device="cpu", cache=cache, **kw)


# ------------------------------------------------------------------ keys


@pytest.mark.parametrize("precision,sketch", [
    ("native", "exact"), ("bf16_refined", "exact"),
    ("native", "countsketch/m512/seed2/ihs2")])
def test_cache_key_digests_equal_jax(folds, precision, sketch):
    jf, _ = folds
    h_tr = np.asarray(jf.hess[None] - jf.fold_hess)
    anchors = np.asarray(props.log_grid(G))
    params = dict(strategy="picholesky", g=G, degree=2, block=BLOCK,
                  basis="monomial")
    jkey = jfc.make_key(jnp.asarray(h_tr), jnp.asarray(anchors), block=BLOCK,
                        backend="reference", params=params,
                        precision=JPRESETS[precision].descriptor(),
                        sketch=sketch)
    key = fc.make_key(torch.from_numpy(h_tr), torch.from_numpy(anchors),
                      block=BLOCK, backend="reference", params=params,
                      precision=PRESETS[precision].descriptor(),
                      sketch=sketch)
    assert key.to_json() == jkey.to_json()
    assert key.digest() == jkey.digest()
    assert key.base_digest() == jkey.base_digest()
    assert key.anchor_digest() == jkey.anchor_digest()
    assert fc.CacheKey.from_json(jkey.to_json()) == key
    other = fc.make_key(torch.from_numpy(h_tr), torch.from_numpy(anchors),
                        block=BLOCK, backend="cuda", params=params,
                        precision=PRESETS[precision].descriptor(),
                        sketch=sketch)
    assert other.digest() != key.digest()   # a cuda entry never serves
    assert other.anchor_digest() != key.anchor_digest()   # a reference one


def test_array_hash_equals_jax_in_float64_and_bf16():
    a = np.random.default_rng(0).normal(size=(5, 7))
    assert fc.array_hash(torch.from_numpy(a)) == jfc.array_hash(a)
    jb = jnp.asarray(a, dtype=jnp.bfloat16)
    tb = torch.from_numpy(a).to(torch.bfloat16)
    # both round to nearest even: the same bf16 bits
    assert fc.array_hash(tb) == jfc.array_hash(jb)
    assert fc.hessian_fingerprint(torch.from_numpy(a)[None]) == \
        jfc.hessian_fingerprint(a[None])
    with pytest.raises(ValueError, match="fold Hessians"):
        fc.hessian_fingerprint(torch.zeros(3, 3))


# --------------------------------------------------------- warm replay


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name", ["picholesky", "picholesky_warmstart",
                                  "low_rank"])
def test_warm_run_has_no_factorization_and_equals_cold(folds, name, backend):
    _, tf = folds
    cache = fc.FactorCache()
    cold_bk = CountingBackend(resolve_backend(backend, block=BLOCK))
    cold = _engine(cache, cold_bk, _strat(name)).run(tf, LAMS)
    assert cold.extras["engine"]["cache"]["status"] == "miss"
    assert (cold_bk.n_cholesky > 0) == (name != "low_rank")
    warm_bk = CountingBackend(resolve_backend(backend, block=BLOCK))
    warm = _engine(cache, warm_bk, _strat(name)).run(tf, LAMS)
    assert warm_bk.n_cholesky == 0
    assert warm.extras["engine"]["cache"]["status"] == "hit"
    assert warm.n_exact_chol == 0 and cache.hits == 1
    np.testing.assert_array_equal(warm.errors, cold.errors)
    # the same grid cold without a cache
    plain = engine.CVEngine(_strat(name), backend=backend, block=BLOCK,
                            device="cpu").run(tf, LAMS)
    np.testing.assert_array_equal(plain.errors, cold.errors)
    assert "cache" not in plain.extras["engine"]


def test_uncacheable_strategies_bypass(folds):
    _, tf = folds
    cache = fc.FactorCache()
    for strat in (engine.make_strategy("exact"),
                  _strat(chol_fn=torch.linalg.cholesky)):
        r = _engine(cache, strat=strat).run(tf, LAMS)
        assert r.extras["engine"]["cache"] == dict(status="bypass")
    assert len(cache) == 0


#: grids over the sequence: the first populates; a sub-range; the same
#: range denser (same anchors); a wider range; a sub-range of that
GRID_SEQUENCE = [(-3.0, 2.0, 17), (-2.0, 1.0, 9), (-3.0, 2.0, 31),
                 (-4.0, 2.0, 9), (-3.5, 1.5, 11)]


@pytest.mark.parametrize("reuse", ["exact", "covering"])
def test_lookup_serves_the_same_entries_as_jax(folds, reuse):
    jf, tf = folds
    jcache, cache = jfc.FactorCache(), fc.FactorCache()
    jeng = jengine.CVEngine(_jstrat(), backend="reference", cache=jcache,
                            reuse=reuse)
    eng = _engine(cache, reuse=reuse)
    seen = []
    for lo, hi, q in GRID_SEQUENCE:
        grid = np.asarray(props.log_grid(q, lo, hi))
        jr = jeng.run(jf, jnp.asarray(grid))
        r = eng.run(tf, grid)
        jinfo, info = (x.extras["engine"]["cache"] for x in (jr, r))
        assert info["status"] == jinfo["status"]
        assert (info["entries"], info["hits"], info["misses"]) == \
            (jinfo["entries"], jinfo["hits"], jinfo["misses"])
        seen.append(info["status"])
        np.testing.assert_allclose(r.errors, np.asarray(jr.errors),
                                   rtol=1e-9)
        assert r.best_lam == jr.best_lam
    assert seen.count("hit") >= 1 and seen[0] == "miss"


@pytest.mark.parametrize("degree,basis", [(2, "centered"), (1, "monomial")])
def test_anchor_refit_has_no_factorization_and_matches_jax_refit(
        folds, degree, basis):
    """The refit from cached anchors: no factorization, Θ bit for bit the
    cold fit at that (degree, basis), and within THETA_RTOL of the JAX
    package's refit.  (Degree 3 on g = 4 anchors over five decades is an
    interpolation through ill-conditioned nodes: there the two packages'
    Θ differ by cond(V)·eps, 8e-10 to 8e-8 relative, and are not held.)"""
    jf, tf = folds
    jcache, cache = jfc.FactorCache(), fc.FactorCache()
    jeng = jengine.CVEngine(_jstrat(), backend="reference", cache=jcache,
                            cache_anchors=True)
    bk = CountingBackend(resolve_backend("reference"))
    eng = _engine(cache, bk, cache_anchors=True)
    jeng.run(jf, jnp.asarray(LAMS))
    eng.run(tf, LAMS)
    n_cold = bk.n_cholesky
    jr = jeng.with_interpolant(degree, basis).run(jf, jnp.asarray(LAMS))
    r = eng.with_interpolant(degree, basis).run(tf, LAMS)
    assert r.extras["engine"]["cache"]["status"] == "refit" == \
        jr.extras["engine"]["cache"]["status"]
    assert bk.n_cholesky == n_cold and r.n_exact_chol == 0
    assert cache.anchor_hits == 1
    refit = list(cache.entries.values())[-1].state
    cold = _strat(degree=degree, basis=basis).fold_state(
        torch.from_numpy(np.asarray(jf.hess[None] - jf.fold_hess)), None,
        engine._sample_grid(torch.from_numpy(LAMS), G),
        resolve_backend("reference"))
    assert torch.equal(refit.theta, cold.theta)
    theta = refit.theta.numpy()
    jtheta = np.asarray(list(jcache.entries.values())[-1].state.theta)
    np.testing.assert_allclose(theta, jtheta,
                               atol=THETA_RTOL * np.abs(jtheta).max())
    np.testing.assert_allclose(r.errors, np.asarray(jr.errors), rtol=1e-9)


def test_lru_evicts_in_the_same_order_as_jax(folds, folds2):
    (jf, tf), (jf2, tf2) = folds, folds2
    jf3 = props.regression_folds(h=H, n=200, k=4, seed=3)
    tf3 = convert.folds_from_numpy(jf3, device="cpu")
    probe = fc.FactorCache()
    _engine(probe).run(tf, LAMS)
    budget = int(2.5 * probe.total_bytes)
    jcache, cache = jfc.FactorCache(max_bytes=budget), \
        fc.FactorCache(max_bytes=budget)
    jeng = jengine.CVEngine(_jstrat(), backend="reference", cache=jcache)
    eng = _engine(cache)
    for j, t in ((jf, tf), (jf2, tf2), (jf, tf), (jf3, tf3), (jf2, tf2),
                 (jf, tf)):
        jr, r = jeng.run(j, jnp.asarray(LAMS)), eng.run(t, LAMS)
        assert r.extras["engine"]["cache"]["status"] == \
            jr.extras["engine"]["cache"]["status"]
        resident = {e.key.fold_hashes for e in cache.entries.values()}
        jresident = {e.key.fold_hashes for e in jcache.entries.values()}
        assert resident == jresident
        assert cache.evictions == jcache.evictions
    assert cache.evictions >= 1


# ----------------------------------------------------------- persistence


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_save_load_replay_is_bitwise(folds, tmp_path, backend):
    _, tf = folds
    cache = fc.FactorCache()
    eng = _engine(cache, backend, cache_anchors=True)
    cold = eng.run(tf, LAMS)
    cache.save(str(tmp_path))
    loaded = fc.FactorCache.load(str(tmp_path), device="cpu")
    assert len(loaded) == len(cache)
    bk = CountingBackend(resolve_backend(backend, block=BLOCK))
    warm = _engine(loaded, bk).run(tf, LAMS)
    assert warm.extras["engine"]["cache"]["status"] == "hit"
    assert bk.n_cholesky == 0
    np.testing.assert_array_equal(warm.errors, cold.errors)
    (entry,) = loaded.entries.values()
    (orig,) = cache.entries.values()
    assert torch.equal(entry.anchors.vec, orig.anchors.vec)
    assert entry.key == orig.key


def test_corrupt_entry_is_skipped_on_load(folds, folds2, tmp_path):
    (_, tf), (_, tf2) = folds, folds2
    cache = fc.FactorCache()
    eng = _engine(cache)
    eng.run(tf, LAMS)
    eng.run(tf2, LAMS)
    cache.save(str(tmp_path))
    with open(os.path.join(str(tmp_path), fc.INDEX_FILENAME)) as f:
        first = json.load(f)["entries"][0]
    leaf = os.path.join(str(tmp_path), f"step_{first['step']:012d}",
                        "leaf_000000.npy")
    with open(leaf, "r+b") as f:
        f.seek(128)
        f.write(b"\xde\xad\xbe\xef")
    loaded = fc.FactorCache.load(str(tmp_path), device="cpu")
    assert len(loaded) == 1 and first["digest"] not in loaded.entries
    # a resave takes fresh steps and leaves the index self-consistent
    cache.save(str(tmp_path))
    assert len(fc.FactorCache.load(str(tmp_path), device="cpu")) == 2


def test_bf16_entry_round_trips_bit_for_bit(folds, tmp_path):
    _, tf = folds
    cache = fc.FactorCache()
    eng = _engine(cache, precision="bf16_store", cache_anchors=True)
    cold = eng.run(tf, LAMS)
    (orig,) = cache.entries.values()
    assert orig.state.theta.dtype == torch.bfloat16
    assert orig.anchors.vec.dtype == torch.bfloat16
    assert cache.bytes_saved > 0
    cache.save(str(tmp_path))
    with open(os.path.join(str(tmp_path), fc.INDEX_FILENAME)) as f:
        rec = json.load(f)["entries"][0]
    assert rec["state"]["theta"]["dtype"] == "bfloat16"
    loaded = fc.FactorCache.load(str(tmp_path), device="cpu")
    (back,) = loaded.entries.values()
    for a, b in ((back.state.theta, orig.state.theta),
                 (back.anchors.vec, orig.anchors.vec)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    warm = _engine(loaded, precision="bf16_store").run(tf, LAMS)
    assert warm.extras["engine"]["cache"]["status"] == "hit"
    np.testing.assert_array_equal(warm.errors, cold.errors)


def test_sketched_entry_never_serves_an_exact_request(folds):
    _, tf = folds
    cache = fc.FactorCache()
    plan = dict(method="srht", m=256, seed=0, ihs_iters=1)
    for reuse in ("exact", "covering"):
        _engine(cache, sketch=plan, cache_anchors=True,
                reuse=reuse).run(tf, LAMS)
    assert len(cache) == 1
    (sketched,) = cache.entries.values()
    exact_eng = _engine(cache, reuse="covering", cache_anchors=True)
    r = exact_eng.run(tf, LAMS)
    assert r.extras["engine"]["cache"]["status"] == "miss"
    assert len(cache) == 2
    assert sketched.key.sketch == "srht/m256/seed0/ihs1"
    # and back: the sketched engine still hits its own entry
    again = _engine(cache, sketch=plan).run(tf, LAMS)
    assert again.extras["engine"]["cache"]["status"] == "hit"
    assert again.extras["engine"]["cache"]["digest"] == \
        sketched.key.digest()[:12]


# ------------------------------------------------------------ checkpoint


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(8, 8, generator=g, dtype=torch.float64),
            "opt": {"mu": torch.zeros(8, 8), "step": torch.tensor(3)},
            "pair": (torch.arange(4), [torch.ones(2, dtype=torch.bfloat16)])}


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_checkpoint_round_trip(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    if mode == "async":
        mgr.save_async(5, tree)
        mgr.wait()
    else:
        mgr.save(5, tree)
    step, back = mgr.restore_latest(tree, device="cpu")
    assert step == 5 and isinstance(back["pair"], tuple)
    _same(back, tree)


def test_checkpoint_picholesky_and_packed_factor(tmp_path):
    jf = props.regression_folds(h=H, n=200, k=3, seed=1)
    h_tr = torch.from_numpy(np.asarray(jf.hess[None] - jf.fold_hess))
    anchors = picholesky.choose_sample_lambdas(1e-2, 1.0, G, device="cpu")
    strat = _strat()
    model, vec = strat.fold_state_and_anchors(h_tr, None, anchors,
                                              resolve_backend("reference"))
    pf = packing.PackedFactor(vec=vec, h=H, block=BLOCK)
    mgr = CheckpointManager(str(tmp_path), keep=None)
    mgr.save(0, {"model": model, "anchors": pf})
    _, back = mgr.restore_latest({"model": model, "anchors": pf},
                                 device="cpu")
    assert (back["model"].h, back["model"].block) == (H, BLOCK)
    _same(back, {"model": model, "anchors": pf})


@pytest.mark.parametrize("fault", ["corrupt", "missing_manifest"])
def test_checkpoint_restore_latest_skips_torn_writes(tmp_path, fault):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    mgr.save(2, tree)
    newest = os.path.join(str(tmp_path), "step_000000000002")
    if fault == "corrupt":
        with open(os.path.join(newest, "leaf_000000.npy"), "r+b") as f:
            f.seek(64)
            f.write(b"\xde\xad\xbe\xef")
    else:
        os.remove(os.path.join(newest, "manifest.json"))
    step, back = mgr.restore_latest(tree, device="cpu")
    assert step == 1 and back is not None
    with pytest.raises(IOError, match="missing or corrupt"):
        mgr.restore(2, tree, device="cpu")


@pytest.mark.parametrize("keep", [2, None])
def test_checkpoint_gc_and_atomicity(tmp_path, keep):
    mgr = CheckpointManager(str(tmp_path), keep=keep)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == ([3, 4] if keep else [1, 2, 3, 4])
    assert not [n for n in os.listdir(str(tmp_path)) if n.endswith(".tmp")]

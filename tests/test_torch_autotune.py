"""The port's autotuner held to the JAX package's pure functions
(``chunk_ladder``, ``candidate_lattice``, ``fingerprint``,
``TunedConfig``'s JSON) on the same inputs, and the reference's autotune
tests (``tests/test_autotune.py``) on the port's engine: zero candidate
executions, tuned against untuned bit for bit, a tuned mesh over repeated
CPU devices, the default winning ties, cache hits that price nothing,
persistence through the checkpoint manager, a pinned ``TunedConfig``, every
entry point dispatching through the tuned engine, and the server tuning
once per geometry."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import autotune as jautotune  # noqa: E402
from repro_torch.core.engine import CVEngine, PiCholeskyStrategy  # noqa
from repro_torch.core.folds import make_folds  # noqa: E402
from repro_torch.distributed import autotune  # noqa: E402
from repro_torch.distributed import sharding as shardlib  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

CPU = torch.device("cpu")


def _problem(h=24, n=240, k=4, q=16, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, h)))
    y = torch.from_numpy(rng.normal(size=(n,)))
    folds = make_folds(x, y, k, device="cpu")
    lams = torch.logspace(-3, 1, q, dtype=torch.float64)
    return folds, lams


# ---------------------------------------------- the JAX package's functions


@pytest.mark.parametrize("auto, q", [(8, 64), (1, 1), (3, 31), (16, 31),
                                     (100, 7), (5, 5)])
def test_chunk_ladder_equals_jax(auto, q):
    assert autotune.chunk_ladder(auto, q) == jautotune.chunk_ladder(auto, q)


LATTICES = [
    dict(h=24, k=4, q=16, n_devices=4, blocks=(8, 16, 32),
         store="float32", budget=64 * 1024, default=(32, 4, None)),
    dict(h=16, k=3, q=8, n_devices=4, blocks=(32,), chunks=(4,),
         default=(32, 4, None)),
    dict(h=1024, k=5, q=31, n_devices=1, blocks=(32, 64, 128),
         store="float64", budget=16 << 20, default=(128, 3, None)),
    dict(h=64, k=6, q=20, n_devices=6, blocks=(16, 32, 256),
         mesh_shapes=[None, (2, 3), (6, 1)], default=(16, 5, None)),
    dict(h=40, k=4, q=9, n_devices=2, blocks=(16, 32),
         default=(16, 9, (2, 1))),
    dict(h=40, k=8, q=33, n_devices=8, blocks=(16, 128), chunks=(1, 4, 64),
         default=(128, 33, None)),
]


@pytest.mark.parametrize("case", LATTICES)
def test_candidate_lattice_equals_jax(case):
    block, chunk, mesh_shape = case["default"]
    kw = dict(h=case["h"], k=case["k"], q=case["q"],
              n_devices=case["n_devices"], blocks=case.get("blocks"),
              chunks=case.get("chunks"), mesh_shapes=case.get("mesh_shapes"),
              budget=case.get("budget"))
    store = case.get("store")
    got = autotune.candidate_lattice(
        default=autotune.TunedConfig(block, chunk, mesh_shape,
                                     source="default"),
        store_dtype=None if store is None else getattr(torch, store), **kw)
    want = jautotune.candidate_lattice(
        default=jautotune.TunedConfig(block, chunk, mesh_shape,
                                      source="default"),
        store_dtype=None if store is None else getattr(jnp, store), **kw)
    assert [c.key() for c in got] == [c.key() for c in want]
    assert got[0].source == "default"


def test_fingerprint_and_config_json_equal_jax():
    devices = {"platform": "cpu", "device_kind": "cpu", "n_devices": 4}
    kw = dict(h=24, k=4, n_f=60, q=16,
              params=dict(strategy="picholesky", g=4, degree=2,
                          basis="monomial"),
              backend="reference", precision="native",
              lattice=dict(blocks=(32, 64), chunks="auto-ladder",
                           mesh_shapes=("none",), default=(32, 16, None)),
              hw_name="cpu", devices=devices)
    got = autotune.fingerprint(dtype=torch.float64, lam_dtype=torch.float64,
                               **kw)
    assert got == jautotune.fingerprint(dtype="float64",
                                        lam_dtype="float64", **kw)
    assert got != autotune.fingerprint(dtype=torch.float32,
                                       lam_dtype=torch.float64, **kw)
    cfg = autotune.TunedConfig(64, 8, (2, 2), 1.5e-3, "tuned")
    jcfg = jautotune.TunedConfig(64, 8, (2, 2), 1.5e-3, "tuned")
    assert cfg.to_json() == jcfg.to_json()
    assert autotune.TunedConfig.from_json(jcfg.to_json()) == cfg
    assert autotune.INDEX_FILENAME == jautotune.INDEX_FILENAME
    assert autotune.DEFAULT_BLOCKS == (32, 64, 128)
    assert set(autotune.DEFAULT_BLOCKS) <= set(_build.BLOCKS)


# ---------------------------------------------------------------- lattice


def test_lattice_default_first_and_legal():
    default = autotune.TunedConfig(block=32, lam_chunk=4, mesh_shape=None,
                                   source="default")
    cands = autotune.candidate_lattice(
        h=24, k=4, q=16, n_devices=4, default=default,
        blocks=(8, 16, 32), store_dtype=torch.float32, budget=64 * 1024)
    assert cands[0] is default
    keys = [c.key() for c in cands]
    assert len(keys) == len(set(keys))
    for c in cands:
        assert 1 <= c.lam_chunk <= 16
        if c.mesh_shape is not None:
            n_fold, n_lam = c.mesh_shape
            assert n_fold * n_lam == 4 and 4 % n_fold == 0


def test_lattice_mesh_candidates_respect_fold_divisibility():
    default = autotune.TunedConfig(block=32, lam_chunk=4)
    cands = autotune.candidate_lattice(
        h=16, k=3, q=8, n_devices=4, default=default, blocks=(32,),
        chunks=(4,))
    assert {c.mesh_shape for c in cands} == {None, (1, 4)}
    assert shardlib.mesh_shape_candidates(4, 4) == [(1, 4), (2, 2), (4, 1)]


def test_chunk_ladder_spans_auto_value():
    ladder = autotune.chunk_ladder(8, 64)
    assert 8 in ladder
    assert any(c < 8 for c in ladder) and any(c > 8 for c in ladder)
    assert autotune.chunk_ladder(1, 1) == (1,)


def test_cuda_lattice_keeps_the_compiled_blocks():
    folds, lams = _problem(h=300, n=1200)
    eng = CVEngine(PiCholeskyStrategy(block=128), backend="cuda",
                   device="cpu")
    cache = autotune.TuningCache()
    cfg = autotune.tune(eng, folds, lams, cache=cache,
                        blocks=(8, 32, 256, 512))
    assert cfg.block in _build.BLOCKS
    # 128 (the default) and 32 survive; 8, 256 and 512 are not compiled
    assert cache.lowerings == len(autotune.candidate_lattice(
        h=300, k=4, q=16, n_devices=1,
        default=autotune.default_config(eng, 4, 300, 16, torch.float64),
        blocks=(32,), store_dtype=torch.float64,
        budget=16 << 20))


# ------------------------------------------------- scoring executes nothing


def test_tune_zero_candidate_executions():
    calls = dict(n=0)

    def chol_fn(a):
        calls["n"] += 1
        return torch.linalg.cholesky(a)

    folds, lams = _problem()
    eng = CVEngine(PiCholeskyStrategy(block=32, chol_fn=chol_fn),
                   backend="reference", device="cpu")
    cache = autotune.TuningCache()
    cfg = autotune.tune(eng, folds, lams, cache=cache, blocks=(32, 64),
                        mesh_shapes=[None])
    assert calls["n"] == 0
    assert cache.lowerings >= 2
    assert cfg.source == "tuned"
    assert np.isfinite(cfg.predicted_s) and cfg.predicted_s > 0
    default = autotune.default_config(eng, 4, 24, 16, torch.float64)
    scored = autotune.score_candidates(
        eng, folds, lams, autotune.candidate_lattice(
            h=24, k=4, q=16, n_devices=1, default=default, blocks=(32, 64),
            mesh_shapes=[None], store_dtype=torch.float64,
            budget=16 << 20))
    assert calls["n"] == 0
    assert min(s.predicted_s for s in scored) == pytest.approx(
        cfg.predicted_s)


# ------------------------------------------------------------ result parity


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_tuned_sweep_bitwise_vs_untuned(backend):
    folds, lams = _problem()
    kw = dict(block=32) if backend == "cuda" else {}
    eng = CVEngine("picholesky", backend=backend, tune="auto",
                   tune_lattice=dict(blocks=(32, 64), mesh_shapes=[None]),
                   device="cpu", **kw)
    base = CVEngine("picholesky", backend=backend, device="cpu", **kw)
    r_t, r_b = eng.run(folds, lams), base.run(folds, lams)
    np.testing.assert_array_equal(r_t.errors, r_b.errors)
    info = r_t.extras["engine"]["tune"]
    assert info["source"] == "tuned" and info["block"] in (32, 64)


def test_tuned_mesh_allclose_and_same_argmin():
    folds, lams = _problem(h=16, n=160, k=4, q=8)
    pool = [CPU] * 4
    base = CVEngine("picholesky", backend="reference", device="cpu")
    r_b = base.run(folds, lams)
    eng = CVEngine("picholesky", backend="reference", tune="auto",
                   tune_lattice=dict(blocks=(16, 32), devices=pool),
                   device="cpu")
    r_t = eng.run(folds, lams)
    np.testing.assert_allclose(r_t.errors, r_b.errors, rtol=1e-12)
    assert r_t.best_lam == r_b.best_lam
    ms = r_t.extras["engine"]["tune"]["mesh_shape"]
    assert ms is None or ms[0] * ms[1] == 4
    # every mesh of the lattice, pinned
    for shape in shardlib.mesh_shape_candidates(4, 4):
        cfg = autotune.TunedConfig(block=16, lam_chunk=3, mesh_shape=shape)
        pinned = CVEngine("picholesky", backend="reference", tune=cfg,
                          tune_lattice=dict(devices=pool), device="cpu")
        r = pinned.run(folds, lams)
        np.testing.assert_allclose(r.errors, r_b.errors, rtol=1e-12)
        assert r.best_lam == r_b.best_lam
        assert r.extras["engine"]["mesh"] == dict(folds=shape[0],
                                                  lams=shape[1])


def test_default_always_candidate_ties_resolve_to_default():
    folds, lams = _problem()
    eng = CVEngine("picholesky", backend="reference", device="cpu")
    default = autotune.default_config(eng, 4, 24, 16, torch.float64)
    cfg = autotune.tune(eng, folds, lams, blocks=(default.block,),
                        chunks=(default.lam_chunk,),
                        mesh_shapes=[default.mesh_shape])
    assert cfg.key() == default.key()
    # a lattice whose every candidate prices the same keeps the default
    flat = dataclasses.replace(autotune.rl.HW_PRESETS["cpu"],
                               peak_flops=float("inf"), hbm_bw=float("inf"),
                               cache_bw=None, cache_bytes=None)
    cfg = autotune.tune(eng, folds, lams, blocks=(16, 32, 64), hw=flat)
    assert cfg.key() == default.key()


# ------------------------------------------------------------ tuning cache


def test_tune_cache_hit_prices_nothing():
    folds, lams = _problem()
    cache = autotune.TuningCache()
    eng = CVEngine("picholesky", backend="reference", tune="auto",
                   tune_cache=cache, device="cpu",
                   tune_lattice=dict(blocks=(32,), mesh_shapes=[None]))
    r1 = eng.run(folds, lams)
    n_low = cache.lowerings
    assert n_low > 0 and cache.misses == 1
    r2 = eng.run(folds, lams)
    assert cache.lowerings == n_low and cache.hits == 1
    assert r2.extras["engine"]["tune"]["source"] == "cache"
    np.testing.assert_array_equal(r1.errors, r2.errors)
    folds2, lams2 = _problem(h=16, n=160)
    eng.run(folds2, lams2)
    assert cache.misses == 2 and cache.lowerings > n_low


def test_tuning_cache_persists_via_checkpoint_manager(tmp_path):
    folds, lams = _problem()
    cache = autotune.TuningCache()
    lattice = dict(blocks=(32, 64), mesh_shapes=[None])
    CVEngine("picholesky", backend="reference", tune="auto",
             tune_cache=cache, tune_lattice=lattice,
             device="cpu").run(folds, lams)
    cache.save(str(tmp_path))
    cache2 = autotune.TuningCache.load(str(tmp_path))
    assert len(cache2) == 1 and cache2.configs == cache.configs
    CVEngine("picholesky", backend="reference", tune="auto",
             tune_cache=cache2, tune_lattice=lattice,
             device="cpu").run(folds, lams)
    assert cache2.hits == 1 and cache2.lowerings == 0
    cache2.save(str(tmp_path))
    assert len(autotune.TuningCache.load(str(tmp_path))) == 1
    steps = [p.name for p in tmp_path.iterdir() if p.name.startswith("step")]
    assert len(steps) == 1                       # the older step pruned


def test_tuning_cache_load_missing_dir_is_empty(tmp_path):
    assert len(autotune.TuningCache.load(str(tmp_path / "nope"))) == 0


def test_explicit_tuned_config_pins_configuration():
    folds, lams = _problem()
    cfg = autotune.TunedConfig(block=32, lam_chunk=4, mesh_shape=None)
    eng = CVEngine("picholesky", backend="reference", tune=cfg,
                   device="cpu")
    r = eng.run(folds, lams)
    assert (r.extras["engine"]["tune"]["block"],
            r.extras["engine"]["tune"]["lam_chunk"]) == (32, 4)
    derived = eng._apply_tuned(cfg)
    assert derived.strategy.block == 32 and derived.lam_chunk == 4
    assert derived.tune is False
    assert eng._apply_tuned(cfg) is derived       # memoized
    with pytest.raises(ValueError, match="tune"):
        CVEngine("picholesky", tune="fast", device="cpu")


def test_every_entry_point_dispatches_through_the_tuned_engine():
    folds, lams = _problem()
    cfg = autotune.TunedConfig(block=32, lam_chunk=5, mesh_shape=None)
    eng = CVEngine("picholesky", backend="reference", tune=cfg,
                   device="cpu")
    derived = eng._apply_tuned(cfg)
    parts = list(eng.sweep_async(folds, lams))
    assert len(parts) == 4                        # ⌈16 / 5⌉ chunks
    want = derived.run(folds, lams)
    np.testing.assert_array_equal(np.concatenate([p.errors for p in parts]),
                                  want.errors)
    for res in (eng.run(folds, lams), eng.run_async(folds, lams),
                eng.search(folds, lams), *eng.run_batch([(folds, lams)])):
        assert res.extras["engine"]["tune"] == cfg.to_json()
        assert res.extras["engine"]["lam_chunk"] == 5
    np.testing.assert_array_equal(eng.run_async(folds, lams).errors,
                                  want.errors)


# -------------------------------------------------------------- serving


def test_server_tunes_once_per_geometry():
    from repro_torch.serving.server import CVSweepServer, ServerConfig, \
        SweepRequest

    folds, lams = _problem()
    srv = CVSweepServer(
        PiCholeskyStrategy(block=32), "reference", device="cpu",
        config=ServerConfig(
            tune="auto",
            tune_lattice=dict(blocks=(32, 64), mesh_shapes=[None])))
    for tenant in ("a", "b", "c"):
        srv.submit(SweepRequest(tenant=tenant, folds=folds, lams=lams))
    srv.drain()
    stats = srv.stats["tuning"]
    assert stats["entries"] == 1 and stats["misses"] == 1
    n_low = stats["lowerings"]
    srv.submit(SweepRequest(tenant="a", folds=folds, lams=lams))
    srv.drain()
    assert srv.stats["tuning"]["lowerings"] == n_low
    assert srv.stats["tuning"]["hits"] >= 1
    resp = srv.take_responses("a")
    assert len(resp) == 2
    cfg = autotune.TunedConfig.from_json(
        resp[0].result.extras["engine"]["tune"])
    solo = CVEngine(PiCholeskyStrategy(block=32), backend="reference",
                    device="cpu", tune=cfg).run(folds, lams)
    np.testing.assert_array_equal(resp[0].result.errors, solo.errors)

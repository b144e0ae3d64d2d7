"""The port's CV sweep server and traffic (``repro_torch.serving``) and
``CVEngine.run_batch`` against the JAX package.

The schedule of ``make_traffic`` (tenant, problem and grid of every
request) comes from the same numpy draws in both packages; the problems'
data do not (torch draws), so the served results are compared on a stream
the JAX package made, carried into the port request by request (one
``FoldData`` per distinct problem, so the sharing is the same).  Last, the
slice's entry points run on the CUDA device unless asked for the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro.core import engine as jengine  # noqa: E402
from repro.serving import CVSweepServer as JServer  # noqa: E402
from repro.serving import ServerConfig as JConfig  # noqa: E402
from repro.serving import TrafficConfig as JTraffic  # noqa: E402
from repro.serving import make_traffic as jmake_traffic  # noqa: E402
from repro.testing import strategies as props  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine, factor_cache as fc  # noqa: E402
from repro_torch.core.backends import CountingBackend, \
    ReferenceBackend  # noqa: E402
from repro_torch.serving import CVSweepServer, ServerConfig, \
    SweepRequest, TrafficConfig, make_traffic  # noqa: E402
from repro_torch.serving import traffic as ptraffic  # noqa: E402

LAMS = np.asarray(props.log_grid(17))
LAMS2 = np.asarray(props.log_grid(25))            # same decades
SHIFTED = np.asarray(props.log_grid(17, -2.0, 3.0))
#: a small stream: 3 problems, 3 tenants, two grid sizes, every 4th
#: request on the shifted range
SMALL = dict(n_requests=12, n_tenants=3, n_problems=3, h=12, n=96, k=4,
             grid_sizes=(9, 13), shifted_grid_every=4)


def _strat():
    return engine.PiCholeskyStrategy(g=4, block=8)


def _server(backend="reference", **cfg):
    return CVSweepServer(_strat(), backend=backend, device="cpu",
                         config=ServerConfig(**cfg))


def _folds(seed=1, h=20, n=160):
    jf = props.regression_folds(h=h, n=n, seed=seed)
    return convert.folds_from_numpy(jf, device="cpu")


def _solo(folds, lams, backend="reference"):
    """The solo cold run: a fresh cache-attached engine."""
    return engine.CVEngine(_strat(), backend=backend, device="cpu",
                           cache=fc.FactorCache(), reuse="covering",
                           cache_anchors=True).run(folds, lams)


def _schedule(reqs):
    """(tenant, problem index by first appearance, grid size, grid lo)."""
    ids: dict = {}
    out = []
    for r in reqs:
        p = ids.setdefault(id(r.folds), len(ids))
        lams = np.asarray(r.lams)
        out.append((r.tenant, p, lams.shape[0], float(lams[0])))
    return out


@pytest.mark.parametrize("cfg", [
    dict(n_requests=16, n_problems=3, h=12, n=96),
    dict(SMALL),
    dict(n_requests=24, n_problems=5, h=12, n=96, zipf_a=2.0, seed=7)],
    ids=["default-grids", "shifted", "hot-zipf"])
def test_traffic_schedule_equals_jax(cfg):
    jreqs = jmake_traffic(JTraffic(**cfg))
    reqs = make_traffic(TrafficConfig(**cfg), device="cpu")
    assert _schedule(reqs) == _schedule(jreqs)
    for r, jr in zip(reqs, jreqs):
        # np.logspace and jnp.logspace round a few grid points apart in
        # the last bits
        np.testing.assert_allclose(r.lams.numpy(), np.asarray(jr.lams),
                                   rtol=1e-14)
        assert r.folds.fold_hess.shape == jr.folds.fold_hess.shape
    again = make_traffic(TrafficConfig(**cfg), device="cpu")
    for a, b in zip(reqs, again):
        assert torch.equal(a.folds.hess, b.folds.hess)
    np.testing.assert_allclose(ptraffic.zipf_weights(5, 1.2).sum(), 1.0)


_JAX_STREAM: dict = {}


def _jax_stream():
    """The JAX package's small stream, served by its server once."""
    if not _JAX_STREAM:
        jreqs = jmake_traffic(JTraffic(**SMALL))
        srv = JServer(jengine.PiCholeskyStrategy(g=4, block=8),
                      config=JConfig(max_batch=4))
        for r in jreqs:
            srv.submit(r)
        _JAX_STREAM.update(reqs=jreqs, resps={
            r.request_id: r for r in srv.drain()})
    return _JAX_STREAM


def _port_requests(jreqs):
    carried: dict = {}
    return [SweepRequest(r.tenant, carried.setdefault(
        id(r.folds), convert.folds_from_numpy(r.folds, device="cpu")),
        np.asarray(r.lams)) for r in jreqs]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_served_stream_equals_solo_runs_and_jax(backend):
    stream = _jax_stream()
    reqs = _port_requests(stream["reqs"])
    srv = _server(backend, max_batch=4)
    for r in reqs:
        srv.submit(r)
    resps = {r.request_id: r for r in srv.drain()}
    assert len(resps) == len(reqs)
    for r in reqs:
        got = resps[r.request_id]
        solo = _solo(r.folds, r.lams, backend)
        np.testing.assert_array_equal(got.result.errors, solo.errors)
        want = stream["resps"][r.request_id]
        assert got.result.best_lam == want.result.best_lam
        assert got.status == want.status
        np.testing.assert_allclose(got.result.errors,
                                   np.asarray(want.result.errors), rtol=1e-9)
    assert srv.dispatches > 1


def test_in_batch_duplicate_costs_one_factorization():
    f = _folds(seed=3)
    bk = CountingBackend(ReferenceBackend())
    srv = CVSweepServer(_strat(), backend=bk, device="cpu")
    srv.submit(SweepRequest("t0", f, LAMS))
    srv.submit(SweepRequest("t1", f, LAMS))
    resps = srv.drain()
    assert sorted(r.status for r in resps) == ["hit", "miss"]
    assert bk.n_cholesky == 1            # one batched call, the cold one
    by_status = {r.status: r for r in resps}
    assert by_status["miss"].result.n_exact_chol == 16
    assert by_status["hit"].result.n_exact_chol == 0
    np.testing.assert_array_equal(resps[0].result.errors,
                                  resps[1].result.errors)


def test_admission_groups_and_fifo():
    f = _folds(seed=1)
    srv = _server(max_batch=8)
    srv.submit(SweepRequest("early", f, SHIFTED))
    srv.submit(SweepRequest("a", f, LAMS))
    srv.submit(SweepRequest("c", f, LAMS2))     # same anchors as "a"
    assert len(srv._queues) == 2
    assert [r.tenant for r in srv.step()] == ["early"]
    second = srv.step()
    assert {r.tenant for r in second} == {"a", "c"}
    assert all(r.batch_size == 2 for r in second)
    k = srv._admission_key(SweepRequest("x", f, LAMS))
    assert "float64" in k and k[0] == "grid"
    assert srv._admission_key(SweepRequest("x", f, LAMS,
                                           mode="search"))[0] == "search"
    with pytest.raises(ValueError, match="precision"):
        srv.submit(SweepRequest("a", f, LAMS, precision="float128_maybe"))
    with pytest.raises(ValueError, match="mode"):
        srv.submit(SweepRequest("a", f, LAMS, mode="binary"))
    assert srv.pending == 0 and list(srv._engines) == ["native"]


def test_tenant_isolation_and_stat_partitions():
    srv = _server(max_batch=6)
    for req in make_traffic(TrafficConfig(n_requests=18, n_tenants=3,
                                          n_problems=3, h=12, n=96),
                            device="cpu"):
        srv.submit(req)
    srv.drain()
    st = srv.stats
    assert st["served"] == 18
    for field in ("hits", "misses"):
        assert sum(t[field] for t in st["tenants"].values()) == \
            st["cache"][field]
    assert srv.cache.hit_rate() > 0
    got = srv.take_responses("tenant-0")
    assert len(got) == 6 and all(r.tenant == "tenant-0" for r in got)
    assert srv.take_responses("tenant-0") == []
    assert srv.take_responses("nobody") == []


def test_no_stale_read_under_eviction_pressure():
    problems = [_folds(seed=s) for s in (10, 11, 12, 13)]
    probe = _server()
    probe.submit(SweepRequest("size", problems[0], LAMS))
    probe.drain()
    entry = next(iter(probe.cache.entries.values())).nbytes
    srv = _server(max_batch=2, cache_bytes=2 * entry + entry // 2)
    for _ in range(2):
        for i, f in enumerate(problems):
            srv.submit(SweepRequest(f"t{i % 2}", f, LAMS))
        srv.drain()
    assert srv.cache.evictions > 0
    for f in problems:
        srv.submit(SweepRequest("probe", f, LAMS))
    for resp, f in zip(srv.drain(), problems):
        np.testing.assert_array_equal(resp.result.errors,
                                      _solo(f, LAMS).errors)


def test_search_mode_uses_fewer_evaluations_and_shares_the_cache():
    f = _folds(seed=7)
    dense = np.asarray(props.log_grid(96))
    srv = _server(search_tol=0.05, search_wave=6)
    srv.submit(SweepRequest("a", f, dense, mode="search"))
    srv.submit(SweepRequest("b", f, dense, mode="search"))
    ra, rb = srv.step()
    info = ra.result.extras["engine"]["search"]
    assert info["wave"] == 6 and info["lams_evaluated"] < dense.size
    assert ra.status == "miss" and rb.status == "hit"
    assert rb.result.n_exact_chol == 0
    srv.submit(SweepRequest("a", f, dense))
    (rg,) = srv.step()
    assert rg.status == "hit" and rg.result.errors.size == dense.size
    gap = abs(np.log10(ra.result.best_lam) - np.log10(rg.result.best_lam))
    assert gap <= info["tol_decades"] + 5.0 / 95.0


def test_run_batch_fallbacks_and_checks():
    fa, fb = _folds(seed=1), _folds(seed=2, h=12, n=96)
    eng = engine.CVEngine(_strat(), device="cpu", cache=fc.FactorCache(),
                          reuse="covering", cache_anchors=True)
    res = eng.run_batch([(fa, LAMS), (fb, LAMS)], tenants=["a", "b"])
    for r, f in zip(res, (fa, fb)):
        assert "batch" not in r.extras["engine"]
        np.testing.assert_array_equal(r.errors, _solo(f, LAMS).errors)
    assert set(eng.cache.tenant_stats) == {"a", "b"}
    with pytest.raises(ValueError, match="tenant"):
        eng.run_batch([(fa, LAMS)], tenants=["a", "b"])
    assert eng.run_batch([]) == []
    (r,) = engine.CVEngine(_strat(), device="cpu").run_batch([(fa, LAMS)])
    np.testing.assert_array_equal(
        r.errors, engine.CVEngine(_strat(), device="cpu").run(fa,
                                                              LAMS).errors)
    # tune= reaches every pooled engine, which share the server's one
    # tuning cache (tests/test_torch_autotune.py drives it)
    srv = CVSweepServer(_strat(), device="cpu",
                        config=ServerConfig(tune="auto"))
    assert srv.engine().tune == "auto"
    assert srv.engine().tune_cache is srv.tune_cache
    assert srv.stats["tuning"] == dict(entries=0, hits=0, misses=0,
                                       lowerings=0)


@pytest.mark.parametrize("entry", ["FactorCache.load",
                                   "CheckpointManager.restore",
                                   "CVSweepServer", "make_traffic",
                                   "CVEngine(cache=)"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    calls = {
        "FactorCache.load": lambda: fc.FactorCache.load(str(tmp_path)),
        "CheckpointManager.restore": lambda: CheckpointManager(
            str(tmp_path)).restore(0, {"w": torch.zeros(2)}),
        "CVSweepServer": lambda: CVSweepServer(_strat()),
        "make_traffic": lambda: make_traffic(TrafficConfig(
            n_requests=2, n_problems=1, h=8, n=64)),
        "CVEngine(cache=)": lambda: engine.CVEngine(
            _strat(), cache=fc.FactorCache()),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()

"""The CV half of ``distributed/`` held to the JAX package: the sharding
helpers, ``StageRing``, ``MeshCtx``, the roofline (the reference's terms
on the same numbers, and its preset tests on the port's presets), the
launch-plan cost against what the engine runs, the engine's folds × λ
mesh over repeated CPU devices (bit for bit against the unsharded engine,
1e-10 of JAX's), ``donate``, ``sweep_temp_bytes`` on the CPU, and
``RidgeCV(ctx=, cv_mesh=)``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cv as jcv  # noqa: E402
from repro.core.engine import CVEngine as JEngine  # noqa: E402
from repro.core.ridge_cv import RidgeCV as JRidgeCV  # noqa: E402
from repro.data import make_regression_dataset  # noqa: E402
from repro.distributed import dtype_bytes as jdtype_bytes  # noqa: E402
from repro.distributed import roofline as jrl  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.distributed.context import MeshCtx as JMeshCtx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.backends import CountingBackend, \
    resolve_backend  # noqa: E402
from repro_torch.core.folds import FoldData  # noqa: E402
from repro_torch.core.ridge_cv import RidgeCV  # noqa: E402
from repro_torch.distributed import dtype_bytes, plan_cost  # noqa: E402
from repro_torch.distributed import roofline as rl  # noqa: E402
from repro_torch.distributed import sharding as shard  # noqa: E402
from repro_torch.distributed.context import MeshCtx  # noqa: E402

CPU = torch.device("cpu")
#: the port's engine against JAX's on the same folds: one float64 algorithm
#: in other summation orders
CURVE_RTOL = 1e-10
H, N, BLOCK, Q = 32, 240, 16, 9
LAMS = np.logspace(-3, 2, Q)


# ---------------------------------------------------------------- sharding


def test_dtype_bytes_table_equals_jax():
    assert dtype_bytes.DTYPE_BYTES == jdtype_bytes.DTYPE_BYTES
    for dt, n in ((torch.float64, 8), (torch.float32, 4),
                  (torch.bfloat16, 2), (torch.int32, 4)):
        assert dtype_bytes.itemsize(dt) == n == dt.itemsize


def test_mesh_shapes_equal_jax():
    assert (shard.CV_FOLD_AXIS, shard.CV_LAM_AXIS) == \
        (jshard.CV_FOLD_AXIS, jshard.CV_LAM_AXIS)
    for k in range(1, 9):
        for n in range(1, 9):
            assert shard.cv_axis_sizes(k, n) == jshard.cv_axis_sizes(k, n)
            assert shard.mesh_shape_candidates(k, n) == \
                jshard.mesh_shape_candidates(k, n)


@pytest.mark.parametrize("k, n", [(4, 4), (3, 4), (2, 4), (5, 1), (4, 3)])
def test_make_cv_mesh_shape_equals_jax(k, n):
    mesh = shard.make_cv_mesh(k, [CPU] * n)
    jmesh = jshard.make_cv_mesh(k, jax.devices()[:n])
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.size == int(np.prod(list(jmesh.shape.values())))


def test_make_cv_mesh_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh spans it")
    with pytest.raises(RuntimeError, match="CUDA"):
        shard.make_cv_mesh(4)
    with pytest.raises(ValueError, match="devices"):
        shard.cv_mesh([CPU] * 3, 2, 2)


@pytest.mark.parametrize("n, multiple", [(7, 3), (9, 3), (1, 4), (5, 1)])
def test_pad_to_multiple_equals_jax(n, multiple):
    x = np.arange(n * 2, dtype=np.float64).reshape(n, 2)
    got, m = shard.pad_to_multiple(torch.from_numpy(x), multiple)
    want, jm = jshard.pad_to_multiple(jnp.asarray(x), multiple)
    assert m == jm == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got1, _ = shard.pad_to_multiple(torch.from_numpy(x.T.copy()), multiple,
                                    axis=1)
    want1, _ = jshard.pad_to_multiple(jnp.asarray(x.T), multiple, axis=1)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


def test_chunking_helpers_equal_jax():
    lams = np.logspace(-3, 0, 31)
    for chunk in (1, 3, 4, 31, 40):
        got, q = shard.chunk_lams(torch.from_numpy(lams), chunk)
        want, jq = jshard.chunk_lams(jnp.asarray(lams), chunk)
        assert q == jq
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="positive"):
        shard.chunk_lams(torch.from_numpy(lams), 0)
    for h, block, budget in ((1024, 128, 16 << 20), (24, 128, 64 << 10),
                             (24, 32, 64 << 10), (64, 16, 1)):
        for tdt, jdt in ((torch.float64, jnp.float64),
                         (torch.bfloat16, jnp.bfloat16)):
            assert shard.auto_lam_chunk(h, block, tdt, budget) == \
                jshard.auto_lam_chunk(h, block, jdt, budget)
    # the engine keeps re-exporting them
    assert engine.chunk_lams is shard.chunk_lams
    assert engine.auto_lam_chunk is shard.auto_lam_chunk


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stage_ring_depth_semantics_equal_jax(depth):
    ring, jring = shard.StageRing(depth), jshard.StageRing(depth)
    for i in range(5):
        ring.admit((torch.full((2,), float(i)),))
        jring.admit((jnp.full((2,), float(i)),))
        assert len(ring._live) == len(jring._live) == min(i + 1, depth)
    assert float(ring._live[0][0][0]) == float(jring._live[0][0][0])
    ring.drain()
    jring.drain()
    assert ring._live == [] and jring._live == []
    for cls in (shard.StageRing, jshard.StageRing):
        with pytest.raises(ValueError, match="depth"):
            cls(0)


def test_meshctx_equals_jax():
    ctx, jctx = MeshCtx(None), JMeshCtx(None)
    x = torch.ones(4, 3)
    assert ctx.constrain(x, "data") is x
    assert ctx.sharding("data") is None and jctx.sharding("data") is None
    for attr in ("dp_size", "tp_size", "fsdp_axis", "dp_axes"):
        assert getattr(ctx, attr) == getattr(jctx, attr)
    assert ctx.axis_size("data") == jctx.axis_size("data") == 1
    mesh = shard.make_cv_mesh(4, [CPU] * 4)
    ctx = MeshCtx.from_mesh(mesh, fsdp=True)
    jctx = JMeshCtx.from_mesh(jshard.make_cv_mesh(4, jax.devices()[:4]),
                              fsdp=True)
    for attr in ("dp_axes", "dp_size", "fsdp_axis"):
        assert getattr(ctx, attr) == getattr(jctx, attr)
    for name in mesh.axis_names:
        assert ctx.axis_size(name) == jctx.axis_size(name)
    assert ctx.constrain(x, ctx.dp_axes, None).device == CPU
    assert ctx.sharding(ctx.dp_axes) == (mesh, (ctx.dp_axes,))
    with pytest.raises(ValueError, match="not an axis"):
        ctx.constrain(x, "model")


# ---------------------------------------------------------------- roofline


def _both_rooflines(temp, cache: bool, wire=3.0):
    kw = dict(name="toy", peak_flops=100.0, hbm_bw=10.0, link_bw=1.0)
    if cache:
        kw.update(cache_bw=100.0, cache_bytes=1000.0)
    args = dict(flops=200.0, hbm_bytes=50.0, wire_bytes=wire,
                by_collective={}, chips=1, temp_bytes=temp)
    return (rl.Roofline(hw=rl.HW(**kw), **args),
            jrl.Roofline(hw=jrl.HW(**kw), **args))


@pytest.mark.parametrize("temp", [None, 5.0, 800.0, 2000.0, 1e4])
@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("wire", [3.0, 70.0])
def test_roofline_terms_equal_jax(temp, cache, wire):
    got, want = _both_rooflines(temp, cache, wire)
    for term in ("compute_s", "memory_s", "collective_s", "effective_bw",
                 "step_s", "bottleneck"):
        assert getattr(got, term) == getattr(want, term), term
    assert got.launch_time_s == 0.0


def test_roofline_launch_term():
    hw = rl.HW(name="toy", peak_flops=100.0, hbm_bw=10.0, link_bw=1.0,
               launch_s=0.5)
    roof = rl.Roofline(flops=200.0, hbm_bytes=50.0, wire_bytes=3.0,
                       by_collective={}, chips=1, hw=hw, launches=4)
    assert roof.launch_time_s == 2.0
    assert roof.step_s == 5.0 + 2.0          # max(terms) + launches·launch_s
    roof.launches = 40
    assert roof.bottleneck == "launch"
    assert roof.summary()["launches"] == 40


def test_hw_presets_cover_platforms():
    assert set(rl.HW_PRESETS) == {"cpu", "h100-sxm", "h100-pcie",
                                  "h100-nvl"}
    for hw in rl.HW_PRESETS.values():
        assert hw.peak_flops > 0 and hw.hbm_bw > 0 and hw.link_bw > 0
        assert hw.launch_s >= 0
    assert rl.HW_PRESETS["cpu"].launch_s == 0.0
    for part in ("SXM", "PCIe", "NVL"):
        hw = rl.HW_PRESETS["h100-" + part.lower()]
        assert (hw.peak_flops, hw.hbm_bw) == (rl.PEAKS[part]["fp64_tc"],
                                              rl.PEAKS[part]["bw"])
        assert hw.launch_s == rl.LAUNCH_S
    # the card's part by its name
    assert rl.h100_part("NVIDIA H100 80GB HBM3") == "SXM"
    assert rl.h100_part("NVIDIA H100 PCIe") == "PCIe"
    assert rl.h100_part("NVIDIA H100 NVL") == "NVL"
    assert rl.peaks_for("NVIDIA H100 NVL")["part"] == "NVL"


def test_detect_hw_platform_and_env_override(monkeypatch):
    from repro_torch.core.precision import PRESETS
    monkeypatch.delenv("REPRO_HW", raising=False)
    if not torch.cuda.is_available():
        assert rl.detect_hw() == rl.HW_PRESETS["cpu"]
        assert rl.detect_hw(torch.float64) == rl.HW_PRESETS["cpu"]
    monkeypatch.setenv("REPRO_HW", "h100-sxm")
    assert rl.detect_hw().name == "h100-sxm"
    sxm = rl.PEAKS["SXM"]
    assert rl.detect_hw(torch.float64).peak_flops == sxm["fp64_tc"]
    assert rl.detect_hw(torch.float32).peak_flops == sxm["fp32"]
    for policy in ("bf16_store", "bf16_refined"):
        assert rl.detect_hw(torch.float32, PRESETS[policy]).peak_flops == \
            sxm["bf16_tc"]
    monkeypatch.setenv("REPRO_HW_PEAK_FLOPS", "1e12")
    hw = rl.detect_hw()
    assert hw.peak_flops == 1e12 and hw.name.endswith("+env")
    assert hw.launch_s == rl.LAUNCH_S
    assert hw.hbm_bw == rl.HW_PRESETS["h100-sxm"].hbm_bw
    for name in ("tpu", "gpu", "hal9000"):
        monkeypatch.setenv("REPRO_HW", name)
        with pytest.raises(ValueError, match="no such preset.*h100-sxm"):
            rl.detect_hw()


def test_roofline_uses_hw_rates():
    hw = rl.HW(name="toy", peak_flops=100.0, hbm_bw=10.0, link_bw=1.0)
    roof = rl.Roofline(flops=200.0, hbm_bytes=50.0, wire_bytes=3.0,
                       by_collective={}, chips=1, hw=hw)
    assert roof.compute_s == 2.0 and roof.memory_s == 5.0
    assert roof.collective_s == 3.0
    assert roof.step_s == 5.0 and roof.bottleneck == "memory"
    s = roof.summary()
    assert s["step_s"] == 5.0 and s["hw"] == "toy"


# --------------------------------------------------------------- plan cost


@pytest.fixture(scope="module")
def folds():
    x, y = make_regression_dataset(jax.random.PRNGKey(5), N, H,
                                   dtype=jnp.float64)
    return {k: (convert.folds_from_numpy(jf := jcv.make_folds(x, y, k),
                                         device="cpu"), jf)
            for k in (3, 4, 5)}


class _Spy(CountingBackend):
    """Counts the pack and the dense trsm too (the plan prices them)."""

    def pack_tril(self, mat, block):
        self._count("pack_tril")
        return super().pack_tril(mat, block)

    def solve_lower(self, l, b, *, transpose=False):
        self._count("solve_lower")
        return super().solve_lower(l, b, transpose=transpose)

    def solve_from_factor(self, l, g):      # the dense pair, counted
        w = self.solve_lower(l, g)
        return self.solve_lower(l, w, transpose=True)


@pytest.mark.parametrize("name, policy", [("picholesky", "native"),
                                          ("picholesky", "bf16_refined"),
                                          ("exact", "native"),
                                          ("picholesky_warmstart", "native"),
                                          ("pinrmse", "native")])
@pytest.mark.parametrize("block, chunk, q", [(16, 3, 9), (32, 4, 7),
                                             (16, None, 5), (16, 16, 9)])
def test_plan_calls_equal_what_the_engine_runs(folds, name, policy, block,
                                               chunk, q):
    tf = folds[4][0]
    kw = {} if name in ("exact", "pinrmse") else dict(block=block)
    spy = _Spy(resolve_backend("cuda", block=block, precision=policy,
                               device="cpu"))
    eng = engine.CVEngine(engine.make_strategy(name, **kw), backend=spy,
                          lam_chunk=chunk, device="cpu")
    eng.run(tf, LAMS[:q])
    cost, chips = plan_cost.engine_cost(eng, 4, H, q, torch.float64)
    assert chips == 1
    want = {stage: dict(rec) for stage, rec in spy.by_stage.items()}
    assert cost.calls == want
    trips = 1 if chunk is None or chunk >= q else -(-q // chunk)
    assert cost.trips == trips
    chol = plan_cost.chol_launches(H, block)
    launches = sum(ln.calls * (chol if ln.kernel == "cholesky" else 1)
                   for ln in cost.plan)
    assert cost.launches == launches


@pytest.mark.parametrize("name", ["svd", "low_rank"])
def test_a_strategy_without_a_launch_plan_is_not_tuned(folds, name):
    # neither runs a kernel of the port: no plan to price, so tune= refuses
    strat = engine.make_strategy(name)
    assert strat.launch_plan is None
    prec = resolve_backend("cuda", device="cpu").precision
    with pytest.raises(ValueError, match="no launch plan"):
        plan_cost.price_sweep(strat, h=H, k=4, q=5, dtype=torch.float64,
                              precision=prec, block=16, chunk=None)
    eng = engine.CVEngine(strat, backend="cuda", device="cpu", tune="auto")
    with pytest.raises(ValueError, match="no launch plan"):
        eng.run(folds[4][0], LAMS[:5])


def test_plan_cost_scales_with_trips():
    strat = engine.make_strategy("picholesky", g=4, block=16)
    prec = resolve_backend("cuda", device="cpu").precision
    kw = dict(h=64, k=4, q=32, dtype=torch.float64, precision=prec,
              block=16)
    one = plan_cost.price_sweep(strat, chunk=32, **kw)
    for chunk in (1, 2, 4, 8, 16):
        c = plan_cost.price_sweep(strat, chunk=chunk, **kw)
        extra = 32 // chunk - 1
        assert c.trips == 32 // chunk
        assert c.launches - one.launches == extra
        # every trip re-reads Θ (and the right-hand sides)
        p = plan_cost._packed(64, 16)
        theta = 4 * 3 * p * 8 + 4 * 64 * 8
        assert c.hbm_bytes - one.hbm_bytes == pytest.approx(extra * theta)
        assert c.flops == pytest.approx(one.flops)
    # a mesh prices the busiest device: half the folds, half the λs
    m = plan_cost.price_sweep(strat, chunk=8, n_fold=2, n_lam=2, **kw)
    c8 = plan_cost.price_sweep(strat, chunk=8, **kw)
    assert m.trips == 2 and c8.trips == 4
    for a, b in zip(m.plan, c8.plan):
        assert (a.kernel, a.stage) == (b.kernel, b.stage)
        assert a.flops == pytest.approx(b.flops / 2)     # k / 2 folds a call
        if a.stage == "fold_errors":                     # q / 2 λs: half
            assert a.calls * 2 == b.calls                # the trips
    assert set(m.wire) == {"scatter", "broadcast", "gather"}
    assert m.wire_bytes > 0 == c8.wire_bytes


# ------------------------------------------------------------- engine mesh


@pytest.fixture(scope="module")
def jax_curves(folds):
    """JAX's unsharded engine, once per fold count and strategy."""
    out = {}
    for k in (3, 4, 5):
        jf = folds[k][1]
        out[k, "exact"] = JEngine("exact", backend="reference",
                                  lam_chunk=3).run(jf, jnp.asarray(LAMS))
        out[k, "picholesky"] = JEngine(
            jcv.make_strategy("picholesky", g=4, block=BLOCK),
            backend="reference", lam_chunk=3).run(jf, jnp.asarray(LAMS))
    return out


def _strategy(name):
    return engine.make_strategy("exact") if name == "exact" else \
        engine.make_strategy("picholesky", g=4, block=BLOCK)


@pytest.mark.parametrize("name", ["picholesky", "exact"])
@pytest.mark.parametrize("k, n_dev", [(4, 4), (5, 4), (4, 2), (3, 6)])
def test_mesh_bitwise_unsharded_and_close_to_jax(folds, jax_curves, name, k,
                                                 n_dev):
    tf = folds[k][0]
    mesh = shard.make_cv_mesh(k, [CPU] * n_dev)
    kw = dict(backend="cuda", block=BLOCK, lam_chunk=3, device="cpu")
    base = engine.CVEngine(_strategy(name), **kw).run(tf, LAMS)
    eng = engine.CVEngine(_strategy(name), mesh=mesh, **kw)
    res = eng.run(tf, LAMS)
    np.testing.assert_array_equal(res.errors, base.errors)
    assert res.extras["engine"]["mesh"] == mesh.shape == \
        dict(zip(("folds", "lams"), shard.cv_axis_sizes(k, n_dev)))
    want = jax_curves[k, name]
    np.testing.assert_allclose(res.errors, np.asarray(want.errors),
                               rtol=CURVE_RTOL)
    assert res.best_lam == base.best_lam
    assert int(np.argmin(res.errors)) == int(np.argmin(want.errors))
    # the staged sweep and the search split the same way
    parts = list(eng.sweep_async(tf, LAMS))
    np.testing.assert_array_equal(np.concatenate([p.errors for p in parts]),
                                  base.errors)
    ra = eng.run_async(tf, LAMS)
    assert ra.extras["engine"]["mesh"] == mesh.shape
    s = eng.search(tf, LAMS, wave=4)
    assert s.extras["engine"]["mesh"] == mesh.shape
    n_lam = mesh.shape["lams"]
    assert s.extras["engine"]["search"]["wave"] % n_lam == 0


@pytest.mark.parametrize("k, c", [(1, 1), (3, 2), (5, 7)])
def test_holdout_scores_do_not_depend_on_the_batch(folds, k, c):
    """A (fold, λ)'s score is the same bits alone and in any batch: what
    makes the mesh and every λ chunk give the unsharded curve."""
    from repro_torch.core.folds import holdout_nrmse
    tf = folds[5][0]
    theta = torch.from_numpy(np.random.default_rng(k).normal(
        size=(5, 7, H)))
    whole = holdout_nrmse(theta, tf.x_folds[:, None], tf.y_folds[:, None])
    part = holdout_nrmse(theta[:k, :c], tf.x_folds[:k, None],
                         tf.y_folds[:k, None])
    assert torch.equal(part, whole[:k, :c])


def test_mesh_auto_on_one_device_runs_unsharded(folds):
    tf = folds[4][0]
    eng = engine.CVEngine(_strategy("picholesky"), backend="cuda",
                          block=BLOCK, device="cpu", mesh="auto")
    res = eng.run(tf, LAMS)
    assert res.extras["engine"]["mesh"] is None
    base = engine.CVEngine(_strategy("picholesky"), backend="cuda",
                           block=BLOCK, device="cpu").run(tf, LAMS)
    np.testing.assert_array_equal(res.errors, base.errors)


def test_mesh_refuses_a_fold_axis_that_does_not_divide_k(folds):
    tf = folds[3][0]
    mesh = shard.cv_mesh([CPU] * 2, 2, 1)
    for fn in (lambda e: e.run(tf, LAMS),
               lambda e: list(e.sweep_async(tf, LAMS)),
               lambda e: e.search(tf, LAMS)):
        with pytest.raises(ValueError, match="3 folds not divisible by "
                                             "mesh axis folds=2"):
            fn(engine.CVEngine("exact", device="cpu", mesh=mesh))
    with pytest.raises(ValueError, match="mesh"):
        engine.CVEngine("exact", device="cpu", mesh=[CPU])


def _snapshot(f: FoldData) -> list:
    return [getattr(f, fl.name).clone() for fl in dataclasses.fields(f)]


@pytest.mark.parametrize("name, policy", [("picholesky", "native"),
                                          ("picholesky", "bf16_refined"),
                                          ("exact", "native"),
                                          ("pinrmse", "native")])
def test_donate_same_bits_and_caller_folds_untouched(folds, name, policy):
    tf = folds[4][0]
    before = _snapshot(tf)
    runs = {}
    for donate in (True, False):
        eng = engine.CVEngine(
            engine.make_strategy(name) if name in ("exact", "pinrmse")
            else _strategy(name), backend="cuda", block=BLOCK,
            precision=policy, lam_chunk=3, device="cpu", donate=donate)
        runs[donate] = eng.run(tf, LAMS)
        assert runs[donate].extras["engine"]["donated"] is donate
        parts = list(eng.sweep_async(tf, LAMS))
        np.testing.assert_array_equal(
            np.concatenate([p.errors for p in parts]), runs[donate].errors)
    np.testing.assert_array_equal(runs[True].errors, runs[False].errors)
    for a, b in zip(before, _snapshot(tf)):
        assert torch.equal(a, b)
    # donate=None is False on the CPU
    assert engine.CVEngine("exact", device="cpu").donate is False


def test_sweep_temp_bytes_raise_on_a_cpu_engine(folds):
    tf = folds[4][0]
    eng = engine.CVEngine(_strategy("picholesky"), device="cpu")
    for fn in (eng.sweep_temp_bytes, eng.replay_temp_bytes):
        with pytest.raises(NotImplementedError, match="card"):
            fn(tf, LAMS)


# ------------------------------------------------------------------ RidgeCV


@pytest.mark.parametrize("method", ["pichol", "exact"])
def test_ridge_cv_ctx_and_cv_mesh_equal_jax(method):
    x, y = make_regression_dataset(jax.random.PRNGKey(9), 300, 24,
                                   dtype=jnp.float64)
    kw = dict(k_folds=4, n_lambdas=9, block=16, method=method)
    want = JRidgeCV(**kw).fit(x, y)
    xt, yt = torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y))
    mesh = shard.make_cv_mesh(4, [CPU] * 4)
    for ctx, cv_mesh in ((MeshCtx(None), None), (MeshCtx(None), mesh),
                         (MeshCtx.from_mesh(mesh), "auto")):
        got = RidgeCV(backend="reference", device="cpu", ctx=ctx,
                      cv_mesh=cv_mesh, **kw).fit(xt, yt)
        np.testing.assert_allclose(got.errors, np.asarray(want.errors),
                                   rtol=1e-9)
        assert got.best_lam == pytest.approx(float(want.best_lam),
                                             rel=1e-15)
        assert int(np.argmin(got.errors)) == int(np.argmin(want.errors))

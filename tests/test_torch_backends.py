"""The port's backend layer: ``CountingBackend`` (counts per call site and
per engine stage, transparent to name and precision, counters shared by
``with_precision`` and ``retile_backend``), ``retile_backend`` and its
block refusal, ``chol_fn=`` overrides (used, and not counted as the
backend's factorization), and ``kernels.ops`` against the plain versions
on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cv as jcv  # noqa: E402
from repro.data import make_regression_dataset  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cv, engine, packing, picholesky  # noqa: E402
from repro_torch.core import solvers  # noqa: E402
from repro_torch.core.backends import (CountingBackend, CudaBackend,  # noqa
                                       ReferenceBackend, resolve_backend,
                                       retile_backend)
from repro_torch.core.precision import PRESETS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

H, BLOCK, K, Q = 40, 16, 4, 7
LAMS = np.logspace(-3, 2, Q)


@pytest.fixture(scope="module")
def folds():
    x, y = make_regression_dataset(jax.random.PRNGKey(3), 240, H,
                                   dtype=jnp.float64)
    return convert.folds_from_numpy(jcv.make_folds(x, y, K), device="cpu")


def _run(folds, name, bk, lam_chunk=3, **params):
    strat = engine.make_strategy(name, **params)
    return engine.CVEngine(strat, backend=bk, block=BLOCK,
                           lam_chunk=lam_chunk, device="cpu").run(folds, LAMS)


@pytest.mark.parametrize("inner", [ReferenceBackend(), CudaBackend(16, 16)],
                         ids=["reference", "cuda"])
def test_counts_by_stage(folds, inner):
    """Cold picholesky: its factorization under 'fold_state', one fused
    interpolant solve per λ chunk under 'fold_errors'; exact: one
    factorization per chunk under 'fold_errors'.  The port runs eagerly, so
    each executed call counts once (a batched call over every fold once)."""
    n_chunks = -(-Q // 3)
    bk = CountingBackend(inner)
    _run(folds, "picholesky", bk, g=4, block=BLOCK)
    assert bk.by_stage == {"fold_state": {"cholesky": 1},
                           "fold_errors": {"interp_solve": n_chunks}}
    assert bk.n_cholesky == 1
    bk.reset()
    assert bk.n_cholesky == 0 and bk.by_stage == {}
    _run(folds, "exact", bk)
    assert bk.by_stage == {"fold_errors": {"cholesky": n_chunks}}
    assert bk.stage_count("fold_state") == 0


@pytest.mark.parametrize("inner", [ReferenceBackend(), CudaBackend(16, 16)],
                         ids=["reference", "cuda"])
def test_new_strategies_count_where_they_factorize(folds, inner):
    """Warm-start factorizes its anchor fit in 'prepare' and its refresh
    in 'fold_state', and solves in 'fold_errors'; PINRMSE factorizes in
    'prepare' only; the SVD family and low rank never."""
    bk = CountingBackend(inner)
    _run(folds, "picholesky_warmstart", bk, g_rest=2, block=BLOCK)
    assert bk.stage_count("prepare") == 1
    assert bk.stage_count("fold_state") == 1
    assert bk.stage_count("fold_errors", "interp_solve") == -(-Q // 3)
    assert bk.stage_count("fold_errors") == 0
    bk.reset()
    _run(folds, "pinrmse", bk)
    assert bk.by_stage == {"prepare": {"cholesky": 1}}
    for name in ("svd", "low_rank"):
        bk.reset()
        _run(folds, name, bk)
        assert bk.n_cholesky == 0 and bk.by_stage == {}


def test_unscoped_calls_and_nested_stages():
    bk = CountingBackend(ReferenceBackend())
    a = torch.eye(4, dtype=torch.float64) * 2
    bk.cholesky(a)
    with bk.stage("outer"):
        bk.cholesky(a)
        with bk.stage("inner"):
            bk.cholesky(a)
            vec = bk.pack_tril(torch.eye(4, dtype=torch.float64), 2)
            bk.solve_packed(packing.PackedFactor(vec, 4, 2),
                            torch.ones(4, dtype=torch.float64))
        bk.cholesky(a)
    assert bk.by_stage == {"unstaged": {"cholesky": 1},
                           "outer": {"cholesky": 2},
                           "inner": {"cholesky": 1, "solve_packed": 1}}
    assert bk.n_cholesky == 4


def test_transparent_to_name_and_precision_with_shared_counts():
    bk = CountingBackend(CudaBackend())
    assert bk.name == "cuda" and bk.precision is PRESETS["native"]
    view = bk.with_precision(PRESETS["fp32"])
    assert view.precision == PRESETS["fp32"]
    assert bk.precision is PRESETS["native"]          # not mutated
    assert view.by_stage is bk.by_stage               # not forked
    view.cholesky(torch.eye(3, dtype=torch.float64))
    assert bk.n_cholesky == 1
    # an engine attaching a policy counts into the caller's object
    eng = engine.CVEngine("exact", backend=bk, precision="fp32",
                          device="cpu")
    assert eng._bk.by_stage is bk.by_stage
    assert resolve_backend(bk) is bk


def test_retile_backend_and_block_refusal():
    cb = retile_backend(CudaBackend(), chol_block=64)
    assert (cb.chol_block, cb.trsm_block) == (64, 128)
    rb = ReferenceBackend()
    assert retile_backend(rb, chol_block=64) is rb     # no kernel tiles
    assert retile_backend(cb) is cb
    counting = CountingBackend(CudaBackend())
    counting.by_stage["unstaged"] = {"cholesky": 3}
    re = retile_backend(counting, chol_block=32, trsm_block=16)
    assert re is not counting and re.by_stage is counting.by_stage
    assert (re.inner.chol_block, re.inner.trsm_block) == (32, 16)
    assert retile_backend(CountingBackend(rb), chol_block=64).inner is rb
    # the card's kernels are compiled for _build.BLOCKS only
    for kw in (dict(chol_block=48), dict(trsm_block=256), dict(chol_block=8)):
        with pytest.raises(ValueError, match="block must be one of"):
            retile_backend(CudaBackend(), **kw)
        with pytest.raises(ValueError, match="block must be one of"):
            retile_backend(counting, **kw)


class _CountingChol:
    """A ``chol_fn``: torch.linalg.cholesky, with its calls counted."""

    def __init__(self):
        self.calls = 0

    def __call__(self, a):
        self.calls += 1
        return torch.linalg.cholesky(a)


@pytest.mark.parametrize("driver", ["exact", "picholesky", "warmstart",
                                    "pinrmse", "mchol"])
def test_chol_fn_override_is_used_and_counted(folds, driver):
    """A chol_fn replaces the backend's factorization on every path: it is
    called, the backend's cholesky is not, and the curve is that of the
    reference backend (torch.linalg.cholesky is its factorization)."""
    chol = _CountingChol()
    bk = CountingBackend(CudaBackend(16, 16))
    runs = {
        "exact": lambda b, c: cv.cv_exact_cholesky(folds, LAMS, c, backend=b,
                                                   device="cpu"),
        "picholesky": lambda b, c: cv.cv_picholesky(
            folds, LAMS, block=BLOCK, chol_fn=c, backend=b, device="cpu"),
        "warmstart": lambda b, c: cv.cv_picholesky_warmstart(
            folds, LAMS, block=BLOCK, chol_fn=c, backend=b, device="cpu"),
        "pinrmse": lambda b, c: cv.cv_pinrmse(folds, LAMS, 4, 2, c,
                                              backend=b, device="cpu"),
        "mchol": lambda b, c: cv.cv_multilevel_cholesky(
            folds, 0.0, 1.5, 0.1, c, backend=b, device="cpu"),
    }
    got = runs[driver](bk, chol)
    assert chol.calls > 0 and bk.n_cholesky == 0
    want = runs[driver](ReferenceBackend(), None)
    np.testing.assert_array_equal(got.lams, want.lams)
    np.testing.assert_allclose(got.errors, want.errors, rtol=1e-12)
    assert got.n_exact_chol == want.n_exact_chol


def test_chol_fn_in_fit_and_solvers():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 30, H))
    hess = torch.from_numpy(np.einsum("kni,knj->kij", a, a))
    g = torch.from_numpy(rng.standard_normal((3, H)))
    lams = torch.logspace(-2, 1, 4, dtype=torch.float64)
    chol = _CountingChol()
    got = picholesky.fit(hess, lams, 2, block=BLOCK, chol_fn=chol)
    want = picholesky.fit(hess, lams, 2, block=BLOCK)
    assert chol.calls == 1                       # one batched call
    torch.testing.assert_close(got.theta, want.theta, rtol=0, atol=0)
    th = solvers.solve_cholesky_sweep(hess, g, lams, chol)
    torch.testing.assert_close(
        th, solvers.solve_cholesky_sweep(hess, g, lams), rtol=0, atol=0)
    one = solvers.solve_cholesky(hess[0], g[0], 0.3, chol)
    torch.testing.assert_close(
        one, solvers.solve_cholesky(hess[0], g[0], 0.3), rtol=0, atol=0)
    assert chol.calls == 3


@pytest.fixture
def factors():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 60, H))
    hess = torch.from_numpy(np.einsum("kni,knj->kij", a, a)) + \
        torch.eye(H, dtype=torch.float64)
    return hess, torch.linalg.cholesky(hess), \
        torch.from_numpy(rng.standard_normal((3, H)))


@pytest.mark.parametrize("switch", [None, "ref", "cuda"])
def test_ops_equal_plain_versions_on_cpu(factors, monkeypatch, switch):
    """Every entry point of kernels.ops on CPU tensors is its kernel's plain
    version, whatever REPRO_KERNELS says."""
    if switch is None:
        monkeypatch.delenv("REPRO_KERNELS", raising=False)
    else:
        monkeypatch.setenv("REPRO_KERNELS", switch)
    hess, l, g = factors
    vec = packing.pack_tril(l, BLOCK)
    same = dict(rtol=0, atol=0)
    torch.testing.assert_close(ops.pack_tril(l, BLOCK), vec, **same)
    torch.testing.assert_close(ops.unpack_tril(vec, H, BLOCK),
                               packing.unpack_tril(vec, H, BLOCK), **same)
    torch.testing.assert_close(ops.cholesky(hess, BLOCK),
                               ref.cholesky_blocked(hess, BLOCK), **same)
    torch.testing.assert_close(
        ops.solve_lower(l, g, BLOCK, transpose=True),
        ref.solve_lower_blocked(l, g[..., None], BLOCK,
                                transpose=True)[..., 0], **same)
    torch.testing.assert_close(
        ops.solve_lower_packed(vec, g, H, BLOCK),
        ref.solve_lower_packed(vec, g[..., None], H, BLOCK)[..., 0], **same)
    torch.testing.assert_close(
        ops.solve_packed(vec, g, H, BLOCK),
        ref.solve_packed(vec, g[..., None], H, BLOCK)[..., 0], **same)
    sweep = ops.solve_factor_sweep(l, g[0], BLOCK)
    w = ref.solve_lower_blocked(l, g[0].expand(3, H)[..., None], BLOCK)
    torch.testing.assert_close(
        sweep, ref.solve_lower_blocked(l, w, BLOCK, transpose=True)[..., 0],
        **same)
    # and they solve what they claim
    torch.testing.assert_close(ops.solve_packed(vec, g, H, BLOCK),
                               torch.linalg.solve(hess, g[..., None])[..., 0])
    model = picholesky.fit(hess, torch.tensor([0.1, 1.0, 10.0]), 2,
                           block=BLOCK)
    lams = torch.tensor([0.3, 3.0], dtype=torch.float64)
    torch.testing.assert_close(
        ops.interp_factors(model.theta, lams, H, BLOCK),
        model.eval_factor(lams), **same)
    torch.testing.assert_close(
        ops.interp_solve(model.theta, lams, g, H, BLOCK),
        ReferenceBackend().interp_solve(model.theta, lams, g, h=H,
                                        block=BLOCK))
    rng = np.random.default_rng(3)
    xc, dt = (torch.from_numpy(rng.standard_normal((1, 9, 6)))
              .float() for _ in range(2))
    bm, cm = (torch.from_numpy(rng.standard_normal((1, 9, 4)))
              .float() for _ in range(2))
    a = -torch.rand(6, 4)
    d = torch.rand(6)
    for got, want in zip(ops.ssm_scan(xc, dt.abs(), bm, cm, a, d),
                         ref.ssm_scan(xc, dt.abs(), bm, cm, a, d)):
        torch.testing.assert_close(got, want, **same)


def test_ops_ref_switch_refuses_cuda_tensors(monkeypatch):
    """REPRO_KERNELS=ref never becomes a fallback on the card: a CUDA
    tensor under it raises (a stand-in with ``is_cuda`` here; the card
    test tests/test_torch_cuda.py passes real ones)."""
    class OnCard:
        is_cuda = True

    monkeypatch.setenv("REPRO_KERNELS", "ref")
    assert ops.kernel_backend() == "ref"
    with pytest.raises(RuntimeError, match="REPRO_KERNELS=ref"):
        ops._dispatch("cholesky", torch.zeros(1), OnCard())
    ops._dispatch("cholesky", torch.zeros(1))          # CPU: fine
    monkeypatch.delenv("REPRO_KERNELS")
    assert ops.kernel_backend() == "cuda"
    ops._dispatch("cholesky", OnCard())                # kernels: fine

"""The port's Algorithm 1 against the JAX package's: Θ element for element
in the packed layout, the fused solve, and a Θ carried across by
``convert.picholesky_from_numpy``.

Tolerance 1e-10 relative to the largest value: both sides factor, pack and
solve the same float64 normal equations; the anchors and the solves
differ by ulps (summation order), which the (r+1)×(r+1) Vandermonde
system amplifies by its conditioning (measured ~1e-14 here).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core import picholesky as jpi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import picholesky as tpi  # noqa: E402
from repro_torch.core import solvers  # noqa: E402

RTOL = 1e-10


def _spd(h, seed=0):
    x = np.random.default_rng(seed).standard_normal((2 * h, h))
    return x.T @ x + np.eye(h)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.fixture(scope="module", params=[(40, 16), (64, 32), (144, 32)],
                ids=lambda p: f"h{p[0]}-b{p[1]}")
def problem(request):
    h, block = request.param
    return h, block, _spd(h, h), np.logspace(-3, 2, 4)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("basis", ["monomial", "centered"])
def test_theta_matches_reference(problem, backend, basis):
    h, block, a, samples = problem
    jm = jpi.fit(jnp.asarray(a), jnp.asarray(samples), 2, block=block,
                 basis=basis)
    tm = tpi.fit(torch.from_numpy(a), torch.from_numpy(samples), 2,
                 block=block, basis=basis, backend=backend)
    assert tm.theta.shape == jm.theta.shape
    assert _rel(tm.theta.numpy(), jm.theta) <= RTOL
    np.testing.assert_allclose(float(tm.center), float(jm.center),
                               rtol=1e-15)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_solve_matches_reference(problem, backend):
    h, block, a, samples = problem
    lams = np.array([2e-3, 0.05, 1.0, 40.0])
    g = np.random.default_rng(1).standard_normal(h)
    jm = jpi.fit(jnp.asarray(a), jnp.asarray(samples), 2, block=block)
    tm = tpi.fit(torch.from_numpy(a), torch.from_numpy(samples), 2,
                 block=block, backend=backend)
    want = np.asarray(jm.solve(jnp.asarray(lams), jnp.asarray(g)))
    got = tm.solve(torch.from_numpy(lams), torch.from_numpy(g),
                   backend=backend).numpy()
    assert got.shape == (4, h)
    assert _rel(got, want) <= RTOL
    np.testing.assert_allclose(
        tm.eval_packed(torch.from_numpy(lams)).numpy(),
        np.asarray(jm.eval_packed(jnp.asarray(lams))), rtol=1e-12,
        atol=1e-12 * float(np.max(np.abs(jm.theta))))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_carried_theta_gives_reference_solutions(problem, backend):
    h, block, a, samples = problem
    jm = jpi.fit(jnp.asarray(a), jnp.asarray(samples), 2, block=block,
                 basis="centered")
    tm = convert.picholesky_from_numpy(jm, device="cpu")
    lams = np.array([0.01, 3.0])
    g = np.random.default_rng(2).standard_normal(h)
    want = np.asarray(jm.solve(jnp.asarray(lams), jnp.asarray(g)))
    got = tm.solve(torch.from_numpy(lams), torch.from_numpy(g),
                   backend=backend).numpy()
    assert _rel(got, want) <= RTOL


def test_fit_from_packed_factors_and_batched_folds(problem):
    """The ``factors=`` path consumes packed anchors without an unpack, and
    a leading fold dimension fits every fold at once."""
    h, block, a, samples = problem
    a2 = np.stack([a, _spd(h, h + 1)])
    lam = torch.from_numpy(samples)
    batched = tpi.fit(torch.from_numpy(a2), lam, 2, block=block)
    assert batched.theta.shape == (2, 3, tpack.packed_size(h, block))
    chol = torch.linalg.cholesky(torch.from_numpy(a2)[:, None]
                                 + lam[:, None, None] * torch.eye(h,
                                                                  dtype=lam.dtype))
    pf = tpack.PackedFactor.from_dense(chol, block)
    refit = tpi.fit(None, lam, 2, block=block, factors=pf)
    np.testing.assert_allclose(refit.theta.numpy(), batched.theta.numpy(),
                               rtol=0, atol=1e-12 * float(
                                   batched.theta.abs().max()))
    jpf = jpack.PackedFactor(vec=jnp.asarray(pf.vec[0].numpy()), h=h,
                             block=block)
    jm = jpi.fit(None, jnp.asarray(samples), 2, block=block, factors=jpf)
    assert _rel(refit.theta[0].numpy(), jm.theta) <= RTOL
    carried = convert.packed_factor_from_numpy(jpf, device="cpu")
    np.testing.assert_array_equal(carried.vec.numpy(), pf.vec[0].numpy())
    assert (carried.h, carried.block) == (h, block)


def test_vandermonde_and_sample_lambdas_match():
    lams = np.logspace(-3, 2, 6)
    np.testing.assert_allclose(
        tpi.vandermonde(torch.from_numpy(lams), 3, 0.5).numpy(),
        np.asarray(jpi.vandermonde(jnp.asarray(lams), 3, 0.5)), rtol=1e-15)
    for lo, hi, g in ((1e-3, 1e2, 4), (1e-3, 1.0, 5), (0.2, 0.3, 2)):
        np.testing.assert_allclose(
            tpi.choose_sample_lambdas(lo, hi, g, device="cpu").numpy(),
            np.asarray(jpi.choose_sample_lambdas(lo, hi, g)), rtol=4e-15)
        np.testing.assert_allclose(
            tpi.choose_sample_lambdas(lo, hi, g, "linear",
                                      device="cpu").numpy(),
            np.asarray(jpi.choose_sample_lambdas(lo, hi, g, "linear")),
            rtol=4e-15)


def test_fit_guards():
    a = torch.from_numpy(_spd(16))
    with pytest.raises(ValueError, match="g > r"):
        tpi.fit(a, torch.tensor([0.1, 1.0]), 2, block=8)
    with pytest.raises(ValueError, match="neither"):
        tpi.fit(None, torch.tensor([0.1, 1.0, 2.0]), 2)
    with pytest.raises(ValueError, match="basis"):
        tpi.fit(a, torch.tensor([0.1, 1.0, 2.0]), 2, block=8, basis="cheb")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_solve_cholesky_sweep_matches_dense_solve(backend):
    h = 40
    a = torch.from_numpy(np.stack([_spd(h, 3), _spd(h, 4)]))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((2, h)))
    lams = torch.tensor([0.01, 1.0, 10.0], dtype=torch.float64)
    got = solvers.solve_cholesky_sweep(a, g, lams, backend=backend)
    want = torch.linalg.solve(
        a[:, None] + lams[:, None, None] * torch.eye(h, dtype=a.dtype),
        g[:, None, :, None])[..., 0]
    assert _rel(got.numpy(), want.numpy()) <= RTOL
    one = solvers.solve_cholesky(a[0], g[0], 0.01, backend=backend)
    assert _rel(one.numpy(), want[0, 0].numpy()) <= RTOL


def test_solve_packed_matches_reference():
    h, block = 40, 16
    l = np.linalg.cholesky(_spd(h, 6))
    g = np.random.default_rng(7).standard_normal(h)
    pf = tpack.PackedFactor.from_dense(torch.from_numpy(l), block)
    want = np.asarray(jpack.solve_packed_ref(jnp.asarray(pf.vec.numpy()),
                                             jnp.asarray(g), h, block))
    got = solvers.solve_packed(pf, torch.from_numpy(g)).numpy()
    assert _rel(got, want) <= RTOL
    np.testing.assert_allclose(
        solvers.solve_from_factor(pf, torch.from_numpy(g)).numpy(), got,
        rtol=0, atol=0)
    # the kernel backend on CPU tensors runs the packed trsm's plain version
    assert _rel(solvers.solve_packed(pf, torch.from_numpy(g),
                                     backend="cuda").numpy(), want) <= RTOL

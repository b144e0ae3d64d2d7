"""The factor routes under the bf16 policies, on the CPU: the packed trsm's
mixed variant and ``interp_factors`` on a bf16 Θ.

The port's wrappers run their plain versions on CPU tensors
(``kernels.ref.solve_lower_packed`` / ``solve_packed`` with
``compute_dtype``, ``kernels.ref.interp_factors`` on a bf16 Θ); they are
held here to the JAX package's Pallas kernels in interpret mode on the
same numpy inputs, then the backends (``CudaBackend`` on CPU tensors
against ``PallasBackend``) under ``bf16_store`` and ``bf16_refined``, the
native policy on a bf16 factor, and the dense-factor route
(``eval_factor`` → ``solve_from_factor``) and the Gauss–Newton head under
``bf16_store``.

Tolerances, max |Δ| / max |JAX| unless stated:

* The mixed packed solve, 1e-5: both sides round the same tiles, solved
  segments, inverses and g_i − acc_i to bf16 and multiply at float32,
  where a product of two bf16 values is exact; only the order of the
  float32 sums and the float32 inversion of the diagonal tiles differ
  (ATen against XLA), and a float32 value one bit apart can round to the
  other bf16 neighbour, which these small, well-conditioned inputs leave
  far below 1e-5 (measured ≤ 6e-8).  A missing rounding would show the
  bf16 error itself, ≥ 1e-4.  So each side's error against the float64
  solve of the same factor must also lie within ERROR_RATIO of the
  other's: a rounding the port skips or adds moves that ratio far outside
  it (the test of the native-policy repair shows it does).  A float64 factor is cast to
  float32 before the kernel, so its tiles round twice (f64 → f32 → bf16)
  where the Pallas kernel rounds them once; the two differ only for a
  value within 2⁻²⁹ of a bf16 midpoint, which none of these inputs holds
  (asserted below), so the same limit applies.
* ``interp_factors`` on a bf16 Θ: bit for bit against a numpy emulation of
  the stated arithmetic (λ and center rounded to bf16 and subtracted in
  bf16; every Horner product and sum rounded to bf16); against the Pallas
  kernel in interpret mode within 2 bf16 ulps of each value, because XLA
  may evaluate the interpreted kernel's bf16 arithmetic with roundings of
  its own (as ``tests/test_torch_precision.py`` finds for
  ``interp_solve``; on these inputs it measured 0 ulps apart).
* The dense-factor route: the factors as ``interp_factors``; the solutions
  within 2e-2 of JAX's and both within 2e-2 of the float64 solve of the
  port's bf16 factors (the bound of ``tests/test_torch_precision.py`` for
  a bf16 sweep: the factors JAX's interpreted kernel rounds otherwise
  change the solve by up to the bf16 error).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import backends as jbackends  # noqa: E402
from repro.core import picholesky as jpi  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro.core.packing import PackedFactor as JPackedFactor  # noqa: E402
from repro.kernels.packed_trsm import solve_lower_packed as j_lower  # noqa: E402
from repro.kernels.packed_trsm import solve_packed as j_solve  # noqa: E402
from repro.kernels.poly_interp import interp_factors as j_factors  # noqa: E402
from repro.optim import gauss_newton as jgn  # noqa: E402
from repro_torch.core import backends, packing, picholesky, solvers  # noqa: E402
from repro_torch.kernels import (LAUNCHES, packed_trsm, poly_interp,  # noqa: E402
                                 ref, reset_launches)
from repro_torch.optim import damped_gauss_newton_head  # noqa: E402

BF, F32, F64 = torch.bfloat16, torch.float32, torch.float64
KERNEL_RTOL = 1e-5
ERROR_RATIO = (0.5, 2.0)
SOLVE_RTOL = 2e-2
FACTOR_ULPS = 2
SHAPES = [(32, 8), (32, 16), (40, 8), (40, 16)]      # 40: a partial tile
SWEEPS = {"L": 1, "LT": 2, "LLT": 3}
JAX_DT = {BF: jnp.bfloat16, F32: jnp.float32, F64: jnp.float64}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _bf(a):
    """numpy values rounded to bf16 (to nearest even), as float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).double().numpy()


def _jax(t):
    """A torch tensor as a JAX array of the same dtype (bf16 through its
    exact float32 values)."""
    return jnp.asarray(t.float().numpy() if t.dtype == BF
                       else t.numpy()).astype(JAX_DT[t.dtype])


def _cuda(policy, block=None):
    """The port's kernel backend (its plain versions on CPU tensors)."""
    return backends.resolve_backend("cuda", block=block, precision=policy)


def _pallas(block, policy):
    """The JAX package's Pallas backend (interpret mode on the CPU)."""
    return jbackends.resolve_backend("pallas", block=block, precision=policy)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    reset_launches()
    yield
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


def _factors(h, block, n=2, seed=0):
    """(n, P) float64 packed Cholesky factors of well-conditioned SPD
    matrices."""
    out = []
    for s in range(n):
        x = np.random.default_rng(seed + h + s).standard_normal((2 * h, h))
        out.append(np.linalg.cholesky(x.T @ x / h + np.eye(h)))
    return packing.pack_tril(torch.from_numpy(np.stack(out)), block)


def _jax_solve(vec, g, h, block, sweeps, **kw):
    """The Pallas kernels in interpret mode, one factor at a time."""
    out = []
    for v, gi in zip(vec, g):
        if sweeps == 3:
            w = j_solve(_jax(v), _jax(gi), h, block, interpret=True, **kw)
        else:
            w = j_lower(_jax(v), _jax(gi), h, block, transpose=sweeps == 2,
                        interpret=True, **kw)
        out.append(np.asarray(w))
    return np.stack(out)


def _exact(vec, g, h, block, sweeps):
    """The float64 solve of the same factor values."""
    squeeze = g.ndim == vec.ndim
    v, g2 = vec.double(), (g[..., None] if squeeze else g).double()
    if sweeps == 3:
        w = ref.solve_packed(v, g2, h, block)
    else:
        w = ref.solve_lower_packed(v, g2, h, block, transpose=sweeps == 2)
    return w[..., 0] if squeeze else w


def _port_solve(vec, g, h, block, sweeps, **kw):
    if sweeps == 3:
        return packed_trsm.solve_packed(vec, g, h, block, **kw)
    return packed_trsm.solve_lower_packed(vec, g, h, block,
                                          transpose=sweeps == 2, **kw)


def _held(got, want, exact):
    """The port against JAX, and the ratio of their errors against the
    float64 solve."""
    e_port, e_jax = _rel(got, exact), _rel(want, exact)
    assert _rel(got, want) <= KERNEL_RTOL, (_rel(got, want), e_port, e_jax)
    assert ERROR_RATIO[0] <= e_port / e_jax <= ERROR_RATIO[1], (e_port,
                                                               e_jax)
    assert e_port > 1e-4                    # the products really were bf16


# ----------------------------------------------- the mixed packed trsm


@pytest.mark.parametrize("ncol", [1, 3], ids=["shared_g", "3_columns"])
@pytest.mark.parametrize("source", [BF, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("sweep", list(SWEEPS))
@pytest.mark.parametrize("h,block", SHAPES)
def test_mixed_packed_solve_matches_pallas(h, block, sweep, source, ncol):
    """A batch of two packed factors, stored in bf16 or float32, under bf16
    products with float32 sums: one g shared by the batch, or a 3-column
    g per factor."""
    sweeps = SWEEPS[sweep]
    vec = _factors(h, block).to(source)
    rng = np.random.default_rng(h + block + ncol)
    if ncol == 1:
        g = torch.from_numpy(rng.standard_normal(h).astype(np.float32))
        g = g.expand(2, h)
    else:
        g = torch.from_numpy(rng.standard_normal((2, h, ncol))
                             .astype(np.float32))
    got = _port_solve(vec, g, h, block, sweeps, compute_dtype=BF,
                      accum_dtype=F32)
    assert got.dtype == F32 and got.shape == g.shape
    want = _jax_solve(vec, g, h, block, sweeps, compute_dtype="bfloat16",
                      accum_dtype="float32")
    _held(got, want, _exact(vec, g, h, block, sweeps))
    # a bf16 factor resolves to this variant by default, as in JAX
    if source == BF:
        assert torch.equal(_port_solve(vec, g, h, block, sweeps), got)


def test_mixed_packed_solve_of_a_float64_factor():
    """A float64 factor under bf16 products: cast to float32 first, so
    its tiles round f64 → f32 → bf16 (the Pallas kernel: f64 → bf16);
    no value of this input lies where the two differ, so the limit is the
    same."""
    h, block = 40, 8
    vec = _factors(h, block)
    assert torch.equal(vec.to(F32).to(BF), vec.to(BF))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((2, h)))
    got = packed_trsm.solve_packed(vec, g, h, block, compute_dtype=BF)
    assert got.dtype == F32
    want = _jax_solve(vec, g, h, block, 3, compute_dtype="bfloat16",
                      accum_dtype="float32")
    _held(got, want, _exact(vec.float(), g, h, block, 3))


@pytest.mark.parametrize("policy", ["bf16_store", "bf16_refined"])
@pytest.mark.parametrize("source", [BF, F32], ids=["bf16", "f32"])
def test_cuda_backend_solve_packed_matches_pallas_backend(policy, source):
    """``solve_packed`` on the cuda backend (its plain version here) under
    a bf16 policy against the JAX ``PallasBackend`` under the same policy:
    three factors, one g (h,) shared by all of them."""
    h, block = 40, 8
    vec = _factors(h, block, n=3).to(source)
    g = np.random.default_rng(7).standard_normal(h).astype(np.float32)
    pf = packing.PackedFactor(vec, h, block)
    got = _cuda(policy).solve_packed(
        pf, torch.from_numpy(g))
    assert got.dtype == F32 and got.shape == (3, h)
    jbk = _pallas(block, policy)
    want = np.asarray(jbk.solve_packed(JPackedFactor(vec=_jax(vec), h=h,
                                                     block=block),
                                       jnp.asarray(g)))
    g3 = torch.from_numpy(g).expand(3, h)
    _held(got, want, _exact(vec, g3, h, block, 3))


def test_native_policy_solves_a_bf16_factor_with_bf16_products():
    """Repair: under the native policy the cuda backend took a bf16 factor
    up to float32 and ran the float32 kernel, where the JAX package takes
    its dtypes from the factor (bf16 products, float32 sums).  The old
    route (the float32 solve of the upcast factor) misses JAX's bf16
    rounding: its error against the float64 solve is far below JAX's, so
    the error-ratio check fails on it; the new route passes it."""
    h, block = 40, 16
    vec = _factors(h, block, n=2).to(BF)
    g = np.random.default_rng(11).standard_normal(h).astype(np.float32)
    pf = packing.PackedFactor(vec, h, block)
    jbk = _pallas(block, "native")
    want = np.asarray(jbk.solve_packed(JPackedFactor(vec=_jax(vec), h=h,
                                                     block=block),
                                       jnp.asarray(g)))
    g2 = torch.from_numpy(g).expand(2, h)
    exact = _exact(vec, g2, h, block, 3)
    e_jax = _rel(want, exact)
    old = packed_trsm.solve_packed(vec.to(F32), g2, h, block)
    assert not ERROR_RATIO[0] <= _rel(old, exact) / e_jax <= ERROR_RATIO[1]
    new = _cuda("native").solve_packed(pf, torch.from_numpy(g))
    assert new.dtype == F32
    _held(new, want, exact)


# --------------------------------------------- interp_factors, bf16 Θ


def _theta_bf16(h, block, n=2):
    """(n, 3, P) bf16 coefficients, L(λ) = L₀ + 0.1 λ L₁ + 0.01 λ² L₂."""
    v = _factors(h, block, n=3 * n, seed=5).reshape(n, 3, -1)
    scale = torch.tensor([1.0, 0.1, 0.01], dtype=F64)[:, None]
    return (v * scale).to(BF)


def _emulate_factors(theta, lams, center, h, block):
    """The stated arithmetic in numpy: x = bf16(bf16(λ) − bf16(center)),
    then v = bf16(bf16(v x) + θ_k) from the top coefficient; unpacked."""
    th = theta.double().numpy()
    x = _bf(_bf(lams) - _bf(np.float32(center)))
    out = []
    for f in range(th.shape[0]):
        v = np.broadcast_to(th[f, -1], (len(x), th.shape[-1]))
        for k in range(th.shape[1] - 2, -1, -1):
            v = _bf(_bf(v * x[:, None]) + th[f, k])
        out.append(packing.unpack_tril(torch.from_numpy(v), h, block).numpy())
    return np.stack(out)


def _ulps(a, want):
    """|a − want| in units of the bf16 spacing at |want| (at least that of
    the smallest normal)."""
    a, want = np.asarray(a, np.float64), np.asarray(want, np.float64)
    r = np.maximum(np.abs(want), 2.0 ** -126)
    return np.abs(a - want) / 2.0 ** (np.floor(np.log2(r)) - 7)


@pytest.mark.parametrize("h,block", SHAPES)
def test_interp_factors_bf16_matches_emulation_and_pallas(h, block):
    theta = _theta_bf16(h, block)
    lams = np.array([1e-3, 0.05, 0.7, 3.0, 40.0])
    center = np.float32(0.37)
    got = poly_interp.interp_factors(theta, torch.from_numpy(lams), h, block,
                                     center=torch.tensor(center))
    assert got.dtype == BF and got.shape == (2, len(lams), h, h)
    np.testing.assert_array_equal(
        got.double().numpy(), _emulate_factors(theta, lams, center, h, block))
    want = np.stack([np.asarray(j_factors(
        _jax(t), jnp.asarray(lams), h, block, center=jnp.float32(center),
        interpret=True)).astype(np.float64) for t in theta])
    assert _ulps(got.double().numpy(), want).max() <= FACTOR_ULPS
    # the cuda backend runs it at Θ's dtype under any policy
    for policy in ("bf16_store", "bf16_refined", "native"):
        out = _cuda(policy).interp_factors(
            theta, torch.from_numpy(lams), h=h, block=block,
            center=torch.tensor(center))
        assert torch.equal(out, got)


@pytest.mark.parametrize("h,block", [(40, 8), (32, 16)])
def test_eval_factor_then_solve_from_factor_under_bf16_store(h, block):
    """The dense-factor route under ``bf16_store``: a bf16 Θ with a float32
    center evaluated into dense bf16 factors (``interp_factors``) and
    solved by the mixed dense trsm, on the cuda backend (plain versions)
    against the JAX ``PallasBackend`` in interpret mode."""
    theta = _theta_bf16(h, block, n=1)[0]
    center = torch.tensor(0.37, dtype=F32)
    lams = np.array([0.01, 0.3, 2.0])
    g = np.random.default_rng(h).standard_normal(h)
    bk = _cuda("bf16_store", block)
    model = picholesky.PiCholesky(theta=theta, center=center, h=h,
                                  block=block)
    l_port = model.eval_factor(torch.from_numpy(lams), backend=bk)
    assert l_port.dtype == BF and l_port.shape == (3, h, h)
    got = solvers.solve_from_factor(
        l_port, torch.from_numpy(g).expand(3, h), backend=bk)
    assert got.dtype == F32
    jbk = _pallas(block, "bf16_store")
    jm = jpi.PiCholesky(theta=_jax(theta), center=jnp.float32(0.37), h=h,
                        block=block)
    l_jax = np.asarray(jm.eval_factor(jnp.asarray(lams), backend=jbk)
                       ).astype(np.float64)
    assert _ulps(l_port.double().numpy(), l_jax).max() <= FACTOR_ULPS
    want = np.stack([np.asarray(jsolvers.solve_from_factor(
        jnp.asarray(l_jax[q]).astype(jnp.bfloat16), jnp.asarray(g),
        backend=jbk)) for q in range(3)])
    exact = torch.cholesky_solve(torch.from_numpy(g)[None, :, None].expand(
        3, h, 1), l_port.double())[..., 0]
    assert _rel(got, want) <= SOLVE_RTOL
    assert _rel(got, exact) <= SOLVE_RTOL and _rel(want, exact) <= SOLVE_RTOL
    assert _rel(got, exact) > 1e-4          # the products really were bf16


def test_gauss_newton_head_under_bf16_store(monkeypatch):
    """The damped Gauss–Newton head on a cuda backend with a bf16 policy:
    Θ stored in bf16, each step a bf16 dense factor (``interp_factors``)
    and the mixed dense trsm; against the JAX head under the same policy
    (which takes it from ``REPRO_TEST_PRECISION``: the JAX head has no
    ``backend=`` and runs the reference backend), and against the port's
    head under the native policy (float64: the same interpolant without
    the bf16 rounding)."""
    h, block = 32, 8
    x = np.random.default_rng(21).standard_normal((3 * h, h))
    hess = x.T @ x / h
    grad = np.random.default_rng(22).standard_normal(h)
    lam_range, steps = (1e-2, 1e1), (0.05, 2.0, 1e4)
    bk = _cuda("bf16_store", block)
    state, step = damped_gauss_newton_head(
        torch.from_numpy(hess), lam_range, block=block, backend=bk)
    assert state.model.theta.dtype == BF
    s64, step64 = damped_gauss_newton_head(
        torch.from_numpy(hess), lam_range, block=block,
        backend=_cuda("native", block))
    monkeypatch.setenv("REPRO_TEST_PRECISION", "bf16_store")
    jstate, jstep = jgn.damped_gauss_newton_head(
        jnp.asarray(hess), lam_range, block=block)
    assert jstate.model.theta.dtype == jnp.bfloat16
    for lam in steps:
        delta, state = step(state, torch.from_numpy(grad), lam)
        jdelta, jstate = jstep(jstate, jnp.asarray(grad), lam)
        d64, s64 = step64(s64, torch.from_numpy(grad), lam)
        assert delta.dtype == F32
        assert float(state.lam) == float(jstate.lam) == float(s64.lam)
        assert _rel(delta, jdelta) <= SOLVE_RTOL
        assert 1e-5 < _rel(delta, d64) <= SOLVE_RTOL

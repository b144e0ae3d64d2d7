"""Each ported kernel's CPU path (its plain PyTorch version) against the
JAX package's Pallas kernel in interpret mode, float64.

Tolerances: packing moves values, so it is exact.  The Cholesky, the
blocked trsm and the fused interp-solve run the same blocked algorithm on
both sides with another summation order inside each tile product (XLA vs
ATen), so they agree to a few ulps times the conditioning of the
substitution; 1e-10 relative to the largest value leaves orders of
magnitude of room on these well-conditioned inputs.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import picholesky as jpi  # noqa: E402
from repro.kernels.chol_blocked import cholesky_blocked as j_chol  # noqa: E402
from repro.kernels.poly_interp import interp_solve as j_interp  # noqa: E402
from repro.kernels.tri_pack import pack_tril as j_pack  # noqa: E402
from repro.kernels.trsm import solve_lower_blocked as j_trsm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import (LAUNCHES, chol_blocked, poly_interp,  # noqa: E402
                                 reset_launches, trsm, tri_pack)

RTOL = 1e-10
SHAPES = [(24, 32), (40, 16), (64, 32), (144, 32)]
SRC = Path(__file__).resolve().parent.parent / "src"


def _spd(h, seed):
    x = np.random.default_rng(seed).standard_normal((2 * h, h))
    return x.T @ x + h * np.eye(h)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    reset_launches()
    yield
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


@pytest.mark.parametrize("h,block", SHAPES)
def test_pack_tril_exact(h, block):
    m = np.random.default_rng(h).standard_normal((2, h, h))
    got = tri_pack.pack_tril(torch.from_numpy(m), block).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(j_pack(jnp.asarray(m[b]), block)))


@pytest.mark.parametrize("h,block", SHAPES)
def test_cholesky_blocked(h, block):
    a = np.stack([_spd(h, 0), _spd(h, 1)])
    got = chol_blocked.cholesky_blocked(torch.from_numpy(a), block).numpy()
    for b in range(2):
        want = np.asarray(j_chol(jnp.asarray(a[b]), block=block))
        assert _rel(got[b], want) <= RTOL


@pytest.mark.parametrize("h,block", SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
def test_solve_lower_blocked(h, block, transpose):
    l = np.stack([np.linalg.cholesky(_spd(h, s)) for s in (2, 3)])
    g = np.random.default_rng(4).standard_normal((2, h, 3))
    got = trsm.solve_lower_blocked(torch.from_numpy(l), torch.from_numpy(g),
                                   block, transpose=transpose).numpy()
    for b in range(2):
        want = np.asarray(j_trsm(jnp.asarray(l[b]), jnp.asarray(g[b]), block,
                                 transpose=transpose))
        assert _rel(got[b], want) <= RTOL
    # the vector form squeezes like the reference
    one = trsm.solve_lower_blocked(torch.from_numpy(l[0]),
                                   torch.from_numpy(g[0, :, 0]), block,
                                   transpose=transpose)
    assert one.shape == (h,)


@pytest.mark.parametrize("h,block", SHAPES)
@pytest.mark.parametrize("basis", ["monomial", "centered"])
def test_interp_solve(h, block, basis):
    """Θ fitted by the JAX package and carried across; λ chunk with an
    edge-padded repeat as the engine streams it."""
    samples = jnp.logspace(-3, 2, 4)
    models = [jpi.fit(jnp.asarray(_spd(h, s)), samples, 2, block=block,
                      basis=basis) for s in (5, 6)]
    lams = np.array([1e-3, 0.3, 7.0, 7.0])
    g = np.random.default_rng(7).standard_normal((2, h))
    theta = torch.stack([convert.picholesky_from_numpy(m, device="cpu").theta
                         for m in models])
    got = poly_interp.interp_solve(theta, torch.from_numpy(lams),
                                   torch.from_numpy(g), h, block,
                                   center=float(models[0].center)).numpy()
    assert got.shape == (2, 4, h)
    for b, m in enumerate(models):
        want = np.asarray(j_interp(m.theta, jnp.asarray(lams),
                                   jnp.asarray(g[b]), h, block,
                                   center=m.center))
        assert _rel(got[b], want) <= RTOL


def test_interp_solve_rhs_per_lam_and_multi_column():
    h, block = 40, 16
    model = jpi.fit(jnp.asarray(_spd(h, 8)), jnp.logspace(-3, 2, 4), 2,
                    block=block)
    theta = convert.picholesky_from_numpy(model, device="cpu").theta
    lams = np.array([0.01, 1.0, 30.0])
    g = np.random.default_rng(9).standard_normal((3, h, 2))
    got = poly_interp.interp_solve(theta, torch.from_numpy(lams),
                                   torch.from_numpy(g), h, block,
                                   rhs_per_lam=True).numpy()
    want = np.asarray(j_interp(model.theta, jnp.asarray(lams), jnp.asarray(g),
                               h, block, rhs_per_lam=True))
    assert _rel(got, want) <= RTOL


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel path, whose checks refuse a
    tensor that is not on a CUDA device — no fallback."""
    m = torch.empty(2, 32, 32, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tri_pack.pack_tril(m, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        chol_blocked.cholesky_blocked(m, 16)


@pytest.mark.parametrize("block", [8, 48, 96, 256])
def test_kernel_blocks_are_the_compiled_ones(block):
    """The Cholesky and pack kernels are compiled for blocks 16, 32, 64 and
    128; any other block is refused before a launch, naming that set (the
    plain versions on the CPU take any block)."""
    m = torch.empty(2, 32, 32, device="meta", dtype=torch.float64)
    for fn in (chol_blocked.cholesky_blocked, tri_pack.pack_tril):
        with pytest.raises(ValueError, match=r"one of \(16, 32, 64, 128\)"):
            fn(m, block)
    cpu = torch.eye(32, dtype=torch.float64) * 4
    torch.testing.assert_close(chol_blocked.cholesky_blocked(cpu, 8),
                               torch.eye(32, dtype=torch.float64) * 2)


def test_build_module_imports_without_nvcc(tmp_path):
    code = ("import repro_torch.kernels._build as b, shutil; "
            "assert shutil.which('nvcc') is None; "
            "print(sorted(b.SOURCES))\n"
            "try:\n    b.build_all()\nexcept RuntimeError as e:\n"
            "    print('refused:', e)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert "refused: nvcc not found" in out
    for name in ("chol_blocked", "poly_interp", "trsm", "tri_pack",
                 "packed_trsm"):
        assert (SRC / "repro_torch" / "kernels" / "csrc"
                / f"{name}.cu").exists()

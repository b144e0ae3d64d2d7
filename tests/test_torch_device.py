"""Device rules of the port: entry points run on the CUDA device unless
asked for the CPU, and the port never imports JAX or the JAX package."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import backends, cv, engine, precision  # noqa: E402
from repro_torch.data import make_regression_dataset  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")


def _folds():
    rng = np.random.default_rng(0)
    return cv.make_folds(rng.standard_normal((40, 8)),
                         rng.standard_normal(40), 4, device="cpu")


@pytest.mark.parametrize("entry", [
    lambda: cv.make_folds(np.ones((8, 2)), np.ones(8), 2),
    lambda: engine.CVEngine("picholesky"),
    lambda: cv.cv_picholesky(_folds(), np.logspace(-2, 1, 5), block=8),
    lambda: cv.cv_exact_cholesky(_folds(), np.logspace(-2, 1, 5)),
    lambda: make_regression_dataset(16, 8),
], ids=["make_folds", "CVEngine", "cv_picholesky", "cv_exact_cholesky",
        "make_regression_dataset"])
def test_default_device_is_cuda_and_raises_without_it(entry):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


class _Carried:
    """Any object with the fields ``convert`` reads, holding numpy arrays."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


_ARR = np.ones((2, 2))
_PI = _Carried(theta=_ARR, center=np.float64(0.0), h=2, block=2)


@pytest.mark.parametrize("entry", [
    lambda: convert.folds_from_numpy(_Carried(
        hess=_ARR, grad=_ARR, fold_hess=_ARR, fold_grad=_ARR, x_folds=_ARR,
        y_folds=_ARR)),
    lambda: convert.picholesky_from_numpy(_PI),
    lambda: convert.packed_factor_from_numpy(_Carried(vec=_ARR, h=2,
                                                      block=2)),
    lambda: convert.gn_state_from_numpy(_Carried(
        model=_PI, lam=np.float64(1.0), lo=np.float64(0.1),
        hi=np.float64(10.0))),
], ids=["folds", "picholesky", "packed_factor", "gn_state"])
def test_convert_defaults_to_cuda_and_raises_without_it(entry):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_cpu_when_asked():
    x, y = make_regression_dataset(60, 8, seed=3, dtype=torch.float64,
                                   device="cpu")
    assert x.shape == (60, 8) and y.shape == (60,) and x.device.type == "cpu"
    assert torch.all(x[:, -1] == 1)          # intercept column
    res = cv.cv_picholesky(cv.make_folds(x, y, 3, device="cpu"),
                           np.logspace(-2, 1, 7), block=8, device="cpu")
    assert res.extras["engine"]["backend"] == "reference"
    assert res.extras["engine"]["device"] == "cpu"


def test_auto_backend_follows_device():
    assert backends.resolve_backend("auto", device="cpu").name == "reference"
    assert backends.resolve_backend("auto", device="cuda").name == "cuda"
    assert backends.resolve_backend(None).name == "cuda"
    bk = backends.resolve_backend("cuda", block=32)
    assert (bk.chol_block, bk.trsm_block) == (32, 32)
    with pytest.raises(ValueError, match="unknown backend"):
        backends.resolve_backend("pallas")


@pytest.mark.parametrize("policy", ["bf16_store", "bf16_refined"])
def test_cuda_backend_refuses_16_bit_policies(policy):
    """The cuda backend refuses no bf16 policy: every kernel has its
    variant (bf16 products, float32 sums), the packed trsm and
    ``interp_factors`` included.  On CPU tensors both run their plain
    versions and match the reference backend under the same policy: the
    packed solve within the JAX package's bound for a bf16 solve
    (``tests/test_precision.py:126-136``, 5e-2 of the norm; the reference
    backend solves the bf16 factor at float32, the kernel rounds its
    products' operands to bf16), the dense factors bit for bit (with
    center 0 both round λ to bf16 once and every Horner step in bf16)."""
    from repro_torch.core import packing
    bk = backends.resolve_backend("cuda", precision=policy)
    ref = backends.resolve_backend("reference", precision=policy)
    assert bk.precision.name == policy
    assert bk._dtypes(torch.float64) == (torch.bfloat16, torch.float32)
    assert bk._dtypes(torch.float32) == (torch.bfloat16, torch.float32)
    h, block = 16, 8
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2 * h, h)))
    spd = x.T @ x / h + torch.eye(h, dtype=torch.float64)
    vec = packing.pack_tril(torch.linalg.cholesky(spd), block)
    vec = torch.stack([vec, 2 * vec]).to(torch.bfloat16)
    pf = packing.PackedFactor(vec, h, block)
    g = torch.ones(h, dtype=torch.float32)
    got, want = bk.solve_packed(pf, g), ref.solve_packed(pf, g)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (2, h)
    assert float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max()) \
        < 5e-2
    theta = torch.stack([vec, 0.1 * vec, 0.01 * vec], 1)      # bf16
    lams = torch.tensor([0.1, 0.5, 2.0], dtype=torch.float64)
    dense = bk.interp_factors(theta, lams, h=h, block=block)
    assert dense.dtype == torch.bfloat16 and dense.shape == (2, 3, h, h)
    assert torch.equal(dense, ref.interp_factors(theta, lams, h=h,
                                                 block=block))
    for one in ("native", "fp32", "fp64"):      # one dtype
        pol = backends.resolve_backend("cuda", precision=one)
        cd, ad = pol._dtypes(torch.float64)
        assert cd == ad


def test_precision_presets_match_reference():
    from repro.core import precision as jprec
    for name, pol in precision.PRESETS.items():
        jpol = jprec.PRESETS[name]
        for role in ("store", "compute", "accum", "fit", "refine_iters"):
            assert getattr(pol, role) == getattr(jpol, role)
        for dt in ("float32", "float64"):
            for role in ("store", "compute", "accum", "fit"):
                want = str(getattr(jpol, f"{role}_dtype")(dt))
                got = str(getattr(pol, f"{role}_dtype")(dt))
                assert got == f"torch.{want}"


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, json, repro_torch, repro_torch.core.cv, "
            "repro_torch.convert, repro_torch.data, repro_torch.kernels.ref, "
            "repro_torch.kernels.tri_pack, repro_torch.kernels.chol_blocked, "
            "repro_torch.kernels.trsm, repro_torch.kernels.poly_interp, "
            "repro_torch.kernels.packed_trsm, repro_torch.core.cv_host, "
            "repro_torch.optim, repro_torch.kernels.ssm_scan, "
            "repro_torch.models, repro_torch.configs; "
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    mods = json.loads(out.strip().splitlines()[-1])
    bad = [m for m in mods if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    assert bad == []
    assert "repro_torch.core.cv" in mods


def test_chip_smoke_imports_no_jax():
    root = SRC.parent
    text = (root / "chip_smoke.py").read_text()
    assert "import jax" not in text and "from repro." not in text \
        and "import repro." not in text

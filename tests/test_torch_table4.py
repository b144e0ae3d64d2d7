"""The Table-4 regression (tests/test_table4_regression.py) held on the
port: same data, k=5, q=31, g=4, block=32, float64.  The port's curves and
λ* indices are compared with the JAX reference's, on the reference and on
the kernel backend (which runs the kernels' plain versions on the CPU).

``tests/data/torch_table4.npz`` carries the JAX reference's inputs and
answers, so ``chip_smoke.py`` can check the card without importing JAX;
this file also checks that the fixture still equals what JAX computes.
Regenerate it with ``PYTHONPATH=src python tests/test_torch_table4.py``.
"""
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cv as jcv  # noqa: E402
from repro.data import make_regression_dataset  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cv as tcv  # noqa: E402

FIXTURE = Path(__file__).parent / "data" / "torch_table4.npz"
K, G, BLOCK = 5, 4, 32
#: curves of the two packages on the same folds: same algorithm in
#: float64, different summation orders (XLA vs ATen); measured ~1e-12
CURVE_RTOL = 1e-9


def jax_reference():
    jax.config.update("jax_enable_x64", True)
    x, y = make_regression_dataset(jax.random.PRNGKey(11), 420, 144,
                                   dtype=jnp.float64)
    folds = jcv.make_folds(x, y, K)
    lams = jnp.logspace(-3, 2, 31)
    r_exact = jcv.cv_exact_cholesky(folds, lams)
    r_pi = jcv.cv_picholesky(folds, lams, g=G, block=BLOCK)
    return dict(x=np.asarray(x), y=np.asarray(y), lams=np.asarray(lams),
                k=K, g=G, block=BLOCK,
                errors_exact=np.asarray(r_exact.errors),
                errors_picholesky=np.asarray(r_pi.errors),
                i_exact=int(np.argmin(r_exact.errors)),
                i_picholesky=int(np.argmin(r_pi.errors)),
                n_exact=r_exact.n_exact_chol,
                n_picholesky=r_pi.n_exact_chol), folds


@pytest.fixture(scope="module")
def reference():
    return jax_reference()


@pytest.fixture(scope="module", params=["reference", "cuda"])
def port(request, reference):
    ref, jfolds = reference
    folds = convert.folds_from_numpy(jfolds, device="cpu")
    r_exact = tcv.cv_exact_cholesky(folds, ref["lams"], backend=request.param,
                                    device="cpu")
    r_pi = tcv.cv_picholesky(folds, ref["lams"], g=G, block=BLOCK,
                             backend=request.param, device="cpu")
    return ref, r_exact, r_pi


def test_fixture_matches_jax(reference):
    ref, _ = reference
    saved = np.load(FIXTURE)
    assert sorted(saved.files) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(saved[name], value, err_msg=name)


def test_same_selected_lambda_as_reference(port):
    ref, r_exact, r_pi = port
    assert int(np.argmin(r_exact.errors)) == ref["i_exact"]
    assert int(np.argmin(r_pi.errors)) == ref["i_picholesky"]


def test_curves_match_reference(port):
    ref, r_exact, r_pi = port
    np.testing.assert_allclose(r_exact.errors, ref["errors_exact"],
                               rtol=CURVE_RTOL)
    np.testing.assert_allclose(r_pi.errors, ref["errors_picholesky"],
                               rtol=CURVE_RTOL)


def test_holdout_curve_tracks_exact_near_argmin(port):
    """Table 4's agreement: within ±3 grid steps of the exact argmin the
    interpolated curve sits within 2% of the exact one."""
    ref, r_exact, r_pi = port
    i_e = int(np.argmin(r_exact.errors))
    lo, hi = max(i_e - 3, 0), min(i_e + 4, len(ref["lams"]))
    np.testing.assert_allclose(r_pi.errors[lo:hi], r_exact.errors[lo:hi],
                               rtol=0.02)


def test_selection_within_one_step_and_near_optimal(port):
    _, r_exact, r_pi = port
    i_e = int(np.argmin(r_exact.errors))
    i_p = int(np.argmin(r_pi.errors))
    assert abs(i_e - i_p) <= 1
    assert (r_exact.errors[i_p] - r_exact.best_error) \
        < 0.01 * r_exact.best_error


def test_factorization_budget(port):
    ref, r_exact, r_pi = port
    assert r_pi.n_exact_chol == ref["n_picholesky"] == 20
    assert r_exact.n_exact_chol == ref["n_exact"] == 155


if __name__ == "__main__":
    data, _ = jax_reference()
    np.savez_compressed(FIXTURE, **data)
    print(f"wrote {FIXTURE}")

"""The algebra of the Cholesky kernel's diagonal step on the CPU.

``repro_torch.kernels.ref.factor_diag_tile`` performs the diagonal step of
``csrc/chol_blocked.cu`` in the kernel's sub-block order: warp-sized potf2
blocks with their inverses, the rows below as products with those
inverses, and the tile's inverse built block row by block row as
``X_ij = −X_ii Σ L_ik X_kj``.  It is held here to the unblocked potf2 and
forward-substitution inverse of the JAX package (``_potf2`` and
``_inv_lower`` of ``src/repro/kernels/chol_blocked.py``) and of the port,
float64, for every tile the kernels are compiled for.

Tolerance: the two sides sum in another order (blocked products against
one long recurrence), so they agree to a few ulps times the tile's
conditioning; the tiles below (``xᵀx/B + I``, condition number < 10) leave
1e-12 relative to the largest value orders of magnitude of room.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.chol_blocked import _inv_lower as j_inv  # noqa: E402
from repro.kernels.chol_blocked import _potf2 as j_potf2  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

RTOL = 1e-12
CASES = [(16, 16), (32, 16), (32, 32), (64, 16), (64, 32), (128, 16),
         (128, 32)]


def _tiles(b, n, seed):
    x = np.random.default_rng(seed).standard_normal((n, 2 * b, b))
    return np.swapaxes(x, -1, -2) @ x / b + np.eye(b)


def _close(got, want):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= RTOL * float(np.abs(np.asarray(want)).max()), err


@pytest.mark.parametrize("b, nb", CASES)
def test_diag_tile_matches_jax_potf2_and_inverse(b, nb):
    a = _tiles(b, 1, b + nb)[0]
    l, x = ref.factor_diag_tile(torch.from_numpy(a), nb)
    l_j = j_potf2(jnp.asarray(a))
    _close(l, l_j)
    _close(x, j_inv(l_j))


@pytest.mark.parametrize("b, nb", CASES)
def test_diag_tile_matches_port_potf2_and_inverse_batched(b, nb):
    a = torch.from_numpy(_tiles(b, 3, 2 * b + nb))
    # the upper triangle is never read: garbage there changes nothing
    noisy = torch.tril(a) + torch.triu(torch.full_like(a, 7.0), 1)
    l, x = ref.factor_diag_tile(noisy, nb)
    l_p = ref._potf2(a)
    _close(l, l_p)
    _close(x, ref._inv_lower(l_p))
    assert torch.equal(l, torch.tril(l)) and torch.equal(x, torch.tril(x))
    eye = torch.eye(b, dtype=a.dtype).expand_as(a)
    _close(l @ x, eye)


def test_diag_tile_rejects_a_ragged_sub_block():
    with pytest.raises(ValueError):
        ref.factor_diag_tile(torch.eye(24, dtype=torch.float64), 16)

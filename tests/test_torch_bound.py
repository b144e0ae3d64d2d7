"""The port's Theorem 4.4 / 4.7 machinery (``repro_torch.core.bound``)
against the JAX package's on the same unit-scale SPD matrices (d ≤ 8), and
its own bound dominating the port's observed interpolation error."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bound as jbound  # noqa: E402
from repro.testing import strategies as props  # noqa: E402
from repro_torch.core import bound, picholesky  # noqa: E402

#: the same float64 operators through other LAPACK paths (pinv, lstsq and
#: the spectral norms); the operators are d² × d² at d ≤ 8
BOUND_RTOL = 1e-10
DIMS = [3, 8]


def _pair(d, seed):
    a = np.array(props.unit_spd_matrix(d, seed))
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=BOUND_RTOL * max(np.abs(want).max(),
                                                     1e-300))


@pytest.mark.parametrize("d", DIMS)
def test_operators_and_taylor_factor_match_jax(d):
    ja, ta = _pair(d, d)
    _close(bound.m_operator(ta, 0.3), jbound.m_operator(ja, 0.3))
    for lam in (0.55, 0.7):
        _close(bound.taylor_factor(ta, lam, 0.5),
               jbound.taylor_factor(ja, jnp.asarray(lam), jnp.asarray(0.5)))


@pytest.mark.parametrize("d", DIMS)
def test_remainder_matches_jax_and_grows_with_the_interval(d):
    ja, ta = _pair(d, d + 1)
    small = bound.remainder_r(ta, 0.5, 0.6)
    _close(small, jbound.remainder_r(ja, 0.5, 0.6))
    big = bound.remainder_r(ta, 0.1, 0.6, n_grid=5)
    _close(big, jbound.remainder_r(ja, 0.1, 0.6, n_grid=5))
    assert float(small) > 0 and float(big) >= float(small) - 1e-12


@pytest.mark.parametrize("d", DIMS)
def test_anchor_advisor_matches_jax(d):
    ja, ta = _pair(d, 2 * d)
    anchors = np.logspace(-2, 0, 4)
    want = jbound.anchor_advisor(ja, anchors, n_grid=3)
    got = bound.anchor_advisor(ta, anchors, n_grid=3)
    assert got["worst"] == want["worst"]
    assert got["proposal"] == want["proposal"]
    assert got["intervals"] == want["intervals"]
    np.testing.assert_allclose(got["scores"], want["scores"],
                               rtol=BOUND_RTOL)
    for bad in ([0.5], [-1.0, 1.0]):
        with pytest.raises(ValueError):
            bound.anchor_advisor(ta, bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_picholesky_bound_matches_jax_and_dominates(seed):
    d = 8
    ja, ta = _pair(d, seed)
    lam_c, w, gamma = 0.6, 0.15, 0.15
    sample = np.linspace(lam_c - w, lam_c + w, 5)
    rhs = bound.picholesky_bound(ta, torch.from_numpy(sample), lam_c, gamma)
    _close(rhs, jbound.picholesky_bound(ja, jnp.asarray(sample), lam_c,
                                        gamma))
    model = picholesky.fit(ta, torch.from_numpy(sample), 2, block=4)
    big_d = d * (d + 1) / 2.0
    worst = 0.0
    for lam in np.linspace(lam_c - gamma, lam_c + gamma, 9):
        l_i = model.eval_factor(float(lam))
        l_e = torch.linalg.cholesky(ta + lam * torch.eye(d,
                                                         dtype=ta.dtype))
        worst = max(worst, float(torch.linalg.norm(l_i - l_e))
                    / np.sqrt(big_d))
    assert worst <= float(rhs) * 1.01, (worst, float(rhs))

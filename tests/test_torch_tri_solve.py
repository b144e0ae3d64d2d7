"""The arithmetic of the cluster solve (``csrc/tri_solve.cuh``) on the CPU.

The dense trsm and ``interp_solve`` kernels run the substitution as a
cluster of C blocks per system: block b owns tile rows b, b + C, …; the
owner of row i solves it with the inverse of its diagonal tile, formed in
the kernel's prologue; every block then adds that row's contribution to the
pending sums of its own rows (right-looking), the next row's owner first.
``repro_torch.kernels.ref.solve_right_looking`` runs that order and
``ref.invert_lower_tile`` the prologue's inversion in its sub-block order;
both are held here to the JAX package: ``repro.kernels.trsm.
solve_lower_blocked`` and ``repro.kernels.poly_interp.interp_solve`` in
interpret mode, and ``repro.core.packing.invert_diag_tiles``, float64.

Tolerances: the right-looking order adds the same products in the same
order per row as the JAX kernels' left-looking walk, but each tile product
and each inversion sums in another order (ATen against XLA, blocked
inverse against one triangular solve), so the two agree to a few ulps
times the conditioning of the substitution.  The factors below come from
``xᵀx/h + I`` (condition number < 10), so 1e-10 relative to the largest
value for the solves, and 1e-12 for a single tile's inverse, leave orders
of magnitude of room.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpacking  # noqa: E402
from repro.kernels.poly_interp import interp_solve as j_interp  # noqa: E402
from repro.kernels.trsm import solve_lower_blocked as j_trsm  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import (LAUNCHES, poly_interp, ref,  # noqa: E402
                                 reset_launches, trsm)

RTOL = 1e-10
TILE_RTOL = 1e-12
HS, BLOCKS, CLUSTERS = (40, 200, 1000), (16, 32, 128), (1, 4, 8)
LAMS = np.array([0.1, 0.5, 2.0])


def _factor(h, seed):
    x = np.random.default_rng(seed).standard_normal((2 * h, h))
    return np.linalg.cholesky(x.T @ x / h + np.eye(h))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _cluster(c, nt):
    """The cluster size the kernels take for a cap of ``c`` at ``nt``."""
    return max(k for k in ref.CLUSTER_SIZES if k <= min(c, nt))


@functools.lru_cache(maxsize=None)
def _trsm_case(h, block):
    l = _factor(h, h)
    g = np.random.default_rng(h + 1).standard_normal((h, 2))
    want = [np.asarray(j_trsm(jnp.asarray(l), jnp.asarray(g), block,
                              transpose=tr)) for tr in (False, True)]
    return l, g, want


@functools.lru_cache(maxsize=None)
def _interp_case(h, block):
    """Θ of three packed lower factors with positive diagonals, so L(λ) =
    L₀ + 0.1 λ L₁ + 0.01 λ² L₂ is well conditioned at every λ of LAMS."""
    vecs = [packing.pack_tril(torch.from_numpy(_factor(h, h + s)), block)
            for s in range(3)]
    theta = torch.stack([vecs[0], 0.1 * vecs[1], 0.01 * vecs[2]]).numpy()
    g = np.random.default_rng(h + 2).standard_normal((h, 2))
    want = np.asarray(j_interp(jnp.asarray(theta), jnp.asarray(LAMS),
                               jnp.asarray(g), h, block))
    return theta, g, want


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    reset_launches()
    yield
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("h", HS)
def test_right_looking_trsm_matches_jax(h, block, cluster):
    """Each sweep on its own (one launch each, as the trsm runs them),
    diagonal tiles identity-padded past h."""
    l, g, want = _trsm_case(h, block)
    nt = packing.num_tiles(h, block)
    hp = nt * block
    lp = ref._identity_padded(torch.from_numpy(l), block)
    gp = torch.nn.functional.pad(torch.from_numpy(g), (0, 0, 0, hp - h))

    def tile(a, b):
        return lp[a * block:(a + 1) * block, b * block:(b + 1) * block]

    for sweeps, w in ((1, want[0]), (2, want[1])):
        got = ref.solve_right_looking(tile, lambda i: tile(i, i), gp, nt,
                                      block, _cluster(cluster, nt), sweeps)
        assert _rel(got[:h], w) <= RTOL


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("h", HS)
def test_right_looking_interp_solve_matches_jax(h, block, cluster):
    """Both sweeps in one run, as ``interp_solve`` runs them: tiles
    Horner-evaluated from Θ, the last diagonal tile with its identity
    tail."""
    theta, g, want = _interp_case(h, block)
    nt = packing.num_tiles(h, block)
    hp = nt * block
    tiles = torch.from_numpy(theta).reshape(3, -1, block, block)
    pmap = packing.tile_pos_map(h, block)
    tail = torch.from_numpy(packing._identity_tail(h, block))
    gp = torch.nn.functional.pad(torch.from_numpy(g), (0, 0, 0, hp - h))
    for q, lam in enumerate(LAMS):
        def tile(a, b):
            t = tiles[:, int(pmap[a, b])]
            return (t[2] * lam + t[1]) * lam + t[0]

        def diag(i):
            return tile(i, i) + (tail if i == nt - 1 else 0)

        got = ref.solve_right_looking(tile, diag, gp, nt, block,
                                      _cluster(cluster, nt), 3)
        assert _rel(got[:h], want[q]) <= RTOL


@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_prologue_inverse_matches_jax_invert_diag_tiles(block):
    """The prologue's inversion (16 × 16 sub-blocks, then block rows)
    against the triangular solve of the JAX package, batched; the upper
    triangle is not read."""
    tiles = np.stack([_factor(block, block + s) for s in range(3)])
    noisy = torch.from_numpy(tiles) + torch.triu(
        torch.full((block, block), 5.0, dtype=torch.float64), 1)
    got = ref.invert_lower_tile(noisy)
    want = np.asarray(jpacking.invert_diag_tiles(jnp.asarray(tiles)))
    assert _rel(got, want) <= TILE_RTOL
    assert torch.equal(got, torch.tril(got))


def test_prologue_inverse_of_an_identity_padded_tile():
    """The last diagonal tile of a ragged h: its padded rows are the
    identity, and so are they in the inverse."""
    h, block = 40, 32
    l = torch.from_numpy(_factor(h, 3))
    d = ref._identity_padded(l, block)[block:, block:]
    got = ref.invert_lower_tile(d)
    torch.testing.assert_close(got[8:, 8:], torch.eye(24, dtype=torch.float64),
                               rtol=0, atol=0)
    want = np.asarray(jpacking.invert_diag_tiles(jnp.asarray(d.numpy())))
    assert _rel(got, want) <= TILE_RTOL


def test_cluster_plan_owns_every_row_once():
    """For nt in 1..64 and every cluster size the kernels may take (at most
    8 and at most nt): each tile row has exactly one owner, block b owns the
    rows ≡ b mod C, and no block owns more than ceil(nt / C)."""
    for nt in range(1, 65):
        for c in ref.CLUSTER_SIZES:
            if c > nt and c > 1:
                with pytest.raises(ValueError):
                    ref.cluster_plan(nt, c)
                continue
            rows = ref.cluster_plan(nt, c)
            assert len(rows) == c <= 8
            assert sorted(r for b in rows for r in b) == list(range(nt))
            assert all(r % c == b for b, rs in enumerate(rows) for r in rs)
            assert max(len(rs) for rs in rows) == -(-nt // c)
    with pytest.raises(ValueError):
        ref.cluster_plan(16, 16)


def test_solve_right_looking_one_tile_row():
    """nt = 1: the forward solve, then the reverse one on its result."""
    l = torch.from_numpy(_factor(24, 5))
    lp = ref._identity_padded(l, 32)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((32, 1)))
    g[24:] = 0
    got = ref.solve_right_looking(None, lambda i: lp, g, 1, 32, 1, 3)
    want = torch.cholesky_solve(g[:24], l)
    assert _rel(got[:24], want) <= RTOL
    assert torch.equal(got[24:], torch.zeros(8, 1, dtype=torch.float64))


@pytest.mark.parametrize("block", [8, 48, 96, 256])
def test_solve_kernels_take_only_the_compiled_blocks(block):
    """The trsm and interp_solve kernels are compiled for blocks 16, 32,
    64 and 128; any other block is refused before a launch (the plain
    versions on the CPU take any block)."""
    h = 2 * block
    l = torch.empty(2, h, h, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match=r"one of \(16, 32, 64, 128\)"):
        trsm.solve_lower_blocked(l, torch.empty(2, h, device="meta",
                                                dtype=torch.float64), block)
    theta = torch.empty(2, 3, packing.packed_size(h, block), device="meta",
                        dtype=torch.float64)
    with pytest.raises(ValueError, match=r"one of \(16, 32, 64, 128\)"):
        poly_interp.interp_solve(theta, torch.ones(2, dtype=torch.float64),
                                 torch.empty(2, h, device="meta",
                                             dtype=torch.float64), h, block)
    cpu = torch.eye(h, dtype=torch.float64) * 2
    torch.testing.assert_close(
        trsm.solve_lower_blocked(cpu, torch.ones(h, dtype=torch.float64),
                                 block),
        torch.full((h,), 0.5, dtype=torch.float64))

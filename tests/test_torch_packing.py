"""The port's packed layout against the JAX package's: index maps equal,
pack/unpack bitwise equal (to ``repro.core.packing`` and to the Pallas
``tri_pack.pack_tril`` in interpret mode), packed solves to 1e-12."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.kernels import tri_pack as jtri  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402

# h < B, h % B != 0, h % B == 0
SHAPES = [(24, 32), (24, 16), (40, 16), (64, 32), (144, 32)]


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("h,block", SHAPES)
def test_index_maps_equal(h, block):
    assert tpack.num_tiles(h, block) == jpack.num_tiles(h, block)
    for a, b in zip(tpack.tile_index_pairs(h, block),
                    jpack.tile_index_pairs(h, block)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpack.tile_pos_map(h, block),
                                  jpack.tile_pos_map(h, block))
    np.testing.assert_array_equal(tpack.column_starts(h, block),
                                  jpack.column_starts(h, block))
    assert tpack.packed_size(h, block) == jpack.packed_size(h, block)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64,
                                                    jnp.float64)):
        assert tpack.packed_nbytes(h, block, tdt) == \
            jpack.packed_nbytes(h, block, jdt)
    np.testing.assert_array_equal(tpack._identity_tail(h, block),
                                  jpack._identity_tail(h, block))


@pytest.mark.parametrize("h,block", SHAPES)
def test_pack_unpack_bitwise(h, block):
    m = _rand((3, h, h), h)
    vt = tpack.pack_tril(torch.from_numpy(m), block).numpy()
    vj = np.asarray(jpack.pack_tril(jnp.asarray(m), block))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(
        tpack.unpack_tril(torch.from_numpy(vt), h, block).numpy(),
        np.asarray(jpack.unpack_tril(jnp.asarray(vj), h, block)))
    np.testing.assert_array_equal(
        vt[0], np.asarray(jtri.pack_tril(jnp.asarray(m[0]), block)))


@pytest.mark.parametrize("h,block", [(24, 16), (40, 16), (64, 32)])
@pytest.mark.parametrize("transpose", [False, True])
def test_solve_lower_packed_matches(h, block, transpose):
    x = _rand((2 * h, h), 1)
    l = np.linalg.cholesky(x.T @ x + h * np.eye(h))
    g = _rand((h, 3), 2)
    vec = tpack.pack_tril(torch.from_numpy(l), block)
    wt = tpack.solve_lower_packed(vec, torch.from_numpy(g), h, block,
                                  transpose=transpose).numpy()
    wj = np.asarray(jpack.solve_lower_packed(jnp.asarray(vec.numpy()),
                                             jnp.asarray(g), h, block,
                                             transpose=transpose))
    np.testing.assert_allclose(wt, wj, rtol=1e-12, atol=0)


@pytest.mark.parametrize("h,block", SHAPES)
def test_solve_packed_ref_matches(h, block):
    """Same blocked substitution in float64 on both sides; only the
    order of the tile products' sums differs (≤ 1e-12 relative)."""
    x = _rand((2 * h, h), 3)
    l = np.linalg.cholesky(x.T @ x + h * np.eye(h))
    g = _rand(h, 4)
    vec = tpack.pack_tril(torch.from_numpy(l), block)
    st = tpack.solve_packed_ref(vec, torch.from_numpy(g), h, block).numpy()
    sj = np.asarray(jpack.solve_packed_ref(jnp.asarray(vec.numpy()),
                                           jnp.asarray(g), h, block))
    assert np.max(np.abs(st - sj)) <= 1e-12 * np.max(np.abs(sj))
    # the solve is a solve: L Lᵀ θ = g
    np.testing.assert_allclose(l @ (l.T @ st), g, rtol=1e-9, atol=1e-9)


def test_packed_factor_batch_and_validation():
    h, block = 40, 16
    m = torch.from_numpy(_rand((2, 3, h, h), 5))
    pf = tpack.PackedFactor.from_dense(m, block)
    assert pf.vec.shape == (2, 3, tpack.packed_size(h, block))
    assert pf.tiles().shape == (2, 3, pf.n_blocks, block, block)
    np.testing.assert_array_equal(pf.dense().numpy(), np.tril(m.numpy()))
    assert pf.astype("float32").nbytes == pf.nbytes // 2
    with pytest.raises(ValueError, match="packed_size"):
        tpack.PackedFactor(torch.zeros(7), h, block)

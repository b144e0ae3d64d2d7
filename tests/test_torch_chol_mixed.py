"""The mixed-precision Cholesky's wgmma design, on the CPU.

At B = 64 and 128 the bf16 Cholesky of ``csrc/chol_blocked.cu`` (float32
state, bf16 products) rounds each operand once where it is stored — the
diagonal inverse by the diagonal step, A_i1 by the panel job as it stages
it, the panel W as a bf16 copy beside the float32 W the panel job writes
into the factor — and runs one block a half panel tile row and one block
a lower tile pair of the trailing update or a zeroing job for the
mirrored upper tile.  No kernel runs here.  What is held:

* the job map: ``chol_blocked.column_jobs`` mirrors the C side's launch
  index → job for every tile column at every block, in the design the
  block runs, and covers every lower tile of the trailing matrix exactly
  once (pair 0, the next diagonal tile, by the next diagonal step),
  touches no strictly upper tile with a product, writes every row of the
  column's tiles once (wgmma: a panel block a half tile row) and zeroes
  every mirrored tile once; its arithmetic and grid sizes are the
  source's;
* the dataflow: ``ref.cholesky_blocked_stored`` (operands rounded once at
  the store, W kept float32 in the factor, the look-ahead pair apart)
  gives ``ref.cholesky_blocked(·, compute_dtype=bf16)`` bit for bit, and
  the JAX package's ``cholesky_blocked(compute_dtype=bfloat16)`` (Pallas,
  interpret mode) within 1e-5 — ``tests/test_torch_precision.py``'s bound
  for the same comparison: the same bf16 operands, products exact in
  float32, only the order of the float32 sums differs (ATen against XLA).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.chol_blocked import cholesky_blocked as j_chol  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import _build, chol_blocked, ref  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
KERNEL_RTOL = 1e-5
SOURCE = (Path(chol_blocked.__file__).parent / "csrc"
          / "chol_blocked.cu").read_text()
# (h, B) pairs for the dataflow, ragged h included
SHAPES = [(48, 16), (40, 16), (64, 32), (72, 32), (100, 64)]
MATS = 2


def _spd32(h, n, seed):
    x = np.random.default_rng(seed).standard_normal((n, 2 * h, h))
    return (np.swapaxes(x, -1, -2) @ x / h + np.eye(h)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_factors():
    """The JAX package's bf16 factors of every SHAPES case (interpret
    mode), computed once for the module."""
    out = {}
    for h, block in SHAPES:
        a = _spd32(h, MATS, h + block)
        out[h, block] = (a, np.stack([
            np.asarray(j_chol(jnp.asarray(m), block, compute_dtype="bfloat16",
                              accum_dtype="float32")) for m in a]))
    return out


# ------------------------------------------------------------------ job map


def _cases():
    for block in _build.BLOCKS:
        for nt in range(1, 9):
            for h in sorted({nt * block, nt * block - 3}):
                if h > 0:
                    yield block, h


@pytest.mark.parametrize("block, h", list(_cases()))
def test_job_map_covers_every_lower_tile_once(block, h):
    nt = packing.num_tiles(h, block)
    last = "zero" if chol_blocked.mixed_variant(block) == "wgmma" \
        else "copy_zero"
    for j in range(nt - 1):
        jobs = chol_blocked.column_jobs(nt, j, block)
        m, rows = nt - 1 - j, jobs["rows"]
        assert len(jobs["panel"]) == m * (block // rows)    # the grids
        assert len(jobs["syrk"]) == m * (m + 1) // 2 - 1 + m
        trailing = [(ti, tj) for ti in range(j + 1, nt)
                    for tj in range(j + 1, ti + 1)]
        pairs = [(ti, tj) for kind, ti, tj in jobs["syrk"] if kind == "pair"]
        assert all(tj <= ti for ti, tj in pairs)        # nothing upper
        assert jobs["diag"] == (j + 1, j + 1) and jobs["diag"] not in pairs
        assert sorted(pairs + [jobs["diag"]]) == trailing
        assert len(set(pairs)) == len(pairs)
        # every row of the column's tiles below the diagonal, once
        assert sorted(jobs["panel"]) == [(i, j, r0) for i in range(j + 1, nt)
                                         for r0 in range(0, block, rows)]
        # every mirrored upper tile zeroed once (and, in mma_sync, the
        # column's tile copied from the scratch panel)
        tail = [(ti, tj) for kind, ti, tj in jobs["syrk"] if kind == last]
        assert tail == [(j, i) for i in range(j + 1, nt)]
        # every pair job before every zeroing job, in row-major order
        assert [k for k, *_ in jobs["syrk"]] == ["pair"] * len(pairs) + [
            last] * m
        assert pairs == sorted(pairs)


def test_job_map_mirrors_the_source():
    """The mirror's arithmetic and grid sizes are those of
    ``syrk_kernel_tc`` and ``run_columns_tc``; a change on either side
    without the other fails here."""
    kern = SOURCE[SOURCE.index("syrk_kernel_tc(const float* src"):]
    for line in ("const int p = job + 1;",
                 "int ti = (int)((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);",
                 "while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;",
                 "while (ti * (ti + 1) / 2 > p) --ti;",
                 "const int tj = p - ti * (ti + 1) / 2;",
                 "if (job >= n_pairs - 1) {",
                 "const int ti = job - (n_pairs - 1);"):
        assert line in kern, line
    panel = SOURCE[SOURCE.index("panel_kernel_tc(const float* src"):]
    for line in ("constexpr int R = 64,",
                 "const int i = blockIdx.x / (B / R), hh = blockIdx.x % (B / R);",
                 "(long long)(lo + B + i * B + hh * R) * hp + lo;"):
        assert line in panel, line
    host = SOURCE[SOURCE.index("int run_columns_tc("):]
    assert "panel_kernel_tc<B><<<dim3(m * (B / 64), batch)" in host
    assert re.search(r"syrk_kernel_tc<B><<<dim3\(m \* \(m \+ 1\) / 2 - 1 \+ m,"
                     r" batch\)", host)
    # the mma_sync design (B = 16, 32: one sub-tile a tile, TS = B)
    old = SOURCE[SOURCE.index("int run_columns(const T* src"):]
    assert "constexpr int TS = B < 64 ? B : 64, S = B / TS;" in old
    assert "panel_kernel<T, B, TS, CT><<<dim3(m * S * S, batch)" in old
    assert "syrk_kernel<T, B, TS, CT><<<dim3((m * (m + 1) / 2 - 1 + m) * S * S," \
        in old
    # the design is chosen from B alone, as mixed_variant says
    assert re.search(r"constexpr bool kWgmma =\s+!std::is_same<T, CT>::value"
                     r" && B >= 64", SOURCE)
    assert chol_blocked.WGMMA_BLOCKS == tuple(b for b in _build.BLOCKS
                                              if b >= 64)


@pytest.mark.parametrize("block", _build.BLOCKS)
def test_mixed_variant_and_scratch_follow_the_block(block):
    want = "wgmma" if block >= 64 else "mma_sync"
    assert chol_blocked.mixed_variant(block) == want
    a = torch.zeros(2, 3, 3, dtype=F32)
    inv, w = chol_blocked.scratch(a, 2, 2 * block, block, BF)
    dtype = BF if want == "wgmma" else F32
    assert inv.shape == (2, block, block) and inv.dtype == dtype
    assert w.shape == (2, 2 * block, block) and w.dtype == dtype
    # one dtype throughout: the state's scratch at every block
    assert chol_blocked.scratch(a, 2, block, block)[0].dtype == F32


def test_mixed_variant_refuses_other_blocks():
    with pytest.raises(ValueError):
        chol_blocked.mixed_variant(48)


# ----------------------------------------------------------------- dataflow


@pytest.mark.parametrize("h, block", SHAPES)
def test_stored_dataflow_equals_the_plain_version_bit_for_bit(h, block):
    a = torch.from_numpy(_spd32(h, MATS + 1, 7 * h + block))
    want = ref.cholesky_blocked(a, block, BF)
    got = ref.cholesky_blocked_stored(a, block, BF)
    assert got.dtype == F32 and torch.equal(got, want)
    # the operands really were bf16: the float32 factor differs
    assert not torch.equal(got, ref.cholesky_blocked(a, block))


@pytest.mark.parametrize("h, block", SHAPES)
def test_stored_dataflow_matches_pallas(jax_factors, h, block):
    a, want = jax_factors[h, block]
    got = ref.cholesky_blocked_stored(torch.from_numpy(a), block, BF).numpy()
    err = np.max(np.abs(got.astype(np.float64) - want)) / np.max(np.abs(want))
    assert err <= KERNEL_RTOL, err
    exact = np.linalg.cholesky(a.astype(np.float64))
    assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) > 1e-4

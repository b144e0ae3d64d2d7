"""The mixed cluster solve's design (``csrc/tri_solve.cuh``
``tri_solve_mixed_kernel``: bf16 products, float32 sums and state), on the
CPU.

The kernel rounds each operand to bf16 once, where it stores it: the
inverses of the diagonal tiles as the prologue keeps them, each staged
chunk of L as it becomes a bf16 tile (a bf16 Θ Horner-evaluated with x and
every step rounded).  ``kernels.ref.solve_lower_blocked_stored`` and
``interp_solve_stored`` are that dataflow, held here bit for bit to the
plain versions the wrappers run on CPU tensors (``ref.solve_lower_blocked``
and ``ref.interp_solve`` with ``compute_dtype=bfloat16``), at ragged h, and
to the JAX package's Pallas kernels in interpret mode: the trsm within
``KERNEL_RTOL`` (1e-5; only the order of the float32 sums differs, as in
``tests/test_torch_precision.py``); ``interp_solve`` within
``EMULATION_RTOL`` (1e-6) of a numpy emulation of the Pallas kernel's
stated arithmetic (float64 sums of exact bf16 products; bf16 Horner, every
step rounded, from x rounded; the segments and g_i − acc_i rounded) on the
same bf16 inverses, because XLA's interpreted kernel rounds a few bf16
Horner values otherwise (``tests/test_torch_precision.py``'s docstring),
and both it and JAX within ``SOLVE_RTOL`` of the float64 solve.

The forward update's depth split (kf warps on a strip's k16 steps) is that
of the chunk the one-dtype plan takes first, whatever chunk the mixed plan
takes, so the bits do not depend on the plan: a mirror of
``mixed_depth_split`` shows that each (strip, k16 step) of every chunk the
plan may take is one warp's, in the one-dtype design's order, and a source
check that the mirror's constants are the source's.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.poly_interp import interp_solve as j_interp  # noqa: E402
from repro.kernels.trsm import solve_lower_blocked as j_trsm  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
KERNEL_RTOL = 1e-5
EMULATION_RTOL = 1e-6
SOLVE_RTOL = 2e-2
SHAPES = [(40, 16), (72, 32), (100, 64)]
LAMS = np.array([0.1, 0.5, 2.0])
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _bf(a):
    """numpy values rounded to bf16 (to nearest even), as float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).double().numpy()


def _emulate_interp(theta, lam, inv, g, h, block):
    """The Pallas kernel's stated arithmetic in numpy on the bf16 inverses
    ``inv`` (nt, B, B): off-diagonal tiles by bf16 Horner, every step
    rounded, from x rounded to bf16; the solved segments and g_i − acc_i
    rounded to bf16 before their products; float64 sums."""
    th = theta.double().numpy().reshape(theta.shape[0], -1, block, block)
    nt, degree = packing.num_tiles(h, block), theta.shape[0] - 1
    pmap = packing.tile_pos_map(h, block)
    xb = _bf(np.float32(lam))

    def tile(p):
        v = th[degree, p]
        for k in range(degree - 1, -1, -1):
            v = _bf(_bf(v * xb) + th[k, p])
        return v

    hp = nt * block
    gp = np.zeros(hp)
    gp[:h] = g
    w = np.zeros(hp)
    seg = [slice(i * block, (i + 1) * block) for i in range(nt)]
    for i in range(nt):
        acc = sum((tile(pmap[i, t]) @ _bf(w[seg[t]]) for t in range(i)),
                  np.zeros(block))
        w[seg[i]] = (inv[i] @ _bf(gp[seg[i]] - acc)).astype(np.float32)
    for i in range(nt - 1, -1, -1):
        acc = sum((tile(pmap[t, i]).T @ _bf(w[seg[t]])
                   for t in range(i + 1, nt)), np.zeros(block))
        w[seg[i]] = (inv[i].T @ _bf(w[seg[i]] - acc)).astype(np.float32)
    return w[:h]


def _factor(h, seed):
    x = np.random.default_rng(seed).standard_normal((2 * h, h))
    return np.linalg.cholesky(x.T @ x / h + np.eye(h))


@functools.lru_cache(maxsize=None)
def _dense(h, block):
    """Two float32 factors, g (2, h, 2), and JAX's mixed trsm of both
    sweeps (interpret mode)."""
    l = np.stack([_factor(h, h + s) for s in range(2)]).astype(np.float32)
    g = np.random.default_rng(h + 7).standard_normal((2, h, 2)
                                                     ).astype(np.float32)
    want = {t: np.stack([np.asarray(j_trsm(
        jnp.asarray(l[k]), jnp.asarray(g[k]), block, transpose=t,
        compute_dtype="bfloat16", accum_dtype="float32")) for k in range(2)])
        for t in (False, True)}
    return torch.from_numpy(l), torch.from_numpy(g), want


@functools.lru_cache(maxsize=None)
def _interp(h, block):
    """A bf16 Θ of three packed factors (L₀ + 0.1 λ L₁ + 0.01 λ² L₂), g
    (h,), JAX's mixed interp_solve (interpret mode) and its float64 one."""
    vecs = [packing.pack_tril(torch.from_numpy(_factor(h, h + s)), block)
            for s in range(3)]
    theta = torch.stack([vecs[0], 0.1 * vecs[1], 0.01 * vecs[2]]).to(BF)
    g = np.random.default_rng(h + 2).standard_normal(h).astype(np.float32)
    jt = jnp.asarray(theta.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(j_interp(jt, jnp.asarray(LAMS, jnp.float32),
                               jnp.asarray(g), h, block,
                               compute_dtype="bfloat16",
                               accum_dtype="float32"))
    f64 = np.asarray(j_interp(jnp.asarray(theta.double().numpy()),
                              jnp.asarray(LAMS), jnp.asarray(g, jnp.float64),
                              h, block))
    return theta, g, want, f64


@pytest.mark.parametrize("transpose", [False, True], ids=["L", "LT"])
@pytest.mark.parametrize("h,block", SHAPES)
def test_stored_trsm_is_the_plain_version_bit_for_bit(h, block, transpose):
    l, g, want = _dense(h, block)
    got = ref.solve_lower_blocked_stored(l, g, block, BF,
                                         transpose=transpose)
    plain = ref.solve_lower_blocked(l, g, block, transpose=transpose,
                                    compute_dtype=BF)
    assert got.dtype == F32 and torch.equal(got, plain)
    assert _rel(got, want[transpose]) <= KERNEL_RTOL
    exact = np.linalg.solve(np.swapaxes(l.double().numpy(), -1, -2)
                            if transpose else l.double().numpy(),
                            g.double().numpy())
    assert _rel(got, exact) > 1e-4          # the operands really were bf16


@pytest.mark.parametrize("h,block", SHAPES)
def test_stored_interp_solve_is_the_plain_version_bit_for_bit(h, block):
    theta, g, want, f64 = _interp(h, block)
    x = torch.from_numpy(LAMS).float()
    th = theta[None]
    inv = ref.interp_diag_inverses(th, x, h, block, F32)
    hp = packing.num_tiles(h, block) * block
    gp = torch.nn.functional.pad(torch.from_numpy(g)[None, :, None],
                                 (0, 0, 0, hp - h))
    got = ref.interp_solve_stored(th, x, inv, gp, h, block, BF)
    plain = ref.interp_solve(th, x, inv, gp, h, block, BF)
    assert got.dtype == F32 and torch.equal(got, plain)
    got = got[0, :, :h, 0]
    for q, lam in enumerate(LAMS):
        inv_q = inv[0, q].to(BF).double().numpy()
        assert _rel(got[q], _emulate_interp(theta, lam, inv_q, g, h, block)) \
            <= EMULATION_RTOL
    assert _rel(got, f64) <= SOLVE_RTOL and _rel(want, f64) <= SOLVE_RTOL
    assert _rel(got, f64) > 1e-4            # the sweep really ran in bf16


@pytest.mark.parametrize("seed", range(4))
def test_horner_stored_is_bf16_arithmetic(seed):
    """The kernel's tile values (a float32 operation rounded to bf16, x
    rounded first) are torch's bf16 operations, for values of every
    magnitude the planes hold."""
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy(rng.standard_normal((3, 64, 64)) *
                              10.0 ** rng.integers(-6, 3, (3, 64, 64))
                              ).to(BF)
    x = torch.tensor(float(rng.uniform(-3, 3)))
    want = planes[2] * x.to(BF) + planes[1]
    want = want * x.to(BF) + planes[0]
    assert torch.equal(ref.horner_stored(planes, x, BF), want)


# ------------------------------------------------- the forward depth split

def _source_constants():
    tri = (SRC / "tri_solve.cuh").read_text()
    common = (SRC / "common.cuh").read_text()
    body = tri[tri.index("mixed_depth_split(int B"):]
    body = body[:body.index("\n}\n")]
    return dict(
        threads=int(re.search(r"kThreads = (\d+);", common).group(1)),
        stage_bytes=int(re.search(r"kStageBytes = (\d+);", tri).group(1)),
        body=re.sub(r"\s+", " ", body))


def _depth_split(B, nc, src_bytes, threads=256, stage_bytes=32768):
    """Mirror of ``mixed_depth_split``: the one-dtype plan's first chunk
    (rows doubled from 16 while nc planes stay within kStageBytes), its
    strips' warps: min(warps / strips, B / 16)."""
    cr = 16
    while cr * 2 <= B and cr * 2 * nc * B * src_bytes <= stage_bytes:
        cr *= 2
    return min(threads // 32 // (cr // 16), B // 16), cr


def test_depth_split_mirrors_the_source():
    c = _source_constants()
    assert c["threads"] == 256 and c["stage_bytes"] == 32768
    for piece in ("int cr = 16;",
                  "while (cr * 2 <= B && (long long)cr * 2 * nc * B * "
                  "src_bytes <= kStageBytes) cr *= 2;",
                  "const int kf = (kThreads / 32) / (cr / 16);",
                  "return kf < B / 16 ? kf : B / 16;"):
        assert piece in c["body"], piece


@pytest.mark.parametrize("B", [16, 32, 64, 128])
@pytest.mark.parametrize("nc, src_bytes", [(1, 4), (1, 2), (3, 2), (2, 2)],
                         ids=["f32", "bf16", "theta_r2", "theta_r1"])
def test_forward_split_covers_every_step_once(B, nc, src_bytes):
    """For every chunk the mixed plan may take (16 rows up to the first
    chunk), the warps' (strip, kp) jobs over k16 steps ks = kp, kp + kf, …
    cover each (strip, k16 step) of the chunk exactly once, with each
    step's partial summed in the same order whatever the chunk: the warp
    of a strip's partial p takes the same steps as in the first chunk."""
    kf, cr0 = _depth_split(B, nc, src_bytes)
    steps = B // 16
    first = {kp: list(range(kp, steps, kf)) for kp in range(kf)}
    cr = cr0
    while cr >= 16:
        ns = cr // 16
        seen = {}
        for warp in range(8):
            strip, kp = warp % ns, warp // ns
            if kp >= kf:
                continue
            assert list(range(kp, steps, kf)) == first[kp]
            for ks in range(kp, steps, kf):
                seen[strip, ks] = seen.get((strip, ks), 0) + 1
        assert seen == {(s, k): 1 for s in range(ns) for k in range(steps)}
        cr //= 2

"""The port's kernels on a CUDA card, at every tile size the port uses.

Each kernel is held against its plain PyTorch version on the card (the
same check ``chip_smoke.py`` makes at the main path's shapes), for blocks
16, 32, 64 and 128, for h below, between and above the blocks (ragged
everywhere), in float64 and float32; then the engine drivers, the host-loop
drivers, the packed solve and the Gauss–Newton head on the kernel backend
against the reference backend; the three cluster solves (dense trsm,
``interp_solve``, packed trsm) at more tile rows than a cluster has blocks
and at one tile row; the packed trsm at every block, one and both sweeps,
in float64, float32 and under bf16 products (bf16 and float32 factors);
``interp_factors`` on a bf16 Θ bit for bit; the mixed-precision variants
(bf16 products, float32 sums) against their plain versions, nt = 17 too,
the mixed cluster solves the same bits twice at every block (h 1000, 999),
the mixed Cholesky's two designs at every block, batch 1 and 20, the same
bits twice;
the Gauss–Newton head under ``bf16_store``; the ``ssm_scan`` kernel at N
8, 16 and 32 on ragged shapes, its fused entry ``mamba_scan`` (S 0, 1 from
a state, 37, 100; d_inner 20, 130, 8100; N 4 to 32; float32 and bf16) and
the fused causal convolution (bit for bit), the reduced Mamba model
against the JAX fixture; the backward kernels of training (the fused
scan's and the convolution's) and the reduced model's gradients against
the JAX training fixture; the paper's other CV algorithms (warm-start,
PINRMSE, MChol, the SVD family, low rank) on the kernel backend against the
reference backend, ``select_interpolant`` and ``RidgeCV`` on the card, and
``kernels.ops`` (the kernels on CUDA tensors, ``REPRO_KERNELS=ref``
refused there), and the engine's staging surface: the count sketch's
fixed-order reduction (the same bits twice, and as on the CPU),
``run_batch`` against solo runs and the pipelined ``sweep_async`` against
the serial one, bit for bit; the hold-out scores the same bits whatever
they are batched with.  Skipped without a CUDA device.  On the
card, from the repo root:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("h", [40, 200])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_kernels_match_plain_versions(dev, smoke, block, h, dtype):
    res = smoke.check_kernels(dev, h, block, 4, 3, dtype)
    torch.cuda.synchronize()
    assert all(r["ok"] for r in res.values()), res


@pytest.mark.parametrize("h", [40, 200, 999])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_mixed_variants_match_plain_versions(dev, smoke, block, h):
    """The mixed-precision Cholesky, dense trsm, interp_solve and packed
    trsm (bf16 products, float32 sums, Θ and packed factors in bf16), and
    interp_factors on a bf16 Θ, against their plain versions in float32,
    within ``chip_smoke.MIXED_TOL`` (its comment gives the reasons)."""
    res = smoke.check_mixed(dev, h, block, 4, 3, 3)
    torch.cuda.synchronize()
    assert all(r["ok"] for r in res.values()), res


@pytest.mark.parametrize("batch", [1, 20])
@pytest.mark.parametrize("h", [200, 1000])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_mixed_cholesky_designs_match_plain_version(dev, smoke, block, h,
                                                    batch):
    """The mixed Cholesky in the design its block runs (``wgmma`` at 64 and
    128: operands stored once in bf16, TMA and wgmma; ``mma_sync`` at 16
    and 32) against its plain version on ragged h, within
    ``chip_smoke.MIXED_TOL`` and ``ERROR_RATIO``, and the same bits on two
    calls."""
    res = smoke.check_chol_designs(dev, h, block, batch)
    torch.cuda.synchronize()
    assert res["ok"], res


def test_mixed_cluster_solves_at_17_tile_rows(dev, smoke):
    """nt = 17 at B = 128 (h = 2100, ragged): more tile rows than a cluster
    has blocks, and the formed inverses in the scratch tensor."""
    from repro_torch.kernels import _build
    res = smoke.check_mixed(dev, 2100, 128, 2, 2, 2)
    torch.cuda.synchronize()
    assert all(r["ok"] for r in res.values()), res
    assert _build.PLANS["interp_solve_bf16"]["inv_in_smem"] == 0


@pytest.mark.parametrize("h", [1000, 999])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_mixed_cluster_solves_give_the_same_bits_twice(dev, block, h):
    """The three mixed cluster solves (the dense trsm pair, interp_solve on
    a bf16 Θ, the packed trsm on bf16 and float32 factors) give the same
    bits on two calls, finite, at every block (h = 999: the dense factor's
    rows not 16-byte aligned, read from global memory)."""
    from repro_torch.core import packing
    from repro_torch.kernels import packed_trsm, poly_interp, trsm
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(h + block)
    x = torch.randn(6, 2 * h, h, generator=gen, device=dev,
                    dtype=torch.float64)
    l64 = torch.linalg.cholesky(x.mT @ x / h + torch.eye(
        h, device=dev, dtype=torch.float64))
    del x
    l = l64.float().contiguous()
    g = torch.randn(6, h, generator=gen, device=dev, dtype=f32)
    v = packing.pack_tril(l64, block)
    theta = torch.stack([v[:2], 0.1 * v[2:4], 0.01 * v[4:6]], 1).to(bf)
    lams = torch.logspace(-3, -1, 5, device=dev)
    calls = dict(
        trsm=lambda: trsm.solve_lower_blocked(
            l, trsm.solve_lower_blocked(l, g, block, compute_dtype=bf), block,
            transpose=True, compute_dtype=bf),
        interp_solve=lambda: poly_interp.interp_solve(
            theta, lams, g[:2], h, block, compute_dtype=bf, accum_dtype=f32),
        packed_bf16=lambda: packed_trsm.solve_packed(v.to(bf), g, h, block),
        packed_f32=lambda: packed_trsm.solve_packed(v.float(), g, h, block,
                                                    compute_dtype=bf))
    for name, fn in calls.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("h", [1024, 1000])
def test_cholesky_ill_conditioned_matches_plain_version(dev, h):
    """κ(A) = 1e8, float64, B = 128 (h = 1000 ragged).  Two backward-stable
    factorizations of one matrix differ in the factor by up to
    κ(A)·h·u relative (the factor's sensitivity times the backward error
    c·h·u), so that is the limit against the plain version.  The
    reconstruction L Lᵀ − A is held to h·u·κ(A)^½: the panel is a product
    with the explicit inverse of the diagonal factor, whose condition is at
    most κ(A)^½, so the usual h·u gains that factor."""
    from repro_torch.kernels import chol_blocked, ref
    kappa, u = 1e8, torch.finfo(torch.float64).eps
    gen = torch.Generator(device=dev).manual_seed(h)
    q, _ = torch.linalg.qr(torch.randn(2, h, h, generator=gen, device=dev,
                                       dtype=torch.float64))
    eig = torch.logspace(0, -8, h, dtype=torch.float64, device=dev)
    a = (q * eig) @ q.mT
    a = ((a + a.mT) / 2).contiguous()
    a0 = a.clone()
    l = chol_blocked.cholesky_blocked(a, 128)
    l_p = ref.cholesky_blocked(a, 128)
    torch.cuda.synchronize()
    assert torch.equal(a, a0), "the input was modified"
    assert torch.isfinite(l).all() and torch.equal(l, torch.tril(l))
    assert float((l - l_p).abs().max()) <= \
        kappa * h * u * float(l_p.abs().max())
    assert float((l @ l.mT - a).abs().max()) <= \
        h * u * kappa ** 0.5 * float(a.abs().max())


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("h, dtype, offset", [
    (999, torch.float64, 0), (1001, torch.float32, 0),
    (1022, torch.float32, 0), (1024, torch.float64, 1),
    (256, torch.float32, 1)], ids=["odd-f64", "odd-f32", "h%4=2-f32",
                                   "base+8B-f64", "base+4B-f32"])
def test_pack_tril_bit_exact_on_misaligned_rows(dev, block, h, dtype,
                                                offset):
    """Rows that are not 16-byte aligned (odd h in float64, h % 4 ≠ 0 in
    float32, or a base pointer off by one element) take the scalar path
    and still equal the plain version bit for bit."""
    from repro_torch.core import packing
    from repro_torch.kernels import tri_pack
    gen = torch.Generator(device=dev).manual_seed(h + block)
    buf = torch.randn(3 * h * h + offset, generator=gen, device=dev,
                      dtype=dtype)
    m = buf[offset:].view(3, h, h)
    got = tri_pack.pack_tril(m, block)
    torch.cuda.synchronize()
    assert torch.equal(got, packing.pack_tril(m, block))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("h, block", [(200, 16), (1000, 32), (40, 128),
                                      (2100, 128)],
                         ids=["nt13", "nt32", "nt1", "nt17"])
def test_cluster_solves_match_plain_versions(dev, smoke, h, block, nrhs,
                                            dtype):
    """The dense trsm (each sweep), the packed trsm (both sweeps) and
    interp_solve (g shared over λ and one g per λ) against their plain
    versions: more tile rows than a cluster has blocks, one tile row, and
    (nt17) three tile rows a block at B = 128, whose formed inverses do not
    fit in shared memory and go to the scratch tensor.  One cluster launch
    per call.  Tolerance: smoke.TOL, the plain versions sum in another
    order."""
    from repro_torch.core import packing
    from repro_torch.kernels import (LAUNCHES, _build, packed_trsm,
                                     poly_interp, ref, reset_launches, trsm)
    tol = smoke.TOL[dtype]
    scratch = h == 2100
    gen = torch.Generator(device=dev).manual_seed(h + nrhs)
    x = torch.randn(4, 2 * h, h, generator=gen, device=dev,
                    dtype=torch.float64)
    l = torch.linalg.cholesky(x.mT @ x / h + torch.eye(
        h, device=dev, dtype=torch.float64)).to(dtype).contiguous()
    g = torch.randn(4, h, nrhs, generator=gen, device=dev, dtype=dtype)
    for transpose in (False, True):
        want = ref.solve_lower_blocked(l, g, block, transpose=transpose)
        reset_launches()
        got = trsm.solve_lower_blocked(l, g, block, transpose=transpose)
        torch.cuda.synchronize()
        assert LAUNCHES["solve_lower_blocked"] == 1
        if scratch:
            assert not _build.PLANS["solve_lower_blocked"]["inv_in_smem"]
        assert smoke.errors(got, want)[1] <= tol
    v = packing.pack_tril(l, block)
    reset_launches()
    got = packed_trsm.solve_packed(v, g, h, block)
    torch.cuda.synchronize()
    assert LAUNCHES["solve_lower_packed"] == 1
    if scratch:
        assert not _build.PLANS["solve_lower_packed"]["inv_in_smem"]
    assert smoke.errors(got, ref.solve_packed(v, g, h, block))[1] <= tol
    theta = torch.stack([v[:2], 0.1 * v[2:], 0.01 * v[:2]], 1).contiguous()
    lams = torch.tensor([0.1, 0.5, 2.0], device=dev, dtype=torch.float64)
    xs = lams.to(dtype)
    hp = packing.num_tiles(h, block) * block
    inv_d = ref.interp_diag_inverses(theta, xs, h, block)
    for per_lam in (False, True):
        gi = torch.randn(2, *((3,) if per_lam else ()), h, nrhs,
                         generator=gen, device=dev, dtype=dtype)
        reset_launches()
        got = poly_interp.interp_solve(theta, lams, gi, h, block,
                                       rhs_per_lam=per_lam)
        torch.cuda.synchronize()
        assert LAUNCHES["interp_solve"] == 1
        if scratch:
            assert not _build.PLANS["interp_solve"]["inv_in_smem"]
        gp = torch.nn.functional.pad(gi, (0, 0, 0, hp - h))
        want = ref.interp_solve(theta, xs, inv_d, gp, h, block)[:, :, :h]
        assert smoke.errors(got, want)[1] <= tol


@pytest.mark.parametrize("block", [16, 64])
def test_drivers_match_reference_backend(dev, block):
    from repro_torch.core import cv
    data = np.load(ROOT / "tests" / "data" / "torch_table4.npz")
    folds = cv.make_folds(data["x"], data["y"], int(data["k"]), device=dev)
    lams = torch.as_tensor(data["lams"], device=dev)
    for run in (lambda bk: cv.cv_picholesky(folds, lams, block=block,
                                            backend=bk, device=dev),
                lambda bk: cv.CVEngine("exact", backend=bk, block=block,
                                       device=dev).run(folds, lams)):
        got, want = run("cuda"), run("reference")
        assert int(np.argmin(got.errors)) == int(np.argmin(want.errors))
        np.testing.assert_allclose(got.errors, want.errors, rtol=1e-8)


PACKED_CASES = {"f64": (torch.float64, None), "f32": (torch.float32, None),
                "bf16_factor": (torch.bfloat16, torch.bfloat16),
                "f32_factor_bf16": (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("case", list(PACKED_CASES))
@pytest.mark.parametrize("h", [40, 200, 999])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_packed_trsm_matches_plain_version(dev, smoke, block, h, case):
    """The packed trsm (the cluster solve with the packed tile source)
    against its plain version: three factors, 1 and 17 right-hand-side
    columns, the forward, the transposed and both sweeps, one launch each;
    float64 and float32 within smoke.TOL (another order of sums), and bf16
    products on bf16 and on float32 factors within
    ``chip_smoke.MIXED_TOL`` with the ratio of the errors of kernel and
    plain against the float64 solve within ``chip_smoke.ERROR_RATIO``."""
    from repro_torch.core import packing
    from repro_torch.kernels import (LAUNCHES, packed_trsm, ref,
                                     reset_launches)
    dtype, cd = PACKED_CASES[case]
    mixed = cd is not None
    gen = torch.Generator(device=dev).manual_seed(h + block)
    x = torch.randn(3, 2 * h, h, generator=gen, device=dev,
                    dtype=torch.float64)
    l = torch.linalg.cholesky(x.mT @ x / h + torch.eye(
        h, device=dev, dtype=torch.float64))
    vec = packing.pack_tril(l, block).to(dtype).contiguous()
    state = torch.float32 if mixed else dtype
    name = "solve_lower_packed_bf16" if mixed else "solve_lower_packed"
    for nrhs in (1, 17):
        g = torch.randn(3, h, nrhs, generator=gen, device=dev, dtype=state)
        for sweeps in (1, 2, 3):
            reset_launches()
            if sweeps == 3:
                got = packed_trsm.solve_packed(vec, g, h, block,
                                               compute_dtype=cd)
                want = ref.solve_packed(vec, g, h, block, cd)
                exact = ref.solve_packed(vec.double(), g.double(), h, block)
            else:
                tr = sweeps == 2
                got = packed_trsm.solve_lower_packed(
                    vec, g, h, block, transpose=tr, compute_dtype=cd)
                want = ref.solve_lower_packed(vec, g, h, block, transpose=tr,
                                              compute_dtype=cd)
                exact = ref.solve_lower_packed(vec.double(), g.double(), h,
                                               block, transpose=tr)
            torch.cuda.synchronize()
            assert {k: n for k, n in LAUNCHES.items() if n} == {name: 1}
            assert got.dtype == state and got.shape == g.shape
            err = smoke.errors(got, want)[1]
            if not mixed:
                assert err <= smoke.TOL[dtype], (nrhs, sweeps, err)
                continue
            ratio = (smoke.errors(got.double(), exact)[1]
                     / smoke.errors(want.double(), exact)[1])
            assert err <= smoke.MIXED_TOL[name], (nrhs, sweeps, err)
            assert smoke.ERROR_RATIO[0] <= ratio <= smoke.ERROR_RATIO[1], \
                (nrhs, sweeps, ratio)


@pytest.mark.parametrize("h", [40, 200, 999])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_interp_factors_bf16_bit_exact(dev, block, h):
    """interp_factors on a bf16 Θ equals its plain version bit for bit
    (both round every Horner step to bf16); h = 999 writes one element a
    thread, the others 16 bytes; one launch, counted apart."""
    from repro_torch.core import packing
    from repro_torch.kernels import (LAUNCHES, poly_interp, ref,
                                     reset_launches)
    gen = torch.Generator(device=dev).manual_seed(h * block)
    p = packing.packed_size(h, block)
    theta = (torch.randn(2, 3, p, generator=gen, device=dev)
             * torch.tensor([1.0, 0.1, 0.01], device=dev)[:, None]
             ).to(torch.bfloat16)
    lams = torch.logspace(-3, 1, 11, dtype=torch.float64, device=dev)
    center = torch.tensor(0.37, device=dev)
    reset_launches()
    got = poly_interp.interp_factors(theta, lams, h, block, center=center)
    torch.cuda.synchronize()
    assert {k: n for k, n in LAUNCHES.items() if n} == {
        "interp_factors_bf16": 1}
    x = lams.to(torch.bfloat16) - center.to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 11, h, h)
    assert torch.equal(got, ref.interp_factors(theta, x, h, block))


def test_gauss_newton_head_under_bf16_store_runs_the_mixed_kernels(dev):
    """Under ``bf16_store`` the Gauss–Newton head stores Θ in bf16 and a
    step launches interp_factors on it (bf16 factors) and the mixed dense
    trsm twice; the steps match the same head on the reference backend
    under the policy within the JAX package's bound for a bf16 solve
    (5e-2 of the norm)."""
    from repro_torch.core import backends, cv
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.optim import damped_gauss_newton_head
    data = np.load(ROOT / "tests" / "data" / "torch_table4.npz")
    folds = cv.make_folds(data["x"], data["y"], int(data["k"]), device=dev)
    deltas = {}
    for name in ("cuda", "reference"):
        bk = backends.resolve_backend(name, block=32, precision="bf16_store")
        state, step = damped_gauss_newton_head(folds.hess, (1e-2, 1e1),
                                               block=32, backend=bk)
        assert state.model.theta.dtype == torch.bfloat16
        out = []
        for lam in (0.05, 2.0):
            reset_launches()
            delta, state = step(state, folds.grad, lam)
            torch.cuda.synchronize()
            if name == "cuda":
                assert {k: n for k, n in LAUNCHES.items() if n} == dict(
                    interp_factors_bf16=1, solve_lower_blocked_bf16=2)
            out.append(delta)
        deltas[name] = torch.stack(out)
    d, r = deltas["cuda"], deltas["reference"]
    assert d.dtype == torch.float32
    assert float(((d - r).norm(dim=-1) / r.norm(dim=-1)).max()) <= 5e-2


@pytest.mark.parametrize("h, block", [(40, 16), (200, 64), (1000, 128)])
def test_launch_counts_are_kernel_launches(dev, h, block):
    """A Cholesky call counts each of its 3·nt − 2 launches; the other
    wrappers launch one kernel per call."""
    from repro_torch.core import packing
    from repro_torch.kernels import (LAUNCHES, chol_blocked, reset_launches,
                                     tri_pack)
    nt = packing.num_tiles(h, block)
    a = torch.eye(h, dtype=torch.float64, device=dev).expand(3, h, h) * 2
    reset_launches()
    l = chol_blocked.cholesky_blocked(a.contiguous(), block)
    tri_pack.pack_tril(l, block)
    torch.cuda.synchronize()
    # every other counter (the backward kernels' too) stays at 0
    assert {k: n for k, n in LAUNCHES.items() if n} == dict(
        cholesky_blocked=3 * nt - 2, pack_tril=1)


@pytest.mark.parametrize("h, block", [(40, 16), (200, 64), (1000, 128)])
def test_factor_route_kernels_launch_once_per_call(dev, h, block):
    """unpack, interp_factors and a packed solve (both sweeps) launch one
    kernel per call."""
    from repro_torch.core import packing
    from repro_torch.kernels import (LAUNCHES, packed_trsm, poly_interp,
                                     reset_launches, tri_pack)
    eye = torch.eye(h, dtype=torch.float64, device=dev).expand(3, h, h)
    vec = packing.pack_tril(eye * 2, block).contiguous()
    theta = torch.stack([vec, vec * 0, vec * 0], dim=1).contiguous()
    lams = torch.logspace(-3, 0, 9, dtype=torch.float64, device=dev)
    g = torch.ones(3, h, dtype=torch.float64, device=dev)
    reset_launches()
    dense = tri_pack.unpack_tril(vec, h, block)
    factors = poly_interp.interp_factors(theta, lams, h, block)
    theta_sol = packed_trsm.solve_packed(vec, g, h, block)
    torch.cuda.synchronize()
    assert {k: n for k, n in LAUNCHES.items() if n} == dict(
        unpack_tril=1, interp_factors=1, solve_lower_packed=1)
    torch.testing.assert_close(dense, eye * 2, rtol=0, atol=0)
    torch.testing.assert_close(factors, (eye * 2)[:, None].expand(
        3, 9, h, h), rtol=0, atol=0)
    torch.testing.assert_close(theta_sol, g / 4, rtol=1e-15, atol=0)


@pytest.mark.parametrize("block", [32, 64])
def test_host_drivers_packed_solve_and_gauss_newton_match_reference(
        dev, block):
    from repro_torch.core import cv, cv_host, picholesky, solvers
    from repro_torch.optim import damped_gauss_newton_head
    data = np.load(ROOT / "tests" / "data" / "torch_table4.npz")
    folds = cv.make_folds(data["x"], data["y"], int(data["k"]), device=dev)
    lams = torch.as_tensor(data["lams"], device=dev)
    for run in (lambda bk: cv_host.host_cv_picholesky(
                    folds, lams, block=block, backend=bk),
                lambda bk: cv_host.host_cv_exact_cholesky(
                    folds, lams, backend=bk),
                lambda bk: cv_host.host_cv_pinrmse(folds, lams, backend=bk)):
        got, want = run("cuda"), run("reference")
        assert int(np.argmin(got.errors)) == int(np.argmin(want.errors))
        np.testing.assert_allclose(got.errors, want.errors, rtol=1e-8)
    h_tr = folds.hess - folds.fold_hess[0]
    g_tr = folds.grad - folds.fold_grad[0]
    sample = picholesky.choose_sample_lambdas(1e-3, 1e2, 4, device=dev)
    model = picholesky.fit(h_tr, sample, 2, block=block, backend="cuda")
    pf = model.eval_packed_factor(lams)
    packed = solvers.solve_packed(pf, g_tr, backend="cuda")
    for want in (solvers.solve_packed(pf, g_tr, backend="reference"),
                 model.solve(lams, g_tr, backend="cuda")):
        assert float((packed - want).abs().max()) <= \
            1e-10 * float(want.abs().max())
    steps = []
    for backend in ("cuda", "reference"):
        state, step = damped_gauss_newton_head(
            folds.hess, (1e-2, 1e1), block=block, backend=backend)
        deltas = []
        for lam in (0.05, 2.0, 1e4):
            delta, state = step(state, folds.grad, lam)
            deltas.append(delta)
        steps.append(torch.stack(deltas))
        assert float(state.lam) == 10.0
    assert float((steps[0] - steps[1]).abs().max()) <= \
        1e-8 * float(steps[1].abs().max())


@pytest.mark.parametrize("b, s, di, n", [
    (1, 37, 20, 8), (2, 100, 130, 16), (1, 65, 64, 32), (3, 1, 8, 5),
    (2, 0, 16, 16)])
def test_ssm_scan_kernel_matches_plain_version(dev, b, s, di, n):
    from repro_torch.kernels import LAUNCHES, ref, reset_launches, ssm_scan
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + s)
    xc, dt = (torch.randn(b, s, di, generator=gen, device=dev)
              for _ in range(2))
    dt = torch.nn.functional.softplus(dt)
    bm, cm = (torch.randn(b, s, n, generator=gen, device=dev)
              for _ in range(2))
    a = -torch.exp(0.3 * torch.randn(di, n, generator=gen, device=dev))
    d = torch.randn(di, generator=gen, device=dev)
    reset_launches()
    y, h = ssm_scan.ssm_scan(xc, dt, bm, cm, a, d)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan"] == 1
    y_p, h_p = ref.ssm_scan(xc, dt, bm, cm, a, d)
    assert y.shape == y_p.shape and h.shape == h_p.shape
    for got, want in ((y, y_p), (h, h_p)):
        assert torch.isfinite(got).all()
        if want.numel():                     # S = 0: y is empty, h zero
            assert float((got - want).abs().max()) <= \
                1e-4 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("di", [20, 130, 8100])
@pytest.mark.parametrize("s", [0, 1, 37, 100])
def test_mamba_scan_kernel_matches_plain_version(dev, smoke, s, di, n,
                                                 dtype):
    """The fused scan (softplus, scan, gate; B and C read in place from an
    x_proj output) against ref.mamba_scan, S = 1 from a state (the decode
    step), one launch.  Limits (chip_smoke.check_mamba_scan): float32 y and
    h_last 1e-4 of max |plain|, the order of float32 sums; bf16 y per
    element 2^-6·|plain| + 1e-4·max|plain|: y and silu(z) each rounded to
    bf16, either of which can land on the other neighbour (2^-7 of the
    value), then the product rounded (one more step), after float32 values
    that differ by the float32 limit (near y = 0 even in sign)."""
    from repro_torch.kernels import LAUNCHES, reset_launches, ssm_scan
    ins = smoke.mixer_inputs(dev, 2, s, di, n, dtype, h0=s == 1)
    reset_launches()
    ssm_scan.mamba_scan(*ins)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan"] == 1
    res = smoke.check_mamba_scan(dev, (2, s, di, n), dtype, h0=s == 1)
    assert res["ok"], res["err"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape, state, offset", [
    ((3, 1, 8192), True, 0), ((2, 2, 8192), True, 0), ((2, 37, 20), True, 0),
    ((2, 70, 130), False, 0), ((1, 33, 8100), True, 0), ((2, 0, 64), True, 0),
    ((1, 300, 8200), True, 0), ((2, 530, 520), True, 1)],
    ids=["decode", "short", "ragged20", "ragged130", "ragged8100", "empty",
         "tile_edges", "misaligned"])
def test_causal_conv1d_kernel_matches_plain_version(dev, smoke, shape, state,
                                                    offset, dtype):
    """The fused convolution, bias and silu equal ref.causal_conv1d_silu bit
    for bit (output and new state): the same float32 products and sums in
    the same order, rounded to the activation dtype where torch rounds, silu
    by the math library's expf and an IEEE division as torch's kernel.  S = 1
    and S < K - 1 from a state, channels that are not a multiple of 8, the
    tile edges (S not a multiple of a slot's rows, a segment boundary inside
    a row, C not a multiple of a channel tile) and a base off by one element
    (the generic variant); the same bits on two calls, one launch each."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    res = smoke.check_conv(dev, shape, dtype, state, offset=offset)
    torch.cuda.synchronize()
    assert LAUNCHES["causal_conv1d"] == 2      # the plain version adds none
    assert res["bit_exact"] and res["bitwise_twice"], res

@pytest.mark.parametrize("scan", ["cuda", "reference"])
def test_bf16_decode_reproduces_forward(dev, smoke, scan):
    """Falcon-Mamba-7B's widths, 2 bf16 layers: prefill then decode steps of
    4 rows give the logits that one forward over the extended sequences
    gives at those positions, bit for bit.  Each decode product runs on at
    least blocks._MIN_ROWS rows, where cuBLAS sums as it does for the
    forward's rows; the conv and scan kernels (or their plain versions) and
    RMSNorm compute each row alone."""
    from repro_torch.models import Model
    cfg = smoke.mamba_config(2, "bfloat16")
    gen = torch.Generator(device=dev).manual_seed(5)
    model = Model(cfg, device=dev, generator=gen, scan=scan)
    prompts = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                            device=dev)
    logits, cache = model.prefill(prompts)
    toks, got = [logits[:, -1].argmax(-1, keepdim=True)], [logits]
    for _ in range(4):
        step, cache = model.decode(cache, toks[-1])
        got.append(step)
        toks.append(step[:, -1].argmax(-1, keepdim=True))
    want = model(torch.cat([prompts, *toks[:-1]], 1))[0][:, 511:]
    assert torch.equal(torch.cat(got, 1), want)


def test_reduced_mamba_matches_jax_fixture(dev, smoke):
    """The reduced model's forward, prefill and decode on the kernel
    reproduce the JAX outputs of tests/data/torch_mamba.npz (1e-4)."""
    out = smoke.phase_mamba_fixture(dev)
    assert all(r["ok"] for r in out.values()), out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape, h0", [
    ((2, 1, 20, 4), True), ((2, 37, 130, 8), True), ((1, 100, 8100, 16),
                                                      False),
    ((2, 9, 64, 32), True), ((3, 17, 70, 3), False), ((2, 0, 64, 16), True)],
    ids=["decode", "ragged130", "ragged8100", "n32", "n3", "empty"])
def test_mamba_scan_bwd_kernel_matches_plain_version(dev, smoke, shape, h0,
                                                     dtype):
    """The backward of the fused scan (kernel A) against
    ref.mamba_scan_bwd, every gradient (chip_smoke.check_mamba_scan_bwd:
    float32 1e-4 of max |plain|; bf16 dxc, dz per element as the forward's
    y, the float32 gradients 2^-8 of max |plain|), on the forward's segment
    states and on its own walk, each the same bits on two calls and the two
    modes the same bits; two launches a call (the backward pass and the
    fixed-order sum), two calls a mode."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    res = smoke.check_mamba_scan_bwd(dev, shape, dtype, h0=h0)
    torch.cuda.synchronize()
    assert LAUNCHES["mamba_scan_bwd"] == 4
    assert LAUNCHES["mamba_scan_bwd_ckpt"] == 4
    assert res["ok"], res


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape, state, offset", [
    ((3, 1, 8192), True, 0), ((2, 2, 8192), True, 0), ((2, 37, 20), True, 0),
    ((2, 70, 130), False, 0), ((1, 130, 8100), True, 0),
    ((2, 0, 64), True, 0), ((1, 300, 8200), True, 0),
    ((2, 530, 520), True, 1)],
    ids=["decode", "short", "ragged20", "ragged130", "ragged8100", "empty",
         "tile_edges", "misaligned"])
def test_causal_conv1d_bwd_kernel_matches_plain_version(dev, smoke, shape,
                                                        state, offset, dtype):
    """The convolution's backward (kernel B): dx and dstate bit for bit,
    dw and db within 1e-5 of max |plain| (float32 sums over (B, S) in
    another order), the same bits on two calls; the tile edges and a
    misaligned base as for the forward."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    res = smoke.check_conv_bwd(dev, shape, dtype, state, offset=offset)
    torch.cuda.synchronize()
    assert LAUNCHES["causal_conv1d_bwd"] == 4
    assert res["ok"], res


def test_training_on_the_card(dev, smoke):
    """The reduced model's loss and gradients on the kernels reproduce
    JAX's (tests/data/torch_mamba_train.npz, 1e-4), one AdamW update on
    JAX's gradients JAX's parameters (1e-6); ssm_scan refuses a gradient on
    the card."""
    from repro_torch.kernels import ssm_scan
    res = smoke.train_fixture(dev, "cuda")
    assert res["ok"], res
    ins = [t.requires_grad_() for t in smoke.scan_inputs(dev, 1, 4, 64, 16)]
    with pytest.raises(NotImplementedError, match="mamba_scan"):
        ssm_scan.ssm_scan(*ins)


@pytest.fixture(scope="module")
def t4_folds(dev):
    """The Table-4 fixture's folds (h=144) and grid on the card."""
    from repro_torch.core import cv
    data = np.load(ROOT / "tests" / "data" / "torch_table4.npz")
    folds = cv.make_folds(data["x"], data["y"], int(data["k"]), device=dev)
    return folds, torch.as_tensor(data["lams"], device=dev)


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("name", ["picholesky_warmstart", "pinrmse", "mchol",
                                  "svd_full", "svd_randomized", "low_rank"])
def test_new_strategies_match_reference_backend(dev, t4_folds, name, block):
    """Each of the paper's other algorithms on the cuda backend against the
    reference backend on the card: the same λ* (MChol: the same visited
    λs), curves within 1e-8 (warm-start within its CPU test's 1e-9); the
    Cholesky paths launch only the port's kernels; the SVD paths and low
    rank none."""
    from repro_torch.core import backends, cv, engine
    from repro_torch.kernels import LAUNCHES, reset_launches
    folds, lams = t4_folds
    omega = torch.randn(folds.x_folds.shape[-1], 30,
                        generator=torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.float64, device=dev)
    runs = {
        "picholesky_warmstart": lambda bk: cv.cv_picholesky_warmstart(
            folds, lams, block=block, backend=bk, device=dev),
        "pinrmse": lambda bk: cv.cv_pinrmse(folds, lams, backend=bk,
                                            device=dev),
        "mchol": lambda bk: cv.cv_multilevel_cholesky(
            folds, -1.5, 1.5, 0.01, backend=bk, device=dev),
        "svd_full": lambda bk: cv.cv_svd(folds, lams, backend=bk,
                                         device=dev),
        "svd_randomized": lambda bk: cv.cv_svd(
            folds, lams, "randomized", 20, omega, backend=bk, device=dev),
        "low_rank": lambda bk: engine.CVEngine(
            "low_rank", backend=bk, block=block, device=dev).run(folds,
                                                                 lams),
    }
    kernels = {"picholesky_warmstart": {"cholesky_blocked", "pack_tril",
                                        "interp_solve"},
               "pinrmse": {"cholesky_blocked", "solve_lower_blocked"},
               "mchol": {"cholesky_blocked", "solve_lower_blocked"}}
    reset_launches()
    got = runs[name](backends.resolve_backend("cuda", block=block))
    torch.cuda.synchronize()
    assert {k for k, n in LAUNCHES.items() if n} == kernels.get(name, set())
    want = runs[name]("reference")
    np.testing.assert_array_equal(got.lams, want.lams)
    np.testing.assert_allclose(got.errors, want.errors,
                               rtol=1e-9 if name == "picholesky_warmstart"
                               else 1e-8)
    assert got.best_lam == want.best_lam
    assert got.n_exact_chol == want.n_exact_chol
    if name == "mchol":
        assert got.extras["visited_lams"] == want.extras["visited_lams"]


def test_select_interpolant_and_ridge_cv_on_the_card(dev, t4_folds):
    """select_interpolant on anchors factored and packed by the kernels:
    the same degree and scores as on the CPU within 1e-9 or their float64
    resolution eps·max_s cond(V_sᵀV_s) (tests/test_torch_select.py gives
    the reason); RidgeCV's λ* that of cv_picholesky, its θ within 1e-8 of
    the reference backend's."""
    from repro_torch.core import backends, cv, picholesky
    from repro_torch.core.ridge_cv import RidgeCV
    folds, lams = t4_folds
    bk = backends.CudaBackend(32, 32)
    sample = picholesky.choose_sample_lambdas(lams[0], lams[-1], 5,
                                              device=dev)
    h = folds.hess.shape[-1]
    eye = torch.eye(h, dtype=torch.float64, device=dev)
    targets = bk.pack_tril(bk.cholesky(
        (folds.hess[None] - folds.fold_hess)[:, None]
        + sample[:, None, None] * eye), 32)
    got = picholesky.select_interpolant(targets, sample, backend=bk)
    cpu = picholesky.select_interpolant(targets.cpu(), sample.cpu())
    assert got["degree"] == cpu["degree"]
    lam = sample.cpu().numpy()
    eps = float(np.finfo(np.float64).eps)
    for key, s in cpu["scores"].items():
        basis, r = key.split("/r")
        v = (lam[:, None] - (lam.mean() if basis == "centered" else 0.0)
             ) ** np.arange(int(r) + 1)
        floor = eps * max(np.linalg.cond(np.delete(v, i, 0).T
                                         @ np.delete(v, i, 0))
                          for i in range(lam.size))
        assert abs(got["scores"][key] - s) <= max(1e-9 * s, floor), key
    x = folds.x_folds.reshape(-1, h)
    y = folds.y_folds.reshape(-1)
    ridge = {b: RidgeCV(k_folds=folds.x_folds.shape[0], n_lambdas=9,
                        lam_lo=1e-3, lam_hi=10.0, block=32, backend=b,
                        device=dev) for b in ("cuda", "reference")}
    theta, res = ridge["cuda"].fit_theta(x, y)
    pi = cv.cv_picholesky(cv.make_folds(x, y, folds.x_folds.shape[0],
                                        device=dev),
                          ridge["cuda"].lambdas(), block=32, backend="cuda",
                          device=dev)
    assert res.best_lam == pi.best_lam
    theta_ref, res_ref = ridge["reference"].fit_theta(x, y)
    assert res_ref.best_lam == res.best_lam
    torch.testing.assert_close(theta, theta_ref, rtol=1e-8, atol=1e-12)


def test_ops_run_the_kernels_and_refuse_ref_on_the_card(dev, monkeypatch):
    """kernels.ops on CUDA tensors launches the kernels and agrees with the
    plain versions on the CPU; with REPRO_KERNELS=ref it raises rather than
    run a plain version on the card."""
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    h, block = 200, 64
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 300, h))
    hess = torch.from_numpy(np.einsum("kni,knj->kij", a, a)).to(dev)
    g = torch.from_numpy(rng.standard_normal((2, h))).to(dev)
    monkeypatch.delenv("REPRO_KERNELS", raising=False)
    reset_launches()
    l = ops.cholesky(hess, block)
    vec = ops.pack_tril(l, block)
    sol = ops.solve_packed(vec, g, h, block)
    sweep = ops.solve_factor_sweep(l, g[0], block)
    torch.cuda.synchronize()
    assert LAUNCHES["pack_tril"] == 1 and LAUNCHES["solve_lower_packed"] == 1
    assert LAUNCHES["solve_lower_blocked"] == 2
    assert LAUNCHES["cholesky_blocked"] > 0
    for got, want in ((sol, ops.solve_packed(vec.cpu(), g.cpu(), h, block)),
                      (sweep, ops.solve_factor_sweep(l.cpu(), g[0].cpu(),
                                                     block))):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-9, atol=1e-12)
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    for call in (lambda: ops.cholesky(hess, block),
                 lambda: ops.pack_tril(l, block),
                 lambda: ops.solve_packed(vec, g, h, block),
                 lambda: ops.solve_lower(l, g, block)):
        with pytest.raises(RuntimeError, match="REPRO_KERNELS=ref"):
            call()
    # on the CPU the switch is what it was: the plain versions
    torch.testing.assert_close(ops.pack_tril(l.cpu(), block), vec.cpu(),
                               rtol=0, atol=0)


def _regression_folds(dev, seed, h=96, n=2048, k=4):
    from repro_torch.serving.traffic import regression_folds
    return regression_folds(h=h, n=n, k=k, seed=seed, device=dev)


def test_countsketch_gives_the_same_bits_twice(dev):
    """The count sketch reduces in a fixed order on the card (no
    scatter-add atomics): two runs of the sketched sweep give the same
    bits, and its gram equals the CPU's up to the gram product."""
    from repro_torch.core import engine, sketch
    folds = _regression_folds(dev, 1)
    lams = torch.logspace(-3, 0, 17, dtype=torch.float64, device=dev)
    plan = sketch.SketchPlan(method="countsketch", m=1024, seed=2)
    runs = [engine.CVEngine("picholesky", block=32, sketch=plan,
                            device=dev).run(folds, lams) for _ in range(2)]
    np.testing.assert_array_equal(runs[0].errors, runs[1].errors)
    x = folds.x_folds[1:].reshape(-1, folds.x_folds.shape[-1])
    draws = sketch.draw_sketch(plan, x.shape[0], 0, dtype=x.dtype,
                               device=dev)
    rows = [sketch.sketch_rows(plan, x, draws) for _ in range(2)]
    assert torch.equal(rows[0], rows[1])
    cpu = sketch.sketch_rows(plan, x.cpu(), {n: d.cpu()
                                             for n, d in draws.items()})
    assert torch.equal(rows[0].cpu(), cpu)


def test_run_batch_equals_solo_runs_bit_for_bit(dev):
    """Stacking cold problems' folds into one fold_state call changes no
    bit of any problem's curve on the kernels (the Θ product runs per
    fold)."""
    from repro_torch.core import engine, factor_cache
    problems = [_regression_folds(dev, s) for s in (1, 2, 3)]
    lams = torch.logspace(-3, 0, 17, dtype=torch.float64, device=dev)

    def eng():
        return engine.CVEngine("picholesky", block=32, device=dev,
                               cache=factor_cache.FactorCache(),
                               cache_anchors=True)

    batched = eng().run_batch([(f, lams) for f in problems])
    assert [r.extras["engine"]["cache"]["status"] for r in batched] == \
        ["miss"] * 3
    for r, f in zip(batched, problems):
        np.testing.assert_array_equal(r.errors, eng().run(f, lams).errors)


def test_pipelined_sweep_equals_serial_bit_for_bit(dev):
    """sweep_async without host syncs (one chunk of look-ahead, the chunk
    read behind an event) against the serial order, cold and warm."""
    from repro_torch.core import engine, factor_cache
    folds = _regression_folds(dev, 4, h=256, n=4096)
    lams = torch.logspace(-3, 0, 31, dtype=torch.float64, device=dev)
    cache = factor_cache.FactorCache()
    for _ in ("cold", "warm"):
        eng = engine.CVEngine("picholesky", block=64, lam_chunk=3,
                              device=dev, cache=cache)
        pipe = list(eng.sweep_async(folds, lams, pipelined=True))
        serial = list(eng.sweep_async(folds, lams, pipelined=False))
        assert len(pipe) == 11
        for a, b in zip(pipe, serial):
            np.testing.assert_array_equal(a.fold_errors, b.fold_errors)
    assert cache.hits >= 2


@pytest.mark.parametrize("k, n_f, h", [(5, 37, 64), (5, 819, 1024),
                                       (3, 1000, 512)])
def test_holdout_scores_do_not_depend_on_the_batch_on_the_card(dev, k, n_f,
                                                                h):
    """``folds.holdout_nrmse`` on CUDA tensors at the engine's score shape
    (θ (k, c, h) against rows (k, 1, n_f, h)): a (fold, λ)'s score is the
    same bits scored beside c − 1 other λs (c = 1, 2, 3, 16) or in any
    contiguous group of folds (a mesh's fold group), and within 1e-12 of
    the CPU's."""
    from repro_torch.core.folds import holdout_nrmse
    gen = np.random.default_rng(7)
    q = 16
    theta = torch.from_numpy(gen.standard_normal((k, q, h)))
    x = torch.from_numpy(gen.standard_normal((k, n_f, h)))
    y = torch.from_numpy(gen.standard_normal((k, n_f)))
    td, xd, yd = theta.to(dev), x[:, None].to(dev), y[:, None].to(dev)
    full = holdout_nrmse(td, xd, yd).cpu()
    for c in (1, 2, 3, 16):
        for s in range(0, q, c):
            part = holdout_nrmse(td[:, s:s + c], xd, yd).cpu()
            assert torch.equal(part, full[:, s:s + c]), (c, s)
    for n in range(1, k):
        for f in range(k - n + 1):
            g = slice(f, f + n)
            part = holdout_nrmse(td[g].clone(), xd[g].clone(),
                                 yd[g].clone()).cpu()
            assert torch.equal(part, full[g]), (f, n)
    cpu = holdout_nrmse(theta, x[:, None], y[:, None])
    torch.testing.assert_close(full, cpu, rtol=1e-12, atol=0)

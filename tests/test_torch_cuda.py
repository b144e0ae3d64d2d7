"""The port's kernels on a CUDA card, at every tile size the port uses.

Each kernel is held against its plain PyTorch version on the card (the
same check ``chip_smoke.py`` makes at the main path's shapes), for blocks
16, 32, 64 and 128, for h below, between and above the blocks, in float64
and float32; then both drivers at blocks 16 and 64 on the kernel backend
against the reference backend.  Skipped without a CUDA device.  On the
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
    assert LAUNCHES == dict(cholesky_blocked=3 * nt - 2, pack_tril=1,
                            solve_lower_blocked=0, interp_solve=0)

"""How the causal convolution's kernels cut their work, on the CPU.

On the card ``csrc/causal_conv1d.cu`` runs a block per unit (batch row,
channel tile, :data:`causal_conv1d.SEGMENT` time steps), in the variant
:func:`causal_conv1d.variant` picks from shape, dtype and alignment, and the
backward writes one dw | db partial a unit, summed in their order by a
second launch.  No kernel runs here; what surrounds them is held: the
variant choice, the partials' count against the units and the source's
constants, the wrapper's refusals, and that the plain backward's dw and db
summed per unit in the kernel's order match the whole sums within
``chip_smoke.CONV_BWD_TOL``.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

from repro_torch.kernels import causal_conv1d as tconv  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

K = tconv.WIDTH
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
          / "causal_conv1d.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


@pytest.mark.parametrize("s, c, dtype, offset, want", [
    (2048, 8192, torch.bfloat16, 0, "staged"),      # training and prefill
    (2048, 8192, torch.float32, 0, "staged"),
    (1, 8192, torch.bfloat16, 0, "staged"),         # decode
    (2, 8192, torch.bfloat16, 0, "staged"),         # S < K - 1
    (300, 8200, torch.bfloat16, 0, "staged"),       # C % 256 != 0
    (0, 8192, torch.bfloat16, 0, "generic"),        # S = 0
    (999, 8100, torch.bfloat16, 0, "generic"),      # 16200 bytes a row
    (999, 8100, torch.float32, 0, "staged"),        # 32400 bytes a row
    (37, 130, torch.float32, 0, "generic"),
    (37, 20, torch.bfloat16, 0, "generic"),
    (530, 520, torch.bfloat16, 1, "generic"),       # a base off by 2 bytes
    (530, 520, torch.float32, 1, "generic"),        # off by 4 bytes
    (530, 520, torch.bfloat16, 8, "staged"),        # off by 16 bytes
], ids=["train-bf16", "train-f32", "decode", "short", "c8200", "s0",
        "c8100-bf16", "c8100-f32", "c130", "c20", "off2", "off4", "off16"])
def test_variant_is_a_function_of_shape_dtype_and_alignment(s, c, dtype,
                                                            offset, want):
    """The staged variant wherever the bulk copies can move a row slice:
    S ≥ 1, C · itemsize a multiple of 16 bytes and every base 16-byte
    aligned (an absent state counts as aligned); the generic one
    elsewhere.  The choice reads the tensors' addresses, not their data."""
    x = chip_smoke.offset_view(torch.zeros(1, s, c, dtype=dtype), offset)
    out = chip_smoke.offset_view(torch.zeros(1, s, c, dtype=dtype), offset)
    ptrs = [x.data_ptr(), None, out.data_ptr()]
    assert tconv.variant(s, c, dtype, ptrs) == want
    # one misaligned tensor among aligned ones is enough to refuse
    if want == "staged":
        assert tconv.variant(s, c, dtype, ptrs + [out.data_ptr() + 2]) \
            == "generic"


def _units(bsz: int, s: int) -> list:
    """The kernels' units along time, in the order of their partials:
    (batch row, first step, end step), ``blockIdx.z`` then ``.y``."""
    seg = tconv.SEGMENT
    nseg = max(-(-s // seg), 1)
    return [(b, g * seg, min(s, (g + 1) * seg))
            for b in range(bsz) for g in range(nseg)]


@pytest.mark.parametrize("bsz, s", [(4, 2048), (1, 300), (3, 999), (2, 2),
                                    (2, 1), (2, 0), (1, 256), (1, 257)])
def test_partials_are_one_a_unit(bsz, s):
    """``bwd_parts`` is the backward grid's batch × segments (one segment
    at S = 0), the wrapper's :data:`SEGMENT` is the source's ``kSegment``,
    and the units' segments cover [0, S) of every batch row once."""
    assert tconv.SEGMENT == _constant("kSegment")
    units = _units(bsz, s)
    assert tconv.bwd_parts(bsz, s) == len(units)
    for b in range(bsz):
        steps = [t for bb, s0, s1 in units if bb == b for t in range(s0, s1)]
        assert steps == list(range(s))


def test_channel_tile_is_whole_16_byte_rows():
    """A unit's channel tile is 512 bytes of a row (kConvThreads ×
    kThreadBytes), a whole number of the bulk copies' 16 bytes, so a row
    slice of any C the staged variant takes ends on a 16-byte boundary;
    the ring's rows fit one lane of warp 0 each (float32 slots hold twice
    the rows)."""
    row = _constant("kConvThreads") * _constant("kThreadBytes")
    assert row % 16 == 0
    assert 2 * 2 * _constant("kBwdTileRows") <= 32
    assert 2 * _constant("kTileRows") <= 32


def _bad(case):
    x, w, b = torch.zeros(2, 5, 8), torch.zeros(8, 4), torch.zeros(8)
    dout, state = torch.zeros(2, 5, 8), None
    if case == "dout-shape":
        dout = torch.zeros(2, 6, 8)
    elif case == "dout-dtype":
        dout = dout.to(torch.bfloat16)
    elif case == "k3":
        w = torch.zeros(8, 3)
    elif case == "b-shape":
        b = torch.zeros(9)
    elif case == "state-shape":
        state = torch.zeros(2, 2, 8)
    elif case == "x-2d":
        x, dout = x[0], dout[0]
    elif case == "f64":
        x, dout = x.double(), dout.double()
    return x, w, b, dout, state


@pytest.mark.parametrize("case, exc, match", [
    ("dout-shape", ValueError, "dout must be"),
    ("dout-dtype", ValueError, "dout must be"),
    ("k3", ValueError, "K=4"), ("b-shape", ValueError, "b has"),
    ("state-shape", ValueError, "state has"), ("x-2d", ValueError, "x must"),
    ("f64", TypeError, "float32 or bfloat16"),
])
def test_causal_conv1d_silu_bwd_refuses(case, exc, match):
    """The backward's refusals hold for CPU tensors too, before any
    plain version runs."""
    x, w, b, dout, state = _bad(case)
    with pytest.raises(exc, match=match):
        tconv.causal_conv1d_silu_bwd(x, w, b, dout, state)


@pytest.fixture(scope="module")
def conv_inputs():
    """numpy-seeded inputs of 3 segments a row, ragged at the end."""
    rng = np.random.default_rng(24)
    bsz, s, c = 2, 2 * tconv.SEGMENT + 37, 24
    arr = {"x": rng.standard_normal((bsz, s, c)),
           "w": 0.5 * rng.standard_normal((c, K)),
           "b": 0.1 * rng.standard_normal(c),
           "dout": rng.standard_normal((bsz, s, c)),
           "state": rng.standard_normal((bsz, K - 1, c))}
    return {k: torch.from_numpy(v).float() for k, v in arr.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("state", [True, False], ids=["state", "zeros"])
def test_partials_sum_to_the_whole(conv_inputs, dtype, state):
    """Each unit's dw and db are the plain backward's over its segment
    (the K-1 inputs before it as its state, the sequence's state or zeros
    at the head); summed in the partials' order, as the second launch sums
    them, they match the whole call's within CONV_BWD_TOL of max |plain|.
    Inputs of ``dtype``'s values, the plain version run in float64: in
    float32 the CPU's own sums of these ~1,100 terms differ by up to ~1e-5
    of max |dw| between the orders it picks, so only a wrong cut (a step
    missed, counted twice or given the wrong halo, O(1) apart) shows.
    (The card holds the units' dx rows bit for bit.)"""
    t = {k: v.to(dtype).double() for k, v in conv_inputs.items()}
    x, dout = t["x"], t["dout"]
    st = t["state"] if state else None
    _, dw, db, _ = tref.causal_conv1d_silu_bwd(x, t["w"], t["b"], dout, st)
    xp = torch.cat([st if state else torch.zeros_like(t["state"]), x], 1)
    sum_w = torch.zeros_like(dw)
    sum_b = torch.zeros_like(db)
    for b, s0, s1 in _units(x.shape[0], x.shape[1]):
        halo = xp[b:b + 1, s0:s0 + K - 1]
        part = tref.causal_conv1d_silu_bwd(x[b:b + 1, s0:s1], t["w"], t["b"],
                                           dout[b:b + 1, s0:s1], halo)
        sum_w += part[1]
        sum_b += part[2]
    for got, want in ((sum_w, dw), (sum_b, db)):
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= chip_smoke.CONV_BWD_TOL, rel

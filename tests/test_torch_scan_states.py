"""The fused scan's segment states, on the CPU: the forward keeps the state
at the start of every ``STATE_EVERY``-step segment and the backward takes
them in place of its own walk.

On the card the forward kernel (``csrc/ssm_scan.cu``) writes them and
kernel A (``csrc/ssm_scan_bwd.cu``) reads them; on CPU tensors the wrappers
run the plain versions of :mod:`repro_torch.kernels.ref`, held here: the
plain forward's states are the plain scan's states (bit for bit, and
within the Pallas tests' 1e-4 of the JAX reference scan), the plain
backward gives the same bits with and without them, a wrong shape or dtype
raises, and under remat the model asks for them in the recompute only.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssm_scan as tscan  # noqa: E402
from repro_torch.models import Model  # noqa: E402

EVERY = tref.STATE_EVERY
SCAN_ATOL = 1e-4       # as tests/test_kernels.py holds the Pallas kernel
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(b, s, di, n, dtype, h0, seed=0):
    """mamba_scan's inputs from numpy: dt_lin and dt_bias whose softplus is
    of order 0.05, A = -(1..N), B and C slices of one projection."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(f))

    xc, z = normal(b, s, di).to(dtype), normal(b, s, di).to(dtype)
    dt_lin, dt_bias = normal(b, s, di, scale=0.5), normal(di) - 3.0
    proj = normal(b, s, 3 + 2 * n).to(dtype)
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n).clone()
    state = normal(b, di, n) if h0 else None
    return (xc, dt_lin, dt_bias, proj[..., 3:3 + n], proj[..., 3 + n:], a,
            normal(di), z, state)


@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_forward_states_are_the_scan_states(dtype, h0):
    """ref.mamba_scan(states=True): y and h_last as without them, and the
    state before steps 0, 8, 16, … equal to h_last of the plain scan over
    that prefix, bit for bit (h0 itself at step 0)."""
    b, s, di, n = 2, 29, 6, 4
    ins = _inputs(b, s, di, n, DTYPES[dtype], h0)
    y, h_last, st = tref.mamba_scan(*ins, states=True)
    y2, h_last2 = tref.mamba_scan(*ins)
    assert torch.equal(y, y2) and torch.equal(h_last, h_last2)
    assert st.shape == (b, -(-s // EVERY), di, n) and st.dtype == torch.float32
    for k in range(st.shape[1]):
        t = k * EVERY
        if t == 0:
            want = ins[8] if h0 else torch.zeros(b, di, n)
        else:
            pre = [v[:, :t] for v in ins[:2]] + [ins[2]] \
                + [v[:, :t] for v in ins[3:5]] + list(ins[5:7]) \
                + [ins[7][:, :t], ins[8]]
            want = tref.mamba_scan(*pre)[1]
        assert torch.equal(st[:, k], want), k


def test_plain_forward_states_match_the_jax_scan():
    """The plain forward's states against h_last of the JAX reference scan
    (``repro.kernels.ref.ssm_scan``, zero state) over each prefix."""
    b, s, di, n = 2, 37, 5, 8
    ins = _inputs(b, s, di, n, torch.float32, False, seed=1)
    _, _, st = tref.mamba_scan(*ins, states=True)
    dt = torch.nn.functional.softplus(ins[1] + ins[2]).numpy()
    xc, bm, cm = (ins[i].numpy() for i in (0, 3, 4))
    for k in range(1, st.shape[1]):
        t = k * EVERY
        _, h_j = jref.ssm_scan(*(jnp.asarray(v) for v in (
            xc[:, :t], dt[:, :t], bm[:, :t], cm[:, :t], ins[5].numpy(),
            ins[6].numpy())))
        np.testing.assert_allclose(st[:, k].numpy(), np.asarray(h_j),
                                   atol=SCAN_ATOL)


@pytest.mark.parametrize("s", [1, 8, 37])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_backward_is_the_same_with_and_without_states(dtype, s):
    """The CPU path of mamba_scan_bwd (the plain backward) gives every
    gradient bit for bit with the forward's states as with its own walk,
    from a state and with dh_last; ``mamba_scan(states=True)`` returns the
    plain forward's outputs and records no graph."""
    b, di, n = 2, 6, 4
    ins = _inputs(b, s, di, n, DTYPES[dtype], True, seed=2)
    y, h_last, st = tscan.mamba_scan(
        *[t.requires_grad_() if t.is_floating_point() else t
          for t in ins], states=True)
    assert y.grad_fn is None
    want = tref.mamba_scan(*(t.detach() for t in ins), states=True)
    for got, w in zip((y, h_last, st), want):
        assert torch.equal(got, w)
    ins = [t.detach() for t in ins]
    gen = torch.Generator().manual_seed(3)
    dy = torch.randn(b, s, di, generator=gen).to(DTYPES[dtype])
    dh_last = torch.randn(b, di, n, generator=gen)
    walk = tscan.mamba_scan_bwd(*ins[:8], dy, ins[8], dh_last)
    kept = tscan.mamba_scan_bwd(*ins[:8], dy, ins[8], dh_last, states=st)
    for i, (g, w) in enumerate(zip(kept, walk)):
        assert torch.equal(g, w), i


@pytest.mark.parametrize("bad", ["short", "narrow", "float64", "bfloat16"])
def test_backward_refuses_wrong_states(bad):
    """States of another shape or dtype than (B, ceil(S/8), d_inner, N)
    float32 raise; nothing falls back to the walk."""
    b, s, di, n = 2, 17, 6, 4
    ins = _inputs(b, s, di, n, torch.float32, False, seed=4)
    _, _, st = tref.mamba_scan(*ins, states=True)
    st = {"short": st[:, :-1], "narrow": st[..., :-1],
          "float64": st.double(), "bfloat16": st.bfloat16()}[bad]
    with pytest.raises(ValueError, match="states"):
        tscan.mamba_scan_bwd(*ins[:8], torch.ones(b, s, di), states=st)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_remat_asks_for_states_in_the_recompute_only(monkeypatch, remat):
    """A spy on the plain forward and backward under Model.loss's gradient:
    with remat every layer's first forward keeps no states, its recompute
    keeps them and its backward takes them; without remat no forward keeps
    them and every backward walks.  The gradients are the same bits."""
    cfg = dataclasses.replace(configs.get("falcon-mamba-7b").reduced(),
                              remat=remat)
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 21))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    names = [n for n, p in model.named_parameters()]

    def grads():
        loss, _ = model.loss(batch)
        return torch.autograd.grad(loss, list(model.parameters()))

    plain = grads()
    calls = []
    fwd, bwd = tref.mamba_scan, tref.mamba_scan_bwd

    def spy_fwd(*args, states=False, **kw):
        calls.append(("forward", states))
        return fwd(*args, states=states, **kw)

    def spy_bwd(*args, states=None, **kw):
        calls.append(("backward", states is not None))
        return bwd(*args, states=states, **kw)

    monkeypatch.setattr(tref, "mamba_scan", spy_fwd)
    monkeypatch.setattr(tref, "mamba_scan_bwd", spy_bwd)
    spied = grads()
    layers = cfg.n_layers
    if remat:
        want = [("forward", False)] * layers \
            + [("forward", True), ("backward", True)] * layers
    else:
        want = [("forward", False)] * layers + [("backward", False)] * layers
    assert calls == want
    for name, g, w in zip(names, spied, plain):
        assert torch.equal(g, w), name

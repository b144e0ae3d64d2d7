"""The port's training gradients held against the JAX package, on the CPU.

The configuration is ``falcon-mamba-7b`` reduced (4 layers, d_model 64,
d_inner 128, N 8, float32, no remat).  The JAX side is built once per
module: ``jax.value_and_grad`` of the JAX ``Model.loss`` on its own weights
(``init(PRNGKey(0))``) and a numpy-drawn batch; the port takes the same
weights through ``convert.model_from_numpy``.  The JAX model runs its
recurrence through ``chunked_linear_recurrence`` (associative scan in
chunks of 16, its adjoint the reverse scan of ``_clr_bwd``), the port one
step at a time (``kernels.ref.mamba_scan_bwd`` on CPU tensors), so sums are
taken in other orders: every gradient leaf is held to max |Δ| ≤ 1e-4 ·
max |JAX leaf| (``GRAD_RTOL``), as the forward parity tests hold logits.
The plain backward passes are also held to ``torch.autograd`` through the
plain forward passes in float64, to 1e-12.

``tests/data/torch_mamba_train.npz`` carries JAX's weights, batch, loss,
gradients and the parameters after one AdamW update on those gradients,
so ``chip_smoke.py`` phase ``train`` holds the card to them without
importing JAX; ``test_fixture_is_current`` checks that it still equals
what JAX computes.  Regenerate it with
``PYTHONPATH=src python tests/test_torch_train.py``.
"""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import causal_conv1d as tconv  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import blocks, layers  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_mamba_train.npz"
ARCH = "falcon-mamba-7b"
BATCH, SEQ = 2, 20
GRAD_RTOL = 1e-4       # max |Δ| / max |JAX leaf|, float32, see the docstring
F64_RTOL = 1e-12       # plain backward vs autograd, float64


def _rel(got, want) -> float:
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _t(a) -> "torch.Tensor":
    return torch.from_numpy(np.array(a, copy=True))


def _cfgs():
    return jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()


def jax_train_reference():
    """JAX's weights, batch, loss, gradients, and the parameters after one
    AdamW update (the launcher's defaults) on those gradients."""
    jcfg, _ = _cfgs()
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    grads = jax.tree.map(np.asarray, grads)
    init, update = jadamw()
    new, _ = jax.jit(update)(grads, init(params), params)
    out = {f"param/{k}": np.asarray(v) for k, v in flatten(params)}
    out.update({f"grad/{k}": np.asarray(v) for k, v in flatten(grads)})
    out.update({f"adamw/{k}": np.asarray(v) for k, v in flatten(new)})
    out.update(tokens=batch["tokens"], labels=batch["labels"],
               loss=np.asarray(loss), nll=np.asarray(metrics["nll"]))
    return out, params, grads


@pytest.fixture(scope="module")
def reference():
    return jax_train_reference()


# ---------------------------------------------------------------- rms_norm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_backward_matches_jax(dtype):
    """dx (in x's dtype) and dscale against ``jax.vjp`` of the reference's
    custom-gradient rms_norm.  float32: 1e-5 of max |JAX|; bf16: both sides
    round each elementwise op to bf16 (XLA may fuse a chain and round once),
    so 2^-6 of max |JAX|, a few bf16 steps at the largest value."""
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a, s: jlayers.rms_norm(a, s, 1e-6),
                     jnp.asarray(x, jdt), jnp.asarray(scale))
    dx_j, ds_j = vjp(jnp.asarray(dy, jdt))
    tdt = getattr(torch, dtype)
    xt = _t(x).to(tdt).requires_grad_()
    st = _t(scale).requires_grad_()
    layers.rms_norm(xt, st, 1e-6).backward(_t(dy).to(tdt))
    assert xt.grad.dtype == tdt and st.grad.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    assert _rel(xt.grad, np.asarray(dx_j, np.float32)) <= tol
    assert _rel(st.grad, np.asarray(ds_j, np.float32)) <= tol


# ------------------------------------------------- plain backward passes


def _mixer_inputs(b, s, di, n, dtype, seed, h0):
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype)

    proj = randn(b, s, 3 + 2 * n)
    ins = [randn(b, s, di), 0.5 * randn(b, s, di), randn(di) - 2.0,
           proj, -(torch.rand(di, n, generator=gen, dtype=dtype) + 0.5),
           randn(di), randn(b, s, di), randn(b, di, n) if h0 else None]
    return ins


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_mamba_scan_bwd_matches_autograd_f64(with_h0):
    """ref.mamba_scan_bwd against autograd through ref.mamba_scan, float64,
    S 37 over segments of 8 (ragged), with and without h0 and dh_last."""
    n = 4
    xc, dt_lin, dt_bias, proj, a, d, z, h0 = _mixer_inputs(
        2, 37, 5, n, torch.float64, 3, with_h0)
    leaves = [t.requires_grad_() for t in (xc, dt_lin, dt_bias, proj, a, d,
                                           z, h0) if t is not None]
    bm, cm = proj[..., 3:3 + n], proj[..., 3 + n:]
    y, h_last = tref.mamba_scan(xc, dt_lin, dt_bias, bm, cm, a, d, z, h0)
    gen = torch.Generator().manual_seed(4)
    dy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    dh = torch.randn(h_last.shape, generator=gen, dtype=torch.float64) \
        if with_h0 else None
    obj = (y * dy).sum() + ((h_last * dh).sum() if with_h0 else 0)
    want = dict(zip(["xc", "dt_lin", "dt_bias", "proj", "a", "d", "z", "h0"],
                    torch.autograd.grad(obj, leaves)))
    got = tref.mamba_scan_bwd(*(t.detach() for t in (xc, dt_lin, dt_bias, bm,
                                                     cm, a, d, z)), dy,
                              None if h0 is None else h0.detach(), dh,
                              segment=8)
    names = ["xc", "dt_lin", "dt_bias", "bm", "cm", "a", "d", "z", "h0"]
    want["bm"] = want["proj"][..., 3:3 + n]
    want["cm"] = want["proj"][..., 3 + n:]
    for name, g in zip(names, got):
        if name == "h0" and not with_h0:
            assert g is None
            continue
        assert _rel(g, want[name].numpy()) <= F64_RTOL, name


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_causal_conv1d_silu_bwd_matches_autograd_f64(with_state):
    gen = torch.Generator().manual_seed(5)
    f64 = torch.float64
    x, w, b = (torch.randn(*s, generator=gen, dtype=f64)
               for s in ((2, 9, 6), (6, 4), (6,)))
    st = torch.randn(2, 3, 6, generator=gen, dtype=f64) if with_state \
        else None
    leaves = [t.requires_grad_() for t in (x, w, b, st) if t is not None]
    out, _ = tref.causal_conv1d_silu(x, w, b, st)
    dout = torch.randn(out.shape, generator=gen, dtype=f64)
    want = torch.autograd.grad((out * dout).sum(), leaves)
    got = tref.causal_conv1d_silu_bwd(x.detach(), w.detach(), b.detach(),
                                      dout, None if st is None
                                      else st.detach())
    assert (got[3] is None) == (not with_state)
    for g, v in zip([g for g in got if g is not None], want):
        assert _rel(g, v.numpy()) <= F64_RTOL


def _mixer_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_,
                      cfg.d_conv)
    f = np.float32

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f)

    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), di))
    return {
        "x_proj": normal(di, r + 2 * n, scale=di ** -0.5),
        "dt_proj": normal(r, di, scale=r ** -0.5),
        "dt_bias": (dt + np.log(-np.expm1(-dt))).astype(f),
        "a_log": np.log(np.tile(np.arange(1, n + 1, dtype=f), (di, 1))),
        "d_skip": normal(di),
        "conv_w": normal(di, k, scale=0.5),
        "conv_b": normal(di, scale=0.1),
    }


@pytest.mark.parametrize("s, with_h0", [(24, False), (37, True)],
                         ids=["s24", "s37-h0"])
def test_mixer_core_gradients_match_jax(s, with_h0):
    """The port's _mamba_core (the fused scan on CPU tensors: its plain
    forward, ref.mamba_scan_bwd behind it) against jax.vjp of the JAX
    _mamba_core + y·silu(z): the gradients of xc, z, h0 and the mixer's
    leaves, each within GRAD_RTOL of max |JAX|."""
    jcfg, cfg = _cfgs()
    params = _mixer_params(cfg, seed=8)
    rng = np.random.default_rng(9)
    di, n = cfg.d_inner, cfg.ssm_state
    xc = rng.standard_normal((2, s, di)).astype(np.float32)
    z = rng.standard_normal((2, s, di)).astype(np.float32)
    h0 = rng.standard_normal((2, di, n)).astype(np.float32) if with_h0 \
        else np.zeros((2, di, n), np.float32)
    ct = rng.standard_normal((2, s, di)).astype(np.float32)
    keys = ("x_proj", "dt_proj", "dt_bias", "a_log", "d_skip")

    def jfun(p, xc, z, h0):
        y, _ = jblocks._mamba_core(p, xc, jcfg, h0)
        return y * jax.nn.silu(z)

    jp = {k: jnp.asarray(params[k]) for k in keys}
    _, vjp = jax.vjp(jfun, jp, jnp.asarray(xc), jnp.asarray(z),
                     jnp.asarray(h0))
    g_p, g_xc, g_z, g_h0 = vjp(jnp.asarray(ct))
    tp = {k: _t(params[k]).requires_grad_() for k in keys}
    p = type("P", (), tp)
    txc, tz = _t(xc).requires_grad_(), _t(z).requires_grad_()
    th0 = _t(h0).requires_grad_() if with_h0 else None
    y, _ = blocks._mamba_core(p, txc, tz, cfg, "auto", th0)
    y.backward(_t(ct))
    for k in keys:
        assert _rel(tp[k].grad, g_p[k]) <= GRAD_RTOL, k
    assert _rel(txc.grad, g_xc) <= GRAD_RTOL
    assert _rel(tz.grad, g_z) <= GRAD_RTOL
    if with_h0:
        assert _rel(th0.grad, g_h0) <= GRAD_RTOL


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_conv_gradients_match_jax(with_state):
    """causal_conv1d_silu's backward (ref.causal_conv1d_silu_bwd on CPU
    tensors) against jax.vjp of layers.causal_conv1d + conv_b + silu."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 19, 12)).astype(np.float32)
    w = (0.5 * rng.standard_normal((12, 4))).astype(np.float32)
    b = (0.1 * rng.standard_normal(12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else np.zeros((2, 3, 12), np.float32)
    ct = rng.standard_normal((2, 19, 12)).astype(np.float32)

    def jfun(x, w, b, st):
        y, _ = jlayers.causal_conv1d(x, w, st)
        return jax.nn.silu(y + b)

    _, vjp = jax.vjp(jfun, *(jnp.asarray(v) for v in (x, w, b, st)))
    want = vjp(jnp.asarray(ct))
    leaves = [_t(v).requires_grad_() for v in (x, w, b, st)]
    y, _ = tconv.causal_conv1d_silu(*leaves[:3],
                                    leaves[3] if with_state else None)
    y.backward(_t(ct))
    for i, (t, g) in enumerate(zip(leaves, want)):
        if i == 3 and not with_state:
            assert t.grad is None
            continue
        assert _rel(t.grad, g) <= GRAD_RTOL, i


# ---------------------------------------------------------------- the model


def _port_grads(model, batch):
    loss, metrics = model.loss(batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, metrics, dict(zip(named, grads))


def _stacked(grads: dict, name: str, n_layers: int) -> "torch.Tensor":
    """The port's per-layer gradients of a reference leaf, stacked."""
    head, _, rest = name.partition(".")
    if head != "groups":
        return grads[name]
    return torch.stack([grads[f"groups.{i}.{rest}"]
                        for i in range(n_layers)])


def test_loss_and_every_gradient_match_jax(reference):
    """Model.loss and the gradient of every leaf against
    jax.value_and_grad of the JAX Model.loss, on JAX's weights and batch."""
    data, params, grads = reference
    cfg = _cfgs()[1]
    model = convert.model_from_numpy(cfg, params, device="cpu")
    batch = {"tokens": data["tokens"], "labels": data["labels"]}
    loss, metrics, got = _port_grads(model, batch)
    assert abs(float(loss.detach()) - float(data["loss"])) <= 1e-5 * float(
        data["loss"])
    assert float(metrics["aux"]) == 0.0
    names = [k for k, _ in flatten(grads)]
    assert len(names) == 14        # embed, 2 norms, lm_head, 10 mixer leaves
    for name, want in flatten(grads):
        assert _rel(_stacked(got, name, cfg.n_layers), want) <= GRAD_RTOL, \
            name


def test_remat_gives_the_same_bits(reference):
    """Per-layer remat (torch.utils.checkpoint) recomputes the same forward
    on the CPU: loss and every gradient equal bit for bit."""
    data, params, _ = reference
    cfg = _cfgs()[1]
    batch = {"tokens": data["tokens"], "labels": data["labels"]}
    out = []
    for remat in (False, True):
        m = convert.model_from_numpy(dataclasses.replace(cfg, remat=remat),
                                     params, device="cpu")
        out.append(_port_grads(m, batch))
    assert torch.equal(out[0][0], out[1][0])
    for name in out[0][2]:
        assert torch.equal(out[0][2][name], out[1][2][name]), name


def test_fixture_is_current(reference):
    """tests/data/torch_mamba_train.npz equals what the JAX package
    computes."""
    data, _, _ = reference
    fixture = np.load(FIXTURE)
    assert sorted(fixture.files) == sorted(data)
    for key, want in data.items():
        np.testing.assert_allclose(fixture[key], want, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_port_matches_the_fixture_on_cpu():
    """chip_smoke.py's train fixture check, run on the CPU: the loss and
    every gradient within GRAD_RTOL of JAX's, one AdamW update on JAX's
    gradients within 1e-6 of JAX's parameters."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    res = chip_smoke.train_fixture(torch.device("cpu"), "auto")
    assert res["ok"], res


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    out, _, _ = jax_train_reference()
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")

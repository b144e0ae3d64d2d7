"""The port's Mamba-1 mixer kernels' plain versions held against the JAX
package, on the CPU.

Two kernels carry the mixer between its GEMMs: ``causal_conv1d_silu``
(the depthwise causal convolution, ``+ conv_b`` and ``silu``) and
``mamba_scan`` (softplus of ``dt_lin + dt_bias``, the selective scan from an
optional state, the gate ``y * silu(z)``).  On CPU tensors their wrappers
run the plain versions of :mod:`repro_torch.kernels.ref`; those are held
here to the JAX functions they replace (``layers.causal_conv1d`` + bias +
silu; ``blocks._mamba_core`` + gate; ``blocks.mamba_decode``) on the same
numpy inputs, and to the composition the port ran before they were fused,
bit for bit.  The JAX model scans with ``chunked_linear_recurrence``
(associative, in chunks), the port one step at a time, so the sums differ
in order: max |Δ| ≤ 1e-4 · max |JAX| (``MODEL_RTOL``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest tests/test_torch_mamba_fused.py -q
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.context import MeshCtx  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import causal_conv1d as tconv  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssm_scan as tscan  # noqa: E402
from repro_torch.models import Model, blocks, layers  # noqa: E402

ARCH = "falcon-mamba-7b"
MODEL_RTOL = 1e-4      # max |Δ| / max |JAX|, float32, see the docstring
CONV_RTOL = 1e-6       # the same K products and sums, float32
F = torch.nn.functional


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _t(a) -> "torch.Tensor":
    return torch.from_numpy(np.array(a, copy=True))


def _cfgs():
    return jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()


def _mixer_params(cfg, seed=0):
    """The mixer's leaves under the JAX names, float32 numpy, with
    dt = softplus(dt_bias) of order 0.01-0.1 and A = -(1..N)."""
    rng = np.random.default_rng(seed)
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_,
                      cfg.d_conv)
    f = np.float32

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f)

    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), di))
    return {
        "wx": normal(d, di, scale=d ** -0.5),
        "wz": normal(d, di, scale=d ** -0.5),
        "conv_w": normal(di, k, scale=0.5),
        "conv_b": normal(di, scale=0.1),
        "x_proj": normal(di, r + 2 * n, scale=di ** -0.5),
        "dt_proj": normal(r, di, scale=r ** -0.5),
        "dt_bias": (dt + np.log(-np.expm1(-dt))).astype(f),
        "a_log": np.log(np.tile(np.arange(1, n + 1, dtype=f), (di, 1))),
        "d_skip": normal(di),
        "out_proj": normal(di, d, scale=di ** -0.5),
    }


def _torch_params(params, dtype=torch.float32):
    return types.SimpleNamespace(**{k: _t(v).to(dtype)
                                    for k, v in params.items()})


def _scan_inputs(cfg, params, b, s, seed=1, dtype=torch.float32):
    """xc, z and the inputs mamba_scan takes, as the mixer forms them."""
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, s, cfg.d_inner)).astype(np.float32)
    z = rng.standard_normal((b, s, cfg.d_inner)).astype(np.float32)
    p = _torch_params(params, dtype)
    n, r = cfg.ssm_state, cfg.dt_rank_
    xct = _t(xc).to(dtype)
    proj = xct @ p.x_proj
    dt_r, b_mat, c_mat = torch.split(proj, [r, n, n], dim=-1)
    dt_lin = dt_r.float() @ p.dt_proj.float()
    a = -torch.exp(p.a_log.float())
    return xc, z, (xct, dt_lin, p.dt_bias, b_mat, c_mat, a, p.d_skip,
                   _t(z).to(dtype))


# ---------------------------------------------------------------- mamba_scan


@pytest.mark.parametrize("s, with_h0", [(24, False), (37, False), (1, False),
                                        (24, True), (5, True)],
                         ids=["s24", "s37", "s1", "s24-h0", "s5-h0"])
def test_mamba_scan_matches_jax_mamba_core(s, with_h0):
    """ref.mamba_scan and the port's _mamba_core (both scan choices) against
    JAX _mamba_core + y * silu(z), float32, from zero state and from a
    given one."""
    jcfg, cfg = _cfgs()
    params = _mixer_params(cfg)
    xc, z, ins = _scan_inputs(cfg, params, 2, s)
    rng = np.random.default_rng(2)
    h0 = (rng.standard_normal((2, cfg.d_inner, cfg.ssm_state)).astype(
        np.float32) if with_h0 else
        np.zeros((2, cfg.d_inner, cfg.ssm_state), np.float32))
    y_j, h_j = jblocks._mamba_core({k: jnp.asarray(v) for k, v in
                                    params.items()}, jnp.asarray(xc), jcfg,
                                   jnp.asarray(h0))
    y_j = y_j * jax.nn.silu(jnp.asarray(z))
    h0_t = _t(h0) if with_h0 else None
    got = {"ref": tref.mamba_scan(*ins, h0_t)}
    p = _torch_params(params)
    for scan in ("reference", "auto"):
        got[scan] = blocks._mamba_core(p, _t(xc), _t(z), cfg, scan, h0=h0_t)
    for tag, (y, h) in got.items():
        assert y.dtype == torch.float32 and h.dtype == torch.float32, tag
        assert _rel(y, y_j) <= MODEL_RTOL, tag
        assert _rel(h, h_j) <= MODEL_RTOL, tag


@pytest.mark.parametrize("scan", ["reference", "auto"])
def test_mamba_decode_matches_jax(scan):
    """One decode step of one layer (the conv from the cache's tail, then
    mamba_scan from the cache's state) against JAX mamba_decode: output and
    the new cache; the old cache is not written."""
    jcfg, cfg = _cfgs()
    params = _mixer_params(cfg, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    cache = {"conv": rng.standard_normal(
                 (2, cfg.d_conv - 1, cfg.d_inner)).astype(np.float32),
             "h": rng.standard_normal(
                 (2, cfg.d_inner, cfg.ssm_state)).astype(np.float32)}
    out_j, cache_j = jblocks.mamba_decode(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, jcfg, MeshCtx(None))
    tcache = {k: _t(v) for k, v in cache.items()}
    out, new = blocks.mamba_decode(_torch_params(params), _t(x), tcache, cfg,
                                   scan)
    assert _rel(out, out_j) <= MODEL_RTOL
    assert _rel(new["h"], cache_j["h"]) <= MODEL_RTOL
    np.testing.assert_array_equal(new["conv"].numpy(),
                                  np.asarray(cache_j["conv"]))
    for k, v in cache.items():
        np.testing.assert_array_equal(tcache[k].numpy(), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [0, 1, 19])
def test_mamba_scan_equals_the_unfused_composition(dtype, s):
    """At h0 = None, ref.mamba_scan is bit for bit what the mixer computed
    before the fusion: softplus(dt_lin + dt_bias) -> ref.ssm_scan -> cast to
    the activation dtype -> * silu(z)."""
    _, cfg = _cfgs()
    params = _mixer_params(cfg, seed=5)
    _, _, ins = _scan_inputs(cfg, params, 3, s, seed=6, dtype=dtype)
    xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z = ins
    dt = F.softplus(dt_lin + dt_bias.float())
    y_old, h_old = tref.ssm_scan(xc, dt, b_mat, c_mat, a, d_skip)
    y_old = y_old.to(dtype) * F.silu(z)
    for fn in (tref.mamba_scan, tscan.mamba_scan):
        y, h = fn(*ins)
        assert y.dtype == dtype and h.dtype == torch.float32
        assert torch.equal(y, y_old) and torch.equal(h, h_old)


def test_mamba_scan_from_a_state_continues_the_sequence():
    """Scanning S steps, then T more from the state it ended in, is the
    scan of S + T steps (float32, the same step order)."""
    _, cfg = _cfgs()
    params = _mixer_params(cfg, seed=7)
    _, _, ins = _scan_inputs(cfg, params, 2, 12, seed=8)
    y, h = tref.mamba_scan(*ins)
    head = [t[:, :7] if t.ndim == 3 else t for t in ins]
    tail = [t[:, 7:] if t.ndim == 3 else t for t in ins]
    y1, h1 = tref.mamba_scan(*head)
    y2, h2 = tref.mamba_scan(*tail, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)


# ---------------------------------------------------------------- conv


@pytest.mark.parametrize("s", [1, 2, 9], ids=["s1", "s2-short", "s9"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero", "carried"])
def test_causal_conv1d_silu_matches_jax(s, with_state):
    """ref.causal_conv1d_silu (and its wrapper on CPU tensors) against JAX
    layers.causal_conv1d + conv_b + silu (blocks.py:387-388), with and
    without a state, at S = 1 and S < K - 1; the new state exactly."""
    rng = np.random.default_rng(9)
    c, k = 6, 4
    x = rng.standard_normal((2, s, c)).astype(np.float32)
    w = rng.standard_normal((c, k)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    st = rng.standard_normal((2, k - 1, c)).astype(np.float32) \
        if with_state else None
    y_j, s_j = jlayers.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if st is None else jnp.asarray(st))
    y_j = jax.nn.silu(y_j + jnp.asarray(b))
    for fn in (tref.causal_conv1d_silu, tconv.causal_conv1d_silu):
        y, s_new = fn(_t(x), _t(w), _t(b), None if st is None else _t(st))
        assert y.shape == (2, s, c) and s_new.shape == (2, k - 1, c)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j),
                                   rtol=CONV_RTOL, atol=CONV_RTOL)
        np.testing.assert_array_equal(s_new.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_causal_conv1d_silu_equals_the_unfused_composition(dtype):
    """ref.causal_conv1d_silu is bit for bit the mixer's old passes:
    layers.causal_conv1d with w in the activation dtype, + b, silu."""
    rng = np.random.default_rng(10)
    x = _t(rng.standard_normal((2, 11, 24)).astype(np.float32)).to(dtype)
    w = _t(rng.standard_normal((24, 4)).astype(np.float32))
    b = _t(rng.standard_normal(24).astype(np.float32))
    st = _t(rng.standard_normal((2, 3, 24)).astype(np.float32)).to(dtype)
    y_old, s_old = layers.causal_conv1d(x, w.to(dtype), st)
    y_old = F.silu(y_old + b.to(dtype))
    y, s_new = tref.causal_conv1d_silu(x, w, b, st)
    assert y.dtype == dtype
    assert torch.equal(y, y_old) and torch.equal(s_new, s_old)


# ---------------------------------------------------------------- wrappers


def test_mixer_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors both wrappers return their plain versions' bits and
    count no launch; resolve_mixer picks the pair by ``scan``."""
    _, cfg = _cfgs()
    params = _mixer_params(cfg, seed=11)
    _, _, ins = _scan_inputs(cfg, params, 2, 9, seed=12,
                             dtype=torch.bfloat16)
    h0 = torch.randn(2, cfg.d_inner, cfg.ssm_state,
                     generator=torch.Generator().manual_seed(0))
    reset_launches()
    for args in (ins, (*ins, h0)):
        got, want = tscan.mamba_scan(*args), tref.mamba_scan(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = ins[0]
    w, b = _t(params["conv_w"]), _t(params["conv_b"])
    got = tconv.causal_conv1d_silu(x, w, b)
    want = tref.causal_conv1d_silu(x, w, b)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert not any(LAUNCHES.values())
    assert tscan.resolve_mixer("auto", "cpu") == (tconv.causal_conv1d_silu,
                                                  tscan.mamba_scan)
    assert tscan.resolve_mixer("reference", "cpu") == (
        tref.causal_conv1d_silu, tref.mamba_scan)
    with pytest.raises(ValueError, match="CUDA"):
        tscan.resolve_mixer("cuda", "cpu")


def _bad_scan_args(case):
    _, cfg = _cfgs()
    params = _mixer_params(cfg, seed=13)
    _, _, ins = _scan_inputs(cfg, params, 2, 5, seed=14)
    xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z = ins
    n = cfg.ssm_state
    if case == "z-shape":
        z = z[:, :4]
    elif case == "dt-bias-shape":
        dt_bias = dt_bias[:-1]
    elif case == "h0-shape":
        return (*ins, torch.zeros(2, cfg.d_inner, n + 1))
    elif case == "n33":
        b_mat = c_mat = torch.zeros(2, 5, 33)
        a = torch.zeros(cfg.d_inner, 33)
    elif case == "b-transposed":       # a strided view with stride(-1) != 1
        b_mat = b_mat.contiguous().transpose(1, 2).contiguous(
            ).transpose(1, 2)
    elif case == "b-c-strides-differ":
        c_mat = c_mat.contiguous()
    elif case == "dt-lin-bf16":
        dt_lin = dt_lin.to(torch.bfloat16)
    elif case == "b-dtype":
        b_mat = b_mat.double()
    return xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z


@pytest.mark.parametrize("case, exc, match", [
    ("z-shape", ValueError, "z must be"),
    ("dt-bias-shape", ValueError, "dt_bias"),
    ("h0-shape", ValueError, "h0 has shape"),
    ("n33", ValueError, "N=33"),
    ("b-transposed", ValueError, "strides"),
    ("b-c-strides-differ", ValueError, "strides"),
    ("dt-lin-bf16", TypeError, "dt_lin float32"),
    ("b-dtype", TypeError, "xc's dtype"),
])
def test_mamba_scan_refuses(case, exc, match):
    """The wrapper's refusals hold for CPU tensors too: bad shapes, N > 32,
    B/C that are not the unit-stride slices of one tensor, wrong dtypes."""
    with pytest.raises(exc, match=match):
        tscan.mamba_scan(*_bad_scan_args(case))


@pytest.mark.parametrize("case, exc, match", [
    ("k3", ValueError, "K=4"), ("k5", ValueError, "K=4"),
    ("w-channels", ValueError, "w must be"), ("b-shape", ValueError, "b has"),
    ("state-shape", ValueError, "state has"), ("x-2d", ValueError, "x must"),
    ("f64", TypeError, "float32 or bfloat16"),
])
def test_causal_conv1d_silu_refuses(case, exc, match):
    x, w, b = torch.zeros(2, 5, 8), torch.zeros(8, 4), torch.zeros(8)
    state = None
    if case == "k3":
        w = torch.zeros(8, 3)
    elif case == "k5":
        w = torch.zeros(8, 5)
    elif case == "w-channels":
        w = torch.zeros(7, 4)
    elif case == "b-shape":
        b = torch.zeros(9)
    elif case == "state-shape":
        state = torch.zeros(2, 4, 8)
    elif case == "x-2d":
        x = x[0]
    elif case == "f64":
        x = x.double()
    with pytest.raises(exc, match=match):
        tconv.causal_conv1d_silu(x, w, b, state)


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_scan_choices_agree_bit_for_bit_on_cpu(dtype):
    """Both scan choices run the same plain versions on CPU tensors:
    forward, prefill and two decode steps agree bit for bit, in float32 and
    in bf16 (B and C the strided bf16 slices of x_proj's output)."""
    import dataclasses
    cfg = dataclasses.replace(_cfgs()[1], dtype=dtype, param_dtype=dtype)
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 9))
    out = {}
    for scan in ("reference", "auto"):
        m = Model(cfg, device="cpu", scan=scan,
                  generator=torch.Generator().manual_seed(1))
        logits_f, _ = m(tokens)
        logits_p, cache = m.prefill(tokens)
        steps = []
        for tok in (tokens[:, :1], tokens[:, 1:2]):
            step, cache = m.decode(cache, tok)
            steps.append(step)
        out[scan] = (logits_f, logits_p, torch.cat(steps, 1),
                     cache["groups"][0]["h"], cache["groups"][0]["conv"])
    for a, b in zip(out["reference"], out["auto"]):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)

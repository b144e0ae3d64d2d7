"""The port's Mamba-1 path held against the JAX package, on the CPU.

The same inputs, made with numpy from fixed seeds, go through both
packages; the weights are the JAX ``Model(cfg).init`` tree carried across
by ``convert.model_from_numpy``.  The configuration is
``falcon-mamba-7b`` reduced (4 layers, d_model 64, d_inner 128, N 8,
dt_rank 8, vocab 512, float32).  The JAX model runs its recurrence through
``chunked_linear_recurrence`` (associative scan in chunks of 16), the port
through ``ssm_scan`` (sequential in time), so the sums are taken in other
orders: model outputs are held to max |Δ| ≤ 1e-4 · max |JAX|.

``tests/data/torch_mamba.npz`` carries the JAX weights, inputs and answers,
so ``chip_smoke.py`` can hold the card to them without importing JAX; this
file checks that the fixture still equals what JAX computes.  Regenerate it
with ``PYTHONPATH=src python tests/test_torch_mamba.py``.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm_scan  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.distributed.context import MeshCtx  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssm_scan as tscan  # noqa: E402
from repro_torch.models import Model, blocks, layers  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402

FIXTURE = Path(__file__).parent / "data" / "torch_mamba.npz"
ARCH = "falcon-mamba-7b"
BATCH, SEQ, N_DECODE = 2, 24, 2
MODEL_RTOL = 1e-4      # max |Δ| / max |JAX|, float32, see the docstring
SCAN_ATOL = 1e-4       # as tests/test_kernels.py holds the Pallas kernel


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _t(a) -> "torch.Tensor":
    return torch.from_numpy(np.array(a, copy=True))


def _scan_inputs(b, s, di, n, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    xc = rng.standard_normal((b, s, di)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))).astype(f)
    bm = rng.standard_normal((b, s, n)).astype(f)
    cm = rng.standard_normal((b, s, n)).astype(f)
    a = (-np.exp(0.3 * rng.standard_normal((di, n)))).astype(f)
    d = rng.standard_normal(di).astype(f)
    return xc, dt, bm, cm, a, d


@pytest.mark.parametrize("oracle, shape", [
    ("pallas", (2, 32, 16, 4, 8, 8)),
    ("pallas", (1, 64, 32, 8, 16, 16)),
    ("reference", (2, 37, 20, 8, None, None)),
    ("reference", (1, 5, 3, 32, None, None)),
], ids=["pallas-small", "pallas-wide", "ref-ragged", "ref-n32"])
def test_ssm_scan_matches_jax(oracle, shape):
    """The port's ssm_scan (its plain version on CPU tensors) against the
    Pallas kernel in interpret mode at tests/test_kernels.py's shapes, and
    against the JAX reference at ragged shapes the Pallas kernel refuses."""
    b, s, di, n, chunk, dblk = shape
    ins = _scan_inputs(b, s, di, n)
    y, h = tscan.ssm_scan(*(_t(v) for v in ins))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (b, s, di) and h.shape == (b, di, n)
    if oracle == "pallas":
        y_j, h_j = pallas_ssm_scan(*(jnp.asarray(v) for v in ins),
                                   chunk=chunk, di_block=dblk)
    else:
        y_j, h_j = jref.ssm_scan(*(jnp.asarray(v) for v in ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=SCAN_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=SCAN_ATOL)


def test_ssm_scan_casts_and_refuses_bad_shapes():
    ins = [_t(v) for v in _scan_inputs(1, 6, 4, 4)]
    y, h = tscan.ssm_scan(ins[0].double(), *ins[1:])
    want = tref.ssm_scan(*ins)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, want[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="N=33"):
        tscan.ssm_scan(*(_t(v) for v in _scan_inputs(1, 3, 2, 33)))
    with pytest.raises(ValueError, match="b_mat"):
        tscan.ssm_scan(ins[0], ins[1], ins[2][:, :3], *ins[3:])


def test_resolve_scan():
    assert tscan.resolve_scan("auto", "cpu") is tscan.ssm_scan
    assert tscan.resolve_scan("reference", "cpu") is tref.ssm_scan
    assert tscan.resolve_scan("cuda", "cuda") is tscan.ssm_scan
    with pytest.raises(ValueError, match="CUDA"):
        tscan.resolve_scan("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown scan"):
        tscan.resolve_scan("pallas", "cpu")


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) \
        if with_state else None
    y_j, s_j = jlayers.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), None if st is None else jnp.asarray(st))
    y, s = layers.causal_conv1d(_t(x), _t(w), None if st is None else _t(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    got = layers.rms_norm(_t(x), _t(scale), 1e-6).numpy()
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                       1e-6))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- model


def _cfgs():
    return jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()


def jax_reference():
    """The JAX model's weights, inputs and answers on the reduced config."""
    jcfg, _ = _cfgs()
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ))
    steps = rng.integers(0, jcfg.vocab_size, (N_DECODE, BATCH, 1))
    logits_f, _ = jax.jit(jm.forward)(params, jnp.asarray(tokens))
    logits_p, cache_p = jax.jit(jm.prefill)(params, jnp.asarray(tokens))
    decode = jax.jit(jm.decode)
    cache, logits_d = cache_p, []
    for tok in steps:
        l_d, cache = decode(params, cache, jnp.asarray(tok))
        logits_d.append(np.asarray(l_d))
    out = {f"param/{k}": np.asarray(v) for k, v in flatten(params)}
    out.update(tokens=tokens, steps=steps,
               forward=np.asarray(logits_f), prefill=np.asarray(logits_p),
               prefill_conv=np.asarray(cache_p["groups"]["conv"]),
               prefill_h=np.asarray(cache_p["groups"]["h"]),
               decode=np.stack(logits_d))
    return out, params


@pytest.fixture(scope="module")
def reference():
    return jax_reference()


@pytest.fixture(scope="module")
def port(reference):
    _, params = reference
    return convert.model_from_numpy(_cfgs()[1], params, device="cpu")


def test_model_from_numpy_keeps_every_leaf(reference, port):
    data, params = reference
    cfg = _cfgs()[1]
    got = dict(port.named_parameters())
    want = {}
    for name, leaf in flatten(params):
        head, _, rest = name.partition(".")
        if head == "groups":
            want.update({f"groups.{i}.{rest}": leaf[i]
                         for i in range(cfg.n_layers)})
        else:
            want[name] = leaf
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        np.testing.assert_array_equal(got[name].detach().numpy(), leaf,
                                      err_msg=name)
    assert got["groups.0.mamba.x_proj"].shape == (cfg.d_inner,
                                                  cfg.dt_rank_
                                                  + 2 * cfg.ssm_state)
    assert all(p.requires_grad for p in port.parameters())


def test_mamba_layer_matches_jax(reference, port):
    _, params = reference
    jcfg, cfg = _cfgs()
    x = np.random.default_rng(4).standard_normal(
        (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    p0 = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      params["groups"]["mamba"])
    want = np.asarray(jblocks.mamba_apply(p0, jnp.asarray(x), jcfg,
                                          MeshCtx(None)))
    got = blocks.mamba_apply(port.groups[0].mamba, _t(x), cfg)
    assert _rel(got, want) <= MODEL_RTOL


def test_forward_prefill_decode_match_jax(reference, port):
    data, _ = reference
    logits_f, aux = port(data["tokens"])
    assert float(aux) == 0.0
    assert logits_f.dtype == torch.float32
    assert _rel(logits_f, data["forward"]) <= MODEL_RTOL
    logits_p, cache = port.prefill(data["tokens"])
    assert logits_p.shape == (BATCH, 1, port.cfg.vocab_size)
    assert _rel(logits_p, data["prefill"]) <= MODEL_RTOL
    assert cache["pos"] == SEQ
    conv = torch.stack([c["conv"] for c in cache["groups"]])
    h = torch.stack([c["h"] for c in cache["groups"]])
    assert _rel(conv, data["prefill_conv"]) <= MODEL_RTOL
    assert _rel(h, data["prefill_h"]) <= MODEL_RTOL
    for step, want in zip(data["steps"], data["decode"]):
        logits_d, cache = port.decode(cache, step)
        assert _rel(logits_d, want) <= MODEL_RTOL
    assert cache["pos"] == SEQ + N_DECODE


def test_decode_matches_forward(port):
    """The port's own consistency, as tests/test_models.py checks the JAX
    model's: decode after prefill == forward over the extended sequence."""
    tokens = np.random.default_rng(5).integers(
        0, port.cfg.vocab_size, (BATCH, SEQ))
    logits_p, cache = port.prefill(tokens)
    nt = logits_p[:, -1].argmax(-1, keepdim=True)
    logits_d, cache2 = port.decode(cache, nt)
    logits_f, _ = port(torch.cat([torch.from_numpy(tokens), nt], 1))
    assert float((logits_f[:, -1] - logits_d[:, 0]).abs().max()) < 1e-3
    assert cache2["pos"] == SEQ + 1
    empty = port.init_cache(BATCH)
    assert empty["pos"] == 0 and len(empty["groups"]) == port.cfg.n_layers
    assert all(float(c["h"].abs().max()) == 0 for c in empty["groups"])


def test_loss_is_forward_nll(port):
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, port.cfg.vocab_size, (BATCH, 8)),
             "labels": rng.integers(0, port.cfg.vocab_size, (BATCH, 8))}
    loss, metrics = port.loss(batch)
    logits, _ = port(batch["tokens"])
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(batch["labels"]).reshape(-1))
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    assert float(metrics["aux"]) == 0.0


def test_fixture_is_current(reference):
    """tests/data/torch_mamba.npz equals what the JAX package computes."""
    data, _ = reference
    fixture = np.load(FIXTURE)
    assert sorted(fixture.files) == sorted(data)
    for key, want in data.items():
        np.testing.assert_allclose(fixture[key], want, rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_own_init_matches_reference_inits():
    """init_params draws what the JAX inits describe: A = -(1..N) stored as
    log, dt = softplus(dt_bias) in [1e-3, 1e-1], D = 1, zero norms."""
    cfg = _cfgs()[1]
    m = Model(cfg, device="cpu",
              generator=torch.Generator().manual_seed(7))
    mix = m.groups[1].mamba
    n = cfg.ssm_state
    torch.testing.assert_close(
        -torch.exp(mix.a_log), -torch.arange(1, n + 1.0).expand(
            cfg.d_inner, n))
    dt = torch.nn.functional.softplus(mix.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert torch.equal(mix.d_skip, torch.ones(cfg.d_inner))
    assert torch.equal(m.final_norm.scale, torch.zeros(cfg.d_model))
    assert abs(float(m.embed.std()) - 0.02) < 2e-3
    logits, _ = m(np.zeros((1, 4), np.int64))
    assert bool(torch.isfinite(logits).all())


def test_scan_choice_and_devices():
    cfg = _cfgs()[1]
    with pytest.raises(ValueError, match="CUDA"):
        Model(cfg, device="cpu", scan="cuda")
    with pytest.raises(ValueError, match="unknown scan"):
        Model(cfg, device="cpu", scan="pallas")
    with pytest.raises(ValueError, match="'speech'"):
        Model(dataclasses.replace(cfg, family="speech"), device="cpu")
    a = Model(cfg, device="cpu", scan="reference")
    b = Model(cfg, device="cpu", scan="auto")
    tokens = np.arange(10).reshape(1, 10)
    torch.testing.assert_close(a(tokens)[0], b(tokens)[0], rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.model_from_numpy(cfg, {})


def test_port_fixture_matches_on_cpu():
    """The port on the CPU reproduces the fixture, as chip_smoke.py's
    mamba_fixture phase holds the card to it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    data = np.load(FIXTURE)
    cfg = _cfgs()[1]
    m = convert.model_from_numpy(cfg, chip_smoke.fixture_params(data),
                                 device="cpu")
    assert _rel(m(data["tokens"])[0], data["forward"]) <= MODEL_RTOL
    logits_p, cache = m.prefill(data["tokens"])
    assert _rel(logits_p, data["prefill"]) <= MODEL_RTOL
    for step, want in zip(data["steps"], data["decode"]):
        logits_d, cache = m.decode(cache, step)
        assert _rel(logits_d, want) <= MODEL_RTOL


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    data, _ = jax_reference()
    np.savez_compressed(FIXTURE, **data)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")

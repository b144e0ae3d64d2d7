"""The port's attention primitives held against the JAX package, on the CPU.

``flash_attention`` (the chunked online softmax and its recompute backward,
a ``torch.autograd.Function``), ``decode_attention``, ``rope``, the mask
bias and the dense MLP get the same numpy inputs (drawn from fixed seeds)
as the JAX package's ``models/layers.py``, in float32.  Tolerances:
attention outputs atol 2e-5 and its gradients atol 1e-4 (those of
``tests/test_layers.py``'s flash cases, against ``jax.grad`` through the
reference's ``custom_vjp``); ``decode_attention``, ``rope`` and the MLP
1e-6; the mask bias exactly.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402

OUT_ATOL = 2e-5        # tests/test_layers.py: flash output against dense
GRAD_ATOL = 1e-4       # tests/test_layers.py: flash gradients against dense
EXACT_ATOL = 1e-6      # decode_attention, rope, mlp: the same float32 formula


def _t(a, grad=False) -> "torch.Tensor":
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _qkv(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, sq, h, hd)).astype(f),
            rng.standard_normal((b, sk, kv, hd)).astype(f),
            rng.standard_normal((b, sk, kv, hd)).astype(f),
            rng.standard_normal((b, sq, h, hd)).astype(f))   # a cotangent


def _both(ins, **kw):
    """Output and (dq, dk, dv) of Σ out · w from both packages."""
    q, k, v, w = ins
    qt, kt, vt = (_t(a, True) for a in (q, k, v))
    out = layers.flash_attention(qt, kt, vt, **kw)
    grads = torch.autograd.grad((out * _t(w)).sum(), (qt, kt, vt))

    def f(q_, k_, v_):
        return (jlayers.flash_attention(q_, k_, v_, **kw) * w).sum()

    want = jlayers.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    jgrads = jax.grad(f, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    return (out.detach().numpy(), [g.numpy() for g in grads],
            np.asarray(want), [np.asarray(g) for g in jgrads])


# tests/test_layers.py:30-48 (S = 70, chunk 32, GQA 4 over 2), then a query
# block at an offset into a longer, ragged key sequence (a prefill chunk
# after a cached prefix), with and without a window
@pytest.mark.parametrize("shape, kw", [
    ((2, 70, 70, 4, 2, 16), dict(causal=True, window=None, chunk=32)),
    ((2, 70, 70, 4, 2, 16), dict(causal=True, window=24, chunk=32)),
    ((2, 70, 70, 4, 2, 16), dict(causal=False, window=None, chunk=32)),
    ((2, 21, 53, 4, 2, 16), dict(causal=True, q_offset=32, chunk=16)),
    ((1, 21, 53, 6, 3, 8), dict(causal=True, window=20, q_offset=32,
                                chunk=16)),
    ((2, 37, 37, 4, 4, 16), dict(causal=True, window=None, chunk=16)),
], ids=["causal", "window24", "noncausal", "offset-ragged",
        "offset-window", "mha-ragged"])
def test_flash_attention_matches_jax(shape, kw):
    out, grads, want, jgrads = _both(_qkv(0, *shape), **kw)
    np.testing.assert_allclose(out, want, atol=OUT_ATOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("s", [17, 33, 64])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_flash_attention_chunk_invariance(s, chunk):
    """tests/test_layers.py:51-62 held within the port: the output (and
    here the gradients) do not depend on the chunking."""
    q, k, v, w = _qkv(s, 1, s, s, 2, 2, 8)

    def run(c):
        qt, kt, vt = (_t(a, True) for a in (q, k, v))
        out = layers.flash_attention(qt, kt, vt, causal=True, chunk=c)
        return out.detach(), torch.autograd.grad((out * _t(w)).sum(),
                                                 (qt, kt, vt))

    (a, ga), (b, gb) = run(chunk), run(s)
    torch.testing.assert_close(a, b, rtol=0, atol=OUT_ATOL)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=0, atol=GRAD_ATOL)


def test_flash_attention_saves_no_score_block():
    """The backward node keeps (q, k, v, o, m, l) only: nothing of a score
    block's (q chunk, kv chunk) shape."""
    q, k, v, _ = _qkv(1, 2, 64, 64, 4, 2, 16)
    qt, kt, vt = (_t(a, True) for a in (q, k, v))
    out = layers.flash_attention(qt, kt, vt, causal=True, chunk=16)
    node = out.grad_fn
    while type(node).__name__ != "_FlashCoreBackward":
        node = node.next_functions[0][0]
    shapes = sorted(tuple(t.shape) for t in node.saved_tensors)
    assert shapes == sorted([(2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16),
                             (2, 64, 4, 16), (2, 2, 64, 2), (2, 2, 64, 2)])


def test_flash_attention_refuses_uneven_groups():
    q, k, v, _ = _qkv(2, 1, 8, 8, 5, 2, 8)
    with pytest.raises(ValueError, match="kv"):
        layers.flash_attention(_t(q), _t(k), _t(v), causal=True)


@pytest.mark.parametrize("kv, window, pos", [
    (2, None, 20), (2, None, 32), (4, None, 1), (2, 8, 20), (1, 30, 32)],
    ids=["gqa", "full", "mha-first", "window", "mqa-window"])
def test_decode_attention_matches_jax(kv, window, pos):
    rng = np.random.default_rng(3)
    f = np.float32
    q = rng.standard_normal((2, 1, 4, 16)).astype(f)
    ck = rng.standard_normal((2, 32, kv, 16)).astype(f)
    cv = rng.standard_normal((2, 32, kv, 16)).astype(f)
    got = layers.decode_attention(_t(q), _t(ck), _t(cv), pos, window=window)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                    jnp.asarray(cv), pos, window=window)
    assert got.shape == (2, 1, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EXACT_ATOL)


def _rope_pair(x, pos, theta):
    got = layers.rope(_t(x), torch.from_numpy(pos), theta).numpy()
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    return got, want


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("decode", [False, True], ids=["seq", "batch"])
def test_rope_matches_jax(theta, decode):
    """Positions (S,) as a prefill gives them and (B, 1) as a decode step
    does, at the reduced configurations' head dim (16) and positions."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1 if decode else 48, 3, 16)).astype(
        np.float32)
    pos = np.array([[47], [30]]) if decode else np.arange(48)
    got, want = _rope_pair(x, pos, theta)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT_ATOL)


@pytest.mark.parametrize("hd", [16, 64, 120, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_frequencies_are_the_formulas(hd, theta):
    """exp(-i · log(θ)/half) in float32: the port's frequencies are the
    float64 formula correctly rounded to float32 in all but at most one
    place, and within one float32 step of JAX's (XLA's CPU exp rounds up
    to 8 of 60 of them the other way)."""
    half = hd // 2
    arg = -np.arange(half, dtype=np.float32) * np.float32(math.log(theta)
                                                          / half)
    got = layers.rope_freqs(half, theta).numpy()
    exact = np.exp(arg.astype(np.float64)).astype(np.float32)
    assert (got != exact).sum() <= 1
    want = np.asarray(jnp.exp(-jnp.arange(0, half, dtype=jnp.float32)
                              * (math.log(theta) / half)))
    np.testing.assert_array_less(np.abs(got - want),
                                 np.spacing(want) * 1.5)


@pytest.mark.parametrize("hd, theta", [(120, 1e4), (128, 1e6), (64, 1e4)],
                         ids=["danube", "qwen2", "smollm"])
def test_rope_at_long_positions(hd, theta):
    """At a serve prompt's positions (up to 4100) a frequency one float32
    step apart turns the angle by up to p · ulp(f): the port and JAX agree
    within 2 · max |x| · max_p p · max_i ulp(f_i), the bound of the
    one-step frequency differences above (measured: 1.0e-3 for H2O-
    Danube3's head dim 120 at θ 1e4, 1.3e-4 and 3.6e-5 for the others)."""
    rng = np.random.default_rng(6)
    pos = np.arange(4101)
    x = rng.standard_normal((1, pos.size, 2, hd)).astype(np.float32)
    got, want = _rope_pair(x, pos, theta)
    half = hd // 2
    freqs = np.exp(-np.arange(half) * np.log(theta) / half).astype(
        np.float32)
    bound = 2 * np.abs(x).max() * pos.max() * np.spacing(freqs).max()
    assert np.abs(got - want).max() <= bound


@pytest.mark.parametrize("causal, window", [(True, None), (True, 5),
                                            (False, None), (False, 3)])
def test_mask_bias_matches_jax(causal, window):
    qp, kp = np.arange(8) + 12, np.arange(16) + 8
    got = layers._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp), 20,
                            causal, window)
    want = jlayers._mask_bias(jnp.asarray(qp), jnp.asarray(kp), 20, causal,
                              window, 8, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(5)
    f = np.float32
    x = rng.standard_normal((2, 5, 12)).astype(f)
    p = {"wi": (0.3 * rng.standard_normal((12, 20))).astype(f),
         "wg": (0.3 * rng.standard_normal((12, 20))).astype(f),
         "wo": (0.3 * rng.standard_normal((20, 12))).astype(f)}
    got = layers.mlp(_t(x), _t(p["wi"]), _t(p["wo"]),
                     _t(p["wg"]) if act == "silu" else None, act)
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EXACT_ATOL)


# ---------------------------------------------------------------- blocks


def _attn_params(cfg, cross, seed):
    """Numpy draws for every leaf of attention_spec (biases and the gate
    too, which the reference initialises to zero)."""
    from repro_torch.models import blocks
    rng = np.random.default_rng(seed)
    return {name: (0.3 * rng.standard_normal(spec.shape)).astype(np.float32)
            for name, spec in blocks.attention_spec(cfg, cross=cross).items()}


@pytest.mark.parametrize("kw", [
    dict(), dict(causal=False, use_rope=False), dict(window=8, positions=5),
    dict(kv_src=10)], ids=["self", "bidirectional-norope",
                           "window-positions", "cross"])
def test_attention_apply_matches_jax(kw):
    """blocks.attention_apply with the arguments the later families use
    (causal, window, use_rope, positions) and blocks.cross_attention (a
    cross-attention source and its gate) against the JAX package's
    attention_apply, on Qwen2 reduced (q/k/v biases)."""
    import types
    from repro import configs as jconfigs
    from repro.distributed.context import MeshCtx
    from repro.models import blocks as jblocks
    from repro_torch import configs
    from repro_torch.models import blocks
    jcfg, cfg = (c.get("qwen2-1.5b").reduced() for c in (jconfigs, configs))
    cross = "kv_src" in kw
    p = _attn_params(cfg, cross, 7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    jkw, tkw = dict(kw), dict(kw)
    tp = types.SimpleNamespace(**{k: _t(v) for k, v in p.items()})
    if cross:
        src = rng.standard_normal((2, kw["kv_src"], cfg.d_model)).astype(
            np.float32)
        jkw["kv_src"] = jnp.asarray(src)
    if "positions" in kw:
        pos = np.arange(19) + kw["positions"]
        jkw["positions"], tkw["positions"] = jnp.asarray(pos), \
            torch.from_numpy(pos)
    # the port's cross-attention is blocks.cross_attention, the reference's
    # attention_apply(kv_src=)
    got = (blocks.cross_attention(tp, _t(x), _t(src), cfg)[0] if cross else
           blocks.attention_apply(tp, _t(x), cfg, **tkw))
    want = jblocks.attention_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), jcfg, MeshCtx(None),
                                   **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)
    if cross:
        # the decode step's cross branch: the cache holds the source's k, v
        ck, cv = (np.einsum("bsd,dhk->bshk", src, p[w]) for w in ("wk",
                                                                  "wv"))
        y, cache = blocks.attention_decode(
            tp, _t(x[:, :1]), {"k": _t(ck), "v": _t(cv)}, 3, cfg, cross=True)
        want_y, _ = jblocks.attention_decode(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x[:, :1]),
            {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, 3, jcfg,
            MeshCtx(None), cross=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   atol=OUT_ATOL)
        assert cache["k"].shape == ck.shape

"""The port's hybrid family (RG-LRU and local attention) held against the
JAX package, on the CPU.

``chunked_linear_recurrence`` and its three gradients against the JAX
``custom_vjp`` (the cases of ``tests/test_layers.py:78`` and the sequential
mode, ``chunk = 0``); one RG-LRU (``rglru_apply``, ``rglru_decode``) on
JAX's weights; then reduced RecurrentGemma-2B (d_model 64, 4 heads over one
kv head, head dim 16, RG-LRU width 64, d_ff 128, vocab 512, local window
32, recurrence chunk 16, attention chunk 32, float32) at ``n_layers`` 3 (one
group of two RG-LRU sublayers and a local-attention layer, what
``reduced()`` gives) and 5 (the same group and a tail of two sublayers).
The JAX ``Model(cfg).init`` weights go to both packages, the port's through
``convert.model_from_numpy``; the leaves the reference initialises to zero
(the norms' scales, the conv, input-gate and recurrence-gate biases) are
drawn with numpy, and every leaf is rounded to a bfloat16 value (kept in
float32).  Forward, prefill (logits and the cache), two decodes, and a
prompt of 48 tokens past the window with three decodes are held against
JAX to max |Δ| ≤ 1e-4 · max |JAX|, decode against the port's own forward
within 1e-3, the loss and every gradient leaf to 1e-4 of max |JAX leaf|,
and remat to no remat bit for bit.

``tests/data/torch_hybrid.npz`` carries the JAX weights, inputs and logits
at 5 layers for ``chip_smoke.py``'s ``hybrid_fixture``;
``test_fixture_is_current`` checks that it still equals what JAX computes.
Regenerate it with ``PYTHONPATH=src python tests/test_torch_hybrid.py``.
"""
import dataclasses
import os
import sys
import types
from pathlib import Path

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
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import Model, blocks, layers  # noqa: E402
from repro_torch.models.params import Spec, flatten, init_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_hybrid.npz"
ARCH = "recurrentgemma-2b"
DEPTHS = (3, 5)                    # reduced(); one group and a tail of two
FIXTURE_DEPTH = 5
BATCH, SEQ, N_DECODE = 2, 24, 2
LONG_SEQ, LONG_DECODE = 48, 3      # beyond the reduced window of 32
GRAD_SEQ = 40
MODEL_RTOL = 1e-4      # max |Δ| / max |JAX|, float32
SELF_ATOL = 1e-3       # decode against forward (tests/test_models.py)
DRAWN = ("'scale'", "'conv_b'", "'b_input'", "'b_rec'")


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _cfgs(n_layers: int = 3):
    return tuple(dataclasses.replace(c.get(ARCH).reduced(), n_layers=n_layers)
                 for c in (jconfigs, configs))


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _drawn(tree, seed: int):
    """The tree with its zero-initialised leaves drawn (0.1 · normal) and
    every leaf rounded to a bfloat16 value."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if any(k in jax.tree_util.keystr(path) for k in DRAWN):
            a = 0.1 * rng.standard_normal(np.shape(a))
        return _bf16(a)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------- recurrence


def _recurrence_loss(hs, hl):
    return (hs ** 2).sum() + (hl * 3).sum()


@pytest.mark.parametrize("s,chunk", [(24, 8), (30, 8), (16, 16), (24, 0)])
def test_recurrence_and_its_gradients_match_jax(s, chunk):
    """tests/test_layers.py:78-105's cases (and the sequential mode): h and
    h_S, and the gradients in a, b and h0 of Σ h² + 3 Σ h_S, against the
    JAX ``custom_vjp``; the backward keeps only (a, hs, h0)."""
    key = jax.random.PRNGKey(0)
    a = jax.random.uniform(key, (2, s, 5), minval=0.3, maxval=0.99,
                           dtype=jnp.float32)
    b = jax.random.normal(jax.random.fold_in(key, 1), (2, s, 5), jnp.float32)
    h0 = jax.random.normal(jax.random.fold_in(key, 2), (2, 5), jnp.float32)
    hs_j, hl_j = jlayers.chunked_linear_recurrence(a, b, h0, chunk)
    grads_j = jax.grad(lambda *x: _recurrence_loss(
        *jlayers.chunked_linear_recurrence(*x, chunk)), (0, 1, 2))(a, b, h0)
    args = [_t(x).requires_grad_() for x in (a, b, h0)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        hs, hl = layers.chunked_linear_recurrence(*args, chunk)
    assert len(saved) == 3
    assert _rel(hs, hs_j) <= 1e-6 and _rel(hl, hl_j) <= 1e-6
    grads = torch.autograd.grad(_recurrence_loss(hs, hl), args)
    for name, g, want in zip(("da", "db", "dh0"), grads, grads_j):
        assert _rel(g, want) <= MODEL_RTOL, name


def test_recurrence_chunks_agree():
    """Every chunk, and the sequential mode, give the same h within float32
    rounding; a chunk longer than the sequence is the whole sequence."""
    rng = np.random.default_rng(4)
    a = _t(rng.uniform(0.5, 0.99, (3, 37, 6)))
    b = _t(rng.standard_normal((3, 37, 6)))
    h0 = _t(rng.standard_normal((3, 6)))
    want, last = layers.chunked_linear_recurrence(a, b, h0, 0)
    for chunk in (1, 5, 16, 37, 64):
        hs, hl = layers.chunked_linear_recurrence(a, b, h0, chunk)
        assert _rel(hs, want) <= 1e-6 and _rel(hl, last) <= 1e-6, chunk


# ---------------------------------------------------------------- RG-LRU


@pytest.fixture(scope="module")
def rglru_layer():
    """One RG-LRU of the reduced configuration: JAX's weights (biases
    drawn), an input of 2 × 21 and a decode cache."""
    jcfg, cfg = _cfgs()
    p = _drawn(jinit_params(jax.random.PRNGKey(3),
                            jblocks.rglru_spec(jcfg, MeshCtx(None)),
                            jnp.float32), 3)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, 21, jcfg.d_model)).astype(np.float32)
    cache = {"conv": rng.standard_normal((BATCH, jcfg.d_conv - 1,
                                          jcfg.lru_width_)),
             "h": rng.standard_normal((BATCH, jcfg.lru_width_))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    return jcfg, cfg, p, x, cache


def test_rglru_apply_matches_jax(rglru_layer):
    jcfg, cfg, p, x, _ = rglru_layer
    want = jblocks.rglru_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               jcfg, MeshCtx(None))
    pt = types.SimpleNamespace(**{k: _t(v) for k, v in p.items()})
    assert _rel(blocks.rglru_apply(pt, _t(x), cfg), want) <= MODEL_RTOL
    y, cache = blocks.rglru_prefill(pt, _t(x), cfg)
    assert cache["conv"].shape == (BATCH, cfg.d_conv - 1, cfg.lru_width_)
    assert cache["h"].dtype == torch.float32


def test_rglru_decode_matches_jax(rglru_layer):
    """One step from a drawn cache: the output, the conv tail and h; the
    given cache is not modified."""
    jcfg, cfg, p, x, cache = rglru_layer
    y_j, c_j = jblocks.rglru_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x[:, :1]),
        jax.tree.map(jnp.asarray, cache), jcfg, MeshCtx(None))
    pt = types.SimpleNamespace(**{k: _t(v) for k, v in p.items()})
    ct = {k: _t(v) for k, v in cache.items()}
    y, c = blocks.rglru_decode(pt, _t(x[:, :1]), ct, cfg)
    assert _rel(y, y_j) <= MODEL_RTOL
    for k in ("conv", "h"):
        assert _rel(c[k], c_j[k]) <= MODEL_RTOL, k
        assert torch.equal(ct[k], _t(cache[k]))


def test_rglru_a_init_gives_decays_in_range():
    """λ drawn so that the decay at r = 1, exp(-8 softplus(λ)), is u² with
    u ~ U(0.9, 0.999) (``params.py:53-57``)."""
    lam = init_params({"lam": Spec((4096,), init="rglru_a")},
                      torch.Generator().manual_seed(0), torch.float32,
                      "cpu")["lam"]
    u = torch.sqrt(torch.exp(-8 * torch.nn.functional.softplus(lam)))
    assert float(u.min()) >= 0.9 - 1e-5 and float(u.max()) <= 0.999 + 1e-5
    assert abs(float(u.mean()) - 0.9495) < 5e-3


# ---------------------------------------------------------------- model


def jax_reference(n_layers: int):
    """The JAX model's answers at ``n_layers`` on its init(PRNGKey(0))
    weights (:func:`_drawn`): forward, prefill (logits and cache), two
    decodes, and a prompt of LONG_SEQ tokens with LONG_DECODE decodes."""
    jcfg, _ = _cfgs(n_layers)
    jm = JModel(jcfg)
    params = _drawn(jm.init(jax.random.PRNGKey(0)), n_layers)
    rng = np.random.default_rng(10 + n_layers)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)

    def serve(toks, steps):
        logits_p, cache = prefill(params, jnp.asarray(toks))
        first, out = cache, []
        for tok in steps:
            logits, cache = decode(params, cache, jnp.asarray(tok))
            out.append(np.asarray(logits))
        return np.asarray(logits_p), first, np.stack(out)

    out = {"tokens": rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)),
           "steps": rng.integers(0, jcfg.vocab_size, (N_DECODE, BATCH, 1)),
           "long_tokens": rng.integers(0, jcfg.vocab_size,
                                       (BATCH, LONG_SEQ)),
           "long_steps": rng.integers(0, jcfg.vocab_size,
                                      (LONG_DECODE, BATCH, 1))}
    logits, aux = jax.jit(jm.forward)(params, jnp.asarray(out["tokens"]))
    out["forward"], out["aux"] = np.asarray(logits), np.asarray(aux)
    out["prefill"], cache, out["decode"] = serve(out["tokens"], out["steps"])
    out["cache"] = jax.tree.map(np.asarray, cache)
    out["long_prefill"], lcache, out["long_decode"] = serve(
        out["long_tokens"], out["long_steps"])
    out["long_cache"] = jax.tree.map(np.asarray, lcache)
    return out, params


class _References(dict):
    def __missing__(self, n_layers):
        self[n_layers] = jax_reference(n_layers)
        return self[n_layers]


@pytest.fixture(scope="module")
def refs():
    return _References()


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"{n}_layers")
def depth(request):
    return request.param


@pytest.fixture(scope="module")
def port(depth, refs):
    return convert.model_from_numpy(_cfgs(depth)[1], refs[depth][1],
                                    device="cpu")


def _stacked(tree: dict, n: int) -> dict:
    """The port's per-entry names of a stacked reference tree."""
    out = {}
    for name, leaf in flatten(tree):
        head, _, rest = name.partition(".")
        if head in ("groups", "tail"):
            out.update({f"{head}.{i}.{rest}": np.asarray(leaf)[i]
                        for i in range(np.shape(leaf)[0])})
        else:
            out[name] = leaf
    return out


def test_model_from_numpy_keeps_every_leaf(depth, refs, port):
    """Every JAX leaf lands on the port's modules: ``groups.<i>.rnn.<j>.
    mix.*``, the attention layer's ``aln1``/``attn``/``aln2``/``amlp``,
    and at 5 layers ``tail.<j>.*``."""
    want = _stacked(refs[depth][1], depth)
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), leaf,
                                      err_msg=name)
    assert len(port.groups) == 1 and len(port.groups[0].rnn) == 2
    assert len(getattr(port, "tail", ())) == depth - 3
    assert port.groups[0].rnn[1].mix.w_rec.shape == (64, 64)


def test_forward_prefill_decode_match_jax(depth, refs, port):
    data, _ = refs[depth]
    with torch.no_grad():
        logits_f, aux = port(data["tokens"])
    assert float(aux) == 0.0 and float(data["aux"]) == 0.0
    assert _rel(logits_f, data["forward"]) <= MODEL_RTOL
    logits_p, cache = port.prefill(data["tokens"])
    assert _rel(logits_p, data["prefill"]) <= MODEL_RTOL
    want = _stacked(data["cache"], depth)
    got = dict(flatten({k: v for k, v in cache.items() if k != "pos"}))
    assert sorted(got) == sorted(k for k in want if k != "pos")
    for name, t in got.items():
        assert t.shape == want[name].shape, name
        assert _rel(t, want[name]) <= MODEL_RTOL, name
    for step, want_d in zip(data["steps"], data["decode"]):
        logits_d, cache = port.decode(cache, step)
        assert _rel(logits_d, want_d) <= MODEL_RTOL
    assert cache["pos"] == SEQ + N_DECODE


def test_prompt_past_the_window_matches_jax(depth, refs, port):
    """A 48-token prompt past the local window of 32: the ring buffer keeps
    the last 32 tokens, token t at slot t % 32, and each decode overwrites
    the oldest; the recurrent state carries the whole prompt.  Logits and
    the ring against JAX, each decode against the port's own forward."""
    data, _ = refs[depth]
    logits_p, cache = port.prefill(data["long_tokens"])
    assert _rel(logits_p, data["long_prefill"]) <= MODEL_RTOL
    ring = cache["groups"][0]["attn"]["k"]
    assert ring.shape[1] == port.cfg.local_window
    assert _rel(ring, data["long_cache"]["groups"]["attn"]["k"][0]) \
        <= MODEL_RTOL
    seq = torch.from_numpy(data["long_tokens"])
    for step, want in zip(data["long_steps"], data["long_decode"]):
        logits_d, cache = port.decode(cache, step)
        assert _rel(logits_d, want) <= MODEL_RTOL
        seq = torch.cat([seq, torch.from_numpy(step)], 1)
        with torch.no_grad():
            logits_f, _ = port(seq)
        assert float((logits_f[:, -1] - logits_d[:, 0]).abs().max()) \
            < SELF_ATOL


def test_decode_matches_forward(depth, port):
    """tests/test_models.py:63-80 on the port: decode after prefill equals
    the forward over the extended sequence; decode does not modify the
    cache it is given."""
    tokens = np.random.default_rng(5).integers(
        0, port.cfg.vocab_size, (BATCH, SEQ))
    logits_p, cache = port.prefill(tokens)
    before = [c["h"].clone() for c in cache["groups"][0]["rnn"]]
    nt = logits_p[:, -1].argmax(-1, keepdim=True)
    logits_d, cache2 = port.decode(cache, nt)
    with torch.no_grad():
        logits_f, _ = port(torch.cat([torch.from_numpy(tokens), nt], 1))
    assert float((logits_f[:, -1] - logits_d[:, 0]).abs().max()) < SELF_ATOL
    assert cache2["pos"] == SEQ + 1 and cache["pos"] == SEQ
    assert all(torch.equal(a, c["h"]) for a, c in
               zip(before, cache["groups"][0]["rnn"]))


def test_init_cache_decodes_like_the_forward(depth, port):
    """init_cache: per group its sublayers' zero conv tails and states and
    min(cache_len, local window) attention slots, per tail sublayer its
    own; decoding one token from it is the forward of that token."""
    cfg = port.cfg
    with pytest.raises(ValueError, match="cache_len"):
        port.init_cache(BATCH)
    empty = port.init_cache(BATCH, 100)
    g = empty["groups"][0]
    assert len(empty["groups"]) == 1 and len(g["rnn"]) == cfg.pattern_rnn
    assert g["attn"]["k"].shape == (BATCH, cfg.local_window, 1, 16)
    assert g["rnn"][0]["h"].shape == (BATCH, cfg.lru_width_)
    assert len(empty.get("tail", ())) == depth - 3
    tok = np.array([[7], [11]])
    logits, c = port.decode(empty, tok)
    with torch.no_grad():
        want, _ = port(tok)
    torch.testing.assert_close(logits, want, rtol=0, atol=SELF_ATOL)
    assert c["pos"] == 1


# ---------------------------------------------------------------- training


def _port_grads(model, batch):
    loss, metrics = model.loss(batch)
    named = dict(model.named_parameters())
    return loss, metrics, dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


@pytest.fixture(scope="module")
def grad_reference(depth, refs):
    """jax.value_and_grad of the JAX Model.loss, on JAX's weights and a
    numpy-drawn batch of GRAD_SEQ tokens (past the window)."""
    jcfg, _ = _cfgs(depth)
    params = refs[depth][1]
    tokens = np.random.default_rng(21).integers(0, jcfg.vocab_size,
                                                (BATCH, GRAD_SEQ + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        JModel(jcfg).loss, has_aux=True))(params, jax.tree.map(jnp.asarray,
                                                                batch))
    return params, batch, float(loss), jax.tree.map(np.asarray, grads)


def test_loss_and_every_gradient_match_jax(depth, grad_reference):
    params, batch, loss_j, grads = grad_reference
    model = convert.model_from_numpy(_cfgs(depth)[1], params, device="cpu")
    loss, metrics, got = _port_grads(model, batch)
    assert abs(float(loss.detach()) - loss_j) <= 1e-5 * loss_j
    want = _stacked(grads, depth)
    assert sorted(got) == sorted(want)
    names = [k for k, _ in flatten(grads)]
    # embed, final_norm, lm_head; per sublayer 2 norms, 10 RG-LRU leaves,
    # 3 MLP leaves (twice, in the group; once more for the tail); the
    # attention layer's 2 norms, wq/wk/wv/wo and 3 MLP leaves
    assert len(names) == 3 + 2 * 15 + 9 + 15 * (depth > 3)
    for name, w in flatten(grads):
        head, _, rest = name.partition(".")
        g = got[name] if head not in ("groups", "tail") else torch.stack(
            [got[f"{head}.{i}.{rest}"] for i in range(np.shape(w)[0])])
        assert _rel(g, w) <= MODEL_RTOL, name


def test_remat_gives_the_same_bits(depth, grad_reference):
    """Per-group remat recomputes the same forward (the recurrence's custom
    function included): loss and every gradient equal bit for bit."""
    params, batch = grad_reference[:2]
    cfg = _cfgs(depth)[1]
    out = []
    for remat in (False, True):
        m = convert.model_from_numpy(dataclasses.replace(cfg, remat=remat),
                                     params, device="cpu")
        out.append(_port_grads(m, batch))
    assert torch.equal(out[0][0], out[1][0])
    for name in out[0][2]:
        assert torch.equal(out[0][2][name], out[1][2][name]), name


def test_model_refuses_the_queued_families():
    """No family is queued any more: a family outside the six raises
    ValueError naming it, as the reference's ``param_specs`` does."""
    cfg = _cfgs()[1]
    for family in ("encoder_only", "diffusion"):
        with pytest.raises(ValueError, match=repr(family)):
            Model(dataclasses.replace(cfg, family=family), device="cpu")


# ---------------------------------------------------------------- fixture


def fixture_entries(refs) -> dict:
    """The npz's entries at FIXTURE_DEPTH: the weights as bfloat16 bits
    (uint16), the inputs and the logits."""
    data, params = refs[FIXTURE_DEPTH]
    out = {f"param/{name}": (np.asarray(a, np.float32).view(np.uint32)
                             >> 16).astype(np.uint16)
           for name, a in flatten(params)}
    for key in ("tokens", "steps", "forward", "prefill", "decode",
                "long_tokens", "long_steps", "long_prefill", "long_decode"):
        out[key] = data[key]
    return out


def test_fixture_is_current(refs):
    """tests/data/torch_hybrid.npz equals what the JAX package computes."""
    want = fixture_entries(refs)
    fixture = np.load(FIXTURE)
    assert sorted(fixture.files) == sorted(want)
    for key, a in want.items():
        np.testing.assert_allclose(fixture[key], a, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_port_matches_the_fixture_on_cpu():
    """chip_smoke.py's hybrid_fixture check, run on the CPU."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    res = chip_smoke.hybrid_fixture(torch.device("cpu"))
    assert res["ok"], res


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    entries = fixture_entries(_References())
    np.savez_compressed(FIXTURE, **entries)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")

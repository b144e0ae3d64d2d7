"""The port's dense (attention) family held against the JAX package, on the
CPU.

For each of the four dense configurations reduced (4 layers, d_model 64,
4 heads over 2 kv heads or 4 for MiniCPM's MHA, head dim 16, d_ff 128,
vocab 512, attention chunk 32, float32; Qwen2 with its q/k/v biases,
H2O-Danube3 with its sliding window of 32) the JAX ``Model(cfg).init``
weights go to both packages, the port's through
``convert.model_from_numpy``.  The leaves the reference initialises to
zero (the q/k/v biases, the norms' scales) are drawn with numpy instead,
so that their paths compute something, and every leaf is rounded to a
bfloat16 value (kept in float32) so that ``tests/data/torch_dense.npz``
holds it in two bytes.  The module builds the JAX side once per
configuration and shares it: forward logits, prefill logits and cache, two
decode steps; for H2O-Danube3 also a prompt of 48 tokens, beyond its
window, and three decodes, so the ring buffer wraps (the reference's own
tests stop at 24).  Logits are held to max |Δ| ≤ 1e-4 · max |JAX|, the
port's decode to its own forward within 1e-3 (``tests/test_models.py``'s
bound), the loss and every gradient leaf to 1e-4 of max |JAX leaf|, and
remat to no remat bit for bit.

``tests/data/torch_dense.npz`` carries the JAX weights, inputs and logits
of the reduced Qwen2 and H2O-Danube3, so ``chip_smoke.py`` can hold the
card to them without importing JAX; ``test_fixture_is_current`` checks
that it still equals what JAX computes.  Regenerate it with
``PYTHONPATH=src python tests/test_torch_dense.py``.
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
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_dense.npz"
DENSE = ("smollm-360m", "qwen2-1.5b", "minicpm-2b", "h2o-danube-3-4b")
FIXTURE_ARCHS = ("qwen2-1.5b", "h2o-danube-3-4b")
WINDOWED = "h2o-danube-3-4b"
BATCH, SEQ, N_DECODE = 2, 24, 2
LONG_SEQ, LONG_DECODE = 48, 3      # beyond the reduced window of 32
GRAD_SEQ = 40                      # a training batch the window binds on
MODEL_RTOL = 1e-4      # max |Δ| / max |JAX|, float32
SELF_ATOL = 1e-3       # decode against forward (tests/test_models.py)


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfgs(arch):
    return jconfigs.get(arch).reduced(), configs.get(arch).reduced()


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def jax_params(arch: str):
    """JAX's init(PRNGKey(0)) tree with numpy-drawn biases and norm scales,
    every leaf rounded to a bfloat16 value (float32 arrays)."""
    jcfg, _ = _cfgs(arch)
    params = jax.tree.map(np.asarray, JModel(jcfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(DENSE.index(arch))

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'", "'scale'")):
            a = 0.1 * rng.standard_normal(a.shape)
        return _bf16(a)

    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_reference(arch: str):
    """The JAX model's answers on :func:`jax_params`: forward, prefill
    (logits and cache) and decode logits; beyond the window too for the
    windowed configuration."""
    jcfg, _ = _cfgs(arch)
    jm = JModel(jcfg)
    params = jax_params(arch)
    rng = np.random.default_rng(10 + DENSE.index(arch))
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ))
    steps = rng.integers(0, jcfg.vocab_size, (N_DECODE, BATCH, 1))
    forward, prefill, decode = (jax.jit(jm.forward), jax.jit(jm.prefill),
                                jax.jit(jm.decode))

    def serve(toks, steps_):
        logits_p, cache = prefill(params, jnp.asarray(toks))
        first = cache
        out = []
        for tok in steps_:
            logits, cache = decode(params, cache, jnp.asarray(tok))
            out.append(np.asarray(logits))
        return np.asarray(logits_p), first, np.stack(out)

    out = {"tokens": tokens, "steps": steps,
           "forward": np.asarray(forward(params, jnp.asarray(tokens))[0])}
    out["prefill"], cache, out["decode"] = serve(tokens, steps)
    out["prefill_k"] = np.asarray(cache["groups"]["k"])
    out["prefill_v"] = np.asarray(cache["groups"]["v"])
    if arch == WINDOWED:
        long = rng.integers(0, jcfg.vocab_size, (BATCH, LONG_SEQ))
        lsteps = rng.integers(0, jcfg.vocab_size, (LONG_DECODE, BATCH, 1))
        out.update(long_tokens=long, long_steps=lsteps)
        out["long_prefill"], lcache, out["long_decode"] = serve(long, lsteps)
        out["long_prefill_k"] = np.asarray(lcache["groups"]["k"])
    return out, params


def fixture_entries(refs) -> dict:
    """The npz's entries: per configuration of FIXTURE_ARCHS its weights as
    bfloat16 bits (uint16) and its inputs and logits."""
    out = {}
    for arch in FIXTURE_ARCHS:
        data, params = refs[arch]
        for name, a in flatten(params):
            out[f"{arch}/param/{name}"] = (
                np.asarray(a, np.float32).view(np.uint32) >> 16).astype(
                    np.uint16)
        for key in ("tokens", "steps", "forward", "prefill", "decode",
                    "long_tokens", "long_steps", "long_prefill",
                    "long_decode"):
            if key in data:
                out[f"{arch}/{key}"] = data[key]
    return out


class _References(dict):
    """JAX's answers by configuration, each computed when first asked."""

    def __missing__(self, arch):
        self[arch] = jax_reference(arch)
        return self[arch]


@pytest.fixture(scope="module")
def refs():
    return _References()


@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def reference(arch, refs):
    return refs[arch]


@pytest.fixture(scope="module")
def port(arch, reference):
    _, params = reference
    return convert.model_from_numpy(_cfgs(arch)[1], params, device="cpu")


# ---------------------------------------------------------------- serving


def test_model_from_numpy_keeps_every_leaf(arch, reference, port):
    """Every JAX leaf lands on the port's layer modules with its layout:
    wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d), the MLP's wi/wg/wo."""
    _, params = reference
    cfg = port.cfg
    got = dict(port.named_parameters())
    want = {}
    for name, leaf in flatten(params):
        head, _, rest = name.partition(".")
        want.update({f"groups.{i}.{rest}": leaf[i]
                     for i in range(cfg.n_layers)} if head == "groups"
                    else {name: leaf})
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), leaf,
                                      err_msg=name)
    attn = port.groups[0].attn
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    assert attn.wq.shape == (d, h, hd) and attn.wk.shape == (d, kv, hd)
    assert attn.wo.shape == (h, hd, d)
    assert hasattr(attn, "bq") == cfg.qkv_bias
    assert port.groups[0].mlp.wg.shape == (d, cfg.d_ff)


def test_forward_prefill_decode_match_jax(arch, reference, port):
    data, _ = reference
    with torch.no_grad():
        logits_f, aux = port(data["tokens"])
    assert float(aux) == 0.0 and logits_f.dtype == torch.float32
    assert _rel(logits_f, data["forward"]) <= MODEL_RTOL
    logits_p, cache = port.prefill(data["tokens"])
    assert logits_p.shape == (BATCH, 1, port.cfg.vocab_size)
    assert _rel(logits_p, data["prefill"]) <= MODEL_RTOL
    assert cache["pos"] == SEQ
    for kv in "kv":
        got = torch.stack([c[kv] for c in cache["groups"]])
        assert got.shape == data[f"prefill_{kv}"].shape
        assert _rel(got, data[f"prefill_{kv}"]) <= MODEL_RTOL
    for step, want in zip(data["steps"], data["decode"]):
        logits_d, cache = port.decode(cache, step)
        assert _rel(logits_d, want) <= MODEL_RTOL
    assert cache["pos"] == SEQ + N_DECODE


def test_decode_matches_forward(arch, port):
    """tests/test_models.py:63-80 on the port: decode after prefill equals
    the forward over the extended sequence; decode does not modify the
    cache it is given."""
    tokens = np.random.default_rng(5).integers(
        0, port.cfg.vocab_size, (BATCH, SEQ))
    logits_p, cache = port.prefill(tokens)
    before = [c["k"].clone() for c in cache["groups"]]
    nt = logits_p[:, -1].argmax(-1, keepdim=True)
    logits_d, cache2 = port.decode(cache, nt)
    with torch.no_grad():
        logits_f, _ = port(torch.cat([torch.from_numpy(tokens), nt], 1))
    assert float((logits_f[:, -1] - logits_d[:, 0]).abs().max()) < SELF_ATOL
    assert cache2["pos"] == SEQ + 1 and cache["pos"] == SEQ
    assert all(torch.equal(a, c["k"]) for a, c in zip(before,
                                                      cache["groups"]))


def test_two_step_decode():
    """tests/test_models.py:83-97 on the port: Qwen2 reduced, a prompt of
    16, two decode steps against the forward over all 18 tokens."""
    _, cfg = _cfgs("qwen2-1.5b")
    m = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    _, cache = m.prefill(tokens)
    t1 = torch.zeros((1, 1), dtype=torch.long)
    l1, cache = m.decode(cache, t1)
    t2 = l1[:, -1].argmax(-1, keepdim=True)
    l2, cache = m.decode(cache, t2)
    with torch.no_grad():
        lf, _ = m(torch.cat([torch.from_numpy(tokens), t1, t2], 1))
    assert float((lf[:, -1] - l2[:, 0]).abs().max()) < SELF_ATOL


def test_ring_buffer_wraps_past_the_window(refs):
    """H2O-Danube3 reduced (window 32): a 48-token prompt then three
    decodes.  The prefill keeps the last 32 tokens, token t at slot
    t % 32; each decode overwrites the oldest slot.  Logits against JAX,
    the ring's slots against JAX's, and each decode against the port's
    own forward over the extended sequence."""
    data, params = refs[WINDOWED]
    cfg = _cfgs(WINDOWED)[1]
    port = convert.model_from_numpy(cfg, params, device="cpu")
    logits_p, cache = port.prefill(data["long_tokens"])
    assert _rel(logits_p, data["long_prefill"]) <= MODEL_RTOL
    ring = torch.stack([c["k"] for c in cache["groups"]])
    assert ring.shape[2] == cfg.sliding_window
    assert _rel(ring, data["long_prefill_k"]) <= MODEL_RTOL
    seq = torch.from_numpy(data["long_tokens"])
    for step, want in zip(data["long_steps"], data["long_decode"]):
        logits_d, cache = port.decode(cache, step)
        assert _rel(logits_d, want) <= MODEL_RTOL
        seq = torch.cat([seq, torch.from_numpy(step)], 1)
        with torch.no_grad():
            logits_f, _ = port(seq)
        assert float((logits_f[:, -1] - logits_d[:, 0]).abs().max()) \
            < SELF_ATOL
    assert cache["pos"] == LONG_SEQ + LONG_DECODE


def test_init_cache_and_cache_len(arch, port):
    """init_cache: min(cache_len, window) zero slots a layer, cache_len
    required; decoding one token from it is the forward of that token.
    prefill(cache_len=): that many slots (no window), fewer than the
    prompt refused."""
    cfg = port.cfg
    with pytest.raises(ValueError, match="cache_len"):
        port.init_cache(BATCH)
    empty = port.init_cache(BATCH, 100)
    slots = min(100, cfg.sliding_window or 100)
    assert empty["pos"] == 0 and len(empty["groups"]) == cfg.n_layers
    assert empty["groups"][0]["k"].shape == (BATCH, slots, cfg.n_kv_heads,
                                             cfg.head_dim_)
    tok = np.array([[7], [11]])
    logits, c = port.decode(empty, tok)
    with torch.no_grad():
        want, _ = port(tok)
    torch.testing.assert_close(logits, want, rtol=0, atol=SELF_ATOL)
    assert c["pos"] == 1
    if cfg.sliding_window:
        return
    _, cache = port.prefill(np.zeros((1, 10), np.int64), cache_len=12)
    assert cache["groups"][0]["v"].shape[1] == 12
    with pytest.raises(ValueError, match="cache_len"):
        port.prefill(np.zeros((1, 10), np.int64), cache_len=9)


# ---------------------------------------------------------------- training


def _port_grads(model, batch):
    loss, metrics = model.loss(batch)
    named = dict(model.named_parameters())
    return loss, metrics, dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


@pytest.fixture(scope="module", params=FIXTURE_ARCHS)
def grad_reference(request, refs):
    """jax.value_and_grad of the JAX Model.loss, on JAX's weights and a
    numpy-drawn batch of GRAD_SEQ tokens."""
    arch = request.param
    jcfg, _ = _cfgs(arch)
    params = refs[arch][1]
    tokens = np.random.default_rng(21).integers(0, jcfg.vocab_size,
                                                (BATCH, GRAD_SEQ + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        JModel(jcfg).loss, has_aux=True))(params, jax.tree.map(jnp.asarray,
                                                                batch))
    return arch, params, batch, float(loss), jax.tree.map(np.asarray, grads)


def test_loss_and_every_gradient_match_jax(grad_reference):
    arch, params, batch, loss_j, grads = grad_reference
    cfg = _cfgs(arch)[1]
    model = convert.model_from_numpy(cfg, params, device="cpu")
    loss, metrics, got = _port_grads(model, batch)
    assert abs(float(loss.detach()) - loss_j) <= 1e-5 * loss_j
    assert float(metrics["aux"]) == 0.0
    names = [k for k, _ in flatten(grads)]
    # embed, final_norm, lm_head; ln1, ln2, wq/wk/wv/wo, biases, wi/wo/wg
    assert len(names) == 3 + 2 + 4 + 3 * cfg.qkv_bias + 3
    for name, want in flatten(grads):
        head, _, rest = name.partition(".")
        g = got[name] if head != "groups" else torch.stack(
            [got[f"groups.{i}.{rest}"] for i in range(cfg.n_layers)])
        assert _rel(g, want) <= MODEL_RTOL, name


def test_remat_gives_the_same_bits(grad_reference):
    """Per-layer remat recomputes the same forward (attention's custom
    function included): loss and every gradient equal bit for bit."""
    arch, params, batch, _, _ = grad_reference
    cfg = _cfgs(arch)[1]
    out = []
    for remat in (False, True):
        m = convert.model_from_numpy(dataclasses.replace(cfg, remat=remat),
                                     params, device="cpu")
        out.append(_port_grads(m, batch))
    assert torch.equal(out[0][0], out[1][0])
    for name in out[0][2]:
        assert torch.equal(out[0][2][name], out[1][2][name]), name


def test_launcher_trains_qwen2_reduced_on_cpu(capsys):
    out = launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps",
                             "2", "--batch", "2", "--seq", "8", "--device",
                             "cpu"])
    assert out["final_step"] == 2
    assert all(np.isfinite(e["loss"]) for e in out["log"])
    assert "final step 2" in capsys.readouterr().out


# ---------------------------------------------------------------- registry


def test_registry_lists_the_dense_configs():
    assert configs.names() == list(DENSE) + [
        "falcon-mamba-7b", "recurrentgemma-2b", "mixtral-8x7b",
        "kimi-k2-1t-a32b", "whisper-base", "llama-3.2-vision-11b"]
    assert sorted(configs.names()) == sorted(jconfigs.names())
    for name in DENSE:
        want = jconfigs.get(name)
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(want), name


@pytest.mark.parametrize("family, item", [
    ("audio", "item 4"), ("vlm", "item 5")])
def test_other_families_name_their_queue_item(family, item):
    """The families of ROADMAP.md queue 1 items 4 and 5 run: their
    reduced configuration builds and gives finite logits over a source."""
    arch = {"audio": "whisper-base", "vlm": "llama-3.2-vision-11b"}[family]
    cfg = configs.get(arch).reduced()
    model = Model(cfg, device="cpu")
    key = {"audio": "enc_frames", "vlm": "image_embeds"}[family]
    extra = {key: torch.randn(1, 8, cfg.d_model)}
    with torch.no_grad():
        logits, _ = model(np.zeros((1, 4), np.int64), extra)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------- fixture


def test_fixture_is_current(refs):
    """tests/data/torch_dense.npz equals what the JAX package computes."""
    want = fixture_entries(refs)
    fixture = np.load(FIXTURE)
    assert sorted(fixture.files) == sorted(want)
    for key, a in want.items():
        np.testing.assert_allclose(fixture[key], a, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_port_matches_the_fixture_on_cpu():
    """chip_smoke.py's dense_fixture check, run on the CPU."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    res = chip_smoke.dense_fixture(torch.device("cpu"))
    assert res["ok"], res


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    entries = fixture_entries(_References())
    np.savez_compressed(FIXTURE, **entries)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")

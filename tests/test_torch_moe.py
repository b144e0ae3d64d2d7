"""The port's MoE family held against the JAX package, on the CPU.

Reduced Mixtral-8x7B and Kimi-K2 (4 layers, d_model 64, 4 heads over 2 kv
heads, head dim 16, vocab 512, 8 experts of width 64, top-2, float32;
Mixtral with its sliding window of 32, Kimi-K2 with its shared expert;
``reduced()`` makes the capacity drop-free, ``capacity_factor = 8``).  The
JAX ``Model(cfg).init`` weights go to both packages, the port's through
``convert.model_from_numpy``.  The norms' scales (zero at init) and the
routers are drawn with numpy, the router at scale 1/√d so that routing is
decided by margins far above float32 rounding, and every leaf is rounded to
a bfloat16 value (kept in float32) so that ``tests/data/torch_moe.npz``
holds it in two bytes.  The module builds the JAX side once per case and
shares it.  Logits and the aux loss are held to max |Δ| ≤ 1e-4 · max |JAX|,
decode to the port's own forward within 1e-3 (``tests/test_models.py``'s
bound), the loss and every gradient leaf to 1e-4 of max |JAX leaf|, and
remat to no remat bit for bit.  Beyond the drop-free case: a tight capacity
(``capacity_factor = 0.5``, the reference's ``test_moe_capacity_drops_
tokens``, on its zero tokens and on random ones), where choices are dropped;
a wide one (16 experts, top-4, ``capacity_factor = 1.25``); and the slots
each expert keeps, read from the JAX ``_moe_local``'s output.

``tests/data/torch_moe.npz`` carries the JAX weights, inputs and logits of
Mixtral (its drop-free and tight cases) and Kimi-K2, each at 1 layer (so
that the file stays under 1 MB), for ``chip_smoke.py``'s
``moe_fixture``; ``test_fixture_is_current`` checks that it still equals
what JAX computes.  Regenerate it with ``PYTHONPATH=src python
tests/test_torch_moe.py``.
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
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model, blocks  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_moe.npz"
MOE = ("mixtral-8x7b", "kimi-k2-1t-a32b")
# the fixture's depths (under 1 MB for the two)
FIXTURE_LAYERS = {"mixtral-8x7b": 1, "kimi-k2-1t-a32b": 1}
TIGHT, WIDE = "tight", "wide"
BATCH, SEQ, N_DECODE = 2, 24, 2
TIGHT_SEQ = 16                     # tests/test_models.py:104
GRAD_SEQ = 40
MODEL_RTOL = 1e-4      # max |Δ| / max |JAX|, float32
SELF_ATOL = 1e-3       # decode against forward (tests/test_models.py)


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _variant(cfg, case: str, layers=None):
    """The reduced configuration of a case: ``tight`` capacity 0.5, ``wide``
    16 experts top-4 at 1.25; ``layers`` the depth."""
    if case == TIGHT:
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    elif case == WIDE:
        cfg = dataclasses.replace(cfg, n_experts=16, top_k=4,
                                  capacity_factor=1.25)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def _cfgs(arch, case=None, layers=None):
    return (_variant(jconfigs.get(arch).reduced(), case, layers),
            _variant(configs.get(arch).reduced(), case, layers))


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def jax_params(jcfg, seed: int):
    """JAX's init(PRNGKey(seed)) tree with numpy-drawn norm scales (0.1)
    and routers (1/√d), every leaf rounded to a bfloat16 value."""
    params = jax.tree.map(np.asarray, JModel(jcfg).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name:
            a = 0.1 * rng.standard_normal(a.shape)
        elif "'router'" in name:
            a = rng.standard_normal(a.shape) / np.sqrt(jcfg.d_model)
        return _bf16(a)

    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_reference(arch: str, case=None, layers=None):
    """The JAX model's answers on :func:`jax_params`: forward logits and
    aux; for the drop-free case also prefill and two decodes; ``tight`` on
    the reference's zero tokens and on random ones."""
    jcfg, _ = _cfgs(arch, case, layers)
    jm = JModel(jcfg)
    params = jax_params(jcfg, MOE.index(arch))
    rng = np.random.default_rng(10 + MOE.index(arch))
    forward = jax.jit(jm.forward)
    out = {}

    def fwd(key, toks):
        out[f"{key}tokens"] = toks
        logits, aux = forward(params, jnp.asarray(toks))
        out[f"{key}forward"], out[f"{key}aux"] = (np.asarray(logits),
                                                  np.asarray(aux))

    if case == TIGHT:
        fwd("zeros_", np.zeros((BATCH, TIGHT_SEQ), np.int64))
        fwd("", rng.integers(0, jcfg.vocab_size, (BATCH, TIGHT_SEQ)))
        return out, params
    fwd("", rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)))
    if case == WIDE:
        return out, params
    steps = rng.integers(0, jcfg.vocab_size, (N_DECODE, BATCH, 1))
    logits_p, cache = jax.jit(jm.prefill)(params, jnp.asarray(out["tokens"]))
    decode, dec = jax.jit(jm.decode), []
    for tok in steps:
        logits, cache = decode(params, cache, jnp.asarray(tok))
        dec.append(np.asarray(logits))
    out.update(steps=steps, prefill=np.asarray(logits_p),
               decode=np.stack(dec))
    return out, params


class _References(dict):
    """JAX's answers by (configuration, case, depth), each computed when
    first asked."""

    def __missing__(self, key):
        self[key] = jax_reference(*key)
        return self[key]


@pytest.fixture(scope="module")
def refs():
    return _References()


@pytest.fixture(scope="module", params=MOE)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def reference(arch, refs):
    return refs[arch, None, None]


@pytest.fixture(scope="module")
def port(arch, reference):
    return convert.model_from_numpy(_cfgs(arch)[1], reference[1],
                                    device="cpu")


def _aux_close(got, want) -> bool:
    return abs(float(got) - float(want)) <= MODEL_RTOL * abs(float(want))


# ---------------------------------------------------------------- serving


def test_model_from_numpy_keeps_every_leaf(arch, reference, port):
    """Every JAX leaf lands on the port's layer modules with its layout:
    router (d, E), wi/wg (E, d, f), wo (E, f, d), Kimi-K2's shared expert
    nested under ``moe.shared``."""
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
    moe = port.groups[0].moe
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    assert moe.router.shape == (d, e) and moe.wi.shape == (e, d, f)
    assert moe.wo.shape == (e, f, d)
    assert hasattr(moe, "shared") == bool(cfg.n_shared_experts)
    if cfg.n_shared_experts:
        assert "groups.3.moe.shared.wg" in got


def test_forward_prefill_decode_match_jax(arch, reference, port):
    data, _ = reference
    with torch.no_grad():
        logits_f, aux = port(data["tokens"])
    assert logits_f.dtype == torch.float32 and aux.dtype == torch.float32
    assert _rel(logits_f, data["forward"]) <= MODEL_RTOL
    assert float(aux) > 0 and _aux_close(aux, data["aux"])
    logits_p, cache = port.prefill(data["tokens"])
    assert _rel(logits_p, data["prefill"]) <= MODEL_RTOL
    for step, want in zip(data["steps"], data["decode"]):
        logits_d, cache = port.decode(cache, step)
        assert _rel(logits_d, want) <= MODEL_RTOL
    assert cache["pos"] == SEQ + N_DECODE


def test_decode_matches_forward(arch, port):
    """tests/test_models.py:63-80 on the port at drop-free capacity: decode
    after prefill equals the forward over the extended sequence, twice;
    decode does not modify the cache it is given; no choice is dropped."""
    tokens = np.random.default_rng(5).integers(
        0, port.cfg.vocab_size, (BATCH, SEQ))
    with blocks.routing_stats() as stats:
        logits_p, cache = port.prefill(tokens)
        before = [c["k"].clone() for c in cache["groups"]]
        seq = torch.from_numpy(tokens)
        for _ in range(2):
            nt = logits_p[:, -1].argmax(-1, keepdim=True)
            logits_p, new = port.decode(cache, nt)
            assert all(torch.equal(a, c["k"]) for a, c in
                       zip(before, cache["groups"]))
            cache, before = new, [c["k"].clone() for c in new["groups"]]
            seq = torch.cat([seq, nt], 1)
            with torch.no_grad():
                logits_f, _ = port(seq)
            assert float((logits_f[:, -1] - logits_p[:, 0]).abs().max()) \
                < SELF_ATOL
    assert cache["pos"] == SEQ + 2
    # prefill, then two decodes and two forwards
    assert len(stats) == 5 * port.cfg.n_layers
    assert sum(int(st["dropped"]) for st in stats) == 0


def test_init_cache_decodes_like_the_forward(arch, port):
    """init_cache: min(cache_len, window) zero slots a layer; decoding one
    token from it is the forward of that token (aux dropped)."""
    cfg = port.cfg
    with pytest.raises(ValueError, match="cache_len"):
        port.init_cache(BATCH)
    empty = port.init_cache(BATCH, 100)
    slots = min(100, cfg.sliding_window or 100)
    assert len(empty["groups"]) == cfg.n_layers
    assert empty["groups"][0]["k"].shape == (BATCH, slots, cfg.n_kv_heads,
                                             cfg.head_dim_)
    tok = np.array([[7], [11]])
    logits, c = port.decode(empty, tok)
    with torch.no_grad():
        want, _ = port(tok)
    torch.testing.assert_close(logits, want, rtol=0, atol=SELF_ATOL)
    assert c["pos"] == 1


# ---------------------------------------------------------------- capacity


@pytest.mark.parametrize("tokens", ["zeros", "random"])
def test_tight_capacity_drops_match_jax(tokens, refs):
    """capacity_factor 0.5 (the reference's test_moe_capacity_drops_tokens:
    its 2 × 16 zero tokens, and random ones): choices are dropped in every
    layer, and the port keeps the ones JAX keeps: logits and aux against
    JAX."""
    data, params = refs["mixtral-8x7b", TIGHT, None]
    cfg = _cfgs("mixtral-8x7b", TIGHT)[1]
    model = convert.model_from_numpy(cfg, params, device="cpu")
    key = "zeros_" if tokens == "zeros" else ""
    with torch.no_grad(), blocks.routing_stats() as stats:
        logits, aux = model(data[f"{key}tokens"])
    assert bool(torch.isfinite(logits).all())
    assert len(stats) == cfg.n_layers
    assert all(int(st["dropped"]) > 0 for st in stats)
    assert _rel(logits, data[f"{key}forward"]) <= MODEL_RTOL
    assert _aux_close(aux, data[f"{key}aux"])


def test_wide_top4_matches_jax(refs):
    """16 experts, top-4, capacity_factor 1.25: each token's four outputs
    summed in ascending expert order, and some choices dropped."""
    data, params = refs["mixtral-8x7b", WIDE, None]
    cfg = _cfgs("mixtral-8x7b", WIDE)[1]
    model = convert.model_from_numpy(cfg, params, device="cpu")
    with torch.no_grad(), blocks.routing_stats() as stats:
        logits, aux = model(data["tokens"])
    assert sum(int(st["dropped"]) for st in stats) > 0
    assert all(st["topi"].shape == (BATCH * SEQ, 4) for st in stats)
    assert _rel(logits, data["forward"]) <= MODEL_RTOL
    assert _aux_close(aux, data["aux"])


def test_kept_slots_match_jax():
    """The (token, expert) pairs each expert keeps at a capacity of 5, with
    most tokens routed to the same two experts, against the JAX
    ``_moe_local``'s: expert e writes only columns [8e, 8e + 8) of the
    output (its ``wo`` zero elsewhere), so a block of JAX's output is
    non-zero exactly where the pair was kept.  ``jnp.argsort`` is stable:
    of an expert's choices the earliest tokens stay, which the port's
    stable sort reproduces and an unstable one would not."""
    jcfg, cfg = _cfgs("mixtral-8x7b")
    t, d, e, f, k, cap = 24, jcfg.d_model, jcfg.n_experts, 16, jcfg.top_k, 5
    rng = np.random.default_rng(3)
    u = rng.standard_normal(d)
    x = (rng.standard_normal((t, d)) + u).astype(np.float32)
    router = 0.1 * rng.standard_normal((d, e)).astype(np.float32)
    router[:, :2] += 4 * (u / (u @ u))[:, None]   # most tokens pick 0 and 1
    wo = np.zeros((e, f, d), np.float32)
    for j in range(e):
        wo[j, :, 8 * j:8 * j + 8] = rng.standard_normal((f, 8))
    p = dict(router=router, wo=wo,
             wi=rng.standard_normal((e, d, f)).astype(np.float32),
             wg=rng.standard_normal((e, d, f)).astype(np.float32))
    jcfg_f = dataclasses.replace(jcfg, moe_d_ff=f)
    out_j, aux_j = jblocks._moe_local(jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, p), jcfg_f,
                                      e, jnp.int32(0), cap)
    out_j = np.asarray(out_j)
    kept_j = {(i, j) for i in range(t) for j in range(e)
              if np.abs(out_j[i, 8 * j:8 * j + 8]).max() > 0}
    pt = types.SimpleNamespace(**{n: torch.from_numpy(a)
                                  for n, a in p.items()})
    out, aux = blocks._moe_local(torch.from_numpy(x), pt,
                                 dataclasses.replace(cfg, moe_d_ff=f), cap)
    topi = torch.topk(torch.softmax(torch.from_numpy(x @ router), -1), k,
                      -1).indices
    idx, valid, counts, _ = blocks.dispatch_slots(topi.reshape(-1), e, cap)
    kept = {(int(i) // k, j) for j in range(e)
            for i, ok in zip(idx[j], valid[j]) if ok}
    assert int(counts.max()) > cap                   # experts over capacity
    assert kept == kept_j
    assert _rel(out, out_j) <= MODEL_RTOL
    assert _aux_close(aux, aux_j)


def test_dispatch_slots_keep_each_experts_earliest_choices():
    """An expert over capacity keeps its choices in the order of the
    flattened (token, choice) index; empty slots hold T·k."""
    flat_e = torch.tensor([1, 0, 1, 2, 1, 0, 1, 1])
    idx, valid, counts, slot = blocks.dispatch_slots(flat_e, 4, 3)
    assert counts.tolist() == [2, 5, 1, 0]
    assert idx.tolist() == [[1, 5, 8], [0, 2, 4], [3, 8, 8], [8, 8, 8]]
    assert valid.sum(1).tolist() == [2, 3, 1, 0]
    assert slot.tolist() == [0, 0, 1, 0, 2, 1, 3, 4]


def test_routing_flips_are_found_and_measured(port):
    """chip_smoke.routing_flips, which moe_consistency holds decode to the
    forward with: none on the CPU's drop-free run; a decode step whose
    k-th and (k+1)-th router logits are swapped in one layer is found
    there, with the forward's margin between them and the logits' drift
    (both the size of the swap)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cfg = port.cfg
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 12))
    with blocks.routing_stats() as stats:
        logits_p, cache = port.prefill(tokens)
        seq = torch.from_numpy(tokens)
        for _ in range(2):
            nt = logits_p[:, -1].argmax(-1, keepdim=True)
            logits_p, cache = port.decode(cache, nt)
            seq = torch.cat([seq, nt], 1)
        with torch.no_grad():
            port(seq)
    k, n = cfg.top_k, cfg.n_layers
    assert chip_smoke.routing_flips(stats, n, 12, k) == [[], [], []]
    step = stats[2 * n + 1]                 # the second decode, layer 1
    logits = step["logits"].clone()
    order = logits[0].argsort(descending=True)
    hi, lo = logits[0, order[k - 1]].item(), logits[0, order[k]].item()
    logits[0, order[k - 1]], logits[0, order[k]] = lo, hi
    stats[2 * n + 1] = dict(step, logits=logits, topi=logits.topk(k).indices)
    flips = chip_smoke.routing_flips(stats, n, 12, k)
    assert [len(f) for f in flips] == [0, 0, 1]
    (flip,) = flips[2]
    assert flip["layer"] == 1
    # the forward's logits there are the decode's within float32 rounding
    assert flip["margin"] == pytest.approx(hi - lo, abs=1e-5)
    assert flip["drift"] == pytest.approx(hi - lo, abs=1e-5)


# ---------------------------------------------------------------- training


def _port_grads(model, batch):
    loss, metrics = model.loss(batch)
    named = dict(model.named_parameters())
    return loss, metrics, dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


@pytest.fixture(scope="module", params=MOE)
def grad_reference(request, refs):
    """jax.value_and_grad of the JAX Model.loss (NLL + 0.01 · aux), on
    JAX's weights and a numpy-drawn batch of GRAD_SEQ tokens."""
    arch = request.param
    jcfg, _ = _cfgs(arch)
    params = refs[arch, None, None][1]
    tokens = np.random.default_rng(21).integers(0, jcfg.vocab_size,
                                                (BATCH, GRAD_SEQ + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        JModel(jcfg).loss, has_aux=True))(params, jax.tree.map(jnp.asarray,
                                                                batch))
    return (arch, params, batch, float(loss), float(metrics["aux"]),
            jax.tree.map(np.asarray, grads))


def test_loss_and_every_gradient_match_jax(grad_reference):
    arch, params, batch, loss_j, aux_j, grads = grad_reference
    cfg = _cfgs(arch)[1]
    model = convert.model_from_numpy(cfg, params, device="cpu")
    loss, metrics, got = _port_grads(model, batch)
    assert abs(float(loss.detach()) - loss_j) <= 1e-5 * loss_j
    assert _aux_close(metrics["aux"].detach(), aux_j)
    names = [k for k, _ in flatten(grads)]
    # embed, final_norm, lm_head; ln1, ln2, wq/wk/wv/wo, router/wi/wg/wo,
    # the shared expert's wi/wg/wo
    assert len(names) == 3 + 2 + 4 + 4 + 3 * bool(cfg.n_shared_experts)
    for name, want in flatten(grads):
        head, _, rest = name.partition(".")
        g = got[name] if head != "groups" else torch.stack(
            [got[f"groups.{i}.{rest}"] for i in range(cfg.n_layers)])
        assert _rel(g, want) <= MODEL_RTOL, name


def test_remat_gives_the_same_bits(grad_reference):
    """Per-layer remat recomputes the same forward (the routing, the
    dispatch and the combine included): loss, aux and every gradient equal
    bit for bit."""
    arch, params, batch = grad_reference[:3]
    cfg = _cfgs(arch)[1]
    out = []
    for remat in (False, True):
        m = convert.model_from_numpy(dataclasses.replace(cfg, remat=remat),
                                     params, device="cpu")
        out.append(_port_grads(m, batch))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1]["aux"], out[1][1]["aux"])
    for name in out[0][2]:
        assert torch.equal(out[0][2][name], out[1][2][name]), name


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "recurrentgemma-2b"])
def test_launcher_trains_the_reduced_config_on_cpu(arch, capsys):
    out = launch_train.main(["--arch", arch, "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "8", "--device", "cpu"])
    assert out["final_step"] == 2
    assert all(np.isfinite(e["loss"]) for e in out["log"])
    assert "final step 2" in capsys.readouterr().out


def test_registry_carries_the_moe_and_hybrid_configs():
    for name in ("recurrentgemma-2b", "mixtral-8x7b", "kimi-k2-1t-a32b",
                 "whisper-base", "llama-3.2-vision-11b"):
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(jconfigs.get(name)), name
        Model(configs.get(name).reduced(), device="cpu")


# ---------------------------------------------------------------- fixture


def fixture_entries(refs) -> dict:
    """The npz's entries: per configuration at its FIXTURE_LAYERS depth
    its weights as bfloat16 bits (uint16), inputs, logits and aux; for
    Mixtral also the tight case's (same weights)."""
    out = {}
    for arch, layers in FIXTURE_LAYERS.items():
        data, params = refs[arch, None, layers]
        for name, a in flatten(params):
            out[f"{arch}/param/{name}"] = (
                np.asarray(a, np.float32).view(np.uint32) >> 16).astype(
                    np.uint16)
        for key in ("tokens", "steps", "forward", "aux", "prefill",
                    "decode"):
            out[f"{arch}/{key}"] = data[key]
    tight, _ = refs["mixtral-8x7b", TIGHT, FIXTURE_LAYERS["mixtral-8x7b"]]
    for key in ("tokens", "forward", "aux"):
        out[f"mixtral-8x7b/tight_{key}"] = tight[key]
    return out


def test_fixture_is_current(refs):
    """tests/data/torch_moe.npz equals what the JAX package computes."""
    want = fixture_entries(refs)
    fixture = np.load(FIXTURE)
    assert sorted(fixture.files) == sorted(want)
    for key, a in want.items():
        np.testing.assert_allclose(fixture[key], a, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_port_matches_the_fixture_on_cpu():
    """chip_smoke.py's moe_fixture check, run on the CPU."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    res = chip_smoke.moe_fixture(torch.device("cpu"))
    assert res["ok"], res


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    entries = fixture_entries(_References())
    np.savez_compressed(FIXTURE, **entries)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")

"""The port's audio (Whisper-base: an encoder and cross-attention decoder
layers) and VLM (Llama-3.2-Vision-11B: groups of one gated cross-attention
layer and dense layers) families held against the JAX package, on the CPU.

Both reduced (d_model 64, 4 heads, head dim 16, d_ff 128, vocab 512,
attention chunk 32, float32): Whisper-base at 2 encoder and 4 decoder
layers (gelu MLPs, 4 kv heads), Llama-3.2-Vision at 4 layers, 2 groups of
one cross-decoder layer and one dense layer (2 kv heads, 16 image tokens).
The JAX ``Model(cfg).init`` weights go to both packages, the port's through
``convert.model_from_numpy``.  The reference initialises the norms' scales
and each cross-attention ``gate`` to zero, and with ``tanh(0) = 0`` a fresh
model's logits do not depend on the source at all; so those leaves are
drawn with numpy (the scales 0.1 · normal, the gates ±U(0.5, 1)), and every
leaf is rounded to a bfloat16 value (kept in float32) so that the fixtures
hold it in two bytes.  The cases: Whisper over 40 encoder frames and the
VLM over its 16 image tokens and over 40, sources that the chunk of 32
does not divide (the padded keys masked).  The encoder's output, forward,
prefill logits and the whole cache (self and cross, under the reference's
keys), and two decodes are held to max |Δ| ≤ 1e-4 · max |JAX|, decode to
the port's own forward within 1e-3 (``tests/test_models.py``'s bound), the
loss and every gradient leaf, the encoder's included, to 1e-4 of max |JAX
leaf|, and remat to no remat bit for bit.

``tests/data/torch_audio.npz`` and ``tests/data/torch_vlm.npz`` carry the
JAX weights, inputs and logits of the first two cases, so that
``chip_smoke.py`` can hold the card to them without importing JAX;
``test_fixture_is_current`` checks that they still equal what JAX computes.
Regenerate them with ``PYTHONPATH=src python tests/test_torch_cross.py``.
"""
import dataclasses
import itertools
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
from repro_torch.data import cross_source, token_stream  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import (TrainLoop, TrainLoopConfig,  # noqa: E402
                               make_train_step)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = {"audio": "whisper-base", "vlm": "llama-3.2-vision-11b"}
SOURCE = {"audio": "enc_frames", "vlm": "image_embeds"}
FIXTURES = {f: ROOT / "tests" / "data" / f"torch_{f}.npz" for f in ARCHS}
# (family, source length): the fixtures' cases first
CASES = (("audio", 40), ("vlm", 16), ("vlm", 40))
BATCH, SEQ, N_DECODE = 2, 24, 2
GRAD_SEQ = 40                      # two attention chunks of 32
MODEL_RTOL = 1e-4      # max |Δ| / max |JAX|, float32
SELF_ATOL = 1e-3       # decode against forward (tests/test_models.py)
STACKED = ("groups", "enc_groups")


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfgs(family: str):
    return (jconfigs.get(ARCHS[family]).reduced(),
            configs.get(ARCHS[family]).reduced())


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def jax_params(family: str):
    """JAX's init(PRNGKey(0)) tree with numpy-drawn norm scales and gates,
    every leaf rounded to a bfloat16 value (float32 arrays)."""
    jcfg, _ = _cfgs(family)
    rng = np.random.default_rng(7)

    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        if "'scale'" in key:
            a = 0.1 * rng.standard_normal(np.shape(a))
        elif "'gate'" in key:
            a = (rng.uniform(0.5, 1.0, np.shape(a))
                 * rng.choice([-1.0, 1.0], np.shape(a)))
        return _bf16(a)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.tree.map(np.asarray, JModel(jcfg).init(
            jax.random.PRNGKey(0))))


def _source(family: str, n: int, seed: int) -> np.ndarray:
    d = _cfgs(family)[0].d_model
    return np.random.default_rng(seed).standard_normal(
        (BATCH, n, d)).astype(np.float32)


def jax_reference(family: str, n_src: int, params) -> dict:
    """The JAX model's answers for a source of ``n_src`` positions: the
    encoder's output (audio), forward, prefill (logits and cache) and two
    decodes."""
    jcfg, _ = _cfgs(family)
    jm = JModel(jcfg)
    rng = np.random.default_rng(10 + n_src)
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)),
           "steps": rng.integers(0, jcfg.vocab_size, (N_DECODE, BATCH, 1)),
           SOURCE[family]: _source(family, n_src, 20 + n_src)}
    extra = {SOURCE[family]: jnp.asarray(out[SOURCE[family]])}
    if family == "audio":
        out["enc_out"] = np.asarray(jax.jit(jm._encode)(
            params, extra["enc_frames"]))
    logits, aux = jax.jit(jm.forward)(params, jnp.asarray(out["tokens"]),
                                      extra)
    out["forward"], out["aux"] = np.asarray(logits), np.asarray(aux)
    logits, cache = jax.jit(jm.prefill)(params, jnp.asarray(out["tokens"]),
                                        extra)
    out["prefill"], out["cache"] = np.asarray(logits), jax.tree.map(
        np.asarray, cache)
    decode, steps = jax.jit(jm.decode), []
    for tok in out["steps"]:
        logits, cache = decode(params, cache, jnp.asarray(tok))
        steps.append(np.asarray(logits))
    out["decode"] = np.stack(steps)
    return out


class _References(dict):
    """JAX's weights by family, JAX's answers by (family, source length)."""

    def __missing__(self, key):
        if isinstance(key, str):
            self[key] = jax_params(key)
        else:
            self[key] = jax_reference(*key, self[key[0]])
        return self[key]


@pytest.fixture(scope="module")
def refs():
    return _References()


@pytest.fixture(scope="module", params=tuple(ARCHS))
def family(request):
    return request.param


@pytest.fixture(scope="module")
def port(family, refs):
    return convert.model_from_numpy(_cfgs(family)[1], refs[family],
                                    device="cpu")


def _unstacked(tree: dict) -> dict:
    """The port's per-entry names of a stacked reference tree."""
    out = {}
    for name, leaf in flatten(tree):
        head, _, rest = name.partition(".")
        if head in STACKED:
            out.update({f"{head}.{i}.{rest}": np.asarray(leaf)[i]
                        for i in range(np.shape(leaf)[0])})
        else:
            out[name] = leaf
    return out


def _extra(family: str, data: dict) -> dict:
    return {SOURCE[family]: torch.from_numpy(data[SOURCE[family]])}


# ---------------------------------------------------------------- weights


def test_registry_carries_the_cross_configs():
    for name in ARCHS.values():
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(jconfigs.get(name)), name


def test_model_from_numpy_keeps_every_leaf(family, refs, port):
    """Every JAX leaf lands on the port's modules: ``enc_groups.<i>.*`` and
    ``enc_norm`` for audio, ``groups.<i>.cross.*`` and ``groups.<i>.self.
    <j>.*`` for the VLM."""
    want = _unstacked(refs[family])
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), leaf,
                                      err_msg=name)
    if family == "audio":
        assert len(port.groups) == 4 and len(port.enc_groups) == 2
        assert port.groups[3].xattn.gate.shape == ()
        assert "wg" not in dict(port.groups[0].mlp.named_parameters())
    else:
        assert len(port.groups) == 2 and len(port.groups[1].self) == 1
        assert port.groups[1].cross.xattn.wk.shape == (64, 2, 16)


def test_other_families_are_refused():
    cfg = dataclasses.replace(_cfgs("vlm")[1], family="diffusion")
    with pytest.raises(ValueError, match="'diffusion'"):
        Model(cfg, device="cpu")


# ---------------------------------------------------------------- serving


def test_encoder_matches_jax(refs):
    data = refs["audio", 40]
    port = convert.model_from_numpy(_cfgs("audio")[1], refs["audio"],
                                    device="cpu")
    with torch.no_grad():
        enc = port._encode(torch.from_numpy(data["enc_frames"]))
    assert enc.shape == (BATCH, 40, 64)
    assert _rel(enc, data["enc_out"]) <= MODEL_RTOL


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_forward_prefill_decode_match_jax(case, refs):
    """Forward, prefill logits, the whole cache (the reference's keys and
    shapes: per audio layer ``self`` and ``cross``, per VLM group
    ``cross``, ``xself`` and ``self``), two decodes; each decode hands the
    cross k and v on as they are."""
    family, n_src = case
    data = refs[case]
    port = convert.model_from_numpy(_cfgs(family)[1], refs[family],
                                    device="cpu")
    extra = _extra(family, data)
    with torch.no_grad():
        logits_f, aux = port(data["tokens"], extra)
    assert float(aux) == 0.0 and float(data["aux"]) == 0.0
    assert _rel(logits_f, data["forward"]) <= MODEL_RTOL
    logits_p, cache = port.prefill(data["tokens"], extra)
    assert _rel(logits_p, data["prefill"]) <= MODEL_RTOL
    want = _unstacked({k: v for k, v in data["cache"].items() if k != "pos"})
    got = dict(flatten({k: v for k, v in cache.items() if k != "pos"}))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.shape == want[name].shape, name
        assert _rel(t, want[name]) <= MODEL_RTOL, name
    assert cache["groups"][0]["cross"]["k"].shape[1] == n_src
    cross = [g["cross"]["k"] for g in cache["groups"]]
    for step, want_d in zip(data["steps"], data["decode"]):
        logits_d, cache = port.decode(cache, step)
        assert _rel(logits_d, want_d) <= MODEL_RTOL
    assert all(g["cross"]["k"] is k for g, k in zip(cache["groups"], cross))
    assert cache["pos"] == SEQ + N_DECODE


def test_decode_matches_forward(family, refs, port):
    """tests/test_models.py:63-80 on the port: decode after prefill equals
    the forward over the extended sequence with the same source; decode
    does not modify the cache it is given."""
    data = refs[family, 40]
    extra = _extra(family, data)
    tokens = torch.from_numpy(data["tokens"])
    logits_p, cache = port.prefill(tokens, extra)
    groups = cache["groups"]
    before = (groups[-1]["self"] if family == "audio"
              else groups[-1]["self"][0])["k"].clone()
    seq = tokens
    for _ in range(2):
        nt = logits_p[:, -1].argmax(-1, keepdim=True)
        logits_p, nxt = port.decode(cache, nt)
        seq = torch.cat([seq, nt], 1)
        with torch.no_grad():
            logits_f, _ = port(seq, extra)
        assert float((logits_f[:, -1] - logits_p[:, 0]).abs().max()) \
            < SELF_ATOL
        assert nxt["pos"] == cache["pos"] + 1
        cache = nxt
    after = (groups[-1]["self"] if family == "audio"
             else groups[-1]["self"][0])["k"]
    assert torch.equal(before, after)


def test_logits_depend_on_the_source(family, refs, port):
    """Other frames or image embeddings give other logits; with the gates
    at the reference's init of 0 they give the same."""
    data = refs[family, 40]
    other = {SOURCE[family]: torch.from_numpy(_source(family, 40, 99))}
    with torch.no_grad():
        a, _ = port(data["tokens"], _extra(family, data))
        b, _ = port(data["tokens"], other)
        assert float((a - b).abs().max()) > 1e-3 * float(a.abs().max())
        closed = dict(port.named_parameters())
        closed = {n: torch.zeros_like(t) if n.endswith(".gate") else t
                  for n, t in closed.items()}
        shut = Model(port.cfg, device="cpu", params=closed)
        assert torch.equal(shut(data["tokens"], _extra(family, data))[0],
                           shut(data["tokens"], other)[0])
    with pytest.raises(ValueError, match=SOURCE[family]):
        port(data["tokens"])


def test_init_cache_has_the_reference_layout(family, port):
    """init_cache: the reference's keys, shapes and dtypes: per decoder
    layer (audio) or group (VLM) zero cross k and v of ``extra_len``
    slots beside the self-attention's ``cache_len``.  Decoding from it is
    not held to the forward: its cross k and v are zeros, not a source's,
    in the reference too."""
    jcfg, cfg = _cfgs(family)
    with pytest.raises(ValueError, match="cache_len"):
        port.init_cache(BATCH)
    want = jax.tree.map(np.asarray, JModel(jcfg).init_cache(BATCH, 100, 40))
    want = _unstacked({k: v for k, v in want.items() if k != "pos"})
    empty = port.init_cache(BATCH, 100, 40)
    got = dict(flatten({k: v for k, v in empty.items() if k != "pos"}))
    assert sorted(got) == sorted(want) and empty["pos"] == 0
    for name, t in got.items():
        assert t.shape == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
        assert not t.any(), name
    logits, c = port.decode(empty, np.array([[7], [11]]))
    assert bool(torch.isfinite(logits).all()) and c["pos"] == 1


# ---------------------------------------------------------------- training


def _port_grads(model, batch, extra):
    loss, _ = model.loss(batch, extra)
    named = dict(model.named_parameters())
    return loss, dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


@pytest.fixture(scope="module")
def grad_reference(family, refs):
    """jax.value_and_grad of the JAX Model.loss, on JAX's weights, a
    numpy-drawn batch of GRAD_SEQ tokens and the case's source."""
    jcfg, _ = _cfgs(family)
    params = refs[family]
    tokens = np.random.default_rng(21).integers(0, jcfg.vocab_size,
                                                (BATCH, GRAD_SEQ + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    extra = {SOURCE[family]: _source(family, 40 if family == "audio" else 16,
                                     31)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        JModel(jcfg).loss, has_aux=True))(
            params, jax.tree.map(jnp.asarray, batch),
            jax.tree.map(jnp.asarray, extra))
    return params, batch, extra, float(loss), jax.tree.map(np.asarray, grads)


def test_loss_and_every_gradient_match_jax(family, grad_reference):
    """The loss and every gradient leaf; the encoder's and the gates' are
    not zero."""
    params, batch, extra, loss_j, grads = grad_reference
    model = convert.model_from_numpy(_cfgs(family)[1], params, device="cpu")
    loss, got = _port_grads(model, batch, {k: torch.from_numpy(v)
                                           for k, v in extra.items()})
    assert abs(float(loss.detach()) - loss_j) <= 1e-5 * loss_j
    want = _unstacked(grads)
    assert sorted(got) == sorted(want)
    for name, w in flatten(grads):
        head, _, rest = name.partition(".")
        g = got[name] if head not in STACKED else torch.stack(
            [got[f"{head}.{i}.{rest}"] for i in range(np.shape(w)[0])])
        assert _rel(g, w) <= MODEL_RTOL, name
    watched = [n for n in got if n.startswith("enc_") or n.endswith("gate")]
    assert watched and all(float(got[n].abs().max()) > 0 for n in watched)


def test_remat_gives_the_same_bits(family, grad_reference):
    """Per-group remat, the source an input of each recomputed group:
    loss and every gradient equal bit for bit."""
    params, batch, extra = grad_reference[:3]
    extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    cfg = _cfgs(family)[1]
    out = []
    for remat in (False, True):
        m = convert.model_from_numpy(dataclasses.replace(cfg, remat=remat),
                                     params, device="cpu")
        out.append(_port_grads(m, batch, extra))
    assert torch.equal(out[0][0], out[1][0])
    for name in out[0][1]:
        assert torch.equal(out[0][1][name], out[1][1][name]), name


def test_train_loop_moves_every_leaf(family):
    """Two AdamW steps through ``TrainLoop.run(data, extra)``: losses
    finite, every parameter (the encoder's and the gates' included)
    moved, the optimizer state in the reference's layout (``enc_groups.
    attn.wq`` with its layer axis first)."""
    cfg = dataclasses.replace(_cfgs(family)[1], remat=True)
    gen = torch.Generator().manual_seed(0)
    model = Model(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gate"):
                p.fill_(0.5)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw()
    loop = TrainLoop(TrainLoopConfig(total_steps=2, log_every=1),
                     make_train_step(model, opt), model, opt[0](model))
    res = loop.run(itertools.islice(token_stream(gen, cfg.vocab_size, 2, 16),
                                    2), cross_source(cfg, gen, 2, 16))
    assert all(np.isfinite(e["loss"]) for e in res["log"])
    for name, p in model.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name
    want = {k: v.shape for k, v in flatten(jax.eval_shape(
        JModel(_cfgs(family)[0]).init, jax.random.PRNGKey(0)))}
    assert {k: tuple(v.shape) for k, v in loop.opt_state.mu.items()} == want


@pytest.mark.parametrize("arch", tuple(ARCHS.values()))
def test_launcher_trains_the_reduced_config_on_cpu(arch, capsys):
    """The launcher draws the stub frontend's frames or image embeddings
    (``data.cross_source``) and trains."""
    out = launch_train.main(["--arch", arch, "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "8", "--device", "cpu",
                             "--microbatches", "2"])
    assert out["final_step"] == 2
    assert all(np.isfinite(e["loss"]) for e in out["log"])
    assert "final step 2" in capsys.readouterr().out


# ---------------------------------------------------------------- fixture


def fixture_entries(refs, family: str) -> dict:
    """A fixture's entries (the family's first case): the weights as
    bfloat16 bits (uint16), the inputs (tokens, decode steps, the source)
    and the logits."""
    case = next(c for c in CASES if c[0] == family)
    data = refs[case]
    out = {f"param/{name}": (np.asarray(a, np.float32).view(np.uint32)
                             >> 16).astype(np.uint16)
           for name, a in flatten(refs[family])}
    for key in ("tokens", "steps", SOURCE[family], "forward", "prefill",
                "decode"):
        out[key] = data[key]
    return out


def test_fixture_is_current(family, refs):
    """tests/data/torch_<family>.npz equals what the JAX package
    computes."""
    want = fixture_entries(refs, family)
    fixture = np.load(FIXTURES[family])
    assert sorted(fixture.files) == sorted(want)
    for key, a in want.items():
        np.testing.assert_allclose(fixture[key], a, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_port_matches_the_fixture_on_cpu(family):
    """chip_smoke.py's audio_fixture and vlm_fixture checks, run on the
    CPU."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    res = chip_smoke.cross_fixture(torch.device("cpu"), family)
    assert res["ok"], res


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    references = _References()
    for fam, path in FIXTURES.items():
        np.savez_compressed(path, **fixture_entries(references, fam))
        print(f"wrote {path} ({path.stat().st_size} bytes)")

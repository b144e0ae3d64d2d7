"""The port's optimizers, train step, loop, token stream and launcher,
held against the JAX package and to the reference's contracts, on the CPU.

The optimizers run on the JAX gradients of ``tests/data/torch_mamba_train.npz``
(the reduced ``falcon-mamba-7b``; ``tests/test_torch_train.py`` checks that
the fixture is current) from the same state (``convert.opt_state_from_numpy``)
as the JAX ``adamw``/``adafactor``: the same float32 operations, so the
parameters and states are held to 1e-6 of max |JAX| (``OPT_RTOL``).  The
train step's own gradients differ from JAX's in the last bits (the scans sum
in other orders), and at step 1 AdamW moves every element by about ±lr
whatever the gradient's size, so an element whose gradient is at noise level
could move the other way: the step's semantics (microbatches, compression,
``grad_norm``) are held on the gradients, at their tolerance, not on the
parameters after a step.
"""
import itertools
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, tree_leaves  # noqa: E402
from repro_torch.data import token_stream  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.optim import (AdafactorState, AdamWState, adafactor,  # noqa
                               adamw)
from repro_torch.optim._tree import zeros_like_tree  # noqa: E402
from repro_torch.train import (TrainLoop, TrainLoopConfig,  # noqa: E402
                               make_train_step)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "torch_mamba_train.npz"
ARCH = "falcon-mamba-7b"
OPT_RTOL = 1e-6        # optimizer on the same gradients, see the docstring
GRAD_RTOL = 1e-4       # the port's gradients against JAX's / each other


def _rel(got, want) -> float:
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / scale) if scale else \
        float(np.max(np.abs(got)))


def _tree(data, prefix):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke._tree(data, prefix)


@pytest.fixture(scope="module")
def fixture():
    data = np.load(FIXTURE)
    return {p: _tree(data, p) for p in ("param/", "grad/")}, data


def _cfg():
    return configs.get(ARCH).reduced()


def _stack(named: dict, name: str, n_layers: int):
    head, _, rest = name.partition(".")
    if head != "groups":
        return named[name]
    return torch.stack([named[f"groups.{i}.{rest}"] for i in range(n_layers)])


# ---------------------------------------------------------------- optimizers


@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizer_matches_jax(fixture, which, updates):
    """``updates`` updates on JAX's gradients from JAX's state (carried by
    convert.opt_state_from_numpy) against JAX's: every parameter and state
    leaf within OPT_RTOL, in the reference's layout (stacked layers)."""
    trees, _ = fixture
    cfg = _cfg()
    jopt = {"adamw": jadamw(lr=1e-3), "adafactor": jadafactor()}[which]
    topt = {"adamw": adamw(lr=1e-3), "adafactor": adafactor()}[which]
    jp = jax.tree.map(jnp.asarray, trees["param/"])
    jg = jax.tree.map(jnp.asarray, trees["grad/"])
    jstate = jopt[0](jp)
    # a state that is not zero: one update on half the gradients first
    jp, jstate = jopt[1](jax.tree.map(lambda g: 0.5 * g, jg), jstate, jp)
    model = convert.model_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    state = convert.opt_state_from_numpy(
        type(jstate)(*(jax.tree.map(np.asarray, f) for f in jstate)),
        device="cpu")
    assert isinstance(state, AdamWState if which == "adamw"
                      else AdafactorState)
    grads = convert.params_from_numpy(cfg, trees["grad/"], "cpu")
    update = jax.jit(jopt[1])
    for _ in range(updates):
        jp, jstate = update(jg, jstate, jp)
        model, state = topt[1](grads, state, model)
    assert int(state.step) == int(jstate.step) == updates + 1
    named = dict(model.named_parameters())
    for name, want in flatten(jax.tree.map(np.asarray, jp)):
        assert _rel(_stack(named, name, cfg.n_layers), want) <= OPT_RTOL, name
    for field in type(state)._fields[1:]:
        for name, want in flatten(jax.tree.map(np.asarray,
                                               getattr(jstate, field))):
            assert _rel(getattr(state, field)[name], want) <= OPT_RTOL, \
                (field, name)


def test_optimizer_state_layout_is_the_references(fixture):
    """init builds the reference's tree: one leaf per reference leaf, the
    layer axis first; Adafactor factors a per-layer vector over (layer,
    channel) as the reference's stacked leaf is factored."""
    trees, _ = fixture
    cfg = _cfg()
    model = convert.model_from_numpy(cfg, trees["param/"], device="cpu")
    jp = jax.tree.map(jnp.asarray, trees["param/"])
    for topt, jopt in ((adamw(), jadamw()), (adafactor(), jadafactor())):
        state, jstate = topt[0](model), jopt[0](jp)
        for field in type(state)._fields[1:]:
            want = dict(flatten(getattr(jstate, field)))
            got = getattr(state, field)
            assert sorted(got) == sorted(want)
            for name in want:
                assert tuple(got[name].shape) == tuple(want[name].shape)
    vr = adafactor()[0](model).vr["groups.mamba.dt_bias"]
    assert tuple(vr.shape) == (cfg.n_layers,)


# ---------------------------------------------------------------- the step


class _Capture:
    """An optimizer that changes nothing and keeps the gradients it got."""

    def __init__(self):
        self.grads = None

    def pair(self):
        def update(grads, state, params):
            self.grads = {k: v.detach().clone() for k, v in grads.items()}
            return params, state
        return (lambda params: None), update


@pytest.fixture(scope="module")
def port_model(fixture):
    trees, data = fixture
    model = convert.model_from_numpy(_cfg(), trees["param/"], device="cpu")
    batch = {k: torch.as_tensor(data[k]) for k in ("tokens", "labels")}
    return model, batch


def test_microbatches_accumulate_the_full_gradient(port_model):
    """microbatches=2 against 1 on one batch: the gradients (float32
    accumulators, divided) within 1e-4 of max |leaf|, as the reference's
    test_microbatched_step_matches_full holds its parameters; the loss the
    mean of the two halves'."""
    model, batch = port_model
    out = {}
    for mb in (1, 2):
        cap = _Capture()
        step = make_train_step(model, cap.pair(), microbatches=mb)
        _, _, metrics = step(model, None, batch)
        out[mb] = cap.grads, metrics
    g1, m1 = out[1]
    g2, m2 = out[2]
    assert all(g.dtype == torch.float32 for g in g2.values())
    for name in g1:
        assert _rel(g2[name], g1[name].numpy()) <= GRAD_RTOL, name
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5
    with pytest.raises(ValueError, match="multiple"):
        make_train_step(model, _Capture().pair(), microbatches=3)(
            model, None, batch)


def test_grad_norm_and_compression_match_jax(fixture, port_model):
    """grad_norm within GRAD_RTOL of JAX's on JAX's gradients; with
    compress_grads the gradient the optimizer sees and the new residual
    equal JAX's ef_compress_tree on the same gradients and residual (one
    quantization step apart at most: the same scale, a quotient that can
    round the other way)."""
    trees, data = fixture
    model, batch = port_model
    cfg = _cfg()
    jg = trees["grad/"]
    want_norm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                            for _, g in flatten(jg)))
    cap = _Capture()
    _, _, metrics = make_train_step(model, cap.pair())(model, None, batch)
    assert abs(float(metrics["grad_norm"]) - want_norm) <= GRAD_RTOL * \
        want_norm
    assert set(metrics) == {"loss", "nll", "aux", "grad_norm"}
    # ef_compress_tree on the same numbers, with a residual
    rng = np.random.default_rng(11)
    grads = convert.params_from_numpy(cfg, jg, "cpu")
    resid = {k: torch.from_numpy((1e-3 * rng.standard_normal(v.shape))
                                 .astype(np.float32))
             for k, v in grads.items()}
    deq, res = compression.ef_compress_tree(grads, resid)
    for name in grads:
        jd, jr = jcomp.ef_compress_tree({"g": jnp.asarray(grads[name])},
                                        {"g": jnp.asarray(resid[name])})
        _, scale = compression.quantize_int8(grads[name] + resid[name])
        step_ = float(scale)
        np.testing.assert_allclose(deq[name].numpy(), np.asarray(jd["g"]),
                                   rtol=0, atol=1.01 * step_, err_msg=name)
        np.testing.assert_allclose(res[name].numpy(), np.asarray(jr["g"]),
                                   rtol=0, atol=1.01 * step_, err_msg=name)
    # the step with compress_grads: (inner, residual) state; the optimizer
    # sees ef_compress_tree of the step's own gradients
    raw = _Capture()
    make_train_step(model, raw.pair())(model, None, batch)
    cap = _Capture()
    state0 = (None, zeros_like_tree(model))
    _, (_, new_res), _ = make_train_step(
        model, cap.pair(), compress_grads=True)(model, state0, batch)
    want_deq, want_res = compression.ef_compress_tree(raw.grads, state0[1])
    for name in raw.grads:
        assert torch.equal(cap.grads[name], want_deq[name]), name
        assert torch.equal(new_res[name], want_res[name]), name


# ---------------------------------------------------------------- the loop


def _setup(seed=0, lr=3e-3):
    cfg = _cfg()
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    opt = adamw(lr=lr)
    return model, opt, make_train_step(model, opt)


def _data():
    return token_stream(torch.Generator().manual_seed(1),
                        _cfg().vocab_size, 4, 8)


def test_loss_decreases():
    model, opt, step = _setup()
    loop = TrainLoop(TrainLoopConfig(total_steps=20, log_every=1), step,
                     model, opt[0](model))
    out = loop.run(itertools.islice(_data(), 30))
    losses = [e["loss"] for e in out["log"]]
    assert out["final_step"] == 20 and len(losses) == 20
    assert losses[-1] < losses[0]


def test_resume_from_checkpoint(tmp_path):
    """Six steps with a checkpoint every three; a new loop with the same
    arguments resumes at step 6 with the saved parameters and AdamW state
    bit for bit, then runs on to 10."""
    model, opt, step = _setup()
    loop1 = TrainLoop(TrainLoopConfig(total_steps=6, ckpt_every=3,
                                      ckpt_dir=str(tmp_path), log_every=1),
                      step, model, opt[0](model))
    loop1.run(itertools.islice(_data(), 10))
    fresh, _, step2 = _setup()
    loop2 = TrainLoop(TrainLoopConfig(total_steps=10, ckpt_every=3,
                                      ckpt_dir=str(tmp_path), log_every=1),
                      step2, fresh, opt[0](fresh))
    assert loop2.start_step == 6
    for (n1, a), (n2, b) in zip(model.named_parameters(),
                                fresh.named_parameters()):
        assert n1 == n2 and torch.equal(a, b), n1
    assert isinstance(loop2.opt_state, AdamWState)
    s1, s2 = tree_leaves(loop1.opt_state), tree_leaves(loop2.opt_state)
    assert len(s1) == len(s2) and all(torch.equal(a, b)
                                      for a, b in zip(s1, s2))
    out = loop2.run(itertools.islice(_data(), 10))
    assert out["final_step"] == 10


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_checkpoint_round_trips_optimizer_states(tmp_path, which):
    """CheckpointManager.save then restore gives back the NamedTuple state
    as its own class, every leaf equal."""
    model = Model(_cfg(), device="cpu",
                  generator=torch.Generator().manual_seed(2))
    opt = {"adamw": adamw(), "adafactor": adafactor()}[which]
    state = opt[0](model)
    state = type(state)(state.step + 3, *(
        {k: v + i for k, v in tree.items()}
        for i, tree in enumerate(state[1:], 1)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"opt": state, "note": (state.step, [state.step])})
    back = mgr.restore(3, {"opt": opt[0](model),
                           "note": (state.step, [state.step])}, device="cpu")
    assert type(back["opt"]) is type(state)
    assert isinstance(back["note"], tuple) and isinstance(back["note"][1],
                                                          list)
    for a, b in zip(tree_leaves(state), tree_leaves(back["opt"])):
        assert torch.equal(a, b)


def test_straggler_counted_on_an_injected_slow_step():
    """A step 20× slower than the EWMA of the others is counted once."""
    calls = []

    def step_fn(params, state, batch, extra=None):
        calls.append(1)
        time.sleep(0.2 if len(calls) == 6 else 0.01)
        return params, state, {"loss": torch.zeros(())}

    loop = TrainLoop(TrainLoopConfig(total_steps=8, log_every=100), step_fn,
                     {"w": torch.zeros(1)}, None)
    out = loop.run(iter(range(20)))
    assert out["final_step"] == 8 and out["straggler_steps"] == 1
    assert len(out["log"]) == 1 and out["ewma_sec_per_step"] > 0


# ---------------------------------------------------------------- data


def test_token_stream():
    """Shapes, the one-token shift, the same draws for the same seed (other
    draws for another), and the Zipf-ish unigram's order: lower ids more
    frequent."""
    v = 512
    a = next(token_stream(torch.Generator().manual_seed(3), v, 4, 16))
    b = next(token_stream(torch.Generator().manual_seed(3), v, 4, 16))
    c = next(token_stream(torch.Generator().manual_seed(4), v, 4, 16))
    assert a["tokens"].shape == a["labels"].shape == (4, 16)
    assert a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    it = token_stream(torch.Generator().manual_seed(5), v, 64, 256)
    toks = torch.cat([next(it)["tokens"].reshape(-1) for _ in range(4)])
    counts = torch.bincount(toks, minlength=v).double()
    assert counts[0] > counts[1] > counts[4] > counts[32] > counts[256]
    p = torch.softmax(-torch.log1p(torch.arange(v, dtype=torch.float64)), 0)
    assert abs(float(counts[0] / counts.sum()) - float(p[0])) < 0.01


# ---------------------------------------------------------------- launcher


def test_launcher_refuses_a_mesh():
    """``--mesh 2x2`` is the 16 × 16 production mesh, as in the
    reference's launcher: on the CPU it raises, naming the 256 devices it
    needs; nothing falls back to the CPU or to repeated devices."""
    with pytest.raises(ValueError, match="256"):
        launch_train.main(["--mesh", "2x2", "--reduced", "--device", "cpu"])


def test_launcher_runs_two_reduced_steps_on_cpu(capsys):
    out = launch_train.main(["--reduced", "--steps", "2", "--batch", "2",
                             "--seq", "8", "--device", "cpu"])
    assert out["final_step"] == 2
    assert "final step 2" in capsys.readouterr().out


def test_serve_steps_are_the_models_entry_points():
    """make_serve_steps: prefill_step and decode_step run the model's
    prefill and decode on the model given as params; a params that is not
    a model is refused."""
    from repro_torch.train import make_serve_steps
    model = Model(_cfg(), device="cpu",
                  generator=torch.Generator().manual_seed(3))
    prefill_step, decode_step = make_serve_steps(model)
    tokens = np.arange(12).reshape(2, 6)
    logits, cache = prefill_step(model, tokens)
    want, want_cache = model.prefill(tokens)
    assert torch.equal(logits, want) and cache["pos"] == 6
    step, cache2 = decode_step(model, cache, tokens[:, :1])
    assert torch.equal(step, model.decode(want_cache, tokens[:, :1])[0])
    assert cache2["pos"] == 7
    with pytest.raises(TypeError, match="model"):
        prefill_step(dict(model.named_parameters()), tokens)

"""The port's examples (``repro_torch.examples``) held against the JAX
package's (``examples/*.py``), on the CPU, in-process.

Each example runs with ``--device cpu`` at its smallest size and prints the
reference's lines (each line against the reference's format string, with
the numbers as patterns), but for ``ridge_cv``'s ``--tune`` section, whose
lines follow the port's own format: the port's tuner prices launch plans
where the reference's lowers and times candidates, and the section prints
what the port's tuner carries.  Without ``--device`` and without a card
each example raises.  On the same arrays: ``quickstart``'s relative error agrees with
the reference's to 1e-8 (the reference's own example, run on JAX's draws);
``ridge_cv``'s algorithms (the r-SVD excepted, whose test matrix is drawn
by ``torch.Generator``) and ``lm_probe``'s two CV runs select the reference
functions' λ* index; ``serve_lm``'s prefill logits agree with the JAX
model's on its weights within ``tests/test_torch_dense.py``'s
``MODEL_RTOL``.  The JAX sides are computed once per module.
"""
import contextlib
import io
import os
import re
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import cv as jcv  # noqa: E402
from repro.data import make_regression_dataset as jdataset  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.examples import (lm_probe, quickstart, ridge_cv,  # noqa
                                  serve_cv, serve_lm, train_lm)

ROOT = Path(__file__).resolve().parent.parent
MODEL_RTOL = 1e-4          # tests/test_torch_dense.py
QUICKSTART_TOL = 1e-8      # |relative error − the reference's|
RIDGE_H, RIDGE_N = 48, 360  # the smallest size with an interior λ*
NUM = r"-?[\d.]+(?:e[-+]\d+)?"
INT = r"\d+"

# each example's printed lines, the reference's format strings with their
# numbers as patterns (one entry a line; (pattern, repeats) for a line the
# reference prints once per item)
FORMATS = {
    "quickstart": [rf"swept {INT} λ values with {INT} factorizations",
                   rf"max relative solution error vs exact: {NUM}"],
    "serve_lm": [rf"arch=\S+ batch={INT} prompt={INT}",
                 rf"prefill: {NUM} ms   decode: {NUM} ms/token   {INT} tok/s",
                 rf"first generated ids: \[{INT}(, {INT})*\]"],
    "lm_probe": [rf"arch=\S+  features=\({INT}, {INT}\)",
                 rf"exact   CV: λ\*={NUM} err={NUM}  \({INT} factorizations\)",
                 rf"piChol  CV: λ\*={NUM} err={NUM}  \({INT} factorizations\)"],
    "serve_cv": [rf"requests={INT} tenants={INT} problems={INT} h={INT}",
                 rf"p50 {INT} ms   p99 {INT} ms   {NUM} req/s   {INT} "
                 rf"dispatches \(mean batch {NUM}\)",
                 rf"cache: hit_rate={NUM} entries={INT} evictions={INT}",
                 (rf"  tenant-{INT}: {INT} served, hit_rate={NUM}, λ\* "
                  rf"\[('{NUM}'(, )?)*\]", None)],
    "train_lm": [rf"arch=\S+ params≈{NUM}M \(preset=\w+\)",
                 (rf"step +{INT}  loss {NUM}  {NUM}s/step", None),
                 rf"done at step {INT}; straggler steps: {INT}"],
}
ROW = rf"\S+ +{NUM} +{NUM} +{NUM} +{INT}"
# the reference's lines, but for the --tune section: the port's own
RIDGE_FORMAT = [
    r"algo +time\(s\) +min holdout +selected λ +#chol", (ROW, 6), "",
    r"--mesh: only one device visible; .*", "",
    rf"CVEngine \(backend=auto, mesh=auto, {INT} device\(s\)\):", (ROW, 5),
    "", rf"Autotune \(lattice priced from launch plans, {INT} plans priced, "
    r"0 executions\):",
    rf"  chosen: block={INT} lam_chunk={INT} mesh=None predicted={NUM}s "
    r"\[tuned\]",
    rf"  first tuned run \(incl. tuning\) +{NUM}s, warm tuned +{NUM}s vs "
    rf"default +{NUM}s",
    r"  tuning cache: \{'entries': 1, 'hits': 1, 'misses': 1, "
    rf"'lowerings': {INT}\}}", "",
    r"FactorCache warm replay \(PiCholesky, g=4\):",
    (rf"\S+ \S+ +{NUM} +{NUM} +{NUM} +{INT}  \[(miss|hit)\]", 3), "",
    rf"Adaptive λ-search \(dense q=96 vs wave={INT}, tol={NUM} decades\):",
    rf"  dense +{NUM}s λ\*= *{NUM}  96 evaluations",
    rf"  search +{NUM}s λ\*= *{NUM}  {INT} evaluations \({NUM}x\) in {INT} "
    rf"waves, stopped on \w+, gap {NUM} decades",
    r"  interpolant: \w+/r\d+ by LOO \(anchor targets: \w+\)",
    rf"  anchor advice \(probe d=24\): weakest interval \[{NUM}, {NUM}\] → "
    rf"next anchor ≈ {NUM}", "",
    rf"Sketched anchors \(countsketch, n={INT} ≫ h={INT}, dense λ\*={NUM}\):",
    r" +m +time\(s\) +max curve diff +regret on dense +selected λ",
    (rf" *{INT} +{NUM} +{NUM} +{NUM} +{NUM}", 2), "",
    rf"Low-rank ACV \(h={INT} ≫ n={INT}, planted rank {INT}\):",
    (rf"\S+ +{NUM} +{NUM} +{NUM} +{INT} chol", 2), "",
    r"Precision policies \(fp32 baseline vs --precision=bf16_refined\):",
    r"policy +time\(s\) +min holdout +selected λ +state bytes",
    (rf"\S+ +{NUM} +{NUM} +{NUM} +{INT}", 2)]


def _check_lines(out: str, formats: list) -> None:
    """Every printed line matches its format, in order; an entry
    ``(pattern, n)`` matches n lines (``None``: one or more)."""
    lines = out.rstrip("\n").split("\n")
    i = 0
    for entry in formats:
        pat, n = entry if isinstance(entry, tuple) else (entry, 1)
        count = 0
        while i < len(lines) and (n is None or count < n) \
                and re.fullmatch(pat, lines[i]):
            i, count = i + 1, count + 1
        assert count == n or (n is None and count >= 1), \
            f"line {i}: {lines[i] if i < len(lines) else None!r} ≠ {pat!r}"
    assert i == len(lines), f"unexpected line {lines[i]!r}"


def _run(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue()


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The examples' many small CPU operations on one torch thread: beside
    the suite's other workers, torch's default thread pool (one thread a
    core) oversubscribes the cores, and ridge_cv's search section then
    takes minutes instead of seconds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ridge():
    """JAX's dataset at RIDGE_H × RIDGE_N, the port's ridge_cv on it with
    every section, and the reference functions' results on the same
    arrays."""
    x, y = jdataset(jax.random.PRNGKey(0), RIDGE_N, RIDGE_H,
                    dtype=jnp.float64)
    args = ridge_cv.parser().parse_args(
        ["--h", str(RIDGE_H), "--n", str(RIDGE_N), "--mesh", "--tune",
         "--search", "--sketch", "--precision", "bf16_refined",
         "--device", "cpu"])
    port, out = _run(ridge_cv.run, args, x=np.array(x), y=np.array(y))
    folds = jcv.make_folds(x, y, 5)
    lams = jnp.logspace(-3, 2, 31)
    want = {
        "Chol": jcv.cv_exact_cholesky(folds, lams),
        "PIChol": jcv.cv_picholesky(folds, lams, g=4),
        "MChol": jcv.cv_multilevel_cholesky(folds, c=0.0, s=1.5, s0=0.05),
        "SVD": jcv.cv_svd(folds, lams, mode="full"),
        "t-SVD": jcv.cv_svd(folds, lams, mode="truncated",
                            k_trunc=RIDGE_H // 4),
    }
    return port, out, want


def _lm_arrays(arch: str, n: int, s: int):
    """JAX's reduced model, its weights (numpy), tokens and source, drawn as
    the reference examples draw them."""
    jcfg = jconfigs.get(arch).reduced()
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    tokens = jax.random.randint(key, (n, s), 0, jcfg.vocab_size)
    return jcfg, jm, params, tokens


@pytest.fixture(scope="module")
def probe():
    """lm_probe's arrays as the reference draws them, the reference's
    features and its two CV results, and the port's run on them."""
    jcfg, jm, params, tokens = _lm_arrays("smollm-360m", 16, 32)
    logits, _ = jax.jit(jm.forward)(params, tokens, {})
    feats = logits.reshape(-1, jcfg.vocab_size)[:, :96].astype(jnp.float64)
    feats = jnp.concatenate([feats, jnp.ones((feats.shape[0], 1))], axis=1)
    theta = jax.random.normal(jax.random.PRNGKey(2), (97,), jnp.float64)
    noise = jax.random.normal(jax.random.PRNGKey(3), (feats.shape[0],),
                              jnp.float64)
    y = feats @ theta + 0.5 * noise
    folds = jcv.make_folds(feats, y, 4)
    lams = jnp.logspace(-4, 1, 31)
    want = (jcv.cv_exact_cholesky(folds, lams),
            jcv.cv_picholesky(folds, lams, g=4, block=32))
    cfg = configs.get("smollm-360m").reduced()
    model = convert.model_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
    args = lm_probe.parser().parse_args(["--device", "cpu"])
    got, out = _run(lm_probe.run, args, model=model,
                    tokens=np.array(tokens), theta_true=np.array(theta),
                    noise=np.array(noise))
    return got, out, want


# ---------------------------------------------------------------- tests


def test_quickstart_matches_the_reference_on_its_arrays():
    """The reference's own example prints its error on JAX's draws; the
    port's on the same x and noise agrees to QUICKSTART_TOL, and both print
    the same lines."""
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    want = float(ref_out.getvalue().split(":")[-1])
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (quickstart.N, quickstart.H), jnp.float64)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (quickstart.N,),
                              jnp.float64)
    got, out = _run(quickstart.run, "cpu", x=np.array(x),
                    noise=np.array(noise))
    _check_lines(out, FORMATS["quickstart"])
    _check_lines(ref_out.getvalue(), FORMATS["quickstart"])
    assert out.split("\n")[0] == ref_out.getvalue().split("\n")[0]
    assert abs(got["max_rel_err"] - want) <= QUICKSTART_TOL
    assert got["max_rel_err"] < 1e-6


def test_ridge_cv_prints_every_section(ridge):
    _check_lines(ridge[1], RIDGE_FORMAT)
    port = ridge[0]
    assert port["tune"]["source"] == "tuned"
    assert port["tune"]["stats"]["hits"] == 1
    assert [s for _, s in port["cache"].values()] == ["miss", "hit", "hit"]


@pytest.mark.parametrize("algo", ["Chol", "PIChol", "MChol", "SVD", "t-SVD"])
def test_ridge_cv_selects_the_reference_lambda(ridge, algo):
    """The same λ* index on JAX's arrays (MChol: the same visited λs and
    the same λ*)."""
    got, want = ridge[0]["algos"][algo], ridge[2][algo]
    assert got.n_exact_chol == want.n_exact_chol
    if algo == "MChol":
        np.testing.assert_allclose(np.asarray(got.lams),
                                   np.asarray(want.lams), rtol=1e-12)
    assert int(np.argmin(np.asarray(got.errors))) == \
        int(np.argmin(np.asarray(want.errors)))
    assert got.best_lam == pytest.approx(float(want.best_lam), rel=1e-12)


def test_ridge_cv_engine_and_sections_agree_with_the_algorithms(ridge):
    """The engine's strategies, the warm replays, the search's dense grid
    and the fp32 precision run select the exact algorithm's λ*."""
    port = ridge[0]
    lam = port["algos"]["Chol"].best_lam
    for name in ("exact", "pichol", "warm", "svd"):
        assert port["engine"][name].best_lam == pytest.approx(lam), name
    assert all(v == pytest.approx(lam) for v, _ in list(
        port["cache"].values())[:2])
    assert 0 < lam < 100          # an interior λ* (not the grid's edge)


def test_lm_probe_selects_the_reference_lambda(probe):
    got, out, want = probe
    _check_lines(out, FORMATS["lm_probe"])
    assert got["features"] == (512, 97)
    for mine, ref in zip((got["exact"], got["picholesky"]), want):
        assert int(np.argmin(np.asarray(mine.errors))) == \
            int(np.argmin(np.asarray(ref.errors)))
        assert mine.n_exact_chol == ref.n_exact_chol


def test_serve_lm_prefill_matches_jax():
    """The reduced Qwen2 on JAX's weights and prompts: prefill logits
    within MODEL_RTOL of the JAX model's; greedy ids printed."""
    arch, batch, prompt, tokens = "qwen2-1.5b", 2, 16, 4
    jcfg, jm, params, prompts = _lm_arrays(arch, batch, prompt)
    want, _ = jm.prefill(params, prompts, {},
                         cache_len=prompt + tokens + 8)
    model = convert.model_from_numpy(configs.get(arch).reduced(),
                                     jax.tree.map(np.asarray, params),
                                     device="cpu")
    args = serve_lm.parser().parse_args(
        ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
         "--tokens", str(tokens), "--device", "cpu"])
    got, out = _run(serve_lm.run, args, model=model,
                    prompts=np.array(prompts))
    _check_lines(out, FORMATS["serve_lm"])
    want = np.asarray(want, np.float64)
    rel = np.max(np.abs(got["prefill_logits"].double().numpy() - want)) \
        / np.max(np.abs(want))
    assert rel <= MODEL_RTOL
    assert np.asarray(got["ids"]).shape == (batch, tokens)


@pytest.mark.parametrize("arch", ["whisper-base", "falcon-mamba-7b"])
def test_serve_lm_runs_the_other_families(arch):
    """At its smallest size, with the audio source drawn as the reference
    draws it (``cross_source``) and the Mamba mixer's plain versions."""
    args = serve_lm.parser().parse_args(
        ["--arch", arch, "--batch", "1", "--prompt-len", "8", "--tokens",
         "2", "--device", "cpu"])
    got, out = _run(serve_lm.run, args)
    _check_lines(out, FORMATS["serve_lm"])
    assert torch.isfinite(got["prefill_logits"]).all()


def test_train_lm_resumes_and_compresses(tmp_path):
    """``--steps 10`` logs every fifth step and saves the last; a second run
    to 12 resumes from it; ``--compress-grads`` trains alike."""
    argv = ["--steps", "10", "--batch", "2", "--seq", "16", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    first, out = _run(train_lm.main, argv)
    _check_lines(out, FORMATS["train_lm"])
    assert [e["step"] for e in first["log"]] == [5, 10]
    assert first["final_step"] == 10
    again, _ = _run(train_lm.main, ["--steps", "12"] + argv[2:])
    assert again["final_step"] == 12
    assert [e["step"] for e in again["log"]] == [12]   # from step 10 on
    comp, out = _run(train_lm.main, ["--steps", "5", "--batch", "2", "--seq",
                                     "16", "--device", "cpu",
                                     "--compress-grads"])
    _check_lines(out, FORMATS["train_lm"])
    assert np.isfinite(comp["log"][-1]["loss"])


def test_serve_cv_prints_its_lines():
    res, out = _run(serve_cv.main, ["--requests", "8", "--tenants", "2",
                                    "--problems", "2", "--h", "16",
                                    "--device", "cpu"])
    _check_lines(out, FORMATS["serve_cv"])
    assert res["requests"] == 8
    assert sum(len(v) for v in res["tenants"].values()) == 8


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("ridge_cv", ["--h", "16"]), ("serve_cv", []),
    ("serve_lm", []), ("train_lm", ["--steps", "1"]), ("lm_probe", [])])
def test_examples_raise_without_a_card(name, argv):
    """No ``--device`` means the CUDA device; without one each example
    raises before it computes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = {"quickstart": quickstart, "ridge_cv": ridge_cv,
           "serve_cv": serve_cv, "serve_lm": serve_lm,
           "train_lm": train_lm, "lm_probe": lm_probe}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)

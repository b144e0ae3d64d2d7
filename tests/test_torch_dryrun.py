"""The port's layouts and dry run held against the JAX package's, on the CPU.

For all ten configurations: every parameter's partition spec
(``spec_pspec`` / ``param_pspecs``) with no mesh, on a (2, 2)
``jax.sharding.Mesh`` and on the production meshes as
``jax.sharding.AbstractMesh`` (16 × 16 and 2 × 16 × 16, no devices), FSDP
above 2e9 parameters as the dry run decides; the divisibility
``ValueError``; and per dry-run cell at both production meshes the local
shard shape of every input (parameters, batch, source, cache, optimizer
state) against ``NamedSharding.shard_shape``, the cell's status and its
argument bytes per device.  The reference stacks each layer list along a
leading axis of spec ``None``: a port layer's spec and local shape are the
stacked one's less that entry.  The port builds everything on the
``meta`` device (``repro_torch.launch.dryrun``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.distributed.context import MeshCtx as JMeshCtx  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.params import Spec as JSpec  # noqa: E402
from repro.optim import adafactor as jadafactor, adamw as jadamw  # noqa
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.context import MeshCtx  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.model import Model, stack_sizes  # noqa: E402
from repro_torch.models.params import Spec  # noqa: E402

ARCHS = configs.names()
# mesh: (shape, axis names), None for no mesh
MESHES = {"none": None, "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PRODUCTION = ("16x16", "2x16x16")


def _norm(spec) -> tuple:
    """A partition spec as a tuple: one-name groups as the name, empty
    groups as None, trailing Nones dropped."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else e[0] if len(e) == 1 else e
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ctxs(mesh_name: str, fsdp: bool):
    """(the JAX MeshCtx, the port's) of a mesh case; the port's over the
    meta device, so no model is allocated."""
    if MESHES[mesh_name] is None:
        return JMeshCtx(None, fsdp=fsdp), MeshCtx(None, fsdp=fsdp)
    shape, names = MESHES[mesh_name]
    if mesh_name == "2x2":
        jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(
            shape), names)
    else:
        jmesh = AbstractMesh(shape, names)
    mesh = sharding.Mesh(shape, names, ["meta"] * int(np.prod(shape)))
    return (JMeshCtx.from_mesh(jmesh, fsdp=fsdp),
            MeshCtx.from_mesh(mesh, fsdp=fsdp))


def _paths(tree, is_leaf=None):
    """{dotted name: leaf} of a JAX tree (dict keys, list indices)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    out = {}
    for path, leaf in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[".".join(keys)] = leaf
    return out


def _per_layer(cfg, jax_by_name: dict) -> dict:
    """The reference's stacked leaves by the port's per-layer names:
    {port name: (reference leaf, stacked)}."""
    sizes = stack_sizes(cfg)
    out = {}
    for name, leaf in jax_by_name.items():
        head, _, rest = name.partition(".")
        if head in sizes:
            for i in range(sizes[head]):
                out[f"{head}.{i}.{rest}"] = (leaf, True)
        else:
            out[name] = (leaf, False)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, mesh_name):
    """Every parameter's spec and local shard shape, FSDP above 2e9
    parameters; the padded query heads' shapes too."""
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    fsdp = cfg.n_params() > dryrun.FSDP_THRESHOLD
    assert fsdp == (jcfg.n_params() > 2e9)
    jctx, ctx = _ctxs(mesh_name, fsdp)
    jm = JModel(jcfg, jctx)
    model = Model(cfg, ctx, device="meta")
    want = _per_layer(cfg, _paths(jshard.param_pspecs(
        jm.param_specs(), jctx), is_leaf=lambda x: isinstance(x, P)))
    shapes = _per_layer(cfg, _paths(jm.param_specs(),
                                    is_leaf=lambda x: isinstance(x, JSpec)))
    got = sharding.param_pspecs(model.param_specs(), ctx)
    assert set(got) == set(want)
    abstract = model.abstract()
    for name, ps in got.items():
        jps, stacked = want[name]
        jspec = shapes[name][0]
        if stacked:
            assert jps[0] is None, name
            jps, jshape = jps[1:], jspec.shape[1:]
        else:
            jshape = jspec.shape
        assert _norm(ps) == _norm(jps), name
        assert tuple(abstract[name].shape) == tuple(jshape), name
        assert abstract[name].device.type == "meta"
        if jctx.mesh is not None:
            jlocal = jax.sharding.NamedSharding(jctx.mesh, P(*want[name][0])
                                                ).shard_shape(jspec.shape)
            local = ctx.sharding(*ps).shard_shape(abstract[name].shape)
            assert local == (jlocal[1:] if stacked else jlocal), name


class _SixteenWide:
    """The reference test's fake context (``tests/test_distributed.py:
    67-75``): every axis 16 wide, FSDP resolving to ``"data"``."""
    fsdp_axis = "data"

    def axis_size(self, name):
        return 16


@pytest.mark.parametrize("shape,axes", [((10,), ("model",)),
                                        ((32, 10), ("fsdp", "model")),
                                        ((12, 32), ("fsdp", None)),
                                        ((32, 48), ("fsdp", "model"))])
def test_divisibility_error_matches_jax(shape, axes):
    """A dimension that its mesh axis does not divide raises the same
    ``ValueError`` in both packages; one that it divides gives the same
    spec."""
    try:
        want = jshard.spec_pspec(JSpec(shape, axes), _SixteenWide())
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sharding.spec_pspec(Spec(shape, axes), _SixteenWide())
        assert str(got.value) == str(e)
    else:
        assert _norm(sharding.spec_pspec(Spec(shape, axes),
                                          _SixteenWide())) == _norm(want)


def _jax_local(sds):
    return tuple(sds.sharding.shard_shape(sds.shape))


def _jax_cell(arch, shape, mesh_name):
    """The reference's arguments of a dry-run cell on an abstract mesh
    (``dryrun.lower_cell`` without the lowering), or the ``ValueError`` its
    layout raises."""
    jcfg = jconfigs.get(arch)
    meta = jconfigs.SHAPES[shape]
    jctx = _ctxs(mesh_name, jcfg.n_params() > 2e9)[0]
    jm = JModel(jcfg, jctx)
    seq, batch, kind = meta["seq_len"], meta["global_batch"], meta["kind"]
    params = jspecs.param_specs_sharded(jm)
    if kind == "train":
        opt = jadafactor() if jcfg.n_params() > 3e11 else jadamw()
        return (params, jspecs.opt_state_specs(opt[0], jm),
                jspecs.batch_specs(jcfg, jctx, batch, seq, with_labels=True),
                jspecs.extra_specs(jcfg, jctx, batch, seq))
    if kind == "prefill":
        return (params, jspecs.batch_specs(jcfg, jctx, batch, seq,
                                           with_labels=False)["tokens"],
                jspecs.extra_specs(jcfg, jctx, batch, seq))
    extra_len = (seq // jcfg.enc_seq_ratio if jcfg.family == "audio" else
                 jcfg.n_image_tokens if jcfg.family == "vlm" else 0)
    tok = jax.ShapeDtypeStruct((batch, 1), np.int32, sharding=jctx.sharding(
        jctx.dp_axes if batch % jctx.dp_size == 0 else None, None))
    return params, jspecs.cache_specs(jm, batch, seq, extra_len), tok


def _bytes(tree) -> int:
    return sum(int(np.prod(_jax_local(s))) * np.dtype(s.dtype).itemsize
               for s in jax.tree.leaves(tree))


def _check_leaves(got_tree, want_tree, cfg, stacked_names: bool):
    """Each leaf's dtype, spec and local shape; ``stacked_names``: the
    port's tree keeps the reference's stacked layout (optimizer states),
    else its layers are per layer."""
    want = _paths(want_tree)
    got = {n: p for n, p in _paths(got_tree,
                                   is_leaf=lambda x: isinstance(
                                       x, specs.Placed)).items()}
    if not stacked_names:
        want = _per_layer(cfg, want)
    else:
        want = {n: (s, False) for n, s in want.items()}
    assert set(got) == set(want)
    for name, leaf in got.items():
        sds, stacked = want[name]
        assert str(leaf.dtype).replace("torch.", "") == str(
            np.dtype(sds.dtype)), name
        jspec, jlocal = tuple(sds.sharding.spec), _jax_local(sds)
        if stacked:
            assert not jspec or jspec[0] is None, name
            jspec, jlocal = jspec[1:], jlocal[1:]
        assert _norm(leaf.sharding.spec) == _norm(jspec), name
        assert leaf.local_shape == jlocal, name


@pytest.mark.parametrize("mesh_name", PRODUCTION)
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cells_match_jax(arch, mesh_name):
    """Per shape of the grid: the status (``skip`` for ``long_500k`` on a
    pure full-attention configuration), every input's spec and local
    shape, the argument bytes of the fullest device, n_params,
    n_active_params, model_flops; ``fits`` null without a card."""
    jcfg = jconfigs.get(arch)
    cfg = configs.get(arch)
    multi_pod = mesh_name == "2x16x16"
    for shape, meta in configs.SHAPES.items():
        res = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              verbose=False)
        assert res["cell"] == f"{arch}×{shape}×{mesh_name}"
        if shape == "long_500k" and not jcfg.subquadratic:
            assert res["status"] == "skip"
            continue
        try:
            want = _jax_cell(arch, shape, mesh_name)
        except ValueError:
            assert res["status"] == "error"
            continue
        assert res["status"] == "ok", res
        got, chips, _ = dryrun.cell_args(arch, shape, multi_pod=multi_pod)
        assert chips == res["chips"] == (512 if multi_pod else 256)
        kind = meta["kind"]
        _check_leaves(got[0], want[0], cfg, False)           # parameters
        if kind == "train":
            _check_leaves(got[1], want[1], cfg, True)        # optimizer
            _check_leaves(got[2], want[2], cfg, False)       # batch
        elif kind == "decode":
            _check_leaves(got[1], want[1], cfg, False)       # cache
        if kind != "decode":
            _check_leaves(got[-1], want[-1], cfg, False)     # source
        assert res["memory"]["argument_size_in_bytes"] == _bytes(want)
        assert res["fits"] is None or torch.cuda.is_available()
        n_act = jcfg.n_active_params()
        tokens = meta["global_batch"] * (meta["seq_len"] if kind != "decode"
                                         else 1)
        assert (res["n_params"], res["n_active_params"]) == (
            jcfg.n_params(), n_act)
        assert res["model_flops"] == (6 if kind == "train" else 2) \
            * n_act * tokens
        for key in ("temp_size_in_bytes",):
            assert res["memory"][key] is None
        for key in dryrun.UNCOMPILED[1:]:
            assert res[key] is None
        assert "compiled" in res["note"]


def test_dryrun_command_runs_every_cell(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --all --both-meshes --out``:
    80 cells, 12 skipped, none in error, one file each; the production
    mesh is built on the meta device only because the dry run asks."""
    results = dryrun.main(["--all", "--both-meshes", "--out",
                           str(tmp_path)])
    assert len(results) == 80 and len(list(tmp_path.iterdir())) == 80
    assert sum(r["status"] == "skip" for r in results) == 12
    assert all(r["status"] in ("ok", "skip") for r in results)
    assert "68 ok, 12 skip, 0 error" in capsys.readouterr().out
    assert make_production_mesh(devices="meta").flat[0].type == "meta"

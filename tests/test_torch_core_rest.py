"""What ``core/`` still lacked, held to the JAX package on the same numpy
inputs: the paper's Table-1 vectorization baselines (``pack_tril_rowwise``,
``unpack_tril_rowwise``, ``pack_tril_full``) and ``tril_mask_packed``
(exact: they only move data), ``precision.tree_astype`` on the port's
dataclasses, the ``CVStrategy`` protocol and ``configs.picholesky``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import picholesky as jconfig  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import precision as jprecision  # noqa: E402
from repro_torch.configs import picholesky as config  # noqa: E402
from repro_torch.core import engine, packing, precision  # noqa: E402
from repro_torch.core.picholesky import PiCholesky  # noqa: E402


def _mats(h, lead=(), seed=0):
    return np.random.default_rng(seed).normal(size=(*lead, h, h))


@pytest.mark.parametrize("h, lead", [(1, ()), (7, ()), (16, (3,)),
                                     (37, (2, 2))])
def test_rowwise_and_full_baselines_equal_jax(h, lead):
    m = _mats(h, lead)
    vec = packing.pack_tril_rowwise(torch.from_numpy(m))
    jvec = np.asarray(jpacking.pack_tril_rowwise(jnp.asarray(m)))
    np.testing.assert_array_equal(vec.numpy(), jvec)
    assert vec.shape[-1] == h * (h + 1) // 2
    back = packing.unpack_tril_rowwise(vec, h)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jpacking.unpack_tril_rowwise(jnp.asarray(jvec), h)))
    np.testing.assert_array_equal(back.numpy(), np.tril(m))
    np.testing.assert_array_equal(
        packing.pack_tril_full(torch.from_numpy(m)).numpy(),
        np.asarray(jpacking.pack_tril_full(jnp.asarray(m))))


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("h", [5, 32, 40, 77])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tril_mask_packed_equals_jax(h, block, dtype):
    mask = packing.tril_mask_packed(h, block, dtype=dtype, device="cpu")
    want = np.asarray(jpacking.tril_mask_packed(h, block,
                                                dtype=getattr(jnp, dtype)))
    assert mask.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(mask.numpy(), want)
    assert float(mask.sum()) == h * (h + 1) // 2


def test_baselines_are_exported():
    for name in ("pack_tril_rowwise", "unpack_tril_rowwise",
                 "pack_tril_full", "tril_mask_packed"):
        assert name in packing.__all__
        assert hasattr(jpacking, name)   # JAX's __all__ omits the unpack
    assert "tree_astype" in precision.__all__
    assert "CVStrategy" in engine.__all__


def _picholesky(h=40, block=16, k=2, seed=0):
    rng = np.random.default_rng(seed)
    p = packing.packed_size(h, block)
    return rng.normal(size=(k, 3, p)), h, block


@pytest.mark.parametrize("to", ["float32", "bfloat16", "float64"])
def test_tree_astype_casts_tensors_keeps_static_fields(to):
    theta, h, block = _picholesky()
    model = PiCholesky(theta=torch.from_numpy(theta),
                       center=torch.tensor(0.25, dtype=torch.float64),
                       h=h, block=block)
    pf = packing.PackedFactor(torch.from_numpy(theta[:, 0]), h, block)
    idx = torch.arange(5)
    tree = dict(model=model, pf=pf, rest=(idx, [torch.ones(3)], "tag", 7))
    out = precision.tree_astype(tree, to)
    dt = getattr(torch, to)
    assert out["model"].theta.dtype == dt and out["model"].center.dtype == dt
    assert (out["model"].h, out["model"].block) == (h, block)
    assert out["pf"].vec.dtype == dt and (out["pf"].h, out["pf"].block) == \
        (h, block)
    assert out["rest"][0].dtype == torch.int64          # integer leaves kept
    assert torch.equal(out["rest"][0], idx)
    assert out["rest"][1][0].dtype == dt
    assert out["rest"][2:] == ("tag", 7)
    assert isinstance(out["rest"], tuple) and isinstance(out["rest"][1],
                                                          list)
    # the same values as the JAX package's cast (bf16 compared as float32)
    jpf = jprecision.tree_astype(
        jpacking.PackedFactor(jnp.asarray(theta[:, 0]), h, block),
        getattr(jnp, to))
    np.testing.assert_array_equal(
        out["pf"].vec.to(torch.float64).numpy(),
        np.asarray(jpf.vec.astype(jnp.float64)))
    # the input is left as it was
    assert model.theta.dtype == torch.float64


def test_cv_strategy_protocol():
    members = {"name", "n_exact_chol", "prepare", "fold_state",
               "fold_errors"}
    assert set(engine.CVStrategy.__protocol_attrs__) == members
    assert set(jengine.CVStrategy.__protocol_attrs__) == members
    for name, cls in engine.STRATEGIES.items():
        kw = dict(sketch=dict(method="gaussian", m=64)) \
            if name == "picholesky_sketched" else {}
        assert isinstance(cls(**kw), engine.CVStrategy), name
    assert not isinstance(object(), engine.CVStrategy)


def test_picholesky_config_equals_jax():
    assert dataclasses.asdict(config.CONFIG) == \
        dataclasses.asdict(jconfig.CONFIG)
    assert config.PiCholeskyConfig(h=64).h == 64

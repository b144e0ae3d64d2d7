"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with :mod:`ctypes`; no PyTorch header
is compiled.  Sources are built at first use, into
``build/repro_torch_kernels/`` at the root of the checkout, under a name
that carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded.  :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

Importing this module needs neither ``nvcc`` nor a GPU.

Every C entry point takes its pointers and the CUDA stream as ``void *``
and returns the ``cudaError_t`` of its launches; :func:`check` raises on a
non-zero code.  :data:`LAUNCHES` counts, per wrapper, the CUDA kernel
launches it made (a call that launches several kernels adds each of them;
a call that failed or took the plain CPU path adds nothing); the
mixed-precision variants count under names of their own
(:data:`MIXED_NAMES`); the Mamba mixer's fused scan counts under
``ssm_scan``, its convolution under ``causal_conv1d``, and their backward
kernels under ``mamba_scan_bwd`` and ``causal_conv1d_bwd`` (two launches a
call each: the backward pass and the fixed-order sum of its partials); the
scan's backward on the forward's segment states counts under
``mamba_scan_bwd_ckpt``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "BLOCKS", "LAUNCHES", "PLANS",
           "MIXED_NAMES",
           "PLAN_KEYS", "build_all", "load", "check", "check_block",
           "check_tensor", "c_function", "count_launch", "reset_launches",
           "launch_solve", "ptr", "stream_ptr", "suffix", "entry",
           "resolve_dtypes", "check_mixed"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("tri_pack", "chol_blocked", "trsm", "poly_interp", "packed_trsm",
           "ssm_scan", "ssm_scan_bwd", "causal_conv1d")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the tile sizes the kernels with a compile-time block are compiled for
#: (the Cholesky, ``pack_tril`` and the three cluster solves: the dense
#: trsm, ``interp_solve`` and the packed trsm)
BLOCKS = (16, 32, 64, 128)

#: the launch plan of a cluster solve (``csrc/tri_solve.cuh``), in the
#: order its launch reports it
PLAN_KEYS = ("cluster", "max_active_clusters", "rows_per_block",
             "inv_in_smem", "smem_bytes", "stages", "chunk_rows")
#: per wrapper, the plan of its last cluster launch (for reports only)
PLANS: Dict[str, dict] = {}
#: ``kNeedsScratch`` of ``csrc/tri_solve.cuh``: a cluster launch that needs
#: room for its diagonal inverses and was given none (nothing launched)
_NEEDS_SCRATCH = -1

#: the mixed-precision variants (bf16 products, float32 sums and state)
#: and ``interp_factors`` on a bf16 Θ count apart from their one-dtype
#: kernels, under these names
MIXED_NAMES = {"cholesky_blocked": "cholesky_blocked_bf16",
               "solve_lower_blocked": "solve_lower_blocked_bf16",
               "interp_solve": "interp_solve_bf16",
               "interp_factors": "interp_factors_bf16",
               "solve_lower_packed": "solve_lower_packed_bf16"}

LAUNCHES: Dict[str, int] = {name: 0 for name in
                            ("pack_tril", "cholesky_blocked",
                             "solve_lower_blocked", "interp_solve",
                             "unpack_tril", "interp_factors",
                             "solve_lower_packed", "ssm_scan",
                             "causal_conv1d", "mamba_scan_bwd",
                             "mamba_scan_bwd_ckpt", "causal_conv1d_bwd",
                             *MIXED_NAMES.values())}

_LIBS: Dict[str, ctypes.CDLL] = {}


def count_launch(name: str, n: int = 1) -> None:
    LAUNCHES[name] += n


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC.glob("*.cuh")):
        src += hdr.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source started
    together.  Returns seconds per source built (0.0 when already there);
    the compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    goes to ``<lib>.log`` beside each library."""
    out = {n: 0.0 for n in names}
    missing = [n for n in out if not _target(n).exists()]
    nvcc = _nvcc() if missing else None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        target = _target(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        log = open(target.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, target, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, log, t0) in procs.items():
        rc = proc.wait()
        out[name] = time.perf_counter() - t0
        log.close()
        if rc:
            failed.append(name)
        else:
            os.replace(tmp, target)
    if failed:
        logs = "\n".join(_target(n).with_suffix(".log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check_block(block: int, what: str) -> None:
    """Raise unless ``block`` is one the kernels are compiled for."""
    if block not in BLOCKS:
        raise ValueError(f"{what}: block must be one of {BLOCKS}, got "
                         f"{block}")


def launch_solve(name: str, fn, head, tail, inverses, device) -> None:
    """Launch a cluster solve: ``fn(*head, scratch, *tail, plan, stream)``.

    The first try passes no scratch; when the launch answers that its
    kernel needs room for the diagonal inverses it forms (``inverses``:
    (n_sys, nt, B, B + 16 bytes), ``inv_ld`` of ``csrc/tri_solve.cuh``),
    that room is allocated and the launch made again.  Records the plan in
    :data:`PLANS` and counts the launch."""
    import torch
    plan = (ctypes.c_int * len(PLAN_KEYS))()
    stream = stream_ptr(device)
    rc = fn(*head, None, *tail, plan, stream)
    if rc == _NEEDS_SCRATCH:
        n_sys, nt, block, dtype = inverses
        pad = 16 // torch.empty((), dtype=dtype).element_size()
        scratch = torch.empty((n_sys, nt, block, block + pad), dtype=dtype,
                              device=device)
        rc = fn(*head, ptr(scratch), *tail, plan, stream)
    check(rc, name)
    PLANS[name] = dict(zip(PLAN_KEYS, plan))
    count_launch(name)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_tensor(t, what: str, dtype=None) -> None:
    """The checks every wrapper makes before a launch: a contiguous CUDA
    tensor of ``dtype`` (a bf16 Θ or packed factor of a mixed variant), or
    of float32 or float64 when ``dtype`` is not given."""
    import torch
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if dtype is None and t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: kernels take float32 or float64, got "
                        f"{t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


_SUFFIX = {"torch.float64": "f64", "torch.float32": "f32",
           "torch.bfloat16": "bf16"}


def suffix(dtype) -> str:
    """The name of ``dtype`` in the C entry points."""
    try:
        return _SUFFIX[str(dtype)]
    except KeyError:
        raise TypeError(f"no kernel takes {dtype}") from None


def entry(name: str, dtype, compute_dtype=None) -> str:
    """The C entry point of ``name`` for ``dtype`` (the state's, or the
    stored tiles'): ``rt_<name>_f64``, ``_f32`` or ``_bf16``, with
    ``_bf16`` appended for a mixed variant whose ``compute_dtype``
    differs from ``dtype`` (``rt_<name>_f32_bf16``)."""
    fn = f"rt_{name}_{suffix(dtype)}"
    if compute_dtype is not None and compute_dtype != dtype:
        fn += f"_{suffix(compute_dtype)}"
    return fn


def resolve_dtypes(ref_dtype, compute_dtype=None, accum_dtype=None):
    """(compute, accum) torch dtypes, the rule of the JAX kernels
    (``src/repro/kernels/packed_trsm.py:99``): compute inherits
    ``ref_dtype``; accum is float32 for a 16-bit compute dtype and the
    compute dtype otherwise."""
    from repro_torch.core.precision import as_dtype, default_accum_dtype
    cd = ref_dtype if compute_dtype is None else as_dtype(compute_dtype)
    ad = default_accum_dtype(cd) if accum_dtype is None \
        else as_dtype(accum_dtype)
    return cd, ad


def check_mixed(compute_dtype, accum_dtype, what: str) -> None:
    """Raise unless (compute, accum) is one the kernels are compiled for:
    one dtype throughout (float32, float64), or bf16 products with float32
    sums and state (the mixed variants)."""
    import torch
    pair = (compute_dtype, accum_dtype)
    if pair not in ((torch.float32,) * 2, (torch.float64,) * 2,
                    (torch.bfloat16, torch.float32)):
        raise NotImplementedError(
            f"{what}: the kernels run float32 or float64 throughout, or "
            f"bfloat16 products with float32 sums; got compute "
            f"{compute_dtype}, accum {accum_dtype}")


def c_function(lib_name: str, fn_name: str, argtypes):
    """``lib_name``'s C entry point with its ctypes signature set (every
    entry point returns an int error code)."""
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn

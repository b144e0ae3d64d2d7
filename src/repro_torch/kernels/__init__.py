"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper module (``tri_pack``, ``chol_blocked``, ``trsm``,
``poly_interp``, ``packed_trsm``, ``ssm_scan``) replaces the Pallas kernels
of the module of the same name in ``src/repro/kernels``;
``causal_conv1d`` fuses the Mamba mixer's convolution, bias and silu,
which the JAX package leaves to XLA.  The mixer's two kernels have
backward kernels of their own (``ssm_scan.mamba_scan_bwd``,
``causal_conv1d.causal_conv1d_silu_bwd``), which their
``torch.autograd.Function``s launch for CUDA tensors.  A wrapper given
CPU tensors runs its plain version (:mod:`.ref` or
:mod:`repro_torch.core.packing`); given CUDA tensors it launches its
kernel, built from ``csrc/`` at first use, or raises.  :mod:`.ops` gives
them the JAX package's entry-point names (``src/repro/kernels/ops.py``).
:data:`LAUNCHES`
counts the CUDA kernel launches per wrapper, the mixed-precision variants
under the names of :data:`MIXED_NAMES`.
"""
from ._build import LAUNCHES, MIXED_NAMES, build_all, reset_launches

__all__ = ["LAUNCHES", "MIXED_NAMES", "build_all", "reset_launches"]

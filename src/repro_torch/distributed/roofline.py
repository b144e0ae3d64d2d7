"""Roofline terms of a priced launch plan, against the card's peaks.

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / effective bandwidth
    collective term = bytes the mesh moves between devices / link bandwidth
    launch term     = launches × launch_s

The reference (``src/repro/distributed/roofline.py``) reads FLOPs and bytes
from compiled HLO text and adds no launch term.  The port has no HLO: its
FLOPs, bytes and launches come from the launch plan the engine would run
(:mod:`.plan_cost`), and its collective term reads the bytes the mesh's
state broadcast and error gather move (there is no HLO text for
``collective_bytes`` to parse).  The predicted step is
``max(compute, memory, collective) + launches · launch_s``: on the card a
λ-chunk trip is also the host issuing launches, which no bandwidth term
sees.

Hardware numbers are an :class:`HW`.  :func:`detect_hw` picks the preset
of the card by its ``torch.cuda.get_device_name()`` (the H100's SXM, PCIe
and NVL parts) and the peak by the compute dtype: ``fp64_tc`` for float64,
``fp32`` for float32, ``bf16_tc`` under the bf16 policies; the CPU preset
without a card.  ``REPRO_HW`` forces a preset by name (``REPRO_HW=tpu``
raises: the port has no TPU preset), and ``REPRO_HW_PEAK_FLOPS`` /
``REPRO_HW_HBM_BW`` / ``REPRO_HW_LINK_BW`` / ``REPRO_HW_CACHE_BW`` /
``REPRO_HW_CACHE_BYTES`` override single terms, as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

__all__ = ["HW", "HW_PRESETS", "PEAKS", "LAUNCH_S", "h100_part",
           "peaks_for", "detect_hw", "roofline", "Roofline"]

#: Published peaks of the H100 parts (NVIDIA data sheets, dense): memory
#: bytes/s, FP64 on tensor cores, FP64 and FP32 outside them, bf16 on
#: tensor cores (half the data sheets' with-sparsity figure), and ``sfu``,
#: exponentials per second on the special-function units: 16 per clock per
#: SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
#: compute capability 9.0) × SMs × boost clock (SXM 132 × 1.98 GHz, PCIe
#: 114 × 1.755 GHz, NVL 132 × 1.785 GHz).  ``link``: the data sheets'
#: interconnect bandwidth (NVLink 900 GB/s on SXM, 600 GB/s on NVL; PCIe
#: Gen5 x16, 128 GB/s, on the PCIe part).
PEAKS = {
    "SXM": dict(bw=3.35e12, fp64_tc=67e12, fp64=34e12, fp32=67e12,
                bf16_tc=989e12, sfu=16 * 132 * 1.98e9, link=900e9),
    "PCIe": dict(bw=2.0e12, fp64_tc=51e12, fp64=26e12, fp32=51e12,
                 bf16_tc=756e12, sfu=16 * 114 * 1.755e9, link=128e9),
    "NVL": dict(bw=3.9e12, fp64_tc=60e12, fp64=30e12, fp32=60e12,
                bf16_tc=835e12, sfu=16 * 132 * 1.785e9, link=600e9),
}

#: Seconds per kernel launch of a dependent chain of the port's kernels
#: (94-launch blocked Cholesky calls of one 512 × 512 matrix at block 16),
#: measured by ``chip_smoke.py`` phase ``tune`` (``launch``) on an NVIDIA
#: H100 80GB HBM3 at its 700 W limit: the median of five runs on five
#: machines (3.198 to 8.344 µs; the host's share of a launch varies from
#: machine to machine).  ``PERF.md`` §6 records the runs.
LAUNCH_S = 5.592e-6


@dataclasses.dataclass(frozen=True)
class HW:
    """Peak rates the roofline terms divide by (per device).

    ``cache_bw`` / ``cache_bytes`` turn on the cache-aware memory term: a
    working set that fits the last-level cache streams at ``cache_bw``,
    a larger one blends toward ``hbm_bw`` by its spilled fraction.
    ``launch_s`` prices one kernel launch (0: launches are free).
    """

    name: str
    peak_flops: float   # FLOP/s
    hbm_bw: float       # bytes/s to device memory (or host RAM on the CPU)
    link_bw: float      # bytes/s between devices
    cache_bw: Optional[float] = None
    cache_bytes: Optional[float] = None
    launch_s: float = 0.0


def _h100(part: str) -> HW:
    p = PEAKS[part]
    return HW(name=f"h100-{part.lower()}", peak_flops=p["fp64_tc"],
              hbm_bw=p["bw"], link_bw=p["link"], launch_s=LAUNCH_S)


#: The card's parts (at the float64 tensor-core peak; :func:`detect_hw`
#: swaps in the compute dtype's) and a rough CPU: on the CPU the tuner only
#: needs the candidates' relative order, and there the working set's cache
#: residency is what separates them (the reference's CPU preset).
HW_PRESETS = {
    "h100-sxm": _h100("SXM"),
    "h100-pcie": _h100("PCIe"),
    "h100-nvl": _h100("NVL"),
    "cpu": HW(name="cpu", peak_flops=1e11, hbm_bw=5e10, link_bw=2.5e10,
              cache_bw=4e11, cache_bytes=3e7),
}


def h100_part(device_name: str) -> str:
    """``'SXM'``, ``'PCIe'`` or ``'NVL'`` from a card's name."""
    return "PCIe" if "PCIe" in device_name else \
        "NVL" if "NVL" in device_name else "SXM"


def peaks_for(device_name: str) -> dict:
    """The :data:`PEAKS` of the card named ``device_name``, with its
    ``part``."""
    part = h100_part(device_name)
    return dict(PEAKS[part], part=part)


def _peak_key(dtype, precision) -> str:
    if precision is not None and not precision.is_native \
            and precision.compute_dtype(dtype) == torch.bfloat16:
        return "bf16_tc"
    return {torch.float64: "fp64_tc", torch.bfloat16: "bf16_tc"}.get(
        dtype, "fp32")


def detect_hw(dtype=None, precision=None) -> HW:
    """The :class:`HW` of this process: the ``REPRO_HW`` preset if set,
    else the CUDA card's part (the CPU preset without a card); under a
    compute dtype (``dtype``, and ``precision``'s bf16 policies) an H100
    preset takes that dtype's peak; ``REPRO_HW_*`` overrides on top."""
    name = os.environ.get("REPRO_HW", "").strip().lower()
    if name:
        if name not in HW_PRESETS:
            raise ValueError(f"REPRO_HW={name!r}: no such preset; "
                             f"have {sorted(HW_PRESETS)}")
        hw = HW_PRESETS[name]
    elif torch.cuda.is_available():
        hw = HW_PRESETS["h100-" + h100_part(
            torch.cuda.get_device_name()).lower()]
    else:
        hw = HW_PRESETS["cpu"]
    if dtype is not None and hw.name.startswith("h100-"):
        part = {"sxm": "SXM", "pcie": "PCIe", "nvl": "NVL"}[hw.name[5:]]
        hw = dataclasses.replace(
            hw, peak_flops=PEAKS[part][_peak_key(dtype, precision)])
    overrides = {}
    for field, env in (("peak_flops", "REPRO_HW_PEAK_FLOPS"),
                       ("hbm_bw", "REPRO_HW_HBM_BW"),
                       ("link_bw", "REPRO_HW_LINK_BW"),
                       ("cache_bw", "REPRO_HW_CACHE_BW"),
                       ("cache_bytes", "REPRO_HW_CACHE_BYTES")):
        val = os.environ.get(env)
        if val:
            overrides[field] = float(val)
    if overrides:
        hw = dataclasses.replace(hw, name=hw.name + "+env", **overrides)
    return hw


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes read and written
    wire_bytes: float            # per-device bytes moved between devices
    by_collective: Dict[str, float]
    chips: int
    hw: Optional[HW] = None      # None = detect for this process
    temp_bytes: Optional[float] = None  # live working set of the plan
    launches: int = 0            # kernel launches of the plan, per device

    def __post_init__(self):
        if self.hw is None:
            self.hw = detect_hw()

    @property
    def compute_s(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def effective_bw(self) -> float:
        """``hbm_bw`` unless the HW models a cache and the working set is
        known: a resident working set streams at ``cache_bw``, a spilled
        one blends toward ``hbm_bw`` by the spilled fraction."""
        hw = self.hw
        if (hw.cache_bw is None or hw.cache_bytes is None
                or not self.temp_bytes):
            return hw.hbm_bw
        if self.temp_bytes <= hw.cache_bytes:
            return hw.cache_bw
        resident = hw.cache_bytes / self.temp_bytes
        return resident * hw.cache_bw + (1.0 - resident) * hw.hbm_bw

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.effective_bw

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / self.hw.link_bw

    @property
    def launch_time_s(self) -> float:
        return self.launches * self.hw.launch_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s,
                 "launch": self.launch_time_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s) \
            + self.launch_time_s

    def summary(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "launches": self.launches,
            "launch_s": self.launch_time_s,
            "step_s": self.step_s,
            "bottleneck": self.bottleneck,
            "by_collective": self.by_collective,
            "hw": self.hw.name,
            "temp_bytes_per_device": self.temp_bytes,
            "effective_bw": self.effective_bw,
        }


def roofline(cost, chips: int, hw: Optional[HW] = None) -> Roofline:
    """The roofline terms of a priced plan (:class:`.plan_cost.PlanCost`,
    per device) on ``chips`` devices."""
    return Roofline(flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                    wire_bytes=cost.wire_bytes, by_collective=dict(cost.wire),
                    chips=chips, hw=hw, temp_bytes=cost.temp_bytes,
                    launches=cost.launches)

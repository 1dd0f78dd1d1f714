"""Hardware description for the serving planner (the fields of
``repro/core/hardware.py::HardwareSpec`` that ``derive_serve_plan`` reads).

The port targets one NVIDIA H100 SXM.  ``vmem_bytes`` is the TPU's on-chip
vector memory in the JAX package; on Hopper the nearest budget is the shared
memory one thread block may use, so that is what the H100 entry carries.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip + interconnect constants of the target platform."""

    name: str
    peak_flops_bf16: float  # FLOP/s per chip
    peak_ops_int8: float  # OP/s per chip
    vmem_bytes: int  # fast on-chip memory one kernel tile may use
    hbm_bytes: int  # device memory capacity
    hbm_bandwidth: float  # device memory bytes/s
    ici_bandwidth_per_link: float  # bytes/s per chip-to-chip link
    ici_links_per_chip: int
    mxu_dim: int = 128  # matrix-unit tile edge (sizes the KV block)
    # Host cost of one device dispatch; sizes ServePlan.rolled_steps and is
    # the overhead term of obs/calibrate.StepTimeModel.  An inherited planner
    # constant (the JAX HardwareSpec's default, set for the TPU planner), not
    # a measurement of any card.
    dispatch_overhead_s: float = 100e-6
    tdp_watts: float = 0.0

    @property
    def machine_balance_bf16(self) -> float:
        """FLOPs per device-memory byte needed to stay compute bound."""
        if self.hbm_bandwidth <= 0:
            return math.inf
        return self.peak_flops_bf16 / self.hbm_bandwidth

    @property
    def ici_bandwidth(self) -> float:
        """Aggregate chip-to-chip bytes/s per chip (0 = single device)."""
        return self.ici_bandwidth_per_link * self.ici_links_per_chip


# NVIDIA H100 SXM data sheet: dense bf16 989 TFLOP/s, int8 1979 TOP/s,
# 80 GB HBM3 at 3.35 TB/s, 227 KB of shared memory per thread block,
# 700 W.  One card, so no chip-to-chip links in the plan.  Its
# dispatch_overhead_s is the dataclass default above: the H100 plan reads it
# when it chooses rolled_steps, so it stays until a measured value replaces
# it in both.
H100_SXM = HardwareSpec(
    name="h100",
    peak_flops_bf16=989e12,
    peak_ops_int8=1979e12,
    vmem_bytes=232448,
    hbm_bytes=80 * 10**9,
    hbm_bandwidth=3.35e12,
    ici_bandwidth_per_link=0.0,
    ici_links_per_chip=0,
    tdp_watts=700.0,
)

DEFAULT_HARDWARE = H100_SXM

_REGISTRY: dict[str, HardwareSpec] = {H100_SXM.name: H100_SXM}


def get_hardware(name: str) -> HardwareSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown hardware {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]

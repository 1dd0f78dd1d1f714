"""Hardware description for the planner and the design-space search (the
port's ``repro/core/hardware.py``): ``HardwareSpec`` with its cost side
(TDP, rental price, a per-op energy table keyed by tech node), and the
registry ``get_hardware`` resolves, variants declared as data
(``HARDWARE_VARIANTS``).

The port targets one NVIDIA H100 SXM.  ``vmem_bytes`` is the TPU's on-chip
vector memory in the JAX package; on Hopper the nearest budget is the shared
memory one thread block may use, so that is what the H100 entry carries.
The registry holds the H100, the paper's VCK5000 (field for field JAX's)
and their variants; JAX's TPU entries are TPU figures and stay out (the
tests build them from the JAX package's spec).
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
    # ---- Cost / energy (the family search's axes) --------------------------
    # Board power envelope; with no per-op energy table the search charges
    # tdp_watts for the whole step (the power-model fallback).
    tdp_watts: float = 0.0
    # Rental / amortized price per chip-hour ($/token numerator).  0 = free
    # (every point of the device reads 0 on the $/token axis).
    dollars_per_hour: float = 0.0
    # Tech node naming a row of ENERGY_PJ.  "" = no table: the search falls
    # back to TDP.
    tech_node: str = ""
    # Per-device overrides of single ENERGY_PJ entries; pairs, so the spec
    # stays hashable.
    energy_pj: tuple[tuple[str, float], ...] = ()

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

    def matmul_time_s(self, m: int, n: int, k: int, dtype_bytes: int = 2) -> float:
        """Roofline time for one MxKxN matmul on one chip."""
        flops = 2.0 * m * n * k
        peak = self.peak_flops_bf16 if dtype_bytes >= 2 else self.peak_ops_int8
        t_compute = flops / peak if peak > 0 else math.inf
        bytes_moved = dtype_bytes * (m * k + k * n + m * n)
        t_memory = (
            bytes_moved / self.hbm_bandwidth if self.hbm_bandwidth > 0 else math.inf
        )
        return max(t_compute, t_memory)


# Per-op dynamic energy by tech node, picojoules (JAX's table, copied):
# order-of-magnitude engineering constants chosen so the ratios (compute vs
# memory vs wire, 7 nm vs 16 nm) are right; J/token from the search is a
# model, not a measurement.  "static_fraction" is the share of TDP burned
# regardless of activity, charged per second of step time.
ENERGY_PJ: dict[str, dict[str, float]] = {
    "7nm": {
        "flop_bf16": 0.8,
        "op_int8": 0.2,
        "mem_byte": 35.0,
        "ici_byte": 90.0,
        "static_fraction": 0.35,
    },
    "16nm": {
        "flop_bf16": 1.8,
        "op_int8": 0.45,
        "mem_byte": 40.0,
        "ici_byte": 110.0,
        "static_fraction": 0.45,
    },
}


def energy_params(hw: HardwareSpec) -> dict[str, float]:
    """Resolved per-op energy table for a device: its tech-node row overlaid
    with the device's own ``energy_pj`` overrides.  Empty dict = no table
    (callers fall back to the TDP power model)."""
    table = dict(ENERGY_PJ.get(hw.tech_node, {}))
    table.update(dict(hw.energy_pj))
    return table


# NVIDIA H100 SXM data sheet: dense bf16 989 TFLOP/s, int8 1979 TOP/s,
# 80 GB HBM3 at 3.35 TB/s, 227 KB of shared memory per thread block,
# 700 W.  One card, so no chip-to-chip links in the plan.  Its
# dispatch_overhead_s is the dataclass default above: the H100 plan reads it
# when it chooses rolled_steps, so it stays until a measured value replaces
# it in both.  No tech node and no price: the family search charges the
# whole 700 W for a step (the TDP fallback), and with no price every point
# reads 0 on the $/token axis (no figure is invented).
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
    dollars_per_hour=0.0,
    tech_node="",
)

# The paper's platform (JAX's entry, field for field): VCK5000, 400 AIE
# cores, 145 TOPS int8, 23.9 MB SRAM, 16 GB DDR at 102.4 GB/s, TSMC 7 nm;
# DDR4 access energy is far above HBM, hence the "mem_byte" override.
VCK5000 = HardwareSpec(
    name="vck5000",
    peak_flops_bf16=145e12 / 4,  # no native bf16 MM at full rate; int8 is the paper's mode
    peak_ops_int8=145e12,
    vmem_bytes=int(23.9e6),
    hbm_bytes=16 * 1024**3,
    hbm_bandwidth=102.4e9,
    ici_bandwidth_per_link=0.0,  # single device
    ici_links_per_chip=0,
    tdp_watts=225.0,
    dollars_per_hour=0.35,  # card price amortized over ~3y of service
    tech_node="7nm",
    energy_pj=(("mem_byte", 150.0),),
)

DEFAULT_HARDWARE = H100_SXM

_REGISTRY: dict[str, HardwareSpec] = {}


def register_hardware(spec: HardwareSpec) -> HardwareSpec:
    """Add a device to the registry ``get_hardware`` resolves.  Re-registering
    a name replaces it (tests register throwaway variants)."""
    _REGISTRY[spec.name] = spec
    return spec


def register_variant(name: str, base: str, **fields) -> HardwareSpec:
    """Declare a device variant: the ``base`` spec with ``fields`` replaced
    (a variant is data, not a subclass)."""
    return register_hardware(dataclasses.replace(get_hardware(base), name=name, **fields))


def get_hardware(name: str) -> HardwareSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown hardware {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_hardware() -> tuple[str, ...]:
    """Names the family search can sweep (sorted, deterministic)."""
    return tuple(sorted(_REGISTRY))


register_hardware(H100_SXM)
register_hardware(VCK5000)

# Variant devices as declarative data: (base, replaced fields).
HARDWARE_VARIANTS: dict[str, tuple[str, dict]] = {
    # JAX's int8-heavy VCK5000 analog: the paper's int8 mode with the AIE
    # array doubled toward int8 MACs.
    "vck5000-int8w": ("vck5000", dict(peak_ops_int8=290e12, tdp_watts=300.0)),
    # H100 SXM with its NVLink from the data sheet: 900 GB/s counting both
    # directions, 450e9 bytes/s one way through the NVSwitch, as one link.
    # It prices the collective term of meshes wider than one rank (the dry
    # run's production meshes); the plan reads no ici field, so its plans
    # are the H100's.
    "h100-nvlink": ("h100", dict(ici_bandwidth_per_link=450e9, ici_links_per_chip=1)),
}

for _name, (_base, _delta) in HARDWARE_VARIANTS.items():
    register_variant(_name, _base, **_delta)

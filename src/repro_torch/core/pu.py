"""MM PU tile solver — the paper's Eq. 3/4 re-derived for VMEM + MXU.
(Equation cross-reference: docs/ARCHITECTURE.md.)

The port's copy of ``repro/core/pu.py``, unchanged but for the hardware
import.  Its default hardware is the port's ``H100_SXM``, whose budget
(shared memory per block, 232,448 / 2 bytes) fits no 128-edge tile, so
``derive_pu_family`` and ``pick_pu`` raise there; the port's ``mm_pu``
does not call them (its tile is the CUDA kernel's own).

Paper (§IV.B): an AIE MM PU is sized by two constraints
  (Eq. 3)  MMSZ_AIE^2 x bit_data <= M_Window / 4     (double-buffered in/out)
           MMSZ_AIE in powers of two                 (vector ISA alignment)
  (Eq. 4)  PLIO_AIE <= floor(T_Calc / T_Window)      (stream bw never starves cores)

TPU analog: a Pallas matmul tile (block_m, block_n, block_k) is sized so
  (Eq. 3') the VMEM working set (x-tile + w-tile + out-tile, double buffered)
           fits in vmem_bytes / vmem_fraction, with dims multiples of the MXU
           native 128 (the ISA-alignment analog);
  (Eq. 4') the arithmetic intensity of a tile step is at least the machine
           balance so the HBM->VMEM stream keeps the MXU busy
           (2*bm*bn*bk FLOPs) / (bytes(bm*bk) + bytes(bk*bn)) >= balance.

Like the paper we derive a small named family — LARGE / STANDARD / SMALL —
instead of exposing the raw design space, then pick per MM-site.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.core.hardware import DEFAULT_HARDWARE, HardwareSpec


@dataclasses.dataclass(frozen=True)
class MMTileSpec:
    """One member of the MM PU family (paper Fig. 4)."""

    name: str
    block_m: int
    block_n: int
    block_k: int
    dtype_bytes: int = 2

    @property
    def vmem_bytes(self) -> int:
        """Working set of one grid step, double buffered (Eq. 3' LHS)."""
        x = self.block_m * self.block_k
        w = self.block_k * self.block_n
        o = self.block_m * self.block_n
        # x/w tiles stream (2x for double buffering); out accumulates in fp32.
        return 2 * self.dtype_bytes * (x + w) + 4 * o

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per streamed byte of one k-step (Eq. 4' LHS)."""
        flops = 2.0 * self.block_m * self.block_n * self.block_k
        streamed = self.dtype_bytes * (
            self.block_m * self.block_k + self.block_k * self.block_n
        )
        return flops / streamed


def _round_down_multiple(x: int, mult: int) -> int:
    return max(mult, (x // mult) * mult)


def is_compute_bound(spec: MMTileSpec, hw: HardwareSpec) -> bool:
    """Eq. 4' — the HBM stream keeps the MXU busy for this tile shape.

    Note the analysis that replaces the paper's PLIO formula: with the output
    tile resident in VMEM and the k-grid innermost, streamed bytes per output
    tile are K*(bm+bn)*dtype while FLOPs are 2*bm*bn*K, so the intensity
    bm*bn/((bm+bn)) / dtype-adjustment depends only on (bm, bn) — block_k sets
    pipeline granularity, not intensity.  The constraint therefore bounds the
    tile *edge* from below (edge/2 >= machine balance, i.e. edge >= ~482 on
    v5e bf16), exactly how Eq. 4 bounds PLIO_AIE from above.
    """
    if spec.dtype_bytes >= 2:
        balance = hw.machine_balance_bf16  # inf when hbm_bandwidth == 0
    elif hw.hbm_bandwidth > 0:
        balance = hw.peak_ops_int8 / hw.hbm_bandwidth
    else:
        balance = math.inf
    return spec.arithmetic_intensity >= balance


def solve_mm_tiles(
    hw: HardwareSpec = DEFAULT_HARDWARE,
    dtype_bytes: int = 2,
    vmem_fraction: float = 0.5,
    candidates: Iterable[int] = (128, 256, 512, 1024, 2048),
) -> list[MMTileSpec]:
    """Enumerate the feasible square tile family (largest volume first).

    Eq. 3' — VMEM fit with double buffering, MXU-aligned edges; block_k is the
    largest power-of-two <= edge that still fits (pipeline granularity).
    """
    budget = hw.vmem_bytes * vmem_fraction
    out: list[MMTileSpec] = []
    for edge in candidates:
        if edge % hw.mxu_dim:
            continue
        bk = edge
        while (
            bk > hw.mxu_dim
            and MMTileSpec("cand", edge, edge, bk, dtype_bytes).vmem_bytes > budget
        ):
            bk //= 2
        spec = MMTileSpec(f"sq{edge}", edge, edge, bk, dtype_bytes)
        if spec.vmem_bytes <= budget:
            out.append(spec)
    out.sort(key=lambda s: -(s.block_m * s.block_n * s.block_k))
    return out


def derive_pu_family(
    hw: HardwareSpec = DEFAULT_HARDWARE, dtype_bytes: int = 2
) -> dict[str, MMTileSpec]:
    """The LARGE / STANDARD / SMALL family (paper Fig. 4 a/b/c).

    LARGE    — largest feasible tile (paper: 64-core PU);
    STANDARD — smallest *compute-bound* tile, the balance point
               (paper: 16-core PU);
    SMALL    — smallest feasible tile, for MMs that would otherwise pad
               (paper: 4-core PU for the per-head attention MMs).
    """
    feas = solve_mm_tiles(hw, dtype_bytes)
    if not feas:
        raise RuntimeError("no feasible MM tile for this hardware")
    large = feas[0]
    small = feas[-1]
    bound = [s for s in feas if is_compute_bound(s, hw)]
    std = bound[-1] if bound else feas[len(feas) // 2]
    return {
        "LARGE": dataclasses.replace(large, name="LARGE"),
        "STANDARD": dataclasses.replace(std, name="STANDARD"),
        "SMALL": dataclasses.replace(small, name="SMALL"),
    }


def pick_pu(
    m: int,
    n: int,
    k: int,
    hw: HardwareSpec = DEFAULT_HARDWARE,
    dtype_bytes: int = 2,
) -> MMTileSpec:
    """Select the PU spec for one MM site (paper: "select the appropriate
    AIE MM PU specification according to the Transformer model specification").

    Rule: the biggest family member whose block dims do not overhang the
    problem by more than one MXU tile of padding per dim — the paper's
    ViT padding observation (L=197 pads to 256 and costs throughput) made
    into a selection criterion.
    """
    family = derive_pu_family(hw, dtype_bytes)
    for name in ("LARGE", "STANDARD", "SMALL"):
        s = family[name]
        pad_m = _padded(m, s.block_m) / max(m, 1)
        pad_n = _padded(n, s.block_n) / max(n, 1)
        if pad_m <= 1.25 and pad_n <= 1.25:
            return s
    return family["SMALL"]


def _padded(dim: int, block: int) -> int:
    return int(math.ceil(dim / block)) * block

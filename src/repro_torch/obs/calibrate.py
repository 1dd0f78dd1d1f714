"""Planner drift meter: predicted step time vs measured wall time (the
port's copy of ``repro/obs/calibrate.py``, on the port's ``HardwareSpec``).

``core/plan.derive_serve_plan`` prices a plan with a decode roofline; this
module checks those prices against what a dispatch actually costs:

* :func:`step_time_model` freezes the per-dispatch constants of the JAX
  planner's ``predict_point`` roofline (weight stream, KV bytes/token,
  FLOPs/row, interconnect, dispatch overhead) into a
  :class:`StepTimeModel` whose :meth:`~StepTimeModel.predict_s` is two
  multiplies and a max per dispatch, using the dispatch's *actual* row
  count and resident context;
* :class:`DriftMeter` accumulates ``ratio = measured / predicted`` per
  phase (``prefill`` when any prompt rows ride the slab, else ``decode``;
  rolled spans are ``decode``) with an EWMA and percentile report —
  surfaced as ``engine.summary()["calibration"]``.

A ratio of 1.0 means the roofline prices this device perfectly; on the CPU
test backend expect large ratios — that *is* the honest signal explaining
why modeled orderings need not survive replay there.  The first dispatch
of each step function (kernel builds, library set-up) is excluded by the
engine (same guard as its step-time EMA), so drift measures steady-state
dispatches only.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.hardware import HardwareSpec

_EPS_S = 1e-12


@dataclasses.dataclass(frozen=True)
class StepTimeModel:
    """Per-dispatch roofline with the plan/hardware constants pre-folded.

    ``predict_s(rows, ctx_tokens, k)`` prices one dispatch of ``k`` device
    iterations, each forwarding ``rows`` live slab rows against
    ``ctx_tokens`` total resident KV positions:

    * memory  — ``weight_bytes + ctx_tokens * kv_bytes_per_token`` (plus
      the dense gather tax when the fused kernel is off) over HBM bandwidth;
    * compute — ``2 * P_active * rows`` over peak FLOP/s;
    * ici     — the per-layer ring all-reduce bytes when model-sharded;
    * total   — ``k * max(memory, compute, ici) + dispatch_overhead`` (one
      host->device dispatch per *span*, which is precisely the rolled
      loop's amortization claim).
    """

    weight_bytes_chip: float
    kv_bytes_per_token_chip: float
    gather_tax_per_token_chip: float  # extra bytes/ctx-token, fused off
    flops_per_row_chip: float
    ici_bytes_per_row_chip: float
    hbm_bandwidth: float
    peak_flops: float
    ici_bandwidth: float
    dispatch_overhead_s: float

    def predict_s(self, rows: float, ctx_tokens: float, k: int = 1) -> float:
        mem_bytes = (
            self.weight_bytes_chip
            + ctx_tokens
            * (self.kv_bytes_per_token_chip + self.gather_tax_per_token_chip)
        )
        t_mem = (
            mem_bytes / self.hbm_bandwidth
            if self.hbm_bandwidth > 0
            else math.inf
        )
        t_comp = (
            self.flops_per_row_chip * rows / self.peak_flops
            if self.peak_flops > 0
            else math.inf
        )
        t_ici = (
            self.ici_bytes_per_row_chip * rows / self.ici_bandwidth
            if self.ici_bytes_per_row_chip and self.ici_bandwidth > 0
            else 0.0
        )
        return max(1, int(k)) * max(t_mem, t_comp, t_ici) + self.dispatch_overhead_s


def step_time_model(
    cfg, serve, hw: HardwareSpec, *, mesh_model: int = 1, fused: bool = True
) -> StepTimeModel:
    """Freeze the ``core/search.predict_point`` roofline terms for one
    (arch, serve plan, device, TP degree) — the engine builds this once at
    construction so per-dispatch prediction costs O(1)."""
    ma = max(1, int(mesh_model))
    p_active = cfg.param_count(active_only=True)
    ici_bytes_per_row = 0.0
    if ma > 1:
        # one ring all-reduce of the (rows, d_model) activations per layer
        ici_bytes_per_row = 2.0 * cfg.d_model * 2.0 * cfg.n_layers * (ma - 1) / ma
    return StepTimeModel(
        weight_bytes_chip=2.0 * p_active / ma,
        kv_bytes_per_token_chip=serve.kv_bytes_per_token / ma,
        gather_tax_per_token_chip=(
            0.0 if fused else 2.0 * serve.kv_bytes_per_token / ma
        ),
        flops_per_row_chip=2.0 * p_active / ma,
        ici_bytes_per_row_chip=ici_bytes_per_row,
        hbm_bandwidth=hw.hbm_bandwidth,
        peak_flops=hw.peak_flops_bf16,
        ici_bandwidth=hw.ici_bandwidth,
        dispatch_overhead_s=hw.dispatch_overhead_s,
    )


class DriftMeter:
    """Accumulates (predicted, measured) dispatch times per phase.

    Bounded memory: per phase, the ratio sample window keeps the most
    recent ``keep`` dispatches (percentiles are over that window) while
    the count / time totals and the EWMA cover the whole run."""

    def __init__(self, *, ewma_alpha: float = 0.1, keep: int = 2048):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha: must be in (0, 1], got {ewma_alpha}")
        self.ewma_alpha = float(ewma_alpha)
        self.keep = int(keep)
        self._phases: dict = {}

    def record(self, phase: str, predicted_s: float, measured_s: float) -> None:
        s = self._phases.get(phase)
        if s is None:
            s = self._phases[phase] = {
                "n": 0,
                "predicted_s": 0.0,
                "measured_s": 0.0,
                "ratios": collections.deque(maxlen=self.keep),
                "ewma": None,
            }
        ratio = float(measured_s) / max(float(predicted_s), _EPS_S)
        s["n"] += 1
        s["predicted_s"] += float(predicted_s)
        s["measured_s"] += float(measured_s)
        s["ratios"].append(ratio)
        s["ewma"] = (
            ratio
            if s["ewma"] is None
            else (1.0 - self.ewma_alpha) * s["ewma"] + self.ewma_alpha * ratio
        )

    @property
    def empty(self) -> bool:
        return not self._phases

    def phase_report(self, phase: str) -> Optional[dict]:
        s = self._phases.get(phase)
        if s is None or s["n"] == 0:
            return None
        arr = np.asarray(s["ratios"], np.float64)
        return {
            "n": s["n"],
            "predicted_ms_mean": s["predicted_s"] / s["n"] * 1e3,
            "measured_ms_mean": s["measured_s"] / s["n"] * 1e3,
            # aggregate ratio over total time — robust to per-dispatch noise
            "ratio": s["measured_s"] / max(s["predicted_s"], _EPS_S),
            "ratio_ewma": s["ewma"],
            "ratio_p50": float(np.percentile(arr, 50)),
            "ratio_p90": float(np.percentile(arr, 90)),
            "ratio_p99": float(np.percentile(arr, 99)),
        }

    def report(self) -> dict:
        """The ``summary()["calibration"]`` payload: per-phase drift plus a
        one-line verdict a human (or the family-search replay) can quote."""
        phases = {
            ph: self.phase_report(ph) for ph in sorted(self._phases)
        }
        ratios = [p["ratio"] for p in phases.values() if p is not None]
        overall = (
            sum(s["measured_s"] for s in self._phases.values())
            / max(sum(s["predicted_s"] for s in self._phases.values()), _EPS_S)
            if self._phases
            else None
        )
        return {
            "phases": phases,
            "overall_ratio": overall,
            "note": _verdict(overall) if ratios else "no calibrated dispatches",
        }


def _verdict(ratio: Optional[float]) -> str:
    if ratio is None:
        return "no calibrated dispatches"
    if 0.5 <= ratio <= 2.0:
        return (
            f"roofline within 2x of measured (ratio {ratio:.2f}); "
            "modeled orderings should roughly hold here"
        )
    direction = "slower" if ratio > 1 else "faster"
    return (
        f"measured steps are {ratio:.3g}x the roofline prediction "
        f"({direction} than modeled); modeled orderings need not survive "
        "replay on this backend"
    )

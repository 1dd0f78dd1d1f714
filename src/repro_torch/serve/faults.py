"""Deterministic chaos injection + fault-tolerance error types (the port's
copy of ``repro/serve/faults.py``: the same numpy draws for the same seed).

The serving engine consults a :class:`FaultInjector` at its dispatch
boundaries to simulate the failure modes real accelerators produce:

* **transient dispatch errors** — raised *before* the device call (so a
  failed attempt never touches the pools), in
  bursts of configurable length, driving the engine's retry ladder;
* **non-finite logits** — a per-slot additive poison vector folded into
  the step as *data* (no shape change), caught by the
  on-device finiteness check and answered with quarantine + replay;
* **block-pool pressure** — the injector temporarily holds blocks from
  the allocator's free list, squeezing admission and rolled-horizon
  planning;
* **step-time spikes** — real sleeps inside the timed dispatch window,
  stressing the SLO/EMA feedback loop.

Every decision is a pure function of ``(seed, kind, iteration)`` via a
freshly seeded generator per draw, so a schedule replays identically
regardless of how many times or in what order the engine asks — the
property the chaos-parity tests lean on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Degradation-ladder rungs, in escalation order.
LADDER = ("rolled", "mixed", "gather")

# RNG stream salts, one per fault kind — the (seed, salt, iteration) triple
# is the whole determinism key, and trace events carry it verbatim so a
# chaos run is visually replayable from its Chrome trace alone.
SALTS = {"transient": 1, "nan": 2, "pressure": 3, "spike": 4}


class TransientDeviceError(RuntimeError):
    """Simulated (or mapped) transient device failure for one dispatch."""


class StallError(RuntimeError):
    """The engine made no progress for ``stall_limit`` consecutive steps."""

    def __init__(self, message: str, health: Optional[dict] = None):
        super().__init__(message)
        self.health = dict(health or {})


class LadderExhausted(RuntimeError):
    """Transient faults persisted through every rung of the retry ladder."""

    def __init__(self, message: str, health: Optional[dict] = None):
        super().__init__(message)
        self.health = dict(health or {})


class FaultInjector:
    """Seeded, deterministic fault schedule consulted by the engine.

    Rates are per-engine-iteration probabilities in ``[0, 1]``. With
    ``horizon`` set, no *new* fault fires at or after that iteration
    (in-flight bursts and held pool blocks still unwind), which
    guarantees chaotic streams eventually drain.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        transient_rate: float = 0.0,
        transient_burst: int = 1,
        nan_rate: float = 0.0,
        pressure_rate: float = 0.0,
        pressure_frac: float = 0.5,
        pressure_steps: int = 4,
        spike_rate: float = 0.0,
        spike_ms: float = 5.0,
        horizon: Optional[int] = None,
    ):
        if transient_burst < 1:
            raise ValueError("transient_burst: must be >= 1")
        for name, rate in (
            ("transient_rate", transient_rate),
            ("nan_rate", nan_rate),
            ("pressure_rate", pressure_rate),
            ("spike_rate", spike_rate),
        ):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name}: must be in [0, 1], got {rate}")
        self.seed = int(seed)
        self.transient_rate = float(transient_rate)
        self.transient_burst = int(transient_burst)
        self.nan_rate = float(nan_rate)
        self.pressure_rate = float(pressure_rate)
        self.pressure_frac = float(pressure_frac)
        self.pressure_steps = int(pressure_steps)
        self.spike_rate = float(spike_rate)
        self.spike_ms = float(spike_ms)
        self.horizon = horizon
        self.counts = {"transient": 0, "nan": 0, "squeeze": 0, "spike": 0}
        self._burst_left = 0
        self._tripped: set[int] = set()  # iterations whose transient already drew
        self.held: list[int] = []  # blocks squeezed out of the pool
        self._release_at = -1
        self.obs = None  # Observability bundle (engine binds its own)

    # -- observability ---------------------------------------------------
    def bind(self, obs) -> None:
        """Attach a ``repro_torch.obs.Observability`` bundle: every injection
        fires a metric + a trace instant tagged (seed, salt, iteration).
        The engine binds its bundle at construction; NaN poisons are the
        one kind the *engine* emits instead (only it knows how many landed
        on occupied slots)."""
        self.obs = obs

    def _emit(self, kind: str, iteration: int, **extra) -> None:
        if self.obs is not None:
            self.obs.on_fault(
                kind, seed=self.seed, salt=SALTS[kind],
                iteration=int(iteration), **extra,
            )

    # -- determinism core ------------------------------------------------
    def _rng(self, iteration: int, salt: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, salt, int(iteration)])

    def _armed(self, iteration: int) -> bool:
        return self.horizon is None or iteration < self.horizon

    # -- transient dispatch failures -------------------------------------
    def check_dispatch(self, iteration: int) -> None:
        """Raise :class:`TransientDeviceError` if this attempt should fail.

        Each scheduled fault fails ``transient_burst`` consecutive
        attempts (the initial one plus retries), so burst length vs the
        plan's ``retry_limit`` decides whether the engine recovers
        in-rung or escalates down the ladder.
        """
        if self._burst_left > 0:
            self._burst_left -= 1
            self.counts["transient"] += 1
            self._emit("transient", iteration, burst_left=self._burst_left)
            raise TransientDeviceError(f"injected transient fault @ iter {iteration}")
        if self.transient_rate <= 0 or not self._armed(iteration):
            return
        if iteration in self._tripped:
            return
        if self._rng(iteration, 1).random() < self.transient_rate:
            self._tripped.add(iteration)
            self._burst_left = self.transient_burst - 1
            self.counts["transient"] += 1
            self._emit("transient", iteration, burst_left=self._burst_left)
            raise TransientDeviceError(f"injected transient fault @ iter {iteration}")

    # -- NaN poison ------------------------------------------------------
    def nan_mask(self, iteration: int, n_slots: int) -> np.ndarray:
        """Boolean (B,) mask of slots whose logits are poisoned this iteration."""
        if self.nan_rate <= 0 or not self._armed(iteration):
            return np.zeros(n_slots, dtype=bool)
        return self._rng(iteration, 2).random(n_slots) < self.nan_rate

    def nan_in_span(self, iteration: int, k: int, n_slots: int) -> np.ndarray:
        """Per-slot offset in ``[0, k)`` of the first poisoned rolled
        iteration, or -1 — the same schedule :meth:`nan_mask` would
        produce if the span ran as K separate dispatches."""
        off = np.full(n_slots, -1, dtype=np.int32)
        for t in range(int(k)):
            mask = self.nan_mask(iteration + t, n_slots) & (off < 0)
            off[mask] = t
        return off

    # -- block-pool pressure ---------------------------------------------
    def pressure(self, iteration: int, alloc) -> None:
        """Maybe squeeze the free list; release a previous squeeze when due."""
        if self.held and iteration >= self._release_at:
            alloc.free(self.held)
            self.held = []
        if self.held or self.pressure_rate <= 0 or not self._armed(iteration):
            return
        if self._rng(iteration, 3).random() < self.pressure_rate:
            n = int(self.pressure_frac * alloc.available)
            if n > 0:
                got = alloc.alloc(n)
                if got:
                    self.held = got
                    self._release_at = iteration + self.pressure_steps
                    self.counts["squeeze"] += 1
                    self._emit(
                        "pressure", iteration,
                        blocks_held=len(got), release_at=self._release_at,
                    )

    def release(self, alloc) -> None:
        """Hand back any squeezed blocks (e.g. after the stream drained)."""
        if self.held:
            alloc.free(self.held)
            self.held = []

    # -- step-time spikes ------------------------------------------------
    def spike_s(self, iteration: int) -> float:
        """Seconds of artificial device latency for this dispatch (0 = none)."""
        if self.spike_rate <= 0 or not self._armed(iteration):
            return 0.0
        if self._rng(iteration, 4).random() < self.spike_rate:
            self.counts["spike"] += 1
            self._emit("spike", iteration, ms=self.spike_ms)
            return self.spike_ms / 1e3
        return 0.0

    # -- reporting -------------------------------------------------------
    def to_record(self) -> dict:
        return {
            "seed": self.seed,
            "transient_rate": self.transient_rate,
            "transient_burst": self.transient_burst,
            "nan_rate": self.nan_rate,
            "pressure_rate": self.pressure_rate,
            "pressure_frac": self.pressure_frac,
            "pressure_steps": self.pressure_steps,
            "spike_rate": self.spike_rate,
            "spike_ms": self.spike_ms,
            "horizon": self.horizon,
        }

    def summary(self) -> dict:
        return {"spec": self.to_record(), "injected": dict(self.counts)}

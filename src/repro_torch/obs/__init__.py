"""``repro_torch.obs`` — serving observability (the port's copy of
``repro/obs``): the bundle the engine, scheduler, draft sources and fault
injector emit into.

* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
  fixed-bucket histograms with declared labels; Prometheus text exposition
  + JSON snapshot (``launch/serve.py --metrics-out``);
* :class:`~repro_torch.obs.trace.Tracer` — ring-buffered per-request
  lifecycle spans and per-dispatch step spans, exported as Chrome
  ``trace_event`` JSON (``--trace-out`` / ``--trace-buffer``);
* :class:`~repro_torch.obs.calibrate.DriftMeter` — predicted (roofline) vs
  measured wall time per dispatch, per phase
  (``engine.summary()["calibration"]``).

``Observability()`` is what every engine gets when the caller passes
nothing: metrics + drift on (host dict arithmetic), tracing *off* — the
disabled tracer returns before touching its ring, so the engine hot path
is unchanged.  Every hook is host-side accounting only: no tensors, no
device work, no synchronisation.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.calibrate import DriftMeter, StepTimeModel, step_time_model
from repro_torch.obs.metrics import (
    DEFAULT_MS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus_text,
    prometheus_roundtrip_ok,
)
from repro_torch.obs.trace import (
    PID_ENGINE,
    PID_REQUESTS,
    TID_DISPATCH,
    TID_FAULTS,
    Tracer,
    validate_chrome_trace,
)


class Observability:
    """The per-engine observability bundle + its emission API.

    Every hook is host-side accounting only — no tensors, no shapes, no
    device work — so enabling or disabling observability can never perturb
    the engine's byte output or its dispatches.
    """

    def __init__(
        self,
        *,
        tracing: bool = False,
        trace_buffer: int = 65536,
        metrics: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
        drift: Optional[DriftMeter] = None,
    ):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = (
            tracer
            if tracer is not None
            else Tracer(trace_buffer, enabled=tracing)
        )
        self.drift = drift if drift is not None else DriftMeter()
        m = self.metrics
        # ---- the serving metric catalog (the JAX package's) ---------------
        self.m_submitted = m.counter(
            "serve_requests_submitted_total",
            "Requests entering the waiting queue", ("tenant", "wclass"),
        )
        self.m_finished = m.counter(
            "serve_requests_finished_total",
            "Requests retired, by disposition", ("tenant", "status"),
        )
        self.m_admissions = m.counter(
            "serve_admissions_total", "Slot admissions (incl. re-admissions)"
        )
        self.m_evictions = m.counter(
            "serve_evictions_total", "Recompute-style preemptions"
        )
        self.m_prefix_hits = m.counter(
            "serve_prefix_hits_total", "Admissions that reused a resident prefix"
        )
        self.m_prefix_saved = m.counter(
            "serve_prefix_tokens_saved_total", "Prompt tokens never re-prefilled"
        )
        self.m_forks = m.counter(
            "serve_forks_total", "Copy-on-write forks scheduled at admission"
        )
        self.m_steps = m.counter(
            "serve_steps_total",
            "Device dispatches by program kind", ("kind",),
        )
        self.m_tokens = m.counter(
            "serve_tokens_total",
            "Slab rows consumed, by kind (generated = emitted output tokens;"
            " prefill = prompt rows)", ("kind",),
        )
        self.m_draft_rows = m.counter(
            "serve_draft_rows_total", "Speculative rows submitted for verification"
        )
        self.m_draft_accepted = m.counter(
            "serve_draft_accepted_total", "Draft rows the target accepted"
        )
        self.m_draft_rounds = m.counter(
            "serve_draft_rounds_total",
            "Draft proposal rounds, by source", ("source",),
        )
        self.m_draft_proposed = m.counter(
            "serve_draft_proposed_total",
            "Draft tokens proposed, by source", ("source",),
        )
        self.m_draft_steps = m.counter(
            "serve_draft_device_steps_total",
            "Drafter device dispatches, by source", ("source",),
        )
        self.m_quarantines = m.counter(
            "serve_quarantines_total", "Non-finite slot-steps quarantined"
        )
        self.m_retries = m.counter(
            "serve_retries_total", "Transient-fault dispatch retries"
        )
        self.m_faults = m.counter(
            "serve_faults_injected_total",
            "Chaos injections fired, by kind", ("kind",),
        )
        self.m_rung_changes = m.counter(
            "serve_rung_changes_total",
            "Degradation-ladder moves", ("direction",),
        )
        self.m_rung = m.gauge(
            "serve_rung", "Current ladder rung (0 rolled, 1 mixed, 2 gather)"
        )
        self.m_blocks_in_use = m.gauge(
            "serve_blocks_in_use", "KV pool blocks currently referenced"
        )
        self.m_blocks_available = m.gauge(
            "serve_blocks_available", "KV pool blocks free"
        )
        self.m_slots_active = m.gauge(
            "serve_slots_active", "Decode slots holding a request"
        )
        self.m_queue_depth = m.gauge(
            "serve_queue_depth", "Requests waiting (arrived or future)"
        )
        self.m_step_ms = m.histogram(
            "serve_step_ms",
            "Measured device dispatch wall time (whole span for rolled)",
            ("phase",),
        )
        self.m_ttft_ms = m.histogram(
            "serve_ttft_ms", "Admit -> first token", ("tenant",)
        )
        self.m_latency_ms = m.histogram(
            "serve_latency_ms", "Admit -> done (finished only)", ("tenant",)
        )

    # ------------------------------------------------------ request events
    def on_submit(self, req) -> None:
        self.m_submitted.inc(tenant=req.tenant, wclass=req.tag or "")

    def on_admit(
        self, req, now: float, *, prefix_tokens: int = 0, forked: bool = False
    ) -> None:
        self.m_admissions.inc()
        if prefix_tokens > 0:
            self.m_prefix_hits.inc()
            self.m_prefix_saved.inc(prefix_tokens)
        if forked:
            self.m_forks.inc()
        if req.t_submit is not None:
            self.tracer.request_span(
                "queued", req.rid, req.t_submit, now,
                {"tenant": req.tenant, "wclass": req.tag or "",
                 "prefix_tokens": prefix_tokens},
            )
        self.tracer.request_instant(
            "admitted", req.rid, now, {"slot": req.slot}
        )

    def on_finish(self, req, now: float) -> None:
        self.m_finished.inc(tenant=req.tenant, status="ok")
        if req.t_admit is not None:
            if req.t_first is not None:
                self.m_ttft_ms.observe(
                    (req.t_first - req.t_admit) * 1e3, tenant=req.tenant
                )
            self.m_latency_ms.observe(
                (now - req.t_admit) * 1e3, tenant=req.tenant
            )
        t0 = req.t_submit if req.t_submit is not None else now
        self.tracer.request_span(
            "request", req.rid, t0, now,
            {"tenant": req.tenant, "wclass": req.tag or "",
             "tokens": len(req.out), "status": "ok"},
        )
        self.tracer.request_instant("finished", req.rid, now)

    def on_cancel(self, req, status: str, now: float) -> None:
        """A request retired without completing: shed / expired / cancelled
        / poisoned."""
        self.m_finished.inc(tenant=req.tenant, status=status)
        self.tracer.request_instant(
            status, req.rid, now, {"tenant": req.tenant}
        )

    def on_evict(self, req, now: float) -> None:
        self.m_evictions.inc()
        self.tracer.request_instant("evict", req.rid, now)

    def on_quarantine(self, req, now: float) -> None:
        self.m_quarantines.inc()
        self.tracer.request_instant(
            "quarantine", req.rid, now, {"streak": req.quarantine_streak}
        )

    # ----------------------------------------------------- dispatch events
    def on_dispatch(
        self,
        kind: str,
        phase: str,
        t0: float,
        t1: float,
        *,
        rows: int,
        composition: Optional[dict] = None,
        rung: str = "",
        k: int = 1,
        predicted_s: Optional[float] = None,
        calibrated: bool = True,
    ) -> None:
        """One device dispatch (a step, a rolled span, or the gather
        fallback).  ``calibrated=False`` (a step function's first
        dispatch) records the step metric but keeps the drift meter clean."""
        measured_s = t1 - t0
        self.m_steps.inc(kind=kind)
        self.m_step_ms.observe(measured_s * 1e3, phase=phase)
        if calibrated and predicted_s is not None:
            self.drift.record(phase, predicted_s, measured_s)
        args = {
            "phase": phase, "rows": rows, "rung": rung, "k": k,
            "measured_ms": measured_s * 1e3,
        }
        if predicted_s is not None:
            args["predicted_ms"] = predicted_s * 1e3
            args["calibrated"] = bool(calibrated)
        if composition:
            args["kinds"] = dict(composition)
        self.tracer.complete(kind, PID_ENGINE, TID_DISPATCH, t0, t1, args)

    def on_step_counts(self, c: dict) -> None:
        """Fold one dispatch's accounting dict (``_slab_done`` /
        ``_rolled_done`` return value) into the token counters."""
        if c.get("generated"):
            self.m_tokens.inc(c["generated"], kind="generated")
        if c.get("prefill"):
            self.m_tokens.inc(c["prefill"], kind="prefill")
        if c.get("draft_rows"):
            self.m_draft_rows.inc(c["draft_rows"])
        if c.get("accepted_drafts"):
            self.m_draft_accepted.inc(c["accepted_drafts"])

    def on_draft_round(
        self, source: str, n_asks: int, n_proposed: int, device_steps: int = 0
    ) -> None:
        """One draft-source proposal round (speculative decoding)."""
        self.m_draft_rounds.inc(source=source)
        if n_proposed:
            self.m_draft_proposed.inc(n_proposed, source=source)
        if device_steps:
            self.m_draft_steps.inc(device_steps, source=source)

    def set_pool(
        self, *, available: int, in_use: int, active: int, queued: int
    ) -> None:
        self.m_blocks_available.set(available)
        self.m_blocks_in_use.set(in_use)
        self.m_slots_active.set(active)
        self.m_queue_depth.set(queued)

    # ------------------------------------------------- faults + the ladder
    def on_fault(
        self,
        kind: str,
        *,
        seed: int,
        salt: int,
        iteration: int,
        t: Optional[float] = None,
        **extra,
    ) -> None:
        """One chaos injection, tagged with the injector's determinism key
        (seed, salt, iteration) so a trace visually replays the schedule."""
        self.m_faults.inc(kind=kind)
        self.tracer.instant(
            f"fault:{kind}", PID_ENGINE, TID_FAULTS, t,
            {"seed": seed, "salt": salt, "iteration": iteration, **extra},
        )

    def on_retry(self) -> None:
        self.m_retries.inc()

    def on_rung(self, direction: str, rung: int, rung_name: str) -> None:
        self.m_rung_changes.inc(direction=direction)
        self.m_rung.set(rung)
        self.tracer.instant(
            f"rung:{direction}", PID_ENGINE, TID_DISPATCH, None,
            {"rung": rung, "rung_name": rung_name},
        )


__all__ = [
    "Observability",
    # metrics layer
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_MS_BUCKETS",
    "parse_prometheus_text",
    "prometheus_roundtrip_ok",
    # tracing layer
    "Tracer",
    "validate_chrome_trace",
    "PID_ENGINE",
    "PID_REQUESTS",
    "TID_DISPATCH",
    "TID_FAULTS",
    # calibration layer
    "DriftMeter",
    "StepTimeModel",
    "step_time_model",
]

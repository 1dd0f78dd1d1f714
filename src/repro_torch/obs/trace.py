"""Lifecycle tracing: ring-buffered spans exported as Chrome ``trace_event``
JSON (load in Perfetto / ``chrome://tracing``); the port's copy of
``repro/obs/trace.py``.

Two kinds of tracks:

* the **engine** process (pid 1) carries one span per device dispatch
  (``step`` / ``rolled_step`` / ``fallback_step``), annotated with the slab
  composition, rolled-K and the degradation-ladder rung, plus an instant
  per injected fault (tid 1) tagged with the injector's (seed, salt,
  iteration) so a chaos run is visually replayable;
* the **requests** process (pid 2) gives each request its own thread: the
  ``queued`` span, per-dispatch ``prefill-chunk`` / ``decode`` spans (their
  window is the enclosing step span's window, so lifecycles nest under
  dispatches on the timeline), ``spec-verify`` / ``rollback``, and the
  terminal ``finished`` / ``shed`` / ``evict`` / ``quarantine`` instants.

The backend is a ``deque(maxlen=buffer)`` ring: always-on tracing is O(1)
memory and O(1) per event; overflow drops the *oldest* events and counts
them (``dropped``), never blocks.  A disabled tracer (``enabled=False``)
returns from every emit before touching the ring — the hot path costs one
attribute load + branch, performs no host->device work, and therefore
cannot change the engine's dispatches or byte output (asserted by the
parity matrix with observability on vs off).

Timestamps are ``time.perf_counter()`` converted to µs relative to the
tracer's birth — the same clock every engine/scheduler ``t_*`` field uses,
so span boundaries line up exactly with the latency accounting.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Optional

# Chrome trace_event pids: one fake "process" per subsystem.
PID_ENGINE = 1
PID_REQUESTS = 2
TID_DISPATCH = 0  # engine pid: device dispatches
TID_FAULTS = 1  # engine pid: chaos injections

# Request threads cycle through a bounded id space so the rid -> tid map
# stays O(1) memory on unbounded streams (collisions only recolor lanes in
# the viewer; events still carry the rid in args).
_MAX_REQUEST_TIDS = 4096


class Tracer:
    """Ring-buffered Chrome trace_event collector (or a no-op when
    ``enabled=False`` — same type, so call sites never branch)."""

    def __init__(self, buffer: int = 65536, enabled: bool = True):
        if buffer <= 0:
            raise ValueError(f"buffer: must be positive, got {buffer}")
        self.enabled = bool(enabled)
        self.buffer = int(buffer)
        self.dropped = 0
        self._events: collections.deque = collections.deque(maxlen=self.buffer)
        self._t0 = time.perf_counter()
        self._rid_tids: dict = {}
        self._next_tid = 0

    # ------------------------------------------------------------- plumbing
    def _ts(self, t: float) -> float:
        return (t - self._t0) * 1e6  # perf_counter seconds -> trace µs

    def _push(self, ev: dict) -> None:
        if len(self._events) == self.buffer:
            self.dropped += 1
        self._events.append(ev)

    def _request_tid(self, rid: str) -> int:
        tid = self._rid_tids.get(rid)
        if tid is None:
            if len(self._rid_tids) >= _MAX_REQUEST_TIDS:
                self._rid_tids.clear()
            tid = self._next_tid % _MAX_REQUEST_TIDS
            self._next_tid += 1
            self._rid_tids[rid] = tid
        return tid

    # ------------------------------------------------------------ emitters
    def complete(
        self,
        name: str,
        pid: int,
        tid: int,
        t0: float,
        t1: float,
        args: Optional[dict] = None,
    ) -> None:
        """One ``ph: X`` complete event over the [t0, t1] perf_counter
        window (clamped to zero duration if the clock went backwards)."""
        if not self.enabled:
            return
        self._push({
            "name": name, "ph": "X", "pid": pid, "tid": tid,
            "ts": self._ts(t0), "dur": max(0.0, (t1 - t0) * 1e6),
            "args": args or {},
        })

    def instant(
        self,
        name: str,
        pid: int,
        tid: int,
        t: Optional[float] = None,
        args: Optional[dict] = None,
    ) -> None:
        if not self.enabled:
            return
        self._push({
            "name": name, "ph": "i", "pid": pid, "tid": tid,
            "ts": self._ts(t if t is not None else time.perf_counter()),
            "s": "t", "args": args or {},
        })

    def request_span(
        self, name: str, rid: str, t0: float, t1: float,
        args: Optional[dict] = None,
    ) -> None:
        if not self.enabled:
            return
        self.complete(
            name, PID_REQUESTS, self._request_tid(rid), t0, t1,
            {"rid": rid, **(args or {})},
        )

    def request_instant(
        self, name: str, rid: str, t: Optional[float] = None,
        args: Optional[dict] = None,
    ) -> None:
        if not self.enabled:
            return
        self.instant(
            name, PID_REQUESTS, self._request_tid(rid), t,
            {"rid": rid, **(args or {})},
        )

    # -------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        """The Chrome trace_event JSON object (load in Perfetto).

        Events are sorted by timestamp (the ring preserves *completion*
        order; viewers and the golden test want monotone ``ts``), with
        process/thread naming metadata prepended."""
        meta = [
            _meta("process_name", PID_ENGINE, 0, "engine"),
            _meta("thread_name", PID_ENGINE, TID_DISPATCH, "dispatch"),
            _meta("thread_name", PID_ENGINE, TID_FAULTS, "faults"),
            _meta("process_name", PID_REQUESTS, 0, "requests"),
        ]
        for rid, tid in sorted(self._rid_tids.items()):
            meta.append(_meta("thread_name", PID_REQUESTS, tid, rid))
        events = sorted(self._events, key=lambda e: e["ts"])
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def write(self, path: str) -> int:
        """Dump the Chrome trace to ``path``; returns the event count
        (excluding naming metadata)."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")


def _meta(name: str, pid: int, tid: int, label: str) -> dict:
    return {
        "name": name, "ph": "M", "pid": pid, "tid": tid, "ts": 0.0,
        "args": {"name": label},
    }


def validate_chrome_trace(doc: dict) -> list:
    """Assert ``doc`` is structurally valid Chrome ``trace_event`` JSON with
    monotone non-meta timestamps; returns the non-meta events.  Used by the
    golden-file test and the launcher after ``--trace-out``."""
    assert isinstance(doc, dict) and isinstance(doc.get("traceEvents"), list), (
        "trace must be the JSON-object form with a traceEvents list"
    )
    events = []
    last_ts = None
    for ev in doc["traceEvents"]:
        assert isinstance(ev, dict), ev
        assert isinstance(ev.get("name"), str) and ev["name"], ev
        assert ev.get("ph") in {"X", "i", "M"}, ev
        assert isinstance(ev.get("pid"), int), ev
        assert isinstance(ev.get("tid"), int), ev
        ts = ev.get("ts")
        assert isinstance(ts, (int, float)) and ts >= 0.0, ev
        if ev["ph"] == "M":
            continue
        if ev["ph"] == "X":
            dur = ev.get("dur")
            assert isinstance(dur, (int, float)) and dur >= 0.0, ev
        assert last_ts is None or ts >= last_ts, (
            f"timestamps not monotone: {ts} after {last_ts}"
        )
        last_ts = ts
        events.append(ev)
    return events

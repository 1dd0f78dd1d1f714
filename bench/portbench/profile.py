"""The measured window, and with ``--trace 1`` the device trace over it.

The window is a span on the host's clock.  Traced, ``torch.profiler``
records the card's activity (kernels, copies, sets) through CUPTI for the
window's length; the harness's own spans (``bench.step``, ``bench.submit``,
``bench.train_step`` ...) are kept on the host's wall clock beside it, so
an idle gap on the device can be named by what the host was doing.  Host
operators are not recorded: their overhead would move the window's times."""
from __future__ import annotations

import contextlib
import time
from typing import Optional


class Spans:
    """The harness's spans: (name, start, end) in ns of the wall clock, the
    clock the profiler's events carry."""

    def __init__(self, on: bool):
        self.on = on
        self.rows: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.rows.append((name, t0, time.time_ns()))


class Window:
    """``with window() as w: ...; w.close(t)``: ``t0`` when it opened (or
    the given ``start``), ``t1`` its close, on ``time.perf_counter``; the
    wall-clock ns of both ends for the trace; the device trace when on."""

    def __init__(self, trace: bool, device=None):
        self.trace = trace
        self.device = device
        self.t0 = self.t1 = None
        self.ns0 = self.ns1 = None
        self.events: Optional[list] = None
        self.prof = None

    def __call__(self, start: Optional[float] = None):
        self._start = start
        return self

    def __enter__(self):
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.reset_peak_memory_stats(self.device)  # the window's own peak
        if self.trace:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        now = time.perf_counter()
        self.ns0 = time.time_ns()
        self.t0 = now if self._start is None else self._start
        return self

    def close(self, t: float) -> None:
        self.t1 = t

    def __exit__(self, *exc):
        self.ns1 = time.time_ns()
        if self.prof is not None:
            import torch

            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.events = device_events(self.prof)
            self.prof = None
        return False


def device_events(prof) -> list:
    """(name, start ns, end ns) of every device activity in the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
        dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
        out.append((e.name(), start, start + dur))
    return out


class Trace:
    """What the readers get of a traced window."""

    def __init__(self, events: list, ns0: int, ns1: int, spans: list):
        self.ns0, self.ns1 = ns0, ns1
        self.events = sorted(((n, max(a, ns0), min(b, ns1)) for n, a, b in events
                              if b > ns0 and a < ns1), key=lambda e: e[1])
        self.spans = sorted(spans, key=lambda s: s[1])
        self.window_s = (ns1 - ns0) / 1e9
        self.busy_intervals = _union([(a, b) for _, a, b in self.events])
        self.busy_s = sum(b - a for a, b in self.busy_intervals) / 1e9

    def device_ops(self, top: int = 10) -> list:
        tot: dict = {}
        for n, a, b in self.events:
            tot[n] = tot.get(n, 0) + (b - a)
        return [[n, t / 1e9] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time summed by the harness span the host was in at
        the gap's middle (``host`` where it was in none)."""
        gaps, prev = [], self.ns0
        for a, b in self.busy_intervals:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.ns1 > prev:
            gaps.append((prev, self.ns1))
        tot: dict = {}
        j = 0
        spans = self.spans
        for a, b in gaps:
            mid = (a + b) // 2
            name = "host"
            while j < len(spans) and spans[j][2] < mid:
                j += 1
            for s in spans[j:j + 8]:  # spans nest rarely; look at the next few
                if s[1] <= mid <= s[2]:
                    name = s[0]
                    break
            tot[name] = tot.get(name, 0) + (b - a)
        return [[n, t / 1e9] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:top]]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out

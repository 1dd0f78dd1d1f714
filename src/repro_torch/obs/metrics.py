"""Process-local metrics registry: counters, gauges, fixed-bucket histograms
(the port's copy of ``repro/obs/metrics.py``, unchanged in behaviour).

One :class:`MetricsRegistry` per serving engine (engine, scheduler, prefix
index, draft sources and the fault injector all emit into it) — the single
structured home for the numbers ``engine.summary()`` used to scatter across
bespoke dict sections.  The ``summary()`` sections remain as back-compat
aliases; this registry is the machine-readable source the launcher exports
(``--metrics-out``).

Design constraints, in order:

* **hot-path cheap** — an ``inc``/``observe`` is one tuple build and one
  dict update on the host; no locks (the engine is single-threaded by
  construction), no string formatting until exposition time;
* **fixed label sets** — every metric declares its label names up front
  and every sample must bind exactly those names, so cardinality is a
  review-time decision, never a runtime surprise;
* **fixed buckets** — histograms never rebucket; the defaults cover the
  step-time and request-latency ranges the serving stack produces
  (sub-ms CPU steps through multi-second chaos runs);
* **two wire formats** — a JSON-able :meth:`MetricsRegistry.snapshot` and
  a Prometheus text exposition (:meth:`MetricsRegistry.to_prometheus`)
  that round-trips through :func:`parse_prometheus_text` (asserted by
  ``chip_smoke.py`` and the launcher's tests).

The metric catalog with label schemas: docs/OBSERVABILITY.md (the JAX
package's; the port emits the same metrics).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Union

Number = Union[int, float]

# Prometheus metric / label name grammar (we enforce at registration so a
# bad name fails at construction, not at scrape time).
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Milliseconds: spans sub-ms fake-device steps through chaos-spiked multi-
# second tails.  Shared by step-time and request-latency histograms so
# cross-metric comparison needs no bucket translation.
DEFAULT_MS_BUCKETS = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
    200.0, 500.0, 1000.0, 2000.0, 5000.0,
)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without the trailing .0 (so
    counters read naturally), everything else via repr (round-trip exact)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Metric:
    """Base: a named family of samples keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = _check_name(name)
        self.help = help
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.labels = tuple(labels)
        self._samples: dict = {}

    def _key(self, kv: dict) -> tuple:
        if tuple(sorted(kv)) != tuple(sorted(self.labels)):
            raise ValueError(
                f"{self.name}: expected labels {self.labels}, got {tuple(kv)}"
            )
        return tuple(str(kv[ln]) for ln in self.labels)

    def _label_dict(self, key: tuple) -> dict:
        return dict(zip(self.labels, key))


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: Number = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up, got {amount}")
        k = self._key(labels)
        self._samples[k] = self._samples.get(k, 0) + amount

    def value(self, **labels) -> Number:
        return self._samples.get(self._key(labels), 0)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: Number, **labels) -> None:
        self._samples[self._key(labels)] = value

    def value(self, **labels) -> Number:
        return self._samples.get(self._key(labels), 0)


class Histogram(Metric):
    """Fixed cumulative buckets + sum + count, one set per label binding."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: tuple = (),
        buckets: tuple = DEFAULT_MS_BUCKETS,
    ):
        super().__init__(name, help, labels)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(bs):
            raise ValueError(f"{name}: buckets must be non-empty and sorted")
        self.buckets = bs

    def observe(self, value: Number, **labels) -> None:
        k = self._key(labels)
        s = self._samples.get(k)
        if s is None:
            s = self._samples[k] = {
                "buckets": [0] * len(self.buckets), "sum": 0.0, "count": 0,
            }
        v = float(value)
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                s["buckets"][i] += 1
                break
        s["sum"] += v
        s["count"] += 1


class MetricsRegistry:
    """Get-or-create factory + the two exposition formats."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, labels: tuple, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labels != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.kind}"
                    f"{tuple(labels)} (was {m.kind}{m.labels})"
                )
            return m
        m = cls(name, help, tuple(labels), **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "", labels: tuple = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: tuple = (),
        buckets: tuple = DEFAULT_MS_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    # ------------------------------------------------------- JSON snapshot
    def snapshot(self) -> dict:
        """JSON-able view: {name: {type, help, labels, samples}}."""
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            samples = []
            for key in sorted(m._samples):
                rec: dict = {"labels": m._label_dict(key)}
                s = m._samples[key]
                if isinstance(s, dict):  # histogram
                    rec["buckets"] = {
                        _fmt(edge): int(c)
                        for edge, c in zip(m.buckets, s["buckets"])
                    }
                    rec["sum"] = s["sum"]
                    rec["count"] = s["count"]
                else:
                    rec["value"] = s
                samples.append(rec)
            out[name] = {
                "type": m.kind,
                "help": m.help,
                "labels": list(m.labels),
                "samples": samples,
            }
        return out

    # ------------------------------------------- Prometheus text exposition
    def flat_samples(self) -> dict:
        """Every exposed series as {(name, ((label, value), ...)): float} —
        histogram buckets expand to ``_bucket``/``_sum``/``_count`` series
        exactly as the text format does.  This is the round-trip oracle:
        ``parse_prometheus_text(to_prometheus())`` must equal it."""
        flat: dict = {}
        for m in self._metrics.values():
            for key, s in m._samples.items():
                base = tuple(sorted(m._label_dict(key).items()))
                if isinstance(s, dict):  # histogram
                    cum = 0
                    for edge, c in zip(m.buckets, s["buckets"]):
                        cum += c
                        flat[
                            m.name + "_bucket",
                            tuple(sorted(base + (("le", _fmt(edge)),))),
                        ] = float(cum)
                    flat[
                        m.name + "_bucket",
                        tuple(sorted(base + (("le", "+Inf"),))),
                    ] = float(s["count"])
                    flat[m.name + "_sum", base] = float(s["sum"])
                    flat[m.name + "_count", base] = float(s["count"])
                else:
                    flat[m.name, base] = float(s)
        return flat

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key in sorted(m._samples):
                s = m._samples[key]
                base = m._label_dict(key)
                if isinstance(s, dict):  # histogram
                    cum = 0
                    for edge, c in zip(m.buckets, s["buckets"]):
                        cum += c
                        lines.append(
                            _series(m.name + "_bucket",
                                    {**base, "le": _fmt(edge)}, cum)
                        )
                    lines.append(
                        _series(m.name + "_bucket",
                                {**base, "le": "+Inf"}, s["count"])
                    )
                    lines.append(_series(m.name + "_sum", base, s["sum"]))
                    lines.append(_series(m.name + "_count", base, s["count"]))
                else:
                    lines.append(_series(m.name, base, s))
        return "\n".join(lines) + "\n"


def _series(name: str, labels: dict, value: Number) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{body}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> dict:
    """Parse an exposition back to {(name, sorted label tuple): float}.

    The inverse of :meth:`MetricsRegistry.to_prometheus` over everything
    the registry emits — :func:`prometheus_roundtrip_ok` asserts
    ``parse(to_prometheus()) == flat_samples()`` so the export is known
    machine-readable, not merely printable."""
    out: dict = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {raw!r}")
        labels = []
        if m.group("labels"):
            for lm in _LABEL_PAIR_RE.finditer(m.group("labels")):
                val = (
                    lm.group(2)
                    .replace("\\n", "\n")
                    .replace('\\"', '"')
                    .replace("\\\\", "\\")
                )
                labels.append((lm.group(1), val))
        v = m.group("value")
        value = math.inf if v == "+Inf" else (
            -math.inf if v == "-Inf" else float(v)
        )
        out[m.group("name"), tuple(sorted(labels))] = value
    return out


def prometheus_roundtrip_ok(reg: MetricsRegistry) -> bool:
    """True iff the text exposition parses back to exactly the registry's
    flat sample map (names, labels and values)."""
    return parse_prometheus_text(reg.to_prometheus()) == reg.flat_samples()

"""Multi-tenant trace workloads (the port's ``repro/serve/workload.py``, a
copy: numpy plus the port's ``Request``): heterogeneous request mixes for
the engine.

The serving analogue of CAT's workload-shaped customization: one engine
carries a *family* of traffic classes the way the paper's one framework
carries a family of accelerators.  A trace is composed from named workload
classes (lumos-style kernel-mix composition applied to requests):

* ``chat``      — medium prompts, long generations, interactive priority
                  and a TTFT target (a human is watching the first token).
* ``summarize`` — long-document prompts, short generations, batch priority
                  (throughput work; no TTFT target).
* ``classify``  — short prompts, tiny generations, the strictest TTFT
                  target and top priority (an online feature extractor).

Every tenant gets its own shared system prompt prepended to each of its
requests — the realistic N-users-one-prefix shape that prefix sharing
(``serve/prefix.py``) turns into one set of pages and one prefill.  Tokens
are synthetic (uniform over the vocab) but *content-correlated within a
tenant*, which is all the radix index cares about.

``make_trace`` builds the request list, ``parse_mix`` reads CLI specs like
``"chat:4,summarize:2,classify:2"``, and ``per_class_report`` turns the
engine's finished requests into per-class p50/p90/p99 latency/TTFT tables
(the engine's percentile stats, grouped by ``Request.tag``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serve.scheduler import Request


@dataclasses.dataclass(frozen=True)
class WorkloadClass:
    """One traffic class: prompt/generation shape + scheduling descriptors."""

    name: str
    prompt_len: tuple[int, int]  # uniform [lo, hi) user-turn tokens
    gen: tuple[int, int]  # uniform [lo, hi) max_new_tokens
    priority: int = 0
    slo_ttft_ms: Optional[float] = None

    def scaled(self, max_tokens: int) -> "WorkloadClass":
        """Shrink prompt/gen ranges to fit a small-context test plan while
        keeping the classes' relative shapes (long-doc stays the longest)."""
        lo, hi = self.prompt_len
        glo, ghi = self.gen
        f = min(1.0, max_tokens / 1024.0)
        cap = lambda x: max(2, int(x * f))
        return dataclasses.replace(
            self,
            prompt_len=(cap(lo), max(cap(hi), cap(lo) + 1)),
            gen=(max(1, int(glo * f)), max(2, int(ghi * f))),
        )


WORKLOADS: dict[str, WorkloadClass] = {
    "chat": WorkloadClass(
        "chat", prompt_len=(48, 160), gen=(32, 128), priority=1, slo_ttft_ms=200.0
    ),
    "summarize": WorkloadClass(
        "summarize", prompt_len=(512, 1024), gen=(16, 48), priority=0
    ),
    "classify": WorkloadClass(
        "classify", prompt_len=(8, 32), gen=(1, 4), priority=2, slo_ttft_ms=50.0
    ),
}


def parse_mix(spec: str) -> dict[str, int]:
    """``"chat:4,summarize:2"`` -> {"chat": 4, "summarize": 2}."""
    mix: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, count = part.partition(":")
        if name not in WORKLOADS:
            raise ValueError(
                f"unknown workload class {name!r}; have {sorted(WORKLOADS)}"
            )
        mix[name] = mix.get(name, 0) + (int(count) if count else 1)
    if not mix:
        raise ValueError(f"empty workload mix spec {spec!r}")
    return mix


def make_trace(
    cfg,
    mix: dict[str, int],
    *,
    tenants: int = 2,
    system_prompt_len: int = 32,
    stagger: int = 1,
    seed: int = 0,
    max_tokens: Optional[int] = None,
) -> list[Request]:
    """Compose a multi-tenant request trace from a workload-class mix.

    ``mix`` maps class name -> request count; requests round-robin over
    ``tenants`` tenants, each of which owns one ``system_prompt_len``-token
    system prompt shared verbatim by all its requests.  Arrivals interleave
    the classes (sorted by a per-request jittered clock) and stagger by
    ``stagger`` engine iterations; ``max_tokens`` (usually the plan's
    ``max_seq_len``) shrinks the class shapes to fit small test contexts.
    """
    rng = np.random.default_rng(seed)
    sys_prompts = [
        [int(t) for t in rng.integers(0, cfg.vocab_size, system_prompt_len)]
        for _ in range(tenants)
    ]
    raw = []
    for name in sorted(mix):
        wc = WORKLOADS[name]
        if max_tokens is not None:
            wc = wc.scaled(max(max_tokens - system_prompt_len, 8))
        for i in range(mix[name]):
            n = int(rng.integers(*wc.prompt_len))
            gen = int(rng.integers(wc.gen[0], wc.gen[1] + 1))
            tenant = len(raw) % tenants
            raw.append(
                (
                    float(rng.uniform()),  # arrival jitter: interleave classes
                    Request(
                        rid=f"{name[:4]}-t{tenant}-{i:03d}",
                        prompt=sys_prompts[tenant]
                        + [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
                        max_new_tokens=gen,
                        tenant=f"tenant{tenant}",
                        priority=wc.priority,
                        slo_ttft_ms=wc.slo_ttft_ms,
                        tag=name,
                    ),
                )
            )
    raw.sort(key=lambda t: (t[0], t[1].rid))
    reqs = []
    for i, (_, r) in enumerate(raw):
        reqs.append(dataclasses.replace(r, arrival=i * stagger))
    return reqs


def _percentiles(xs: list) -> Optional[dict]:
    if not xs:
        return None
    arr = np.asarray(xs, np.float64)
    return {
        "mean": float(arr.mean()),
        "p50": float(np.percentile(arr, 50)),
        "p90": float(np.percentile(arr, 90)),
        "p99": float(np.percentile(arr, 99)),
    }


def per_class_report(finished: list[Request]) -> dict:
    """Per-workload-class latency table from the engine's finished requests.

    {class tag: {count, tokens, latency_s: {p50, p90, p99}, ttft_s: ...}} —
    the per-class view the multi-tenant benchmark publishes next to the
    engine's aggregate summary."""
    by_tag: dict[str, list[Request]] = {}
    for r in finished:
        by_tag.setdefault(r.tag or "untagged", []).append(r)
    return {
        tag: {
            "count": len(rs),
            "tokens": sum(len(r.out) for r in rs),
            "latency_s": _percentiles(
                [r.t_done - r.t_admit for r in rs if r.t_done and r.t_admit]
            ),
            "ttft_s": _percentiles(
                [r.t_first - r.t_admit for r in rs if r.t_first and r.t_admit]
            ),
        }
        for tag, rs in sorted(by_tag.items())
    }

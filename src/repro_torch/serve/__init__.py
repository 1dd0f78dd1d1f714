"""``repro_torch.serve``: the serving API of the port (the eager
``greedy_generate``; :class:`ServingEngine` with ``submit`` / ``run`` /
``summary``, the :class:`Request` record, the synthetic ``random_stream``
and the multi-tenant trace workloads: ``make_trace`` / ``parse_mix`` /
``per_class_report`` / ``WORKLOADS``)."""

from repro_torch.serve.engine import (
    ServingEngine,
    greedy_generate,
    make_decode_step,
    make_mixed_step,
    make_prefill_step,
    make_rolled_step,
)
from repro_torch.serve.scheduler import Request, random_stream
from repro_torch.serve.workload import (
    WORKLOADS,
    WorkloadClass,
    make_trace,
    parse_mix,
    per_class_report,
)

__all__ = ["ServingEngine", "Request", "random_stream", "WORKLOADS", "WorkloadClass",
           "make_trace", "parse_mix", "per_class_report", "greedy_generate",
           "make_prefill_step", "make_decode_step", "make_mixed_step", "make_rolled_step"]

"""``repro_torch.serve``: the serving API of the port (the eager
``greedy_generate``; :class:`ServingEngine` with ``submit`` / ``run`` /
``step`` / ``cancel`` / ``health`` / ``snapshot`` / ``restore`` /
``summary``, the :class:`Request` record, the synthetic ``random_stream``,
the multi-tenant trace workloads ``make_trace`` / ``parse_mix`` /
``per_class_report`` / ``WORKLOADS``, the speculative draft sources
``NGramDraft`` / ``ModelDraft`` / ``make_draft_source``, and the chaos
harness ``FaultInjector`` with its error types)."""

from repro_torch.obs import Observability
from repro_torch.serve.engine import (
    ServingEngine,
    greedy_generate,
    make_decode_step,
    make_mixed_step,
    make_prefill_step,
    make_rolled_step,
)
from repro_torch.serve.faults import (
    LADDER,
    FaultInjector,
    LadderExhausted,
    StallError,
    TransientDeviceError,
)
from repro_torch.serve.scheduler import Request, random_stream
from repro_torch.serve.speculative import (
    ModelDraft,
    NGramDraft,
    make_draft_source,
    prompt_lookup,
)
from repro_torch.serve.workload import (
    WORKLOADS,
    WorkloadClass,
    make_trace,
    parse_mix,
    per_class_report,
)

__all__ = ["ServingEngine", "Request", "random_stream", "WORKLOADS", "WorkloadClass",
           "make_trace", "parse_mix", "per_class_report", "greedy_generate",
           "make_prefill_step", "make_decode_step", "make_mixed_step", "make_rolled_step",
           "NGramDraft", "ModelDraft", "make_draft_source", "prompt_lookup",
           "FaultInjector", "LADDER", "LadderExhausted", "StallError",
           "TransientDeviceError", "Observability"]

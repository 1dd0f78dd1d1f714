"""``repro_torch.serve``: the continuous-batching serving API of the port
(:class:`ServingEngine` with ``submit`` / ``run`` / ``summary``, the
:class:`Request` record and the synthetic ``random_stream``)."""

from repro_torch.serve.engine import ServingEngine, make_mixed_step, make_rolled_step
from repro_torch.serve.scheduler import Request, random_stream

__all__ = ["ServingEngine", "Request", "random_stream", "make_mixed_step", "make_rolled_step"]

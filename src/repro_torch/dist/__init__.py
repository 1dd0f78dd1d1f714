"""repro_torch.dist: the execution layer that maps an ExecutionPlan onto the
ranks of ``torch.distributed`` (the port's ``repro/dist``).

  sharding.py    partition specs per parameter / cache / batch / activation
                 (Megatron orientation + divisibility safety net), and the
                 placement of each rank's local shard
  collectives.py manual collectives (ring gather-matmul, Megatron-SP
                 reduce-scatter, compressed gradient sum, tensor
                 parallelism's all-reduce pair)
  pipeline.py    GPipe microbatch pipelining over the pod axis

JAX runs these inside ``shard_map`` on global arrays; the port has none:
every function takes and returns this rank's local shard.  All three are
live in ``launch/train.py``: the pipeline via ``plan.pod_role``,
``compressed_psum`` via ``plan.grad_compression``, the SP collectives via
``plan.seq_parallel_acts``, tensor parallelism's pair via a model axis
neither takes (``sharding.tensor_parallel``; the serving engine's
``shardings=`` too).
"""
from repro_torch.dist.collectives import (
    compressed_psum,
    overlap_all_gather_matmul,
    ring_gather_matmul,
    seq_scatter,
    wire_bytes,
)
from repro_torch.dist.pipeline import bubble_fraction, pipeline_forward
from repro_torch.dist.sharding import Shardings

__all__ = [
    "Shardings",
    "overlap_all_gather_matmul",
    "ring_gather_matmul",
    "seq_scatter",
    "compressed_psum",
    "wire_bytes",
    "bubble_fraction",
    "pipeline_forward",
]

"""Shared set-up for the port's multi-process tests: ranks started with
``torch.multiprocessing.spawn`` over gloo on the CPU, each with its own
``file://`` rendezvous under the test's ``tmp_path`` (xdist workers never
share a port), joined with a timeout that fails the test instead of
hanging the suite.

It holds no test: the other ``tests/test_torch_*.py`` import it.  A
rank's work is a module-level function ``fn(rank, *args) -> picklable
result``; the results come back in rank order.  ``ShapeMesh`` stands in for a mesh of more ranks
than the test has (JAX's tests' ``FakeMesh``).
"""
from __future__ import annotations

import os
import time

import pytest
import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 240


class ShapeMesh:
    """A shape-only mesh with this rank's coordinates: what ``Shardings``'
    spec methods, ``local_shard`` and ``wire_compression_axes`` read."""

    def __init__(self, shape: dict, coords: dict = None):
        self.shape = dict(shape)
        self.coords = dict(coords or {a: 0 for a in self.shape})


def _entry(rank, fn, world, init, out_dir, args, threads):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    torch.set_num_threads(threads)
    init_distributed("cpu", init_method=init, rank=rank, world_size=world)
    try:
        torch.save(fn(rank, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT_S,
              threads: int = 1) -> list:
    """``fn(rank, *args)`` on ``world`` gloo ranks; their results in rank
    order.  A rank that raises fails the test with its traceback; ranks
    still running after ``timeout`` seconds are killed and the test fails."""
    out_dir = str(tmp_path)
    init = f"file://{os.path.join(out_dir, 'rendezvous')}"
    ctx = mp.spawn(_entry, args=(fn, world, init, out_dir, args, threads), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.05, min(1.0, deadline - time.monotonic()))):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks of {fn.__name__} still running after {timeout:.0f} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]

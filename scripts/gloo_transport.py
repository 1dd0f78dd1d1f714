"""Times the transport of two ranks that share one card over gloo (the
route of ``dist/collectives.py``'s ``_staged``): each collective's parts
(the device-to-host copy, gloo's operation on host tensors, the copy back)
and whole, for an all-reduce, an all-gather and a reduce-scatter, then
variants of the gloo part: an all-gather or reduce-scatter taken as an
all-reduce, and each split into chunks over several process groups in
flight at once.

    python3 scripts/gloo_transport.py [--gib 1] [--groups 4] [--device cuda]

Runs on one CUDA card (``--device cpu``: host tensors only, a rehearsal);
starts its two ranks itself (a ``tcp://localhost``
rendezvous) and prints one line a measurement from rank 0, the medians of
``--reps`` runs.
"""
from __future__ import annotations

import argparse
import os
import socket
import statistics
import subprocess
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _timed(fn, reps, dev):
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = []
    for _ in range(reps):
        dist.barrier()
        sync()
        t = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t)
    return statistics.median(out)


def _rank(rank, port, gib, n_groups, reps, device):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    groups = [dist.new_group([0, 1]) for _ in range(n_groups)]
    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    n = int(gib * 2**30) // 4
    x = torch.randn(n, device=dev)
    whole = torch.randn(2 * n, device=dev)
    host = x.cpu()
    host_whole = whole.cpu()

    def say(what, fn, gb):
        s = _timed(fn, reps, dev)
        if rank == 0:
            print(f"{what}: {s:.3f} s ({gb / s:.2f} GB/s of {gb:.2f} GB)", flush=True)

    gb, gb2 = x.numel() * 4 / 1e9, whole.numel() * 4 / 1e9
    say("device to host, pageable", lambda: x.to("cpu", copy=True), gb)
    if dev.type == "cuda":
        pinned = torch.empty(n, pin_memory=True)
        say("device to host, pinned", lambda: pinned.copy_(x), gb)
    say("host to device, pageable", lambda: host.to(dev, copy=True), gb)
    say("gloo all_reduce (host)", lambda: dist.all_reduce(host.clone()), gb)
    out = torch.empty(2 * n)
    say("gloo all_gather of a shard (host)", lambda: dist.all_gather_into_tensor(out, host), gb)
    half = torch.empty(n)
    say("gloo reduce_scatter of the whole (host)",
        lambda: dist.reduce_scatter_tensor(half, host_whole), gb2)

    def gather_by_sum():
        buf = torch.zeros(2 * n)
        buf[rank * n:(rank + 1) * n] = host
        dist.all_reduce(buf)

    say("gloo all_gather as an all_reduce (host)", gather_by_sum, gb)

    def chunked(op, src, dst):
        def run():
            hs = [op(d, s, group=g, async_op=True)
                  for d, s, g in zip(dst, src, groups)]
            for h in hs:
                h.wait()
        return run

    srcs = [c.contiguous() for c in host.chunk(n_groups)]
    outs = [torch.empty(2 * c.numel()) for c in srcs]
    say(f"gloo all_gather in {n_groups} groups at once (host)",
        chunked(dist.all_gather_into_tensor, srcs, outs), gb)
    wsrc = [torch.cat([a, b]) for a, b in zip(host_whole[:n].chunk(n_groups),
                                              host_whole[n:].chunk(n_groups))]
    wout = [torch.empty(c.numel() // 2) for c in wsrc]
    say(f"gloo reduce_scatter in {n_groups} groups at once (host)",
        chunked(dist.reduce_scatter_tensor, wsrc, wout), gb2)
    sums = [c.clone() for c in host.chunk(n_groups)]

    def chunked_sum():
        for h in [dist.all_reduce(c, group=g, async_op=True) for c, g in zip(sums, groups)]:
            h.wait()

    say(f"gloo all_reduce in {n_groups} groups at once (host)", chunked_sum, gb)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args()
    if a.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    mp.spawn(_rank, args=(port, a.gib, a.groups, a.reps, a.device), nprocs=2)


if __name__ == "__main__":
    main()

"""A/B of two checkouts of the port on one CUDA card, in one call.

    python3 scripts/ab_serve.py PARENT_DIR CHANGE_DIR

Runs PARENT, CHANGE, CHANGE, PARENT, each in its own process that imports
``DIR/src/repro_torch`` (``--one DIR`` is that process).  Each measures, on
random bf16 weights from a seed:

* the eager path (``greedy_generate``, B 8 x 2048-token prompts, 32 new
  tokens) of qwen3-1.7b and of rwkv6-1.6b: five timed runs and five timed
  prefills after a warm-up; the decode step is (median run - median
  prefill) / 31; then one more prefill under ``torch.profiler``: device time
  by kernel name and by class (cuBLAS GEMMs, elementwise, reductions,
  copies, the port's own kernels: the ``__global__`` functions of the
  checkout's ``src/repro_torch/kernels/*/csrc/*.cu``);
* the qwen3-1.7b continuous engine on the derived H100 plan: 16 requests of 100-600
  prompt tokens, 16 new tokens each; its mean dispatch time and tok/s;
* the same engine stream once more under ``torch.profiler``: the device
  time of each kernel name (the 12 largest, and every kernel of the port's
  own, with their launch counts), the device time in all, and the wall
  time of that run, whose ratio is the device's busy share (the
  profiler's own cost included).

Prints the card's name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, PROMPT, GEN = 8, 2048, 32
ARCHS = ("qwen3-1.7b", "rwkv6-1.6b")


def eager(arch: str, port: frozenset) -> dict:
    """The eager path of ``arch``: timed runs and prefills, then one
    profiled prefill (``port``: the port's kernel names)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.plan import derive_execution_plan
    from repro_torch.models.params import init_params
    from repro_torch.serve import greedy_generate, make_prefill_step

    cfg = get_config(arch)
    plan = derive_execution_plan(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, plan, torch.bfloat16, generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    batch = {"tokens": tokens}
    run = lambda n: greedy_generate(params, cfg, plan, batch, n_steps=n,  # noqa: E731
                                    cache_len=PROMPT + GEN, device="cuda").cpu()
    prefill_step = make_prefill_step(cfg, plan)
    run(2)  # warm-up: builds the kernels, first cuBLAS calls
    totals, prefills = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(GEN)
        totals.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        logits, _ = prefill_step(params, batch)
        torch.cuda.synchronize()
        prefills.append(time.perf_counter() - t0)
        del logits
    total, prefill = statistics.median(totals), statistics.median(prefills)
    res = {"eager_total_s": totals, "eager_prefill_s": prefills,
           "decode_step_ms": (total - prefill) / (GEN - 1) * 1e3, "tok_per_s": B * GEN / total,
           "prefill_profile": profile(lambda: prefill_step(params, batch), port)}
    del params
    torch.cuda.empty_cache()
    return res


def one(tree: str) -> dict:
    sys.path.insert(0, tree + "/src")
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.plan import derive_execution_plan, derive_serve_plan
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServingEngine, random_stream

    torch.backends.cuda.matmul.allow_tf32 = False
    port = port_kernels(tree)
    res = {arch: eager(arch, port) for arch in ARCHS}
    cfg = get_config("qwen3-1.7b")
    plan = derive_execution_plan(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    serve = derive_serve_plan(cfg, {"data": 1, "model": 1}, H100_SXM, max_seq_len=2048)
    params = init_params(cfg, plan, torch.bfloat16, generator=gen, device="cuda")
    engine = ServingEngine(params, cfg, plan, serve, device="cuda")
    engine.run(random_stream(cfg, 16, (100, 600), 16, stagger=1, seed=3))
    s = engine.summary()
    res.update(engine_mean_dispatch_ms=s["mean_dispatch_ms"], engine_tok_per_s=s["tok_per_s"],
               engine_dispatches=s["dispatches"])
    del engine  # its pools: the profiled engine makes its own
    torch.cuda.empty_cache()
    res["engine_profile"] = profile(lambda: ServingEngine(params, cfg, plan, serve, device="cuda")
                                    .run(random_stream(cfg, 16, (100, 600), 16, stagger=1, seed=3)),
                                    port)
    return res


# Kernel classes of a profile, by the first name fragment that matches,
# after the port's own kernels (``port_kernels``).
CLASSES = (("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "cublas")),
           ("elementwise", ("elementwise",)),
           ("reduce", ("reduce", "norm", "softmax")),
           ("copy", ("copy", "Memcpy", "Memset", "cat", "Cat", "index")))
# How the profiler names a kernel in an anonymous namespace at the top, as
# the port's are (PyTorch has such kernels too: the name decides); a
# template's name starts with its return type, a plain function's does not.
ANON = "(anonymous namespace)::"


def port_kernels(tree: str, sources=None) -> frozenset:
    """The names of the ``__global__`` functions in ``tree``'s CUDA sources
    (or in ``sources``, paths of some of them)."""
    names = set()
    for path in sources or Path(tree, "src/repro_torch/kernels").glob("*/csrc/*.cu"):
        for decl in re.findall(r"__global__([^{;]*)", path.read_text()):
            names.update([n for n in re.findall(r"(\w+)\s*\(", decl)
                          if n != "__launch_bounds__"][:1])
    return frozenset(names)


def is_port(name: str, port: frozenset) -> bool:
    """Whether the profiler's kernel ``name`` is one of ``port``: in the
    top anonymous namespace or one inside it (``tc::``), by its own name."""
    name = name.removeprefix("void ")
    m = re.match(r"[\w:]+", name[len(ANON):]) if name.startswith(ANON) else None
    return bool(m) and m.group(0).split("::")[-1] in port


def kernel_class(name: str, port: frozenset) -> str:
    if is_port(name, port):
        return "port"
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def profile(fn, port: frozenset, with_kernels: bool = False) -> dict:
    """Device time by kernel name and by class over one call of ``fn``
    (torch.profiler); ``port``: the port's kernel names.  ``with_kernels``
    adds ``kernels``: every (ms, launches, full name), longest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():  # the kernels themselves: device events
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    classes = {}
    for ms, n, name in rows:
        c = classes.setdefault(kernel_class(name, port), [0.0, 0])
        c[0], c[1] = round(c[0] + ms, 3), c[1] + n
    own = [(ms, n, name[:80]) for ms, n, name in rows if is_port(name, port)]
    res = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy_share": device_ms / wall_ms if wall_ms else None, "by_class": classes,
           "top": [[round(ms, 3), n, name[:80]] for ms, n, name in rows[:12]],
           "port_kernels": [[round(ms, 3), n, name] for ms, n, name in own]}
    if with_kernels:
        res["kernels"] = rows
    return res


def main(argv: list) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    parent, change = argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for name, tree in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        p = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True,
                           text=True, timeout=900)
        lines = p.stdout.strip().splitlines()
        print(name, p.returncode, lines[-1] if lines else "", flush=True)
        if p.returncode:
            print(p.stderr[-3000:], flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

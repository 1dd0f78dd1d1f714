"""Serving launcher of the port, on the card by default.

    # continuous batching over the paged KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 8 --prompt-len 128 --gen 16 --stagger 2
    # multi-tenant trace replay (MoE archs serve continuously too): two
    # tenants, each with a shared system prompt, a mix of workload classes,
    # per-tenant and per-class latency percentiles in the summary
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --replay-trace classify:8,chat:4,summarize:2 --tenant-mix 2 --stagger 1 \\
        --max-seq 512
    # the eager path: one prefill of the batch, then lockstep greedy decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --engine eager --batch 8 --prompt-len 2048 --gen 32

The flags are the subset of ``repro.launch.serve.ServeArgs`` this port
honours, plus ``--device`` and ``--dtype``; ``--pages-per-tile`` is left
out because the CUDA kernel has no page-tile schedule.  ``plan_overrides``
maps them onto ``derive_serve_plan`` keywords as ``ServeArgs.
plan_overrides`` does.  An arch that ``serve_feasible`` refuses (RWKV-6)
falls back to ``--engine eager``.  The plan derives for the ``h100``
hardware entry.  Weights are random, drawn from ``--seed``, and so are the
eager path's prompts.  The batched engine prints the execution and serve
plans, then its summary as JSON (with ``classes``, the per-class report,
when a trace is replayed); the eager path prints the tokens' shape and
tok/s.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.hardware import get_hardware
from repro_torch.core.plan import derive_execution_plan, derive_serve_plan, serve_feasible
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.rmsnorm import kernel as rmsnorm_kernel
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.models.params import init_params
from repro_torch.serve import (
    ServingEngine,
    greedy_generate,
    make_trace,
    parse_mix,
    per_class_report,
    random_stream,
)

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--engine", default="batched", choices=["batched", "eager"])
    ap.add_argument("--batch", type=int, default=4,
                    help="eager batch / batched decode slots (with --fix-batch)")
    ap.add_argument("--fix-batch", action="store_true",
                    help="pin decode_batch to --batch instead of deriving it")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--stagger", type=int, default=2,
                    help="engine iterations between request arrivals")
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--slab-width", type=int, default=None,
                    help="mixed-slab query rows per slot (default: prefill chunk)")
    ap.add_argument("--no-fused", action="store_true",
                    help="plain versions (gathered pages, plain norms) instead of the"
                         " CUDA kernels")
    ap.add_argument("--kv-dtype", default=None, choices=[None, "bf16", "int8", "fp32"])
    ap.add_argument("--rolled-steps", type=int, default=None,
                    help="cap K of the rolled decode loop (1 disables)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable copy-on-write prefix sharing (outputs are identical"
                         " either way)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="fleet TTFT target fed back into the plan (slab width)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="fleet-default per-request deadline (wall-clock ms from submit)")
    ap.add_argument("--replay-trace", default=None,
                    help="multi-tenant trace replay: a workload mix such as"
                         " 'chat:4,summarize:2,classify:2' (replaces --requests/"
                         "--prompt-len/--gen)")
    ap.add_argument("--tenant-mix", type=int, default=2,
                    help="tenants of a replayed trace, each with its own shared system"
                         " prompt")
    ap.add_argument("--hardware", default="h100")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bf16", choices=sorted(_DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    return ap


def plan_overrides(a: argparse.Namespace) -> dict:
    """Keyword arguments for ``derive_serve_plan`` (``ServeArgs.
    plan_overrides`` for the flags the port has)."""
    return {
        "max_seq_len": a.max_seq,
        "decode_batch": a.batch if a.fix_batch else None,
        "prefill_chunk": a.prefill_chunk,
        "mixed_slab_width": a.slab_width,
        "fused_attention": not a.no_fused,
        "kv_dtype": a.kv_dtype,
        "prefix_sharing": not a.no_prefix_sharing,
        "slo_ttft_ms": a.slo_ttft_ms,
        "rolled_steps": a.rolled_steps,
        "typical_prompt_len": a.prompt_len,
        "deadline_ms": a.deadline_ms,
    }


def request_stream(a: argparse.Namespace, cfg) -> list:
    """The replayed trace (``ServeArgs.request_stream``: seed 1, class
    shapes fitted to --max-seq), else the synthetic random stream."""
    if a.replay_trace:
        return make_trace(cfg, parse_mix(a.replay_trace), tenants=a.tenant_mix,
                          stagger=a.stagger, seed=1, max_tokens=a.max_seq)
    return random_stream(cfg, a.requests, a.prompt_len, a.gen, a.stagger, seed=1)


def run(a: argparse.Namespace) -> dict:
    device = resolve_device(a.device)
    cfg = get_config(a.arch)
    plan = derive_execution_plan(cfg)
    serve = derive_serve_plan(cfg, {"data": 1, "model": 1}, get_hardware(a.hardware),
                              **plan_overrides(a))
    print(plan)
    print(serve.describe())
    gen = torch.Generator(device=device).manual_seed(a.seed)
    params = init_params(cfg, plan, _DTYPES[a.dtype], generator=gen, device=device)
    engine = ServingEngine(params, cfg, plan, serve, device=device)
    out = engine.run(request_stream(a, cfg))
    first = next(iter(out))
    print(f"served {len(out)} requests; {first} -> {out[first]}")
    summary = engine.summary()
    if a.replay_trace:
        summary["classes"] = per_class_report(engine.sched.finished)
    print(json.dumps(summary, indent=1, default=str))
    return summary


def run_eager(a: argparse.Namespace) -> dict:
    """``greedy_generate`` over a batch of random prompts: --batch x
    --prompt-len tokens, --gen new tokens each."""
    device = resolve_device(a.device)
    cfg = get_config(a.arch)
    plan = derive_execution_plan(cfg)
    gen = torch.Generator(device=device).manual_seed(a.seed)
    params = init_params(cfg, plan, _DTYPES[a.dtype], generator=gen, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (a.batch, a.prompt_len), generator=gen,
                           device=device, dtype=torch.int32)
    if device.type == "cuda":  # build the path's kernels now: tok/s excludes nvcc
        _build.build_all([wkv_kernel.SOURCE, flash_kernel.SOURCE, rmsnorm_kernel.SOURCE])
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, plan, {"tokens": tokens}, n_steps=a.gen,
                          cache_len=a.prompt_len + a.gen, device=device)
    out = out.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    tok_s = a.batch * a.gen / dt
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s ({tok_s:.1f} tok/s)")
    print(out[0].tolist())
    return {"tok_per_s": tok_s, "tokens": out}


def main(argv: Optional[list] = None) -> dict:
    a = build_parser().parse_args(argv)
    cfg = get_config(a.arch)
    ok, reason = serve_feasible(cfg)
    if a.engine == "batched" and not ok:
        print(f"{a.arch}: {reason}; falling back to --engine eager")
        a.engine = "eager"
    return run(a) if a.engine == "batched" else run_eager(a)


if __name__ == "__main__":
    main()

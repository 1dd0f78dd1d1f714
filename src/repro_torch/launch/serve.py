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
    # speculative decoding: n-gram self-drafting (or a config name for a
    # model drafter), gamma 4; the tokens are those of plain decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --draft ngram --spec-len 4 --replay-trace chat:4,classify:4
    # chaos: seeded transient faults (retried; bursts past --retry-limit
    # step the ladder rolled -> mixed -> gather), NaN poison; Prometheus
    # metrics and a Chrome trace of the run
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --chaos-seed 3 --chaos-transient 0.05 --chaos-burst 2 --chaos-nan 0.02 \
        --metrics-out m.prom --trace-out trace.json
    # the eager path: one prefill of the batch, then lockstep greedy decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --engine eager --batch 8 --prompt-len 2048 --gen 32

The flags are those of ``repro.launch.serve.ServeArgs`` but
``--pages-per-tile`` (the CUDA kernels have no page-tile schedule),
``--from-family`` and the deprecated ``--trace``, plus ``--device`` and
``--dtype``.  ``plan_overrides``
maps them onto ``derive_serve_plan`` keywords as ``ServeArgs.
plan_overrides`` does.  An arch that ``serve_feasible`` refuses (RWKV-6)
falls back to ``--engine eager``.  The plan derives for the ``h100``
hardware entry.  Weights are random, drawn from ``--seed``, and so are the
eager path's prompts, and a model drafter's weights (seed 2, as JAX).  The
batched engine prints the execution and serve plans, the engine's health
after a chaos run, the drift meter's verdict, then its summary as JSON
(with ``classes``, the per-class report, when a trace is replayed); the
eager path prints the tokens' shape and tok/s.
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
from repro_torch.obs import Observability
from repro_torch.serve import (
    FaultInjector,
    ServingEngine,
    greedy_generate,
    make_draft_source,
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
    ap.add_argument("--draft", default=None,
                    help="speculative draft source: 'ngram' (prompt-lookup self-drafting)"
                         " or a config name (a model drafter)")
    ap.add_argument("--spec-len", type=int, default=None,
                    help="draft depth gamma per decode slot (default: derived from the"
                         " roofline's compute slack; 0 disables)")
    ap.add_argument("--retry-limit", type=int, default=3,
                    help="transient-dispatch retries per ladder rung before stepping down"
                         " rolled -> mixed -> gather")
    ap.add_argument("--stall-limit", type=int, default=256,
                    help="consecutive no-progress iterations before run() raises StallError")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="enable the deterministic fault injector with this seed")
    ap.add_argument("--chaos-transient", type=float, default=0.0,
                    help="per-iteration probability of a transient dispatch failure burst")
    ap.add_argument("--chaos-burst", type=int, default=1,
                    help="consecutive dispatch attempts each transient fault fails")
    ap.add_argument("--chaos-nan", type=float, default=0.0,
                    help="per-slot per-iteration probability of non-finite logits")
    ap.add_argument("--chaos-pressure", type=float, default=0.0,
                    help="per-iteration probability of a temporary block-pool squeeze")
    ap.add_argument("--chaos-spike-ms", type=float, default=0.0,
                    help="artificial latency added to every dispatch; 0 disables")
    ap.add_argument("--chaos-horizon", type=int, default=None,
                    help="iteration after which no new fault fires")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics after the run: *.prom/*.txt as Prometheus text,"
                         " anything else as a JSON snapshot")
    ap.add_argument("--trace-out", default=None,
                    help="write the lifecycle + dispatch trace as Chrome trace_event JSON;"
                         " tracing is on only when this is set")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="trace ring-buffer capacity in events (oldest dropped first)")
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
        "draft": a.draft or "none",
        "spec_len": a.spec_len,
        "retry_limit": a.retry_limit,
        "stall_limit": a.stall_limit,
    }


def make_injector(a: argparse.Namespace) -> Optional[FaultInjector]:
    """The chaos injector when ``--chaos-seed`` asks for one
    (``ServeArgs.make_injector``)."""
    if a.chaos_seed is None:
        return None
    return FaultInjector(
        a.chaos_seed,
        transient_rate=a.chaos_transient,
        transient_burst=a.chaos_burst,
        nan_rate=a.chaos_nan,
        pressure_rate=a.chaos_pressure,
        spike_rate=1.0 if a.chaos_spike_ms > 0 else 0.0,
        spike_ms=a.chaos_spike_ms,
        horizon=a.chaos_horizon,
    )


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
    hw = get_hardware(a.hardware)
    serve = derive_serve_plan(cfg, {"data": 1, "model": 1}, hw, **plan_overrides(a))
    print(plan)
    print(serve.describe())
    gen = torch.Generator(device=device).manual_seed(a.seed)
    params = init_params(cfg, plan, _DTYPES[a.dtype], generator=gen, device=device)
    draft = None
    if a.draft and serve.spec_len == 0:
        print("roofline slack leaves no free verification rows at this decode batch:"
              " speculation stays off (gamma = 0)")
    elif a.draft:
        draft = make_draft_source(a.draft, cfg, serve, hw=hw, seed=2, device=device,
                                  dtype=_DTYPES[a.dtype])
    injector = make_injector(a)
    if injector is not None:
        print(f"chaos injection on: {injector.to_record()}")
    obs = Observability(tracing=a.trace_out is not None, trace_buffer=a.trace_buffer)
    engine = ServingEngine(params, cfg, plan, serve, draft=draft, injector=injector, obs=obs,
                           hw=hw, device=device)
    out = engine.run(request_stream(a, cfg))
    summary = engine.summary()
    if injector is not None:
        print(f"engine health after chaos: {json.dumps(engine.health())}")
    first = next(iter(out))
    print(f"served {len(out)} requests; {first} -> {out[first]}")
    if a.replay_trace:
        summary["classes"] = per_class_report(engine.sched.finished)
    if a.trace_out:
        n = obs.tracer.write(a.trace_out)
        print(f"wrote {n} trace events to {a.trace_out}")
    if a.metrics_out:
        with open(a.metrics_out, "w") as f:
            if a.metrics_out.endswith((".prom", ".txt")):
                f.write(obs.metrics.to_prometheus())
            else:
                json.dump(obs.metrics.snapshot(), f, indent=1)
        print(f"wrote metrics to {a.metrics_out}")
    cal = summary["calibration"]
    if cal.get("overall_ratio"):
        print(f"planner calibration: {cal['note']}")
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

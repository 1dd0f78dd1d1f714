"""Serving launcher of the port: continuous batching over the paged KV
cache, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 8 --prompt-len 128 --gen 16 --stagger 2

The flags are the subset of ``repro.launch.serve.ServeArgs`` this slice
honours, plus ``--device`` and ``--dtype``; ``--pages-per-tile`` is left
out because the CUDA kernel has no page-tile schedule.  The plan derives
for the ``h100`` hardware entry.  Weights are random, drawn from ``--seed``.
Prints the execution and serve plans, then the engine summary as JSON.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.hardware import get_hardware
from repro_torch.core.plan import derive_execution_plan, derive_serve_plan
from repro_torch.models.params import init_params
from repro_torch.serve import ServingEngine, random_stream

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots when --fix-batch is given")
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
                    help="gather the pages instead of the CUDA paged-attention kernel")
    ap.add_argument("--kv-dtype", default=None, choices=[None, "bf16", "int8", "fp32"])
    ap.add_argument("--rolled-steps", type=int, default=None,
                    help="cap K of the rolled decode loop (1 disables)")
    ap.add_argument("--hardware", default="h100")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bf16", choices=sorted(_DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(a: argparse.Namespace) -> dict:
    device = resolve_device(a.device)
    cfg = get_config(a.arch)
    plan = derive_execution_plan(cfg)
    serve = derive_serve_plan(
        cfg, {"data": 1, "model": 1}, get_hardware(a.hardware),
        max_seq_len=a.max_seq,
        decode_batch=a.batch if a.fix_batch else None,
        prefill_chunk=a.prefill_chunk,
        mixed_slab_width=a.slab_width,
        fused_attention=not a.no_fused,
        kv_dtype=a.kv_dtype,
        rolled_steps=a.rolled_steps,
        typical_prompt_len=a.prompt_len,
    )
    print(plan)
    print(serve.describe())
    gen = torch.Generator(device=device).manual_seed(a.seed)
    params = init_params(cfg, plan, _DTYPES[a.dtype], generator=gen, device=device)
    engine = ServingEngine(params, cfg, plan, serve, device=device)
    out = engine.run(random_stream(cfg, a.requests, a.prompt_len, a.gen, a.stagger, seed=1))
    first = next(iter(out))
    print(f"served {len(out)} requests; {first} -> {out[first]}")
    summary = engine.summary()
    print(json.dumps(summary, indent=1, default=str))
    return summary


def main(argv: Optional[list] = None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

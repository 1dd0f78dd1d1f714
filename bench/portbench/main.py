"""``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Runs one cell on the card and prints its result as the last line of
standard output.  ``--control 1`` (not part of a benchmark run) also reads
the controls beside the program's numbers: the reference in float8, and for
training the reference on half the batch and with bf16-rounded operands;
``--control fp8,half_batch`` reads only those."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from bench.portbench import check, guard, spec

CACHE_DIR = spec.ROOT / "build" / "bench_cache"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="0")
    a = ap.parse_args(argv)
    a.control = check.control_tags(a.control)
    return a


def fixed_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's nvcc libraries already live in ``build/repro_torch_kernels``),
    and the port on the path of anything the run starts."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(spec.ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)


def result_line(outcome, cell, trace: bool, device) -> tuple:
    """(the result dict, the compared rows)."""
    from bench.portbench.run import device_info

    run = outcome.run
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = device_info(device)
    dev["memory_peak_bytes"] = outcome.peak_bytes
    dev.update(outcome.device)
    correct, rows = check.judge(outcome.numbers, cell.limits())
    res = {"correct": bool(correct),
           "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
           "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        res["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    extra = {k: v for k, v in outcome.numbers.items() if k not in {r[0] for r in rows}}
    if extra:
        res["readings"] = extra
    controls = check.judge_controls(outcome.numbers, cell.limits())
    if controls:
        res["controls_correct"] = controls
    res["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return res, rows


def main(argv=None) -> int:
    t_start = time.perf_counter()
    from bench.portbench.run import process_age_s, serve_cell, train_cell

    age0 = process_age_s()
    a = parse(argv)
    fixed_caches()
    guard.check("before the run")
    import torch

    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fn = train_cell if cell.kind == "train" else serve_cell
    t_cell = time.perf_counter()
    outcome = fn(cell, a.seed, a.seconds, bool(a.trace), device, control=a.control)
    outcome.run.setup_s = age0 + (outcome.run.window["t0"] - t_start)
    outcome.numbers.setdefault("setup_parts_s", {})["start"] = age0 + (t_cell - t_start)
    res, rows = result_line(outcome, cell, bool(a.trace), device)
    bad = guard.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 4
    for tag, ok in res.get("controls_correct", {}).items():
        print(f"control {tag} correct {ok}", file=sys.stderr)
    for name, value, lim in rows:
        print(f"{name} {value!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(res))
    return 0

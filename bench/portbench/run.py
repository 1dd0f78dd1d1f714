"""One run of one cell: set-up, the window, the metrics, the comparison.

The result is one JSON line on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, traced also ``breakdown``, and last
``compared``: each number the comparison read beside its limit), preceded on
standard error by the same numbers, one a line."""
from __future__ import annotations

import dataclasses
import gc
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

from bench.portbench import check, spec
from bench.portbench.profile import Spans, Trace, Window

KERNELS_DIR = spec.ROOT / "src" / "repro_torch" / "kernels"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(")


def kernel_names(*sources: str) -> set:
    """The ``__global__`` functions defined in the port's CUDA sources
    (paths under ``src/repro_torch/kernels``); a source that is gone gives
    none."""
    names = set()
    for s in sources:
        p = KERNELS_DIR / s
        if p.is_file():
            names |= set(_GLOBAL.findall(p.read_text()))
    return names


def base_name(event_name: str) -> str:
    """A device event's function name without its return type, namespaces,
    template arguments and parameters (``void (anonymous
    namespace)::tc::k<64>(Args)`` -> ``k``)."""
    n = event_name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    return re.split(r"[<(]", n, maxsplit=1)[0].strip().rsplit("::", 1)[-1]


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; 0 where unreadable)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, float(Path("/proc/uptime").read_text().split()[0]) - start)
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class Run:
    """What a metric reader gets (``metrics/<name>.py``'s ``read(run)``)."""
    cell: object  # spec.Cell
    cfg: object  # the port's ArchConfig
    window: dict  # t0, t1 (perf_counter) and the loop's own record
    setup_s: float = 0.0
    serve_plan: object = None
    steps: list = dataclasses.field(default_factory=list)  # serving StepRecords
    tracks: list = dataclasses.field(default_factory=list)  # serving Tracks
    trace: Optional[Trace] = None

    def trace_time_s(self, names: set) -> float:
        return sum(b - a for n, a, b in self.trace.events if base_name(n) in names) / 1e9

    def trace_calls(self, names: set) -> int:
        """Calls of a kernel library whose kernels launch once a call: the
        most launches of any one of ``names``."""
        count: dict = {}
        for n, _, _ in self.trace.events:
            b = base_name(n)
            if b in names:
                count[b] = count.get(b, 0) + 1
        return max(count.values(), default=0)


@dataclasses.dataclass
class Outcome:
    run: Run
    numbers: dict
    peak_bytes: int
    attempted: int
    failed: int
    device: dict = dataclasses.field(default_factory=dict)  # more readings beside the peak


def arch_config(config: dict, overrides: Optional[dict] = None):
    """The port's config for ``config["arch"]``, held to the published sizes
    the file states (a mismatch raises: the cell would run other sizes).
    ``overrides`` (the CPU tests' small shapes) skips that check."""
    from repro_torch.configs import get_config

    cfg = get_config(config["arch"])
    if overrides:
        return dataclasses.replace(cfg, **overrides)
    for key, field in config["runs_as"].items():
        if getattr(cfg, field) != config["published"][key]:
            raise ValueError(f"{config['arch']}: {field} = {getattr(cfg, field)}, the "
                             f"published {key} is {config['published'][key]}")
    return cfg


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def serve_cell(cell, seed: int, seconds: float, trace: bool, device, control=(),
               arch_overrides=None, plan_overrides=None,
               fault: Optional[Callable] = None) -> Outcome:
    """A serving cell's window and comparison.  ``fault(engine)`` (the CPU
    tests') breaks the timed path before the run."""
    import torch

    from bench.portbench import serving

    t_in = time.perf_counter()
    cfg = arch_config(cell.config, arch_overrides)
    engine, layout, serve = serving.build_engine(cfg, cell.config, seed, device, plan_overrides)
    t_built = time.perf_counter()
    if fault is not None:
        fault(engine)
    traffic = spec.generator(cell.traffic["kind"]).make(cell.traffic, cfg.vocab_size, seed,
                                                        seconds)
    spans = Spans(trace)
    loop = serving.Loop(engine, traffic, spans)
    serving.warm_up(loop, cfg.vocab_size, min(300, serve.max_seq_len // 2))
    t_warm = time.perf_counter()
    window = Window(trace, device)
    run_loop = serving.run_closed if traffic.kind == "closed" else serving.run_open
    win = run_loop(loop, seconds, window)
    parts = {"build": t_built - t_in, "warm_up": t_warm - t_built, "fill": win["t0"] - t_warm}
    peak = _peak(device)
    pool = {"kv_pool_bytes": serving.pool_bytes(serve, serve.n_blocks),
            "kv_live_peak_bytes": serving.pool_bytes(serve, loop.blocks_peak)}
    tracks = list(loop.tracks.values())
    run = Run(cell=cell, cfg=cfg, window=win, serve_plan=serve, steps=loop.steps, tracks=tracks)
    if trace:
        run.trace = Trace(window.events or [], window.ns0, window.ns1, spans.rows)
    t0, t1 = win["t0"], win["t1"]
    if traffic.kind == "open":
        counted = [tr for tr in tracks if t0 <= tr.due < t1]
    else:
        counted = [tr for tr in tracks if any(t0 <= s <= t1 for s in tr.stamps)
                   or (tr.due <= t1 and tr.req.status != "ok")]
    served = [tr for tr in tracks if any(t0 <= s <= t1 for s in tr.stamps)]
    sample = check.sample_requests(served, int(cell.traffic.get("check_requests", 8)), seed)
    records = [(list(tr.req.prompt), list(tr.req.out)) for tr in sample]
    failed = sum(1 for tr in counted if tr.req.status != "ok")
    del engine, loop
    free(device)
    t_ref = time.perf_counter()
    leaves = check.redraw(layout, seed, cfg, device, torch.float32)
    numbers = check.serve_numbers(check.reference_class(cell.config["reference"]),
                                  check.sizes_of(cfg), leaves, records, "fp8" in control,
                                  device)
    del leaves
    free(device)
    numbers["reference_s"] = time.perf_counter() - t_ref
    numbers["setup_parts_s"] = parts
    return Outcome(run, numbers, peak, len(counted), failed, pool)


def train_cell(cell, seed: int, seconds: float, trace: bool, device, control=(),
               arch_overrides=None, fault: Optional[Callable] = None) -> Outcome:
    """A training cell's check steps, window and comparison.  ``fault`` (the
    CPU tests') wraps the step function."""
    import math

    import torch

    from bench.portbench import training
    from bench.reference import train as ref_train

    t_in = time.perf_counter()
    cfg = arch_config(cell.config, arch_overrides)
    mix = cell.traffic
    step_fn, state, layout, opt = training.build_step(cfg, cell.config, mix, seed, device)
    t_built = time.perf_counter()
    if fault is not None:
        step_fn = fault(step_fn)
    feed = spec.generator(mix["kind"]).make(mix, cfg.vocab_size, seed, device)
    spans = Spans(trace)
    n_check = int(mix["check_steps"])
    state, prog = training.check_steps(step_fn, state, feed, n_check, opt.b1, spans)
    window = Window(trace, device)
    state, win = training.run_window(step_fn, state, feed, n_check + 1, seconds, window, spans)
    parts = {"build": t_built - t_in, "check_steps": win["t0"] - t_built}
    peak = _peak(device)
    run = Run(cell=cell, cfg=cfg, window=win)
    if trace:
        run.trace = Trace(window.events or [], window.ns0, window.ns1, spans.rows)
    failed = sum(1 for x in win["losses"] if not math.isfinite(x))
    del step_fn, state
    free(device)
    t_ref = time.perf_counter()
    batches = [feed.batch(s) for s in range(1, n_check + 1)]
    model = check.reference_class(cell.config["reference"])
    sizes = check.sizes_of(cfg)
    ref = ref_train.follow(model, sizes, check.redraw(layout, seed, cfg, device), batches,
                           mix["optimizer"])
    free(device)
    numbers = check.train_numbers(prog, ref)
    numbers["worst_grad"] = check.worst_leaves(prog["grad"], ref["grad"])
    numbers["worst_change"] = check.worst_leaves(prog["change"], ref["change"])
    numbers["reference_s"] = time.perf_counter() - t_ref
    numbers["setup_parts_s"] = parts
    how = {"fp8": dict(prec="fp8"), "half_batch": dict(rows=slice(0, mix["batch"] // 2)),
           "bf16_witness": dict(prec="bf16")}
    for tag in control:
        r = ref_train.follow(model, sizes, check.redraw(layout, seed, cfg, device), batches,
                             mix["optimizer"], **how[tag])
        free(device)
        for k, v in check.train_numbers(r, ref).items():
            if k != "left_out":
                numbers[f"{k}.{tag}"] = v
    return Outcome(run, numbers, peak, len(win["losses"]), failed)

"""Dry run of the production meshes: trace every (arch x shape x mesh) cell
on the ``meta`` device and record its memory, cost and collectives (the
port's ``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

    # accelerator-family mode: sweep the serving design space on one device
    # and print/write the Pareto frontier (tokens/s vs $/token vs J/token)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --family --hardware h100

    # the plan autotuner over the candidates of core/autotune.py
    PYTHONPATH=src python -m repro_torch.launch.dryrun --autotune --arch qwen3-1.7b

    # drift calibration: a short smollm-135m stream served on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --calibrate

JAX places 512 placeholder devices and compiles each cell's step.  The
port has no compiler to ask: a cell runs one rank's step eagerly on the
``meta`` device (shapes, no storage) over a ``launch.mesh.DryRunMesh`` of
the production shape, which needs no process group, and ``core/op_cost``
counts what the step does (matrix-product FLOPs, bytes, each collective
with its group, each hand-written kernel's calls and cost, live bytes);
``core/roofline.analyze`` turns that into the cell's ``RooflineReport``.
Nothing is downloaded and nothing runs on a device: configs are in the
repo, weights, batches, states and caches are meta tensors.  The cells are
priced as ``h100-nvlink`` (the H100 entry with its NVLink rate, so that
meshes wider than one rank have a collective term); the plans derive as on
the H100 entry.

A cell is one rank's step, as the port executes it: training through
``make_train_step`` (the launcher's path: its shards, the global batch of
which the loss cuts this rank's rows, the state donated), prefill and
decode through ``serve.engine``'s steps on this rank's shards, rows and
dense cache, the decode cache full to the cell's depth (one new token
against ``seq_len`` cached positions; learned positions up to their
table's length).  A cell that cannot run records ``status: "error"`` with
the reason's text, as JAX's does for a failing cell (e.g. the multi-pod
pipeline cells: ``check_pipeline_supported`` refuses their model axis of
16, as JAX's does), and ``--all`` then exits 1.

Results go to runs/dryrun/<mesh>/<arch>__<shape>.json (incremental:
existing cells are skipped unless --force); --family reports go to
runs/family/<hardware>__<arch>.json.  ``--calibrate`` serves on the card
and raises without one, as the other entry points do.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ALL_SHAPES, ASSIGNED_ARCHS, applicable, get_config
from repro_torch.core.hardware import get_hardware
from repro_torch.core.op_cost import analyze_step, tensor_bytes
from repro_torch.core.plan import derive_plan, derive_serve_plan, serve_feasible
from repro_torch.core.roofline import analytic_memory_floor, analyze, model_flops_for
from repro_torch.dist.pipeline import bubble_fraction
from repro_torch.dist.sharding import Shardings, place, unexecuted_layout
from repro_torch.launch.mesh import DryRunMesh, mesh_axes_dict
from repro_torch.models.cache import init_cache
from repro_torch.models.params import init_params
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import OptimizerConfig, init_state
from repro_torch.train.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS = ROOT / "runs" / "dryrun"
# The hardware the cells are priced on (the plans derive as on "h100").
DRYRUN_HARDWARE = "h100-nvlink"
META = torch.device("meta")

SINGLE_POD = {"data": 16, "model": 16}
MULTI_POD = {"pod": 2, "data": 16, "model": 16}


def production_mesh(multi_pod: bool, coords: Optional[dict] = None) -> DryRunMesh:
    """JAX's ``make_production_mesh`` seen from one rank: (data 16, model
    16) or (pod 2, data 16, model 16), no process group."""
    return DryRunMesh(MULTI_POD if multi_pod else SINGLE_POD, coords)


def input_specs(cfg, shape, plan):
    """Meta stand-ins for every model input, JAX's shapes and dtypes (no
    allocation): the global batch."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    specs = {}
    if shape.kind == "decode":
        specs["tokens"] = torch.empty((B, 1), dtype=i32, device=META)
        return specs
    text = S
    if cfg.frontend != "none" and cfg.n_prefix_embeds:
        text = S - cfg.n_prefix_embeds
        specs["prefix_embeds"] = torch.empty((B, cfg.n_prefix_embeds, cfg.d_model), dtype=bf16,
                                             device=META)
    if cfg.enc_dec:
        specs["enc_embeds"] = torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=bf16,
                                          device=META)
    if cfg.vocab_size > 1:
        specs["tokens"] = torch.empty((B, text), dtype=i32, device=META)
    if shape.kind == "train":
        specs["targets"] = torch.empty((B, text), dtype=i32, device=META)
    return specs


def _fill(cache: dict, t: int) -> dict:
    """The dense cache with ``t`` positions counted as cached (every
    layer's count and the cache's own)."""
    def walk(tree):
        if isinstance(tree, dict):
            if "t" in tree and isinstance(tree["t"], torch.Tensor):
                tree["t"].fill_(t)
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                walk(v)

    walk(cache["layers"])
    cache["t"] = t
    return cache


def arg_bytes(args) -> float:
    """Bytes of a cell's arguments on this rank: every tensor leaf (the
    dense cache's per-layer counts are host tensors, counted as JAX's int32
    scalars are) and a Python int leaf (the cache's own count) as JAX's
    int32 scalar."""
    total = 0
    stack = [args]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += tensor_bytes(x)
        elif isinstance(x, bool):
            continue
        elif isinstance(x, int):
            total += 4
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    return float(total)


def build_cell(cfg, shape, mesh, *, plan_overrides=None, hw=None):
    """Returns (step, this rank's meta arguments, plan) for one cell: the
    step runs on ``mesh`` (a ``DryRunMesh``) from the rank at its
    coordinates.  ``hw`` (default ``DRYRUN_HARDWARE``) is what the plan
    derives on.  Raises where the port refuses the plan's layout (ZeRO
    under Megatron-SP, a plan no ``derive_plan`` makes)."""
    hw = hw or get_hardware(DRYRUN_HARDWARE)
    axes = mesh_axes_dict(mesh)
    plan = derive_plan(cfg, axes, hw, batch=shape.global_batch, seq_len=shape.seq_len,
                       training=shape.kind == "train", **(plan_overrides or {}))
    reason = unexecuted_layout(plan, cfg)
    if reason:
        raise ValueError(f"mesh {axes}: {reason}")
    sh = Shardings(mesh, plan, cfg)
    whole = init_params(cfg, plan, torch.bfloat16, device=META)
    param_sh = sh.manual_param_shardings(whole)
    params = place(whole, param_sh)
    batch = input_specs(cfg, shape, plan)
    if shape.kind == "train":
        state = init_state(params)
        step = make_train_step(cfg, plan, OptimizerConfig(), device=META, mesh=mesh,
                               grad_shardings=param_sh, donate=True)
        return step, (state, batch), plan
    local = sh.local_batch(batch)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, plan, mesh=mesh, shardings=param_sh), (params, local), plan
    B = local["tokens"].shape[0]
    cache = init_cache(cfg, plan, B, shape.seq_len, device=META, shardings=sh)
    filled = shape.seq_len - 1
    if cfg.pos_embedding == "learned":
        filled = min(filled, cfg.max_seq_len - 1)
    step = make_decode_step(cfg, plan, mesh=mesh, shardings=param_sh)
    return step, (params, local["tokens"], _fill(cache, filled)), plan


def cell_arg_bytes(cfg, shape, mesh, args, plan) -> float:
    """This rank's argument bytes: a training cell's step takes the global
    batch (its loss cuts this rank's rows), so its batch counts as those
    rows."""
    if shape.kind != "train":
        return arg_bytes(args)
    state, batch = args
    return arg_bytes(state) + arg_bytes(Shardings(mesh, plan, cfg).local_batch(batch))


def plan_record(cfg, shape, plan, axes: dict, hw) -> dict:
    """JAX's record of the plan: the stage decisions, the pod axis's role
    and the GPipe bubble, and a serving cell's derived serve plan."""
    return {
        "mha_mode": plan.mha.mode,
        "ffn_mode": plan.ffn.mode,
        "mha_factor1": plan.mha.factor1,
        "ffn_factor1": plan.ffn.factor1,
        "fuse_qkv": plan.fuse_qkv,
        "p_atb": plan.p_atb,
        "head_shards": plan.head_shards,
        "remat": plan.remat,
        "microbatches": plan.microbatches,
        "embed_shard": plan.embed_shard,
        "moe_mode": plan.moe_mode,
        "moe_dispatch": plan.moe_dispatch,
        "seq_shard": plan.seq_shard,
        "seq_parallel_acts": plan.seq_parallel_acts,
        "grad_compression": plan.grad_compression,
        "pod_role": plan.pod_role,
        "pipeline_stages": plan.pod_axis if plan.pod_role == "pipeline" else 1,
        "pipeline_bubble": (bubble_fraction(plan.microbatches, plan.pod_axis)
                            if plan.pod_role == "pipeline" else 0.0),
        "serve": (
            derive_serve_plan(cfg, axes, hw, max_seq_len=shape.seq_len,
                              draft="ngram").to_record()
            if shape.kind in ("decode", "prefill") and serve_feasible(cfg)[0]
            else None
        ),
    }


def trace_cell(cfg, shape, mesh, *, plan_overrides=None, hw=None, mesh_name: str = "") -> dict:
    """Build and trace one cell; returns {"plan", "report", "trace_s",
    "state_bytes"}: ``report`` is the ``RooflineReport``, ``state_bytes``
    the argument bytes without the batch and tokens (a training cell's
    state, a serving cell's weights and cache)."""
    hw = hw or get_hardware(DRYRUN_HARDWARE)
    n_chips = mesh.size
    t0 = time.time()
    fn, args, plan = build_cell(cfg, shape, mesh, plan_overrides=plan_overrides, hw=hw)
    _, cost, counted = analyze_step(fn, *args)
    trace_s = time.time() - t0
    a_bytes = cell_arg_bytes(cfg, shape, mesh, args, plan)
    rep = analyze(
        arch=cfg.name, shape=shape.name, mesh_name=mesh_name, n_chips=n_chips, cost=cost,
        flop_counter_flops=counted, hw=hw,
        model_flops=model_flops_for(cfg, shape, shape.kind == "train"),
        arg_bytes=a_bytes, temp_bytes=float(cost.peak_bytes),
        memory_floor_bytes=analytic_memory_floor(cfg, shape, plan, n_chips),
    )
    state = (args[0], args[2]) if shape.kind == "decode" else args[0]  # all but the inputs
    return {"plan": plan, "report": rep, "trace_s": trace_s, "state_bytes": arg_bytes(state)}


def run_cell(arch, shape, *, multi_pod, force=False, out_dir=RESULTS, plan_overrides=None,
             tag=""):
    mesh_name = "multi" if multi_pod else "single"
    out = pathlib.Path(out_dir) / mesh_name
    out.mkdir(parents=True, exist_ok=True)
    fname = out / f"{arch}__{shape.name}{tag}.json"
    if fname.exists() and not force:
        return json.loads(fname.read_text())

    cfg = get_config(arch)
    ok, reason = applicable(cfg, shape)
    record = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "status": "skipped",
              "reason": reason}
    if ok:
        try:
            mesh = production_mesh(multi_pod)
            hw = get_hardware(DRYRUN_HARDWARE)
            cell = trace_cell(cfg, shape, mesh, plan_overrides=plan_overrides, hw=hw,
                              mesh_name=mesh_name)
            rep = cell["report"]
            record = {
                "status": "ok",
                "trace_s": round(cell["trace_s"], 2),
                "hardware": hw.name,
                "state_bytes": cell["state_bytes"],
                "plan": plan_record(cfg, shape, cell["plan"], mesh_axes_dict(mesh), hw),
                **rep.to_dict(),
                "step_time_s": rep.step_time_s,
                "roofline_fraction": rep.roofline_fraction,
            }
        except Exception as e:  # a refused or failing cell is the record's content
            record = {
                "arch": arch,
                "shape": shape.name,
                "mesh": mesh_name,
                "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-3000:],
            }
    fname.write_text(json.dumps(record, indent=1, default=str))
    return record


def calibrate(arch: str, hardware: str, bench_out: Optional[str] = None) -> dict:
    """Serve a short stream on the card (JAX's ``ServeArgs`` of its
    ``--calibrate``: 6 requests of 16 prompt tokens, 12 new, stagger 2, 3
    decode slots, 16-token prefill chunks, max_seq 96) and print the drift
    report: predicted (roofline) vs measured ms per phase.  Raises without
    a card."""
    from repro_torch.launch.serve import build_parser, run

    cfg = get_config(arch)
    ok, reason = serve_feasible(cfg)
    if not ok:
        raise SystemExit(f"{arch}: {reason} (pick a serve-feasible --arch)")
    a = build_parser().parse_args([
        "--arch", arch, "--requests", "6", "--prompt-len", "16", "--gen", "12",
        "--stagger", "2", "--max-seq", "96", "--batch", "3", "--fix-batch",
        "--prefill-chunk", "16", "--hardware", hardware])
    summary = run(a)
    cal = summary["calibration"]
    print()
    print(f"planner drift calibration ({arch}, roofline priced as {hardware}):")
    for phase, rep in (cal.get("phases") or {}).items():
        if rep is None:
            continue
        print(
            f"  {phase:8s} n={rep['n']:4d}"
            f" predicted={rep['predicted_ms_mean']:8.3f}ms"
            f" measured={rep['measured_ms_mean']:8.3f}ms"
            f" ratio={rep['ratio']:8.2f}"
            f" p50={rep['ratio_p50']:8.2f} p90={rep['ratio_p90']:8.2f}"
        )
    print(f"  overall ratio: {cal.get('overall_ratio')}")
    print(f"  {cal.get('note')}")
    if bench_out:
        pathlib.Path(bench_out).write_text(
            json.dumps({"arch": arch, "hardware": hardware, "calibration": cal}, indent=1,
                       default=str))
        print(f"wrote {bench_out}")
    return cal


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--autotune", action="store_true",
                    help="search plan candidates for --arch/--shape and report the winner")
    ap.add_argument("--family", action="store_true",
                    help="design-space search: the Pareto frontier of serving design points "
                         "for --arch on --hardware (tokens/s vs $/token vs J/token)")
    ap.add_argument("--hardware", default="h100",
                    help="registered device name for --family / --calibrate (see "
                         "repro_torch.core.hardware.registered_hardware)")
    ap.add_argument("--calibrate", action="store_true",
                    help="serve a short stream on the card and print the planner drift "
                         "report: predicted (roofline) vs measured time per phase")
    ap.add_argument("--max-seq", type=int, default=2048,
                    help="serving context bound for the --family sweep")
    ap.add_argument("--bench-out", default=None,
                    help="write an aggregate JSON of all cells run")
    ap.add_argument("--out-dir", default=str(RESULTS),
                    help="where the cells' records go (<out-dir>/<mesh>/<arch>__<shape>.json; "
                         "--family: <out-dir>/../family)")
    a = ap.parse_args(argv)
    out_dir = pathlib.Path(a.out_dir)

    if a.calibrate:
        calibrate(a.arch or "smollm-135m", a.hardware, a.bench_out)
        return

    if a.family:
        from repro_torch.core.search import family_report

        arch = a.arch or "qwen3-1.7b"
        fam_dir = out_dir.parent / "family"
        result, record = family_report(arch, a.hardware, max_seq_len=a.max_seq,
                                       out_dir=fam_dir)
        print(record["markdown"])
        print(f"wrote {fam_dir / (result.hardware + '__' + arch + '.json')}")
        if a.bench_out:
            pathlib.Path(a.bench_out).write_text(json.dumps(record, indent=1, default=str))
            print(f"wrote {a.bench_out}")
        if not result.frontier:
            raise SystemExit("empty frontier: no feasible design point")
        return

    if a.autotune:
        from repro_torch.core.autotune import autotune

        shape = next(s for s in ALL_SHAPES if s.name == (a.shape or "train_4k"))
        best, scored = autotune(a.arch or "qwen3-1.7b", shape, multi_pod=a.mesh == "multi")
        for c in scored:
            print(
                f"{c.name:18s} step={c.step_s if c.step_s is None else round(c.step_s, 3)}"
                f" fits={c.fits} err={c.error and c.error[:80]}"
            )
        print(f"winner: {best.name if best else 'none'}")
        return

    archs = [a.arch] if a.arch else list(ASSIGNED_ARCHS)
    shapes = [s for s in ALL_SHAPES if a.shape in (None, s.name)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[a.mesh]
    n_ok = n_err = n_skip = 0
    records = []
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, multi_pod=multi, force=a.force, out_dir=out_dir)
                records.append(r)
                status = r.get("status")
                n_ok += status == "ok"
                n_err += status == "error"
                n_skip += status == "skipped"
                extra = (
                    f" bottleneck={r.get('bottleneck')} trace={r.get('trace_s')}s"
                    if status == "ok"
                    else " " + str(r.get("reason") or r.get("error", ""))[:120]
                )
                print(f"[{'multi' if multi else 'single'}] {arch:22s} {shape.name:12s} "
                      f"{status:8s}{extra}", flush=True)
    print(f"done: ok={n_ok} err={n_err} skipped={n_skip}")
    if a.bench_out:
        pathlib.Path(a.bench_out).write_text(json.dumps(
            {"ok": n_ok, "err": n_err, "skipped": n_skip, "cells": records}, indent=1,
            default=str))
        print(f"wrote {a.bench_out} ({len(records)} cells)")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

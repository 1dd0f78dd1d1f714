"""Plan autotuner (the port's ``repro/core/autotune.py``): enumerate a small
candidate set of plan overrides, dry-run each (``launch/dryrun.build_cell``
on a ``DryRunMesh``, traced on the ``meta`` device), score it by the
roofline step time and return the winner with its full iteration log.

    from repro_torch.core.autotune import autotune
    best, scored = autotune("mixtral-8x7b", TRAIN_4K, multi_pod=False)

JAX compiles every candidate on 512 placeholder devices; the port traces
one rank's step, so it needs no device and no process group.  Candidates
are priced on ``launch.dryrun.DRYRUN_HARDWARE`` unless ``hw`` names
another entry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.core.hardware import DEFAULT_HARDWARE, HardwareSpec
from repro_torch.core.plan import ONE_SHOT_MM_TILES, one_shot_mm
from repro_torch.core.pu import MMTileSpec, pick_pu
from repro_torch.core.roofline import analytic_memory_floor, collective_seconds


@dataclasses.dataclass
class Candidate:
    name: str
    overrides: dict
    step_s: Optional[float] = None
    compute_s: Optional[float] = None
    collective_s: Optional[float] = None
    fits: Optional[bool] = None
    error: Optional[str] = None


def default_candidates(cfg) -> list[Candidate]:
    cands = [
        Candidate("planner-default", {}),
        Candidate("force-spatial", {"force_mode": "spatial"}),
        Candidate("force-temporal", {"force_mode": "temporal"}),
        Candidate("split-qkv", {"fuse_qkv": False}),
    ]
    if cfg.is_moe:
        cands.append(Candidate("moe-sort-dispatch", {"moe_dispatch": "sort"}))
    return cands


def score_candidate(cfg, shape, mesh, cand: Candidate, hw: Optional[HardwareSpec] = None
                    ) -> Candidate:
    """Trace the candidate's cell on ``mesh`` and fill in its roofline
    terms (compute, ring-model collectives, the analytic memory floor) and
    whether its arguments and temporaries fit the device; a refused or
    failing candidate keeps its error."""
    from repro_torch.launch.dryrun import DRYRUN_HARDWARE, build_cell, cell_arg_bytes
    from repro_torch.core.hardware import get_hardware
    from repro_torch.core.op_cost import analyze_step

    hw = hw or get_hardware(DRYRUN_HARDWARE)
    try:
        fn, args, plan = build_cell(cfg, shape, mesh, plan_overrides=cand.overrides, hw=hw)
        _, cost, _ = analyze_step(fn, *args)
        compute_s = cost.flops / hw.peak_flops_bf16
        coll_s = collective_seconds(cost, hw.ici_bandwidth_per_link)
        floor_bytes = analytic_memory_floor(cfg, shape, plan, mesh.size)
        floor_s = floor_bytes / hw.hbm_bandwidth if hw.hbm_bandwidth > 0 else 0.0
        cand.compute_s = compute_s
        cand.collective_s = coll_s
        cand.step_s = max(compute_s, coll_s, floor_s)
        cand.fits = cell_arg_bytes(cfg, shape, mesh, args, plan) + cost.peak_bytes <= hw.hbm_bytes
    except Exception as e:  # infeasible candidate = informative result
        cand.error = f"{type(e).__name__}: {e}"
    return cand


def resolve_serve_tile(cfg, serve, hw: HardwareSpec = DEFAULT_HARDWARE) -> MMTileSpec:
    """MM tile for one serving design point (the family search's hook).

    JAX's rule: the unified step's dominant MM site is the fused QKV
    projection over the live slab rows (m = decode_batch * (1 + spec_len),
    n = the fused QKV width, k = d_model), and ``pick_pu`` applies the
    paper's padding-overhang rule to it on the target device.  On a card
    with a hand-written MM kernel (``ONE_SHOT_MM_TILES``: the H100 entries)
    the tile is that kernel's CTA tile (``one_shot_mm``): the VMEM tile
    search finds no tile in its shared memory."""
    if hw.name in ONE_SHOT_MM_TILES:
        bm, bn, bk = one_shot_mm(hw)
        return MMTileSpec("CTA", bm, bn, bk)
    rows = serve.decode_batch * (1 + serve.spec_len)
    qkv_width = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
    return pick_pu(max(rows, 1), qkv_width, cfg.d_model, hw, dtype_bytes=2)


def autotune(arch: str, shape, *, multi_pod: bool = False, hw: Optional[HardwareSpec] = None,
             candidates=None, prefer_fitting: bool = True, mesh=None):
    """Returns (best_candidate, all_candidates) sorted by step time.  The
    mesh is the production one from its first rank unless ``mesh`` (a
    ``DryRunMesh``) is given."""
    from repro_torch.launch.dryrun import production_mesh

    cfg = get_config(arch)
    mesh = mesh or production_mesh(multi_pod)
    cands = candidates or default_candidates(cfg)
    scored = [score_candidate(cfg, shape, mesh, c, hw) for c in cands]
    ok = [c for c in scored if c.step_s is not None]
    if prefer_fitting and any(c.fits for c in ok):
        ok = [c for c in ok if c.fits] or ok
    ok.sort(key=lambda c: c.step_s)
    best = ok[0] if ok else None
    return best, scored

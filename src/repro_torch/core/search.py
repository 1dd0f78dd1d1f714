"""Design-space search: derive a *family* of serving accelerators per device
(a copy of ``repro/core/search.py``).

The paper's framework derives one customized accelerator from
(model, hardware).  This module is the step the paper motivates but leaves
manual: sweep the customizable attributes the serving planner already owns —
mesh shape (model-axis TP degree), ``decode_batch``, ``kv_dtype``,
``block_size``, ``mixed_slab_width``, ``pages_per_tile``, ``spec_len``
(draft depth gamma), ``rolled_steps`` — through the same roofline and
feasibility models ``derive_serve_plan`` uses, cost every candidate on three
axes (tokens/s, $/token, J/token), and keep the Pareto frontier.  Each
frontier point carries its full :class:`~repro_torch.core.plan.ServePlan`
plus the autotune-resolved MM tile for its dominant GEMM site, so a point
is directly runnable by the serving engine (``launch.serve --from-family``).

Everything here is pure host arithmetic, so a full sweep over a few hundred
candidates is milliseconds.  The CLI surface is
``python -m repro_torch.launch.dryrun --family --hardware <name>``.  On the
H100 entries a point's tile is the tensor-core MM kernel's CTA tile
(``core/plan.one_shot_mm``: the VMEM tile search finds none there); on
every other entry it is picked as JAX picks it.  The H100 entries have no
price, so their points read 0 on the $/token axis.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import pathlib
from typing import Optional, Union

from repro_torch.core.hardware import HardwareSpec, energy_params, get_hardware
from repro_torch.core.plan import ServePlan, derive_serve_plan, serve_feasible

# Representative decode context for the steady-state cost model: requests are
# half-way through ``max_seq_len`` on average over their lifetime.
CTX_FRACTION = 0.5


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Candidate values per customizable attribute.

    ``None`` in a value tuple means "let ``derive_serve_plan`` derive it" —
    a space of all-``None`` singletons therefore degenerates to exactly the
    single plan the planner derives today (tested invariant).  Attribute
    order here is the candidate enumeration order, so a search is
    deterministic for a fixed space."""

    mesh_models: tuple[int, ...] = (1,)  # model-axis TP degree (n_chips)
    decode_batches: tuple[Optional[int], ...] = (None,)
    kv_dtypes: tuple[Optional[str], ...] = (None,)
    block_sizes: tuple[Optional[int], ...] = (None,)
    slab_widths: tuple[Optional[int], ...] = (None,)
    pages_per_tile: tuple[Optional[int], ...] = (None,)
    spec_lens: tuple[Optional[int], ...] = (0,)  # draft depth gamma
    rolled_steps: tuple[Optional[int], ...] = (None,)
    max_seq_len: int = 2048
    draft: str = "ngram"  # source used whenever a candidate speculates
    # Modeled per-row draft acceptance probability (alpha).  Expected
    # accepted tokens per slot per step is (1 - a^(g+1)) / (1 - a) — the
    # standard speculative-decoding expectation; 0.6 matches the NGram
    # draft's measured mid-range on BENCH_spec.json.
    acceptance: float = 0.6


def default_space(hw: HardwareSpec, *, max_seq_len: int = 2048) -> SearchSpace:
    """The stock sweep: TP degree where the device has ICI, both KV dtypes,
    the gamma ladder, and rolling on/off.  ~100 candidates."""
    models = (1, 2, 4) if hw.ici_links_per_chip > 0 else (1,)
    return SearchSpace(
        mesh_models=models,
        kv_dtypes=(None, "bf16", "int8"),
        spec_lens=(0, 2, 4, 8),
        rolled_steps=(None, 1),
        max_seq_len=max_seq_len,
    )


@dataclasses.dataclass
class DesignPoint:
    """One costed candidate: the plan plus its three Pareto coordinates."""

    hardware: str
    arch: str
    mesh: dict
    plan: ServePlan
    tile: str  # autotune-resolved MM tile for the dominant decode GEMM
    tokens_per_s: float
    usd_per_mtok: float  # $/token axis, scaled to $ per 1e6 tokens
    mj_per_tok: float  # J/token axis, scaled to millijoules
    step_s: float
    tokens_per_step: float
    bound: str  # "memory" | "compute" | "ici" — the step's binding term
    feasible: bool
    reason: str = ""

    def to_record(self) -> dict:
        return {
            "hardware": self.hardware,
            "arch": self.arch,
            "mesh": dict(self.mesh),
            "plan": self.plan.to_record(),
            "tile": self.tile,
            "tokens_per_s": round(self.tokens_per_s, 1),
            "usd_per_mtok": round(self.usd_per_mtok, 4),
            "mj_per_tok": round(self.mj_per_tok, 4),
            "step_s": self.step_s,
            "tokens_per_step": round(self.tokens_per_step, 3),
            "bound": self.bound,
            "feasible": self.feasible,
            "reason": self.reason,
        }


def expected_accepted(gamma: int, alpha: float) -> float:
    """Expected emitted tokens per speculating slot per step (>= 1)."""
    if gamma <= 0:
        return 1.0
    if alpha >= 1.0:
        return gamma + 1.0
    return (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)


def predict_point(
    cfg,
    hw: HardwareSpec,
    plan: ServePlan,
    *,
    mesh_model: int = 1,
    acceptance: float = 0.6,
) -> DesignPoint:
    """Cost one (plan, device, mesh) candidate on the three Pareto axes.

    Steady-state decode roofline (derivation + worked example in
    docs/PLANNER.md §Cost model):

    * memory   — weight stream (2 bytes/param / TP degree) + each slot's KV
      pages at the representative context (+ the dense gather tax when the
      fused kernel is off);
    * compute  — 2 FLOPs/param/row over decode_batch x (1 + gamma) rows;
    * ici      — one ring all-reduce of the slab activations per layer when
      the model axis is sharded;
    * step     — max of the three, plus dispatch overhead amortized over the
      rolled span;
    * tokens   — decode_batch x E[accepted | gamma, alpha] per step;
    * $/token  — n_chips x $/hr x step / tokens;
    * J/token  — per-op dynamic energy (tech-node table) + static TDP share,
      over emitted (not drafted) tokens: rejected draft rows burn real
      energy, which is exactly the tokens/s-vs-J/token trade the frontier
      exposes.  With no energy table the whole TDP is charged (power model).
    """
    ma = max(1, int(mesh_model))
    n_chips = ma
    mesh = {"data": 1, "model": ma}
    b = plan.decode_batch
    rows = b * (1 + plan.spec_len)
    p_active = cfg.param_count(active_only=True)

    # ---- feasibility: pool + weights must fit each chip's HBM. ----------
    weight_bytes_chip = 2.0 * p_active / ma
    pool_bytes_chip = (
        plan.n_blocks * plan.block_size * plan.kv_bytes_per_token / ma
    )
    if weight_bytes_chip + pool_bytes_chip > hw.hbm_bytes:
        return DesignPoint(
            hardware=hw.name, arch=cfg.name, mesh=mesh, plan=plan,
            tile="", tokens_per_s=0.0, usd_per_mtok=math.inf,
            mj_per_tok=math.inf, step_s=math.inf, tokens_per_step=0.0,
            bound="memory", feasible=False,
            reason="weights + KV pool exceed HBM",
        )
    if ma > 1 and hw.ici_bandwidth <= 0:
        return DesignPoint(
            hardware=hw.name, arch=cfg.name, mesh=mesh, plan=plan,
            tile="", tokens_per_s=0.0, usd_per_mtok=math.inf,
            mj_per_tok=math.inf, step_s=math.inf, tokens_per_step=0.0,
            bound="ici", feasible=False,
            reason="model-sharded mesh on a device with no interconnect",
        )

    # ---- per-step traffic / compute. ------------------------------------
    ctx = plan.max_seq_len * CTX_FRACTION
    kv_bytes_chip = b * ctx * plan.kv_bytes_per_token / ma
    if not plan.fused_attention:
        # gather fallback: dense write + re-read of the full-context cache
        kv_bytes_chip += 2.0 * b * plan.max_seq_len * plan.kv_bytes_per_token / ma
    mem_bytes_chip = weight_bytes_chip + kv_bytes_chip
    flops_chip = 2.0 * p_active / ma * rows
    ici_bytes_chip = 0.0
    if ma > 1:
        # one ring all-reduce of the (rows, d_model) activations per layer:
        # ring moves 2*(g-1)/g of the operand per chip
        operand = rows * cfg.d_model * 2.0 * cfg.n_layers
        ici_bytes_chip = 2.0 * operand * (ma - 1) / ma

    t_mem = mem_bytes_chip / hw.hbm_bandwidth if hw.hbm_bandwidth > 0 else math.inf
    t_compute = flops_chip / hw.peak_flops_bf16 if hw.peak_flops_bf16 > 0 else math.inf
    t_ici = ici_bytes_chip / hw.ici_bandwidth if ici_bytes_chip else 0.0
    terms = {"memory": t_mem, "compute": t_compute, "ici": t_ici}
    bound = max(terms, key=terms.get)
    t_step = max(t_mem, t_compute, t_ici) + hw.dispatch_overhead_s / max(
        plan.rolled_steps, 1
    )
    if not math.isfinite(t_step) or t_step <= 0:
        return DesignPoint(
            hardware=hw.name, arch=cfg.name, mesh=mesh, plan=plan,
            tile="", tokens_per_s=0.0, usd_per_mtok=math.inf,
            mj_per_tok=math.inf, step_s=math.inf, tokens_per_step=0.0,
            bound=bound, feasible=False,
            reason="unserviceable step (no off-chip bandwidth)",
        )

    tokens_per_step = b * expected_accepted(plan.spec_len, acceptance)
    tokens_per_s = tokens_per_step / t_step

    # ---- $/token. --------------------------------------------------------
    usd_per_tok = (
        n_chips * hw.dollars_per_hour / 3600.0 * t_step / tokens_per_step
    )

    # ---- J/token. --------------------------------------------------------
    ep = energy_params(hw)
    if ep:
        joules = (
            flops_chip * ma * ep.get("flop_bf16", 0.0) * 1e-12
            + mem_bytes_chip * ma * ep.get("mem_byte", 0.0) * 1e-12
            + ici_bytes_chip * ma * ep.get("ici_byte", 0.0) * 1e-12
            + hw.tdp_watts * ep.get("static_fraction", 0.3) * t_step * n_chips
        )
    else:
        joules = hw.tdp_watts * t_step * n_chips
    j_per_tok = joules / tokens_per_step

    from repro_torch.core.autotune import resolve_serve_tile  # cycle-free: deferred

    tile = resolve_serve_tile(cfg, plan, hw)
    return DesignPoint(
        hardware=hw.name,
        arch=cfg.name,
        mesh=mesh,
        plan=plan,
        tile=f"{tile.name}({tile.block_m}x{tile.block_n}x{tile.block_k})",
        tokens_per_s=tokens_per_s,
        usd_per_mtok=usd_per_tok * 1e6,
        mj_per_tok=j_per_tok * 1e3,
        step_s=t_step,
        tokens_per_step=tokens_per_step,
        bound=bound,
        feasible=True,
    )


def dominates(a: DesignPoint, b: DesignPoint) -> bool:
    """a dominates b: no worse on every axis, strictly better on one.
    tokens/s is maximized; $/Mtok and mJ/tok are minimized."""
    ge = (
        a.tokens_per_s >= b.tokens_per_s
        and a.usd_per_mtok <= b.usd_per_mtok
        and a.mj_per_tok <= b.mj_per_tok
    )
    gt = (
        a.tokens_per_s > b.tokens_per_s
        or a.usd_per_mtok < b.usd_per_mtok
        or a.mj_per_tok < b.mj_per_tok
    )
    return ge and gt


def pareto_frontier(points: list[DesignPoint]) -> list[DesignPoint]:
    """Non-dominated subset of the feasible points, sorted by tokens/s
    (descending) for a stable, deterministic report order.  Metric-identical
    duplicates keep only their first (enumeration-order) representative."""
    feas = [p for p in points if p.feasible]
    seen: set[tuple] = set()
    unique = []
    for p in feas:
        key = (p.tokens_per_s, p.usd_per_mtok, p.mj_per_tok)
        if key in seen:
            continue
        seen.add(key)
        unique.append(p)
    frontier = [
        p for p in unique if not any(dominates(q, p) for q in unique if q is not p)
    ]
    frontier.sort(key=lambda p: (-p.tokens_per_s, p.usd_per_mtok, p.mj_per_tok))
    return frontier


@dataclasses.dataclass
class FamilyResult:
    """Everything one search produced: all costed candidates + the frontier."""

    arch: str
    hardware: str
    space: SearchSpace
    points: list[DesignPoint]
    frontier: list[DesignPoint]

    def to_record(self) -> dict:
        return {
            "arch": self.arch,
            "hardware": self.hardware,
            "max_seq_len": self.space.max_seq_len,
            "acceptance": self.space.acceptance,
            "n_candidates": len(self.points),
            "n_feasible": sum(p.feasible for p in self.points),
            "frontier": [p.to_record() for p in self.frontier],
        }

    def render_markdown(self) -> str:
        """The frontier as a markdown table (the dryrun --family report)."""
        head = (
            f"## Accelerator family: {self.arch} on {self.hardware}\n\n"
            f"{len(self.frontier)} non-dominated points "
            f"({sum(p.feasible for p in self.points)} feasible of "
            f"{len(self.points)} candidates; "
            f"max_seq={self.space.max_seq_len}, "
            f"alpha={self.space.acceptance})\n\n"
        )
        cols = (
            "| # | mesh | B | kv | gamma | K | slab | tile "
            "| tok/s | $/Mtok | mJ/tok | bound |\n"
            "|---|------|---|----|-------|---|------|------"
            "|-------|--------|--------|-------|\n"
        )
        rows = []
        for i, p in enumerate(self.frontier):
            s = p.plan
            rows.append(
                f"| {i} | {p.mesh['data']}x{p.mesh['model']} "
                f"| {s.decode_batch} | {s.kv_dtype} | {s.spec_len} "
                f"| {s.rolled_steps} | {s.mixed_slab_width} | {p.tile} "
                f"| {p.tokens_per_s:.0f} | {p.usd_per_mtok:.2f} "
                f"| {p.mj_per_tok:.2f} | {p.bound} |"
            )
        return head + cols + "\n".join(rows) + "\n"


def search_family(
    arch_or_cfg: Union[str, object],
    hw: Union[str, HardwareSpec],
    space: Optional[SearchSpace] = None,
) -> FamilyResult:
    """Sweep the space and return all costed points + the Pareto frontier.

    Pure function of (arch, hardware, space): candidates are enumerated in
    attribute order, plans that collide after derivation are deduplicated to
    their first spelling, and the frontier sort is total — two calls return
    identical results."""
    if isinstance(arch_or_cfg, str):
        from repro_torch.configs import get_config

        cfg = get_config(arch_or_cfg)
    else:
        cfg = arch_or_cfg
    if isinstance(hw, str):
        hw = get_hardware(hw)
    ok, reason = serve_feasible(cfg)
    if not ok:
        raise ValueError(f"no serving family for {cfg.name}: {reason}")
    space = space or default_space(hw)

    points: list[DesignPoint] = []
    seen_plans: set[tuple] = set()
    for ma, batch, kv, bs, slab, ppt, gamma, rolled in itertools.product(
        space.mesh_models,
        space.decode_batches,
        space.kv_dtypes,
        space.block_sizes,
        space.slab_widths,
        space.pages_per_tile,
        space.spec_lens,
        space.rolled_steps,
    ):
        mesh = {"data": 1, "model": ma}
        try:
            plan = derive_serve_plan(
                cfg,
                mesh,
                hw,
                max_seq_len=space.max_seq_len,
                decode_batch=batch,
                kv_dtype=kv,
                block_size=bs,
                mixed_slab_width=slab,
                pages_per_tile=ppt,
                spec_len=gamma,
                rolled_steps=rolled,
                draft=space.draft if (gamma is None or gamma > 0) else "none",
            )
        except (ValueError, ZeroDivisionError, OverflowError):
            continue  # infeasible spelling; the space may legally contain it
        key = (ma, plan)
        if key in seen_plans:
            continue  # different spellings deriving the same plan
        seen_plans.add(key)
        points.append(
            predict_point(
                cfg, hw, plan, mesh_model=ma, acceptance=space.acceptance
            )
        )
    return FamilyResult(
        arch=cfg.name,
        hardware=hw.name,
        space=space,
        points=points,
        frontier=pareto_frontier(points),
    )


def family_report(
    arch: str,
    hardware: str,
    *,
    space: Optional[SearchSpace] = None,
    max_seq_len: int = 2048,
    out_dir: Optional[Union[str, pathlib.Path]] = None,
) -> tuple[FamilyResult, dict]:
    """The ``dryrun --family`` engine: search, write JSON, return markdown.

    Returns (result, record); ``record`` is what lands in
    ``<out_dir>/<hardware>__<arch>.json`` (record["markdown"] carries the
    rendered table so the artifact is self-contained)."""
    hw = get_hardware(hardware)
    if space is None:
        space = default_space(hw, max_seq_len=max_seq_len)
    result = search_family(arch, hw, space)
    record = result.to_record()
    record["markdown"] = result.render_markdown()
    if out_dir is not None:
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{hw.name}__{arch}.json").write_text(
            json.dumps(record, indent=1, default=str)
        )
    return result, record

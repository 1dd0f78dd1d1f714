"""Roofline analysis of one rank's traced step (the port's
``repro/core/roofline.py``).

Three terms per (arch x shape x mesh) cell, as in JAX:
    compute_s    = FLOPs_per_device / peak_FLOP/s
    memory_s     = bytes_per_device / HBM_bw
    collective_s = ring-model interconnect seconds of the collectives

JAX reads the FLOPs, bytes and collectives off the compiled, partitioned
HLO (``repro.core.hlo_cost``).  The port reads them off one rank's step
traced on the ``meta`` device (``core/op_cost``): the aten matrix products,
every op's bytes, each hand-written kernel's ``cost()`` and each
collective with its group.  Where JAX's ``blocked_attention`` computes
every (query, key) block and masks it, the port's flash kernel is priced by
the pairs its masks leave visible, so a causal cell counts about half of
JAX's attention FLOPs.

Differences of the record from JAX's:

* JAX's two cross-check fields, ``xla_flops_per_device`` and
  ``xla_bytes_per_device`` (XLA's own ``cost_analysis``, loop bodies
  counted once), become ``flop_counter_flops_per_device``:
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the same trace
  (the aten matrix products; it does not see the kernels' meta routes).
  There is no bytes cross-check.
* The peak the roofline fraction divides by is held on the report
  (``peak_flops``), not in a module global.
* ``kernel_calls``: each hand-written kernel's calls in the step.

Conventions (JAX's):
  * collective_bytes = per-device summed operand bytes of every all-gather /
    all-reduce / reduce-scatter / all-to-all / collective-permute;
    collective term (spec form) = collective_bytes / link_bw.
  * ring model: all-reduce 2x(g-1)/g, gathers (g-1)/g, permute 1x.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.op_cost import OpCost


def _ring_seconds(op: str, operand_bytes: float, g: int, link_bw: float) -> float:
    if g <= 1 or link_bw <= 0:
        return 0.0
    if op == "all-gather":
        # operand = out/g; ring moves out*(g-1)/g = operand*(g-1)
        return operand_bytes * (g - 1) / link_bw
    if op == "all-reduce":
        return 2.0 * operand_bytes * (g - 1) / g / link_bw
    if op == "reduce-scatter":
        return operand_bytes * (g - 1) / g / link_bw
    if op == "all-to-all":
        return operand_bytes * (g - 1) / g / link_bw
    return operand_bytes / link_bw  # collective-permute


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # raw (per device: one rank's step)
    flops_per_device: float
    bytes_per_device: float
    collective_operand_bytes_per_device: float
    n_collectives: int
    collectives_by_op: dict
    # cross-check: torch.utils.flop_counter on the same trace
    flop_counter_flops_per_device: float
    # terms (seconds)
    compute_s: float
    memory_s: float  # op-by-op bytes (upper bound: eager ops are all top level)
    memory_floor_s: float  # analytic lower bound (params+acts+probs+CE traffic)
    collective_s: float  # ring model
    collective_s_spec: float  # task-spec convention
    # utilization
    model_flops: float
    model_flops_ratio: float  # MODEL_FLOPS / (traced flops x chips)
    bottleneck: str
    # memory fit
    arg_bytes: float
    temp_bytes: float
    fits_hbm: bool
    peak_flops: float  # the peak compute_s and roofline_fraction divide by
    kernel_calls: dict  # hand-written kernel -> calls in the step

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time model: overlapped compute/memory/comm (memory
        enters via the analytic floor — see analyze())."""
        return max(self.compute_s, self.memory_floor_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs MFU at the roofline step time."""
        if self.step_time_s <= 0:
            return 0.0
        useful = self.model_flops / self.n_chips
        return useful / self.step_time_s / self.peak_flops


def collective_seconds(cost: OpCost, link_bw: float) -> float:
    """Ring-model seconds of every collective of ``cost``."""
    return sum(_ring_seconds(o, b, g, link_bw) * m for o, b, g, m in cost.collectives)


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_chips: int,
    cost: OpCost,
    flop_counter_flops: float,
    hw: HardwareSpec,
    model_flops: float,
    arg_bytes: float = 0.0,
    temp_bytes: float = 0.0,
    memory_floor_bytes: float = 0.0,
) -> RooflineReport:
    flops = cost.flops
    byts = cost.hbm_bytes
    link_bw = hw.ici_bandwidth_per_link
    ring_s = collective_seconds(cost, link_bw)
    op_bytes = cost.collective_operand_bytes
    by_op: dict = {}
    for o, b, g, m in cost.collectives:
        d = by_op.setdefault(o, {"count": 0, "operand_bytes": 0.0})
        d["count"] += m
        d["operand_bytes"] += b * m

    compute_s = flops / hw.peak_flops_bf16
    # A zero-bandwidth device makes any HBM traffic unserviceable: report
    # inf rather than divide by zero.
    if hw.hbm_bandwidth > 0:
        memory_s = byts / hw.hbm_bandwidth
        floor_s = memory_floor_bytes / hw.hbm_bandwidth
    else:
        memory_s = math.inf if byts else 0.0
        floor_s = math.inf if memory_floor_bytes else 0.0
    spec_s = op_bytes / link_bw if link_bw else 0.0
    # Bottleneck attribution uses the analytic memory floor: the op-by-op
    # byte count has no fusion at all and would swallow every cell into
    # "memory".
    terms = {"compute": compute_s, "memory": floor_s or memory_s, "collective": ring_s}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * n_chips
    ratio = model_flops / total_flops if total_flops else 0.0
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_chips=n_chips,
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_operand_bytes_per_device=float(op_bytes),
        n_collectives=int(sum(m for _, _, _, m in cost.collectives)),
        collectives_by_op=by_op,
        flop_counter_flops_per_device=float(flop_counter_flops),
        compute_s=compute_s,
        memory_s=memory_s,
        memory_floor_s=floor_s,
        collective_s=ring_s,
        collective_s_spec=spec_s,
        model_flops=model_flops,
        model_flops_ratio=ratio,
        bottleneck=bottleneck,
        arg_bytes=arg_bytes,
        temp_bytes=temp_bytes,
        fits_hbm=(arg_bytes + temp_bytes) <= hw.hbm_bytes,
        peak_flops=hw.peak_flops_bf16,
        kernel_calls=cost.kernel_calls(),
    )


def model_flops_for(cfg, shape, training: bool) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N_active*D (inference forward)."""
    n = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if training else 2.0) * n * tokens


def analytic_memory_floor(cfg, shape, plan, n_chips: int) -> float:
    """Minimum plausible HBM bytes per chip per step (roofline lower bound).

    Train:  weights fwd+bwd reads + grad write + optimizer r/w (~12B/param on
            its shard) + ~8 activation tensors/layer r+w (x3 with remat) +
            attention probs traffic + CE logits chunks.
    Decode: active weights read once + KV/state cache read + write.
    """
    mesh = dict(plan.mesh_axes)
    n_active = cfg.param_count(active_only=True)
    params_shard = n_active / n_chips
    if shape.kind == "decode":
        cache_elems = 0.0
        for i in range(cfg.n_layers):
            kind = cfg.layer_kind(i)
            if kind in ("attn", "swa", "local"):
                window = (
                    cfg.sliding_window if kind == "swa"
                    else cfg.local_window if kind == "local" else 0
                )
                sc = min(window, shape.seq_len) if window else shape.seq_len
                cache_elems += (
                    2 * shape.global_batch * sc * cfg.n_kv_heads * cfg.d_head
                )
            elif kind == "rwkv6":
                cache_elems += shape.global_batch * cfg.rnn_heads * cfg.d_head**2
            elif kind == "rglru":
                cache_elems += shape.global_batch * (cfg.lru_width or cfg.d_model)
        return 2.0 * n_active / n_chips + 2.0 * cache_elems / n_chips
    # training / prefill
    tokens_per_chip = shape.global_batch * shape.seq_len / max(
        mesh.get("data", 1)
        * (mesh.get("model", 1) if plan.dp_over_model else 1)
        * mesh.get("pod", 1),
        1,
    )
    passes = 3.0 if shape.kind == "train" else 1.0
    width_frac = 1.0 / (mesh.get("model", 1) if not plan.dp_over_model else 1)
    act = tokens_per_chip * cfg.d_model * 2.0 * 8 * cfg.n_layers * passes * (
        2.0 if plan.remat else 1.0
    ) * width_frac
    eff_kv = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    attn_layers = sum(
        1
        for i in range(cfg.n_layers)
        if cfg.layer_kind(i) in ("attn", "swa", "local")
    )
    probs = tokens_per_chip * eff_kv * cfg.n_heads * 4.0 * attn_layers * passes * width_frac
    ce = tokens_per_chip * cfg.vocab_size * 4.0 * passes if shape.kind == "train" else 0.0
    weights = params_shard * (12.0 if shape.kind == "train" else 2.0)
    return weights + act + probs + ce

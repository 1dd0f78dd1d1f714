"""The arithmetic the metric files share (``metrics/<name>.py`` are one
reader each; several metrics read the same quantity in other cells)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from bench.portbench import costs
from bench.portbench.run import kernel_names
from bench.portbench.serving import kv_elem, step_flops

PAGED_SOURCES = ("paged_attention/csrc/paged_attention.cu",)
FLASH_FWD = ("flash_attention/csrc/flash_attention.cu",)
FLASH_BWD = ("flash_attention/csrc/flash_attention_bwd.cu",)
WKV_FWD = ("rwkv6/csrc/wkv.cu",)
WKV_BWD = ("rwkv6/csrc/wkv_bwd.cu",)


def p95(xs) -> Optional[float]:
    xs = list(xs)
    return float(np.percentile(np.asarray(xs, np.float64), 95)) if xs else None


def window_steps(run) -> list:
    t0, t1 = run.window["t0"], run.window["t1"]
    return [s for s in run.steps if s.t0 >= t0 and s.t1 <= t1]


def dispatch_ms(run) -> Optional[float]:
    steps = window_steps(run)
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps) if steps else None


def serve_mfu(run) -> Optional[float]:
    """Model FLOPs of the window's live work over the summed dispatch time
    at the bf16 peak, in %."""
    steps = window_steps(run)
    busy = sum(s.t1 - s.t0 for s in steps)
    if not steps or busy <= 0:
        return None
    flops = sum(step_flops(run.cfg, s) for s in steps)
    return 100.0 * flops / (busy * costs.PEAK_BF16_FLOPS)


def paged_roofline(run) -> Optional[float]:
    """The byte and FLOP bound of the window's paged-attention calls (every
    attention layer of every traced step, each live slot's pages, rows and
    outputs once) over the kernels' device time, in %."""
    if run.trace is None:
        return None
    names = kernel_names(*PAGED_SOURCES)
    t = run.trace_time_s(names)
    steps = window_steps(run)
    if t <= 0 or not steps:
        return None
    cfg, sp = run.cfg, run.serve_plan
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.layer_kind(i) in ("attn", "swa", "local"))
    bound = 0.0
    for s in steps:
        nbytes = costs.paged_attention_bytes(s.slots, cfg.n_kv_heads, cfg.d_head, cfg.n_heads,
                                             sp.block_size, kv_elem(sp))
        flops = costs.paged_attention_flops(s.slots, cfg.n_heads, cfg.d_head)
        bound += n_attn * costs.bound_s(flops, nbytes)
    return 100.0 * bound / t


def device_idle(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def train_tokens(run) -> int:
    return len(run.window["step_ends"]) * run.window["tokens_per_step"]


def train_model_flops_per_step(run) -> float:
    """6 FLOPs a matrix weight a token (forward and backward), the head
    included, and three times the forward of the sequence mixing:
    causal attention's products, or RWKV-6's WKV recurrence."""
    cfg, mix = run.cfg, run.cell.traffic
    B, S = int(mix["batch"]), int(mix["seq_len"])
    if cfg.layer_pattern == ("rwkv6",):
        per_layer = costs.rwkv6_matrix_weights(cfg.d_model, cfg.rnn_heads, cfg.d_head, cfg.d_ff,
                                               max(32, cfg.d_model // 32))
        mixing = 3.0 * costs.wkv_token_flops(cfg.rnn_heads, cfg.d_head) * B * S * cfg.n_layers
    else:
        per_layer = costs.decoder_matrix_weights(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                                 cfg.d_head, cfg.d_ff)
        mixing = (3.0 * costs.attention_pair_flops(cfg.n_heads, cfg.d_head) * B
                  * costs.causal_pairs(S) * cfg.n_layers)
    weights = per_layer * cfg.n_layers + cfg.d_model * cfg.vocab_size
    return 6.0 * weights * B * S + mixing


def train_mfu(run) -> Optional[float]:
    w = run.window
    span = w["t1"] - w["t0"]
    if span <= 0 or not w["step_ends"]:
        return None
    flops = train_model_flops_per_step(run) * len(w["step_ends"])
    return 100.0 * flops / (span * costs.PEAK_BF16_FLOPS)


def train_kernel_roofline(run, fwd_sources, bwd_sources, fwd_cost, bwd_cost) -> Optional[float]:
    """Forward and backward calls' bounds (calls counted in the trace, each
    at the job's shape) over their device time, in %."""
    if run.trace is None:
        return None
    fwd, bwd = kernel_names(*fwd_sources), kernel_names(*bwd_sources)
    t = run.trace_time_s(fwd) + run.trace_time_s(bwd)
    if t <= 0:
        return None
    bound = (run.trace_calls(fwd) * costs.bound_s(*fwd_cost)
             + run.trace_calls(bwd) * costs.bound_s(*bwd_cost))
    return 100.0 * bound / t

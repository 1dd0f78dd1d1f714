"""AdamW as the training configuration states it, in float32.

Clip the gradients by their global norm, update f32 moments, bias-correct,
add decoupled weight decay on every leaf of two or more dimensions as the
tree stores it (a stacked per-layer vector counts as one), and store each
parameter back in its own dtype, rounded to nearest.  The learning rate
warms up linearly to ``peak_lr`` over ``warmup_steps``, then follows a
cosine to ``min_lr`` at ``total_steps``."""
from __future__ import annotations

import math

import torch


def lr_at(opt: dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    frac = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    return opt["min_lr"] + 0.5 * (opt["peak_lr"] - opt["min_lr"]) * (1 + math.cos(math.pi * frac))


def step(params: dict, grads: dict, m: dict, v: dict, t: int, opt: dict) -> tuple:
    """One update at step ``t`` (1-based) of the ``{path: tensor}`` dicts,
    in place; returns (the clipped gradients' scale, the global norm)."""
    gnorm = math.sqrt(math.fsum(float(g.double().square().sum()) for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0) if opt["clip_norm"] > 0 else 1.0
    lr = lr_at(opt, t)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for path, p in params.items():
        g = grads[path].float() * scale
        m[path].mul_(b1).add_((1 - b1) * g)
        v[path].mul_(b2).add_((1 - b2) * g.square())
        delta = (m[path] / bc1) / (torch.sqrt(v[path] / bc2) + eps)
        if p.dim() >= 2:
            delta = delta + wd * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return scale, gnorm

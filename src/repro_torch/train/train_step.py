"""The training step (the port's ``repro/train/train_step.py``, one
device, no mesh).

``make_train_step`` returns a plain function ``train_step(state, batch) ->
(state, metrics)``: the loss and its gradients (``lm_loss`` through
autograd, over ``plan.microbatches`` microbatches whose gradients are summed
in f32 and divided by their number; ``plan.remat`` is the forward's), the
gradient compression of ``plan.grad_compression`` (or of an explicit
``CompressionConfig``) with the state's error-feedback residual, then
AdamW.  JAX jits this function; the port runs it eagerly, and on the card
its forward and backward go through the flash-attention, RMSNorm and WKV
kernels (``torch.autograd.Function``s): every arch trains there.

Left for ``dist/`` (ROADMAP queue 1, item 7): the pipeline plan
(``pipeline_lm_loss``) and the compressed wire path (``compressed_psum``
and ``wire_compression_axes``): on one device compression runs at the
accumulation boundary.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models.transformer import lm_loss
from repro_torch.train.compression import CompressionConfig, compress_grads
from repro_torch.train.optimizer import (OptimizerConfig, TrainState, adamw_update,
                                         tree_leaves, tree_map, tree_unflatten)

Tree = Any

logger = logging.getLogger(__name__)


def _split_micro(batch: dict, n: int) -> dict:
    """Every (B, ...) leaf of ``batch`` as (n, B / n, ...)."""
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}


def make_loss_fn(cfg: ArchConfig, plan: ExecutionPlan, fused: bool = True) -> Callable:
    def loss_fn(params, batch):
        return lm_loss(params, batch, cfg=cfg, plan=plan, fused=fused)

    return loss_fn


def value_and_grad(loss_fn: Callable, params: Tree, batch: dict) -> tuple:
    """(loss, gradients) of ``loss_fn(params, batch)``: the gradient tree
    has the parameters' shape and dtypes; a leaf the loss does not reach
    gets zeros (as ``jax.value_and_grad`` gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(
    cfg: ArchConfig,
    plan: ExecutionPlan,
    opt: OptimizerConfig,
    compression: Optional[CompressionConfig] = None,
    *,
    fused: bool = True,
    device="cuda",
) -> Callable:
    """The step function for ``cfg`` on ``plan``.  ``device`` is where the
    step runs (the card by default; raises without one unless
    ``device="cpu"``).  ``fused=False`` runs every kernel's plain version
    (the oracle)."""
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg, plan, fused)
    n_micro = max(1, plan.microbatches)
    # plan.grad_compression is the control-plane knob; an explicit
    # CompressionConfig only overrides its error-feedback detail
    cc = compression or CompressionConfig(mode=plan.grad_compression)

    def accumulate(params, batch):
        """(loss, gradients), over the microbatches when there are several:
        f32 sums divided by their number."""
        if n_micro == 1:
            return value_and_grad(loss_fn, params, batch)
        micro = _split_micro(batch, n_micro)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            loss, g = value_and_grad(loss_fn, params, {k: v[i] for k, v in micro.items()})
            gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
            lsum = lsum + loss
            del g
        return lsum / n_micro, tree_map(lambda g: g / n_micro, gsum)

    def train_step(state: TrainState, batch: dict):
        loss, grads = accumulate(state.params, batch)
        residual = state.residual
        if residual is not None:
            grads, residual = compress_grads(grads, residual, cc)
        elif cc.mode != "none":
            # compression asked for without an error-feedback residual in
            # the state: honour the mode statelessly rather than silently
            # training uncompressed
            logger.warning(
                "gradient compression (mode=%s) running statelessly: no error-feedback "
                "residual in the train state", cc.mode)
            zeros = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                   device=g.device), grads)
            grads, _ = compress_grads(grads, zeros,
                                      dataclasses.replace(cc, error_feedback=False))
        new_state, metrics = adamw_update(state, grads, opt)
        new_state = new_state._replace(residual=residual)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step

"""The training step (the port's ``repro/train/train_step.py``).

``make_train_step`` returns a plain function ``train_step(state, batch) ->
(state, metrics)``: the loss and its gradients (through autograd, over
``plan.microbatches`` microbatches whose gradients are summed in f32 and
divided by their number; ``plan.remat`` is the forward's), the gradient
compression of ``plan.grad_compression``, then AdamW.  JAX jits this
function; the port runs it eagerly, and on the card its forward and
backward go through the flash-attention, RMSNorm and WKV kernels
(``torch.autograd.Function``s).

With a ``mesh`` (``launch.mesh``), ``batch`` is the global batch on every
rank and ``state`` holds this rank's shards (``Shardings``), and the plan is
the control plane, as in JAX:

* ``plan.pod_role == "pipeline"`` routes the loss through
  ``models.transformer.pipeline_lm_loss`` (the stacked groups as pipeline
  stages over ``pod``), which does its own microbatching: no outer
  accumulation.  A stage's FSDP shards (ZeRO, ``dp_over_model``) are
  gathered at its entry and their gradients scattered back, as below.
* ``plan.grad_compression`` picks the gradient wire format.  On a pure
  data-parallel mesh (``wire_compression_axes``) the step computes each
  rank's loss and gradients on its rows and sums them with
  ``dist.collectives.compressed_psum`` / n: compression happens once, on
  the wire.  Elsewhere the same mode falls back to
  ``train/compression.py``'s accumulation-dtype quantization with error
  feedback.
* Otherwise each rank's gradients (1/n of its rows' gradient, through the
  loss's mean over the batch axes) are summed over the axes that split the
  batch, never over an axis that does not: a replicated parameter's
  gradient is then the data-parallel mean, a model or stage shard's its
  own.  Under tensor parallelism without SP the model axis takes no sum:
  every model rank sees the same rows, and f's backward already summed
  the partial gradients where a replicated tensor enters a sharded block,
  so each rank's gradient of a replicated leaf is the whole one.  An FSDP
  shard (ZeRO, ``dp_over_model``) takes no sum over the axes it is sharded
  over: its gather's backward reduce-scattered its gradient over them
  (``dist.collectives.fsdp_gather``), so the sum after the backward covers
  only the batch axes it is not sharded over.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models.transformer import lm_loss, pipeline_lm_loss
from repro_torch.train.compression import CompressionConfig, compress_grads
from repro_torch.train.optimizer import (OptimizerConfig, TrainState, adamw_update,
                                         tree_leaves, tree_map, tree_unflatten)

Tree = Any

logger = logging.getLogger(__name__)


def _split_micro(batch: dict, n: int) -> dict:
    """Every (B, ...) leaf of ``batch`` as (n, B / n, ...)."""
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}


def make_loss_fn(cfg: ArchConfig, plan: ExecutionPlan, fused: bool = True,
                 mesh=None, shardings=None) -> Callable:
    if plan.pod_role == "pipeline" and plan.pod_axis > 1:
        if mesh is None:
            raise ValueError("plan.pod_role == 'pipeline' needs a mesh to execute; "
                             "pass mesh= to make_train_step")

        def loss_fn(params, batch):
            return pipeline_lm_loss(params, batch, cfg=cfg, plan=plan, mesh=mesh, fused=fused,
                                    shardings=shardings)

        return loss_fn

    def loss_fn(params, batch):
        return lm_loss(params, batch, cfg=cfg, plan=plan, fused=fused, mesh=mesh,
                       shardings=shardings)

    return loss_fn


def wire_compression_axes(plan: ExecutionPlan, mesh, batch: Optional[int] = None):
    """Mesh axes the compressed gradient exchange runs over, or None when
    the wire path cannot host this plan: it computes each rank's loss and
    gradients on replicated parameters with only the batch split, so any
    weight-sharding feature (tensor / sequence parallel, ZeRO, the folded
    model axis) and the pipeline disqualify it.  ``batch`` (the global batch)
    also applies the run-time divisibility requirement."""
    if mesh is None or plan.grad_compression == "none":
        return None
    if (
        plan.pod_role == "pipeline"
        or plan.zero_weights
        or plan.dp_over_model
        or plan.seq_shard
        or plan.seq_parallel_acts
    ):
        return None
    sizes = dict(mesh.shape)
    axes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    if not axes:
        return None
    if any(v > 1 for k, v in sizes.items() if k not in axes):
        return None  # a >1 model axis means params are not replicated
    if batch is not None:
        n_dp = math.prod(sizes[a] for a in axes)
        if batch % (n_dp * max(1, plan.microbatches)):
            return None  # the local batch would not split into microbatches
    return axes


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
    mesh=None,
    grad_shardings: Optional[Tree] = None,
    donate: bool = False,
) -> Callable:
    """The step function for ``cfg`` on ``plan`` (over ``mesh``'s ranks when
    given).  ``device`` is where the step runs (the card by default; raises
    without one unless ``device="cpu"``).  ``fused=False`` runs every
    kernel's plain version (the oracle).  ``grad_shardings`` is the
    parameters' layout (``Shardings.manual_param_shardings`` of the whole
    tree), which the global gradient norm reads (a shard's squares are
    summed over its axes) and the loss's FSDP gathers follow; without it
    every leaf is replicated.  ``donate``:
    each step updates the state it is given in place (JAX's
    ``donate_argnums``)."""
    from repro_torch.dist.collectives import all_reduce, compressed_psum, mean_over
    from repro_torch.dist.sharding import Shardings, local_shard

    dev = resolve_device(device)
    pipelined = plan.pod_role == "pipeline" and plan.pod_axis > 1
    loss_fn = make_loss_fn(cfg, plan, fused, mesh, grad_shardings)
    # the pipeline schedules its own microbatches: no outer accumulation
    n_micro = 1 if pipelined else max(1, plan.microbatches)
    # plan.grad_compression is the control-plane knob; an explicit
    # CompressionConfig only overrides its error-feedback detail
    cc = compression or CompressionConfig(mode=plan.grad_compression)
    wire_axes = wire_compression_axes(plan, mesh)
    sh = None if mesh is None else Shardings(mesh, plan, cfg)
    # per leaf, the axes its FSDP gather's backward already summed over
    gathered = (None if sh is None or grad_shardings is None else
                tree_map(lambda s: frozenset(a for e in (sh.gather_spec(s.spec) or ())
                                             if e is not None
                                             for a in (e if isinstance(e, tuple) else (e,))),
                         grad_shardings))
    if wire_axes:
        local_loss = make_loss_fn(cfg, plan, fused)  # this rank's rows, no mesh
        n_dp = math.prod(dict(mesh.shape)[a] for a in wire_axes)

    def accumulate(fn, params, batch):
        """(loss, gradients), over the microbatches when there are several:
        f32 sums divided by their number."""
        if n_micro == 1:
            return value_and_grad(fn, params, batch)
        micro = _split_micro(batch, n_micro)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            loss, g = value_and_grad(fn, params, {k: v[i] for k, v in micro.items()})
            gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
            lsum = lsum + loss
            del g
        return lsum / n_micro, tree_map(lambda g: g / n_micro, gsum)

    def mesh_norm(grads):
        """The global norm of sharded gradients (None: every leaf whole)."""
        if grad_shardings is None or mesh is None:
            return None
        parts: dict = {}
        for g, s in zip(tree_leaves(grads), tree_leaves(grad_shardings)):
            axes = tuple(a for e in s.spec if e is not None
                         for a in (e if isinstance(e, tuple) else (e,)))
            sq = g.float().square().sum()
            parts[axes] = sq if axes not in parts else parts[axes] + sq
        if set(parts) <= {()}:
            return None
        return torch.sqrt(sum(all_reduce(sq, axes, mesh) if axes else sq
                              for axes, sq in parts.items()))

    def batch_axes(batch: dict):
        """The axes that split the loss's rows (those its mean runs over)."""
        b0 = next(iter(batch.values())).shape[0]
        return sh.batch_axes_for(b0 // (plan.microbatches if pipelined else n_micro))

    def train_step(state: TrainState, batch: dict):
        use_wire = bool(wire_axes)
        if use_wire:
            # the local batch must still split into microbatches on each rank
            use_wire = next(iter(batch.values())).shape[0] % (n_dp * n_micro) == 0
        residual = state.residual
        if use_wire:
            entry = wire_axes if len(wire_axes) > 1 else wire_axes[0]
            local = {k: local_shard(v, (entry,), mesh) for k, v in batch.items()}
            loss, grads = accumulate(local_loss, state.params, local)
            grads = tree_map(
                lambda g: compressed_psum(g, wire_axes, plan.grad_compression, mesh=mesh) / n_dp,
                grads)
            loss = mean_over(loss, wire_axes, mesh=mesh)  # wire mode: compression done
        else:
            loss, grads = accumulate(loss_fn, state.params, batch)
            axes = None if mesh is None else batch_axes(batch)
            if axes and mesh.extent(axes) > 1:
                def dp_sum(g, done=frozenset()):  # f32 sums
                    rest = tuple(a for a in axes if a not in done)
                    # an FSDP shard summed whole by its scatter stays as it is
                    # (AdamW widens each leaf in turn): no f32 copy of the tree
                    return all_reduce(g.float(), rest, mesh) if mesh.extent(rest) > 1 else g

                grads = (tree_map(dp_sum, grads) if gathered is None
                         else tree_map(dp_sum, grads, gathered))
            if residual is not None:
                grads, residual = compress_grads(grads, residual, cc)
            elif cc.mode != "none":
                # compression asked for without an error-feedback residual in
                # the state (the wire path disqualified, or a plan-only
                # caller): honour the mode statelessly rather than silently
                # training uncompressed
                logger.warning(
                    "gradient compression (mode=%s) running statelessly: no error-feedback "
                    "residual in the train state and the wire path is unavailable on this "
                    "mesh/batch", cc.mode)
                zeros = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                       device=g.device), grads)
                grads, _ = compress_grads(grads, zeros,
                                          dataclasses.replace(cc, error_feedback=False))
        new_state, metrics = adamw_update(state, grads, opt, grad_norm=mesh_norm(grads),
                                          donate=donate)
        new_state = new_state._replace(residual=residual)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step

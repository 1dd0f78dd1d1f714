"""Pipeline parallelism over the ``pod`` axis (the port's
``repro/dist/pipeline.py``): stage s (one rank of the axis) runs layer-group
slice s and hands its activations to stage s+1 on every tick.

Microbatch schedule (GPipe, all-forward), JAX's tick for tick::

    tick t = 0 .. M + S - 2       (M microbatches, S stages)
      stage 0    consumes microbatch ``min(t, M-1)`` (ramp-down ticks feed
                 it stale data whose results are never written),
      stage s>0  consumes what stage s-1 sent it on tick t-1,
      stage S-1  writes microbatch ``t - (S-1)`` once ``t >= S-1``;
      every stage but the last sends its output to the next on every tick,
      ramp ticks included, so all ranks issue the same calls.

The idle share is the ramp, ``bubble_fraction(M, S) = (S-1)/(M+S-1)``.  The
result is summed over the axis (zeros off the last stage), which replicates
it on every stage as JAX's final ``psum`` does.

JAX differentiates the ``lax.scan`` of ticks; here the schedule is one
``torch.autograd.Function`` whose backward runs the ticks in reverse: the
last stage seeds each written microbatch's gradient, every stage sends the
gradient of what it received back to the previous stage (the inverse
permute), and the microbatches' gradient, found on stage 0, is summed over
the axis like the forward's result.  The stage's weights enter its compute
group by group (each group's leaves are views of the stacked slice), so
each tick's weight gradients are added into the stage's gradient where
autograd finishes a group, one group in flight: no tick holds a second
stage-sized gradient.
"""
from __future__ import annotations

import torch

from repro_torch.dist.collectives import all_reduce, permute
from repro_torch.train.optimizer import tree_leaves, tree_unflatten


def bubble_fraction(n_micro: int, n_stage: int) -> float:
    """GPipe bubble: (S-1)/(M+S-1) of step time is idle ramp-up/down."""
    if n_stage <= 1:
        return 0.0
    if n_micro < 1:
        return 1.0
    return (n_stage - 1) / (n_micro + n_stage - 1)


def _peers(mesh, axis: str):
    s, n = mesh.index(axis), mesh.extent(axis)
    ranks = mesh.ranks(axis)
    return s, n, (ranks[s + 1] if s < n - 1 else None), (ranks[s - 1] if s > 0 else None)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, mesh, axis, w_tree, record, micro, *w_leaves):
        stage, n_stage, nxt, prv = _peers(mesh, axis)
        n_micro = micro.shape[0]
        out = torch.zeros_like(micro)
        recv = torch.zeros_like(micro[0])
        ticks = []
        with torch.set_grad_enabled(record):
            # each group's leaves: views of the stacked slice, leaves of
            # their own for autograd
            n_groups = w_leaves[0].shape[0] if w_leaves else 0
            parts = [[w[g].detach().requires_grad_(w.requires_grad) for w in w_leaves]
                     for g in range(n_groups)]
            groups = [tree_unflatten(w_tree, p) for p in parts]
            for t in range(n_micro + n_stage - 1):
                x_in = micro[min(t, n_micro - 1)] if stage == 0 else recv
                x_in = x_in.detach().requires_grad_(record)
                y = stage_fn(groups, x_in)
                ticks.append((x_in, y))
                m = t - (n_stage - 1)
                if stage == n_stage - 1 and m >= 0:
                    out[m] = y.detach()
                if n_stage > 1:
                    recv = permute(y.detach(), axis, mesh, nxt, prv)
        ctx.state = (mesh, axis, ticks, parts, w_leaves, micro.shape, micro.dtype)
        return all_reduce(out, axis, mesh)

    @staticmethod
    def backward(ctx, dout):
        mesh, axis, ticks, parts, w_leaves, mshape, mdtype = ctx.state
        stage, n_stage, nxt, prv = _peers(mesh, axis)
        n_micro = mshape[0]
        dmicro = torch.zeros(mshape, dtype=mdtype, device=dout.device)
        dw = [torch.zeros_like(w) if w.requires_grad else None for w in w_leaves]
        live = []
        for g, group in enumerate(parts):
            for i, w in enumerate(group):
                if w.requires_grad:
                    w.grad = dw[i][g]  # autograd adds each tick's group gradient here
                    live.append(w)
        dx_next = None  # gradient of the input consumed at tick t + 1
        for t in reversed(range(len(ticks))):
            x_in, y = ticks[t]
            dy = torch.zeros_like(y)
            if n_stage > 1:
                # what this stage received on tick t fed tick t + 1: send its
                # gradient back; the next stage's is this tick's output's
                d_recv = dx_next if (stage > 0 and dx_next is not None) else torch.zeros_like(y)
                dy = dy + permute(d_recv, axis, mesh, prv, nxt)
            m = t - (n_stage - 1)
            if stage == n_stage - 1 and m >= 0:
                dy = dy + dout[m]
            torch.autograd.backward(y, dy, inputs=[x_in] + live)
            dx_next = torch.zeros_like(x_in) if x_in.grad is None else x_in.grad
            if stage == 0:
                dmicro[min(t, n_micro - 1)] += dx_next
        ctx.state = None
        dmicro = all_reduce(dmicro, axis, mesh)
        return (None, None, None, None, None, dmicro, *dw)


def pipeline_forward(stage_fn, mesh, axis: str = "pod", batch_axes: tuple = ()):
    """Build a pipelined forward over ``axis``.

    ``stage_fn(groups, x) -> x`` is one stage's compute, ``groups`` the
    stage's layer-groups in order, each a tree shaped like ``w`` with one
    group's leaves (JAX's stage scans over the stacked leaves).  The
    returned callable takes ``w``, this stage's slice of the weights (leaves
    ``(n_groups / n_stage, ...)``, the block ``Shardings.param_spec`` gives
    a stage by putting ``pod`` on the stacked leading dim), and ``micro``
    ``(n_micro, mb, ...)``, this rank's microbatches: ``batch_axes`` name
    the axes that split dim 1 over data-parallel ranks (JAX's in-spec), so
    each rank passes its own rows.  It returns the microbatches after all
    stages, bit-identical to running the stages in sequence, on every
    stage; differentiable in ``w`` and ``micro``."""
    del batch_axes  # each rank already holds its rows: nothing to cut here

    def pipelined(w, micro):
        leaves = tree_leaves(w)
        record = torch.is_grad_enabled() and (
            micro.requires_grad or any(x.requires_grad for x in leaves))
        return _Pipeline.apply(stage_fn, mesh, axis, w, record, micro, *leaves)

    return pipelined

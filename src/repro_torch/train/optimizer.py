"""AdamW + cosine schedule + global-norm clipping (the port's
``repro/train/optimizer.py``).

Parameters, gradients and the moments are plain trees (nested dicts and
tuples of tensors, ``None`` leaves kept), as the model's parameters are.
m and v are f32; the update is computed in f32 and each new parameter is
cast back to its own dtype; weight decay applies to matrices only (two
dimensions or more, so a stacked norm scale counts as one, as in JAX).
The update builds new tensors and leaves the state it is given untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

# Elements of a leaf AdamW updates at once (its f32 temporaries: 256 MB each).
UPDATE_SLICE = 1 << 26

Tree = Any


def tree_map_with_path(fn: Callable, tree: Tree, *rest: Tree, path: tuple = ()) -> Tree:
    """``fn(path, leaf, *leaves of rest)`` over the tensor leaves of ``tree``
    (nested NamedTuples, dicts, tuples and lists; the ``rest`` trees share
    its shape), keeping its shape; ``None`` leaves stay None.  A leaf's
    ``path`` is the tuple of its keys from the root: NamedTuple field
    names, dict keys and sequence indices, as JAX's
    ``tree_flatten_with_path`` names them.  Every walk of the port's trees
    goes through here, so they all share one leaf order: fields and
    sequences in order, dict keys as stored.  A class with a true
    ``tree_leaf`` attribute is a leaf whatever it subclasses."""
    if tree is None:
        return None
    if getattr(type(tree), "tree_leaf", False):  # a leaf that is a tuple (a spec)
        return fn(path, tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (name,))
                            for i, (name, v) in enumerate(zip(tree._fields, tree))))
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of ``tree`` (and the same leaves of the
    ``rest`` trees, which share its shape); ``None`` leaves stay None."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves_with_path(tree: Tree) -> list:
    """(path, leaf) of every tensor leaf of ``tree``, in
    ``tree_map_with_path``'s order (``None`` leaves skipped)."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_leaves(tree: Tree) -> list:
    """The tensor leaves of ``tree`` in ``tree_map_with_path``'s order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(tree: Tree, leaves) -> Tree:
    """A tree of ``tree``'s shape with its tensor leaves replaced, in
    ``tree_leaves`` order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class TrainState(NamedTuple):
    step: torch.Tensor  # () int32
    params: Tree
    m: Tree  # f32 first moment
    v: Tree  # f32 second moment
    residual: Tree = None  # f32 error-feedback residual (gradient compression)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_state(params: Tree, with_residual: bool = False) -> TrainState:
    """Step 0 with f32 zero moments (and residual) shaped like ``params``:
    on a mesh, this rank's shards, so the moments are sharded as the
    weights are (ZeRO / FSDP)."""
    device = tree_leaves(params)[0].device
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params,
        m=tree_map(_zeros32, params),
        v=tree_map(_zeros32, params),
        residual=tree_map(_zeros32, params) if with_residual else None,
    )


def lr_at(opt: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``min_lr`` at
    ``total_steps``; f32, as JAX computes it."""
    step = step.float()
    warm = opt.peak_lr * step / max(opt.warmup_steps, 1)
    frac = torch.clamp((step - opt.warmup_steps) / max(opt.total_steps - opt.warmup_steps, 1),
                       0.0, 1.0)
    cos = opt.min_lr + 0.5 * (opt.peak_lr - opt.min_lr) * (1 + torch.cos(math.pi * frac))
    return torch.where(step < opt.warmup_steps, warm, cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def adamw_update(state: TrainState, grads: Tree, opt: OptimizerConfig,
                 grad_norm: Optional[torch.Tensor] = None, donate: bool = False) -> tuple:
    """One AdamW step: clip by the global norm, bias-correct, decoupled
    weight decay on matrices.  Returns (new state, {"grad_norm", "lr"});
    the residual is carried unchanged.  ``grad_norm`` is the global norm
    when the caller computes it (a mesh's shards: ``train_step``), else
    ``global_norm(grads)``.  ``donate``: the given state's parameters and
    moments are updated in place and returned (JAX's launcher donates the
    state to its step), so no second copy of them is made; the values are
    the same to the bit."""
    if opt.clip_norm > 0:
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        gnorm = torch.zeros((), device=state.step.device)
        scale = torch.ones((), device=state.step.device)
    step = state.step + 1
    lr = lr_at(opt, step)
    b1, b2 = opt.b1, opt.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def part(p, g, m, v, matrix: bool):  # one slice of a leaf
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g.square()
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + opt.eps)
        if matrix:  # decoupled weight decay on matrices only
            delta = delta + opt.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    def upd(p, g, m, v):
        # elementwise, so a leaf is updated a slice at a time: its f32
        # temporaries stay a slice's, not the leaf's (a 200k-row embedding's
        # ~15 GB); the values are the same to the bit
        out = (p, m, v) if donate else tuple(
            torch.empty_like(x, memory_format=torch.contiguous_format) for x in (p, m, v))
        flat = [x.reshape(-1) for x in (p, g, m, v)]
        dest = [x.view(-1) for x in out]  # a donated leaf is updated in its own storage
        for i in range(0, p.numel(), UPDATE_SLICE):
            for d, x in zip(dest, part(*(f[i:i + UPDATE_SLICE] for f in flat), p.dim() >= 2)):
                d[i:i + UPDATE_SLICE].copy_(x)
        return out

    out = [upd(*leaf) for leaf in zip(tree_leaves(state.params), tree_leaves(grads),
                                       tree_leaves(state.m), tree_leaves(state.v))]
    new_state = TrainState(
        step,
        tree_unflatten(state.params, [o[0] for o in out]),
        tree_unflatten(state.params, [o[1] for o in out]),
        tree_unflatten(state.params, [o[2] for o in out]),
        state.residual,
    )
    return new_state, {"grad_norm": gnorm, "lr": lr}

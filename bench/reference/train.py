"""The reference's training steps: the loss and its gradients a sequence at a
time (so it fits beside nothing), then AdamW, for the job's first steps."""
from __future__ import annotations

import torch

from bench.reference import adamw
from bench.reference.fp8 import strict_f32


def _slice_norms(leaves: dict) -> dict:
    out = {}
    for path, x in leaves.items():
        if path[0] == "blocks":
            n = torch.linalg.vector_norm(x.float().reshape(x.shape[0], -1), dim=1)
            for i, v in enumerate(n.tolist()):
                out[(path, i)] = v
        else:
            out[(path, None)] = float(torch.linalg.vector_norm(x.float()))
    return out


def follow(model_cls, sizes: dict, leaves: dict, batches: list, opt: dict,
           prec: str = "f32", rows=None) -> dict:
    """Run ``len(batches)`` steps from ``leaves`` (``{path: tensor}`` in the
    dtypes the job stores, consumed: updated in place).  ``rows`` (a slice)
    keeps only those rows of each batch, the mean taken over them.  Returns
    each step's loss, the first step's clipped gradient norms a layer at a
    time, and the change of the parameters over the steps, a layer at a
    time."""
    strict_f32()
    start = {p: x.clone() for p, x in leaves.items()}
    m = {p: torch.zeros(x.shape, dtype=torch.float32, device=x.device) for p, x in leaves.items()}
    v = {p: torch.zeros_like(t) for p, t in m.items()}
    losses, grad = [], None
    for t, batch in enumerate(batches, start=1):
        tokens, targets = batch["tokens"], batch["targets"]
        if rows is not None:
            tokens, targets = tokens[rows], targets[rows]
        p32 = {p: x.detach().to(torch.float32, copy=True).requires_grad_(True)
               for p, x in leaves.items()}
        model = model_cls(sizes, p32, prec)
        n = tokens.numel()
        total = 0.0
        for b in range(0, tokens.shape[0], model_cls.rows_per_block):
            blk = slice(b, b + model_cls.rows_per_block)
            loss = model.loss_sum(tokens[blk], targets[blk])
            (loss / n).backward()
            total += float(loss.detach())
        grads = {p: (x.grad if x.grad is not None else torch.zeros_like(x)) for p, x in p32.items()}
        del model, p32
        losses.append(total / n)
        scale, _ = adamw.step(leaves, grads, m, v, t, opt)
        if t == 1:
            grad = {k: val * scale for k, val in _slice_norms(grads).items()}
        del grads
    change = {}
    for p in leaves:
        change.update(_slice_norms({p: leaves[p].float() - start[p].float()}))
    return {"losses": losses, "grad": grad, "change": change}

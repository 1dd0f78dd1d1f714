"""What the two references share: reading the weights by their paths, the
norms, and the loss over the vocabulary in chunks."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference.fp8 import mm


class Weights:
    """The weights as the harness drew them, ``{path: tensor}`` with the
    port's paths (``("blocks", "stack", 0, "attn", "wo")``: a stacked leaf,
    one row a layer), read a layer at a time.  A leaf the reference does not
    know raises, so a change of layout shows instead of being skipped."""

    def __init__(self, leaves: dict, n_layers: int, known: set):
        self.leaves = leaves
        self.n_layers = n_layers
        for path in leaves:
            if path[:2] == ("blocks", "tail") or (path[:2] == ("blocks", "stack") and path[2] != 0):
                raise ValueError(f"layer pattern with a tail or several kinds: {path}")
            key = path[3:] if path[0] == "blocks" else path
            if key not in known:
                raise ValueError(f"the reference has no rule for the weight {path}")

    def layer(self, i: int) -> dict:
        """{key path under the layer: tensor} of layer ``i``."""
        return {p[3:]: t[i] for p, t in self.leaves.items() if p[0] == "blocks"}

    def top(self, *key):
        return self.leaves[key]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the scale as an offset from one (the port's form)."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def layernorm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _xent_sum(x, w, targets, prec):
    logits = mm(x, w, prec)
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - logits.gather(-1, targets[:, None].long())[:, 0]).sum()


def xent_sum(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, prec: str,
             chunk: int = 512) -> torch.Tensor:
    """Summed cross-entropy of hidden rows ``x`` (S, d) against ``targets``
    over the head ``w`` (d, V), a chunk of rows at a time, each chunk's
    logits recomputed in the backward."""
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(0, x.shape[0], chunk):
        args = (x[i:i + chunk], w, targets[i:i + chunk], prec)
        if torch.is_grad_enabled() and x.requires_grad:
            total = total + checkpoint(_xent_sum, *args, use_reentrant=False)
        else:
            total = total + _xent_sum(*args)
    return total


def run_layers(x: torch.Tensor, n_layers: int, layer_fn, remat: bool) -> torch.Tensor:
    """``layer_fn(x, i)`` for each layer; with ``remat`` each layer's inside
    is recomputed in the backward (only its input is kept)."""
    for i in range(n_layers):
        if remat:
            x = checkpoint(layer_fn, x, i, use_reentrant=False)
        else:
            x = layer_fn(x, i)
    return x

"""Weights drawn by the benchmark from the seed.

The port's own ``init_params`` is the program's; the benchmark makes the
weights itself and hands the same tensors to the program and, drawn again
after the window, to the plain reference.  The tree's layout (leaf names,
shapes, dtypes) is read off the port's parameters on the meta device, which
holds no values.  Values come from one ``torch.Generator`` on the device, in
one draw a dtype (every leaf of that dtype is a view of one flat buffer),
then a per-leaf affine map or squashing by the leaf's name:

* matrices N(0, 0.02), attention's output projection ``wo`` too (not scaled
  down by depth, so attention moves the logits as much as the MLP and the
  check sees it); RWKV-6's time-mix output ``w_o`` 0.02 / sqrt(layers), as
  the configuration's own initialisation draws it (at 0.02 the bf16 and
  float32 gradients of the deep layers part by orders of magnitude at init);
* RMSNorm scales (the port's ``1 + scale`` form) and the qk-norms N(0, 0.1);
  LayerNorm and group-norm scales 1 + N(0, 0.1), their biases N(0, 0.02);
* RWKV-6: token-shift mixes in (0, 1), the decay base ``w0`` in (-6, 0)
  (decays from e^-1 to 0.9975 a token), the bonus ``u`` N(0, 0.3); the
  time-mix key and value ``w_k``, ``w_v`` N(0, 0.2).  The per-head group
  norm after WKV is blind to the scale of its input but for its eps, and at
  a sequence's first token, where the state is empty, WKV's output is a
  multiple c v of the value: where c nearly cancels, that head's output
  sits in the eps regime and its gradient (to ``u``, ``w_k``, ``w_r`` and
  the mixes) swings with the last bit of c.  Keys and values ten times the
  other matrices lift c v a hundredfold clear of the eps, and change nothing
  else the norm sees.

Norm scales are drawn away from their identity so the check sees them."""
from __future__ import annotations

import hashlib
import math

import torch


def generator(seed: int, salt: str, device) -> torch.Generator:
    """A generator on ``device`` seeded by (``seed``, ``salt``): any whole
    ``seed`` (the driver's exceed 32 bits) maps to a 63-bit key."""
    key = hashlib.sha256(f"{int(seed)}:{salt}".encode()).digest()
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int.from_bytes(key[:8], "little") & ((1 << 63) - 1))
    return g


def _rule(path: tuple, shape: tuple, norm: str) -> tuple:
    """(kind, a, b) of a leaf: ``normal`` a + b z, ``uniform`` a + (b - a) Phi(z)."""
    name = str(path[-1])
    if name == "w_o":  # a stacked leaf: one row a layer
        return "normal", 0.0, 0.02 / math.sqrt(shape[0] if path[:2] == ("blocks", "stack") else 1)
    if name in ("q_norm", "k_norm") or (name == "scale" and norm == "rmsnorm"):
        return "normal", 0.0, 0.1
    if name in ("scale", "gn_scale"):
        return "normal", 1.0, 0.1
    if name in ("bias", "gn_bias"):
        return "normal", 0.0, 0.02
    if name.startswith("mix_"):
        return "uniform", 0.0, 1.0
    if name == "w0":
        return "uniform", -6.0, 0.0
    if name == "u":
        return "normal", 0.0, 0.3
    if name in ("w_k", "w_v") and path[-2] == "attn":  # RWKV-6's time-mix
        return "normal", 0.0, 0.2
    return "normal", 0.0, 0.02


def leaves_with_path(tree, path=()):
    """(path, leaf) of every tensor leaf, dict keys and sequence indices in
    order (the port's tree is nested dicts and tuples)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_path(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def rebuild(tree, leaves: dict, path=()):
    """``tree``'s shape with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, leaves, path + (i,)) for i, v in enumerate(tree))
    return leaves[path]


def draw(layout, seed: int, norm: str, device) -> dict:
    """{path: tensor} for every leaf of ``layout`` (a tree of meta tensors
    or of anything with ``shape`` and ``dtype``), drawn on ``device``."""
    items = leaves_with_path(layout)
    out = {}
    by_dtype: dict = {}
    for path, leaf in items:
        by_dtype.setdefault(leaf.dtype, []).append((path, tuple(leaf.shape)))
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        total = sum(math.prod(s) for _, s in group)
        g = generator(seed, f"weights:{dtype}", device)
        flat = torch.randn(total, generator=g, dtype=dtype, device=device)
        off = 0
        for path, shape in group:
            n = math.prod(shape)
            x = flat[off:off + n].view(shape)
            off += n
            kind, a, b = _rule(path, shape, norm)
            if kind == "normal":
                x.mul_(b)
                if a:
                    x.add_(a)
            else:
                z = x.float()
                x.copy_(a + (b - a) * 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0))))
            out[path] = x
    return out

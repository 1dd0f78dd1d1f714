"""Weight bridge: a parameter tree from ``repro.models.params.init_params``
(leaves as numpy arrays, or anything ``np.asarray`` accepts) -> the port's
tree of torch tensors, same shape: dicts stay dicts, tuples stay tuples,
``None`` stays ``None``.

This module imports no JAX: the caller hands over host arrays, so the tests
can run both packages on the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: carry the bits as
        # int16 and re-tag them.  np.array copies, since arrays handed back
        # by JAX are read-only.
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def from_jax(tree: Any, device="cuda") -> Any:
    """Convert every array leaf of ``tree`` to a torch tensor on ``device``
    (the card by default; raises without one unless ``device="cpu"``)."""
    return _convert(tree, resolve_device(device))


def _convert(tree: Any, device: torch.device) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(v, device) for v in tree)
    return _leaf(tree, device)

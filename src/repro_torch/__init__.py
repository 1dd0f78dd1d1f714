"""CAT reproduction on PyTorch and CUDA for one NVIDIA H100.

This package is the port of the JAX package ``repro``, which stays the
reference.  Module names mirror ``repro``'s so each part has an obvious
counterpart; the port imports ``torch`` and numpy, never ``jax`` and never
``repro``.  Its entry points run on the card unless the caller asks for the
CPU (``device="cpu"``, as the tests do); without a card they raise instead
of falling back.  ``device="meta"`` builds shapes without storage: the
dry run (``launch/dryrun.py``) traces its steps so.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``"cuda"`` (the default),
    ``"cpu"`` or ``"meta"`` (shapes only, the dry run's).  Raises when CUDA
    is asked for and absent."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda', 'cpu' or 'meta'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev

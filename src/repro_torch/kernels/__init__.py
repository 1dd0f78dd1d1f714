"""Hand-written Hopper kernels of the port, one package per TPU kernel
(``kernel.py`` builds and binds the CUDA source under ``csrc/``, ``ops.py``
is the wrapper the model calls, ``ref.py`` the plain PyTorch version)."""

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: grad enabled and
    one of them requires it.  On the card a wrapper then goes through its
    ``torch.autograd.Function`` (a backward kernel) or raises; it never
    returns a tensor without a ``grad_fn``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, item: str, *tensors) -> None:
    """Raise when autograd would need a backward of kernel ``name``, which
    has none yet (``item``: where ROADMAP lists it)."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: no backward kernel yet ({item}); run it under torch.no_grad(), "
            "or train on the plain path (fused=False)")

"""Wrapper of the WKV kernels in the model's layout (the port's
``repro/kernels/rwkv6/ops.py``, with the model path's contract of
``repro/models/rwkv6.py::wkv_chunked``: optional initial state, optional
final state, f32 output).

r/k/v/w stay (B, S, H, D); the kernels index that layout directly, so no
transpose is paid.  The dtype of r/k/v alone picks the kernel
(``ENTRIES``): bf16 (the model's prefill) runs on tensor cores
(``wkv_forward_mma``: TF32 hi + lo operands), f32 on CUDA cores
(``wkv_forward``: the tensor cores would round its inputs).  CPU tensors
go to the plain version (``repro_torch.models.rwkv6.wkv_chunked``); CUDA
tensors launch the kernel their dtype selects or raise: there is no
fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.rwkv6 import kernel

# Kernel launches so far; a run resets it to show which path it took.
LAUNCHES = 0

# The C entry point (csrc/wkv.cu) each r/k/v dtype launches, and the dtype
# code both entries take.
ENTRIES = {torch.float32: "wkv_forward", torch.bfloat16: "wkv_forward_mma"}
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (16, 32, 64)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wkv: {msg}")


def wkv(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    chunk: int = 32,
    state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """r/k/v: (B, S, H, D); w: (B, S, H, D) f32 decay in (0, 1); u: (H, D)
    f32 bonus; ``state`` (B, H, D, D) f32 before the first token (zero when
    None).  Returns the (B, S, H, D) f32 output and, with ``return_state``,
    the (B, H, D, D) f32 state after the last token.

    ``chunk`` is the tokens per step of the recurrence, in the kernels and
    in the plain version: it changes the schedule, not the function
    (outputs agree to rounding across chunks)."""
    if r.device.type == "cpu":
        # the plain version lives with the model (it imports this module)
        from repro_torch.models.rwkv6 import wkv_chunked

        return wkv_chunked(r, k, v, w, u, chunk=chunk, state=state, return_state=return_state)
    _require(r.is_cuda, f"r must be a CUDA or CPU tensor, got {r.device}")
    refuse_grad("wkv", "the WKV backward, ROADMAP queue 1, item 5", r, k, v, w, u, state)
    res = launch(kernel.library(), r, k, v, w, u, chunk=chunk, state=state,
                 return_state=return_state, stream=torch.cuda.current_stream(r.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    return res


def launch(lib, r, k, v, w, u, *, chunk: int, state, return_state: bool, stream):
    """Check the operands, allocate the outputs and call ``lib``'s entry
    point for r's dtype (``ENTRIES``) on ``stream``; raises on what the
    kernels do not take or a failed launch."""
    _require(r.dim() == 4, f"r must be (B, S, H, D), got {tuple(r.shape)}")
    B, S, H, D = r.shape
    _require(r.dtype in ENTRIES and k.dtype == r.dtype and v.dtype == r.dtype,
             f"r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype} (one of f32, bf16)")
    _require(k.shape == r.shape and v.shape == r.shape and w.shape == r.shape,
             "r, k, v and w must share one (B, S, H, D) shape")
    _require(w.dtype == torch.float32 and u.dtype == torch.float32, "w and u must be f32")
    _require(u.shape == (H, D), f"u must be (H, D) = {(H, D)}, got {tuple(u.shape)}")
    _require(D in (32, 64), f"head dim {D} (32 or 64)")
    _require(chunk in CHUNKS, f"chunk {chunk} (one of {CHUNKS})")
    _require(state is None or (state.shape == (B, H, D, D) and state.dtype == torch.float32),
             "state must be (B, H, D, D) f32")
    tensors = [r, k, v, w, u] + ([state] if state is not None else [])
    _require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _require(all(t.device == r.device for t in tensors), "all tensors on one device")
    _require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, w)),
             "r/k/v/w must be 16-byte aligned (the kernels copy 16-byte vectors)")
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device) if return_state else None
    entry = ENTRIES[r.dtype]
    rc = getattr(lib, entry)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr() if state is not None else None, out.data_ptr(),
        s_out.data_ptr() if s_out is not None else None,
        B, S, H, D, chunk, _IN_CODES[r.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"wkv kernel launch failed ({entry}, code {rc})")
    return (out, s_out) if return_state else out

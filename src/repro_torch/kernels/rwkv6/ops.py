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

Training: when autograd would record the call (grad enabled, an input
requiring grad), it goes through ``WKV``, a ``torch.autograd.Function``.
On the card its forward launches the forward kernel and saves its inputs
(nothing per chunk); its backward launches the entry of
``csrc/wkv_bwd.cu`` that r's dtype picks (``BWD_ENTRIES``: bf16 on the
tensor cores, ``wkv_backward_mma``; f32 on the CUDA cores,
``wkv_backward``), which recomputes the chunk-start states and returns
dr, dk, dv, d(log w), du and d(state).  On
the CPU the same Function runs the plain versions (``wkv_chunked``, then
``ref.wkv_backward_ref``).  d(w) follows from d(log w) as JAX's
``log(maximum(w, 1e-12))`` gives it (``dw_from_dlogw``).

On the ``meta`` device (the dry run's trace) the forward and backward
entries check their operands as a launch does, return empty outputs of the
right shapes and record one call with ``cost()`` / ``backward_cost()``: no
computation, no launch counted.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.op_cost import record_kernel
from repro_torch.kernels import needs_grad
from repro_torch.kernels.rwkv6 import kernel
from repro_torch.kernels.rwkv6.ref import BWD_MMA_CHUNK, wkv_backward_ref

# Kernel launches so far (forward; backward); a run resets them to show
# which path it took.
LAUNCHES = 0
BWD_LAUNCHES = 0

# The C entry point (csrc/wkv.cu) each r/k/v dtype launches, and the dtype
# code both entries take.
ENTRIES = {torch.float32: "wkv_forward", torch.bfloat16: "wkv_forward_mma"}
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (16, 32, 64)
# The backward's entry (csrc/wkv_bwd.cu) for each r/k/v dtype.
BWD_ENTRIES = {torch.float32: "wkv_backward", torch.bfloat16: "wkv_backward_mma"}


def scratch_chunk(entry: str, chunk: int) -> int:
    """The chunk whose start states the backward ``entry`` keeps in its
    scratch: ``wkv_backward_mma`` runs a 64-token chunk as two of 32
    (``ref.BWD_MMA_CHUNK``)."""
    return min(chunk, BWD_MMA_CHUNK) if entry == "wkv_backward_mma" else chunk


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
    (outputs agree to rounding across chunks).  Differentiable on every
    device, through ``WKV``."""
    if r.device.type != "cpu":
        _require(r.is_cuda or r.is_meta, f"r must be a CUDA, CPU or meta tensor, got {r.device}")
    if needs_grad(r, k, v, w, u, state):
        return WKV.apply(r, k, v, w, u, state, chunk, return_state)
    return _forward(r, k, v, w, u, chunk=chunk, state=state, return_state=return_state)


def _forward(r, k, v, w, u, *, chunk: int, state, return_state: bool):
    """The plain version for CPU tensors, else one forward launch."""
    if r.device.type == "cpu":
        # the plain version lives with the model (it imports this module)
        from repro_torch.models.rwkv6 import wkv_chunked

        return wkv_chunked(r, k, v, w, u, chunk=chunk, state=state, return_state=return_state)
    if r.is_meta:
        B, S, H, D = _check(r, k, v, w, u, chunk, state)
        record_kernel("wkv", *cost(r))
        out = torch.empty((B, S, H, D), dtype=torch.float32, device=r.device)
        s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
        return (out, s_out) if return_state else out
    res = launch(kernel.library(), r, k, v, w, u, chunk=chunk, state=state,
                 return_state=return_state, stream=torch.cuda.current_stream(r.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    return res


def dw_from_dlogw(dlogw: torch.Tensor, w: torch.Tensor, *, clamp: bool = True) -> torch.Tensor:
    """d(w) from the gradient of log(max(w, 1e-12)): d(log w) / w where w
    > 1e-12, else 0 (there the clamp, not w, set the decay).  ``clamp=False``
    divides everywhere: a planted control."""
    dw = dlogw / w
    return torch.where(w > 1e-12, dw, torch.zeros_like(dw)) if clamp else dw


class WKV(torch.autograd.Function):
    """The WKV recurrence as one differentiable op: the forward kernel (or
    ``wkv_chunked`` on the CPU), then the backward kernel (or
    ``wkv_backward_ref``).  Saves r, k, v, w, u and the state passed in;
    the backward recomputes what it needs per chunk."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk: int, return_state: bool):
        ctx.set_materialize_grads(False)
        out, s_out = _forward(r, k, v, w, u, chunk=chunk, state=state, return_state=True)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.chunk = chunk
        return (out, s_out) if return_state else out

    @staticmethod
    def backward(ctx, dout, dstate=None):
        r, k, v, w, u, state = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        if r.device.type == "cpu":
            dr, dk, dv, dlogw, du, dstate_in = wkv_backward_ref(
                r, k, v, w, u, dout, chunk=ctx.chunk, state=state, dstate=dstate)
        else:
            dr, dk, dv, dlogw, du, dstate_in = backward(r, k, v, w, u, dout, chunk=ctx.chunk,
                                                        state=state, dstate=dstate)
        return dr, dk, dv, dw_from_dlogw(dlogw, w), du, dstate_in, None, None


def backward(r, k, v, w, u, dout, *, chunk: int, state=None, dstate=None):
    """One backward launch on the card: (dr, dk, dv, d(log w), du,
    d(state) or None)."""
    if r.is_meta:
        B, S, H, D = _check(r, k, v, w, u, chunk, state)
        record_kernel("wkv_bwd", *backward_cost(r))
        grads = [torch.empty(r.shape, dtype=r.dtype, device=r.device) for _ in range(3)]
        grads += [torch.empty(r.shape, dtype=torch.float32, device=r.device),
                  torch.empty((H, D), dtype=torch.float32, device=r.device),
                  None if state is None else torch.empty_like(state)]
        return tuple(grads)
    res = launch_backward(kernel.backward_library(), r, k, v, w, u, dout, chunk=chunk,
                          state=state, dstate=dstate,
                          stream=torch.cuda.current_stream(r.device).cuda_stream)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return res


def cost(r) -> tuple:
    """(flops, bytes) of one forward call, as ``PERF.md``'s bound counts
    them: ~6 D^2 flops a token and head; r/k/v in their type, w and the
    output in f32, u and the final state each once."""
    B, S, H, D = r.shape
    n = B * S * H * D
    return 6 * D * n, 3 * n * r.element_size() + 8 * n + 4 * H * D + 4 * B * H * D * D


def backward_cost(r) -> tuple:
    """(flops, bytes) of one backward call: the four D x D products a token
    and head (8 D^2 flops); r/k/v read and dr/dk/dv written in r's type, w
    and dO read and d(log w) written in f32, u and du once."""
    B, S, H, D = r.shape
    n = B * S * H * D
    return 8 * D * n, 6 * n * r.element_size() + 12 * n + 8 * H * D


def _check(r, k, v, w, u, chunk: int, state) -> tuple:
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
    return B, S, H, D


def launch(lib, r, k, v, w, u, *, chunk: int, state, return_state: bool, stream):
    """Check the operands, allocate the outputs and call ``lib``'s entry
    point for r's dtype (``ENTRIES``) on ``stream``; raises on what the
    kernels do not take or a failed launch."""
    B, S, H, D = _check(r, k, v, w, u, chunk, state)
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


def launch_backward(lib, r, k, v, w, u, dout, *, chunk: int, state, dstate, stream,
                    entry: Optional[str] = None):
    """Check the operands, allocate dr, dk, dv (r's dtype), d(log w) (f32,
    the shape of w), du (H, D) f32, d(state) when ``state`` is given, and
    the scratch (each chunk's start state, f32 (B, H, N, D, D) with N chunks
    of ``scratch_chunk`` tokens, and du's (B, H, D) partial sums), then
    call ``lib``'s ``entry`` (by default the one for r's dtype,
    ``BWD_ENTRIES``; ``wkv_backward`` takes bf16 too) on ``stream``.
    ``dout`` (f32, the forward output's shape) and ``dstate`` (f32 (B, H,
    D, D) or None) are made contiguous (and ``dout`` 16-byte aligned).
    Raises on what the kernel does not take or a failed launch."""
    B, S, H, D = _check(r, k, v, w, u, chunk, state)
    dout = dout.float().contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    _require(dout.shape == r.shape and dout.device == r.device, "dout must be r's shape")
    if dstate is not None:
        dstate = dstate.float().contiguous()
        _require(dstate.shape == (B, H, D, D) and dstate.device == r.device,
                 "d(state out) must be (B, H, D, D)")
    entry = entry or BWD_ENTRIES[r.dtype]
    N = -(-S // scratch_chunk(entry, chunk))
    dr, dk, dv = (torch.empty(r.shape, dtype=r.dtype, device=r.device) for _ in range(3))
    dlogw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.empty((H, D), dtype=torch.float32, device=r.device)
    dstate_in = (torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
                 if state is not None else None)
    states = torch.empty((B, H, N, D, D), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, D), dtype=torch.float32, device=r.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = getattr(lib, entry)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), ptr(state),
        dout.data_ptr(), ptr(dstate), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dlogw.data_ptr(), du.data_ptr(), ptr(dstate_in), states.data_ptr(), du_part.data_ptr(),
        B, S, H, D, chunk, _IN_CODES[r.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"wkv backward kernel launch failed ({entry}, code {rc})")
    return dr, dk, dv, dlogw, du, dstate_in

"""Wrapper of the RMSNorm kernel in the model's layout (the port's
``repro/kernels/rmsnorm/ops.py``).

x keeps its (..., d) shape.  The kernel indexes rows as (outer, inner) with
an element stride each, so any view whose leading dimensions fold into two
strided ones is read in place: the qk-norm input, a (B, S, H, D) view of the
fused QKV projection, needs no copy.  A view that does not fold is copied
first.  The output is a new dense tensor in x's dtype.  ``launch_plan``
gives the kernel its schedule (lanes a row, vectors a lane, CTAs).  CPU
tensors go to the plain version (``ref.rmsnorm_ref``, which autograd
differentiates); CUDA tensors launch the kernel or raise: there is no
fallback.

Training: when autograd would record the call, a CUDA call goes through
``RMSNorm``, a ``torch.autograd.Function`` whose backward launches
``rmsnorm_backward`` (``csrc/rmsnorm_bwd.cu``): one pass over the rows,
which reads x (in the same strided layouts the forward takes) and dy once
and writes dx (and d(residual), the same tensor) contiguous in x's dtype,
on ``backward_launch_plan``'s schedule; d(scale) in f32 from per-lane
column sums, one partial row a CTA summed in a fixed order (no atomics:
every rerun gives the same bits).

On the ``meta`` device (the dry run's trace) the forward and backward
entries return empty outputs of the right shapes and record one call with
``cost()`` / ``backward_cost()``: no computation, no launch counted.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.op_cost import record_kernel
from repro_torch.kernels import needs_grad
from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

# Kernel launches so far (forward; backward); a run resets them to show
# which path it took.
LAUNCHES = 0
BWD_LAUNCHES = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}
WARPS = 8  # warps a CTA (csrc/rmsnorm.cu kWarps)
N_SMS = 132  # H100 SXM
MAX_NV = 16  # 16-byte vectors a lane holds of a row in registers
IN_FLIGHT = 4  # 16-byte vectors a lane holds of its rows at once, at least
SMEM_SCALE_MAX = 200 * 1024  # bytes of 1 + scale a CTA may stage (full-warp rows)


def resident_ctas(nv: int, rows: int) -> int:
    """CTAs an SM holds, as the kernel's ``__launch_bounds__`` promise
    them: 1 when a lane holds 16 vectors or more, else 2."""
    return 1 if nv * rows >= 16 else 2


def launch_plan(rows: int, d: int, elem_size: int, vec: bool) -> tuple:
    """``(group, nv, rows_a_group, grid)`` of the kernel for ``rows`` rows
    of ``d`` elements of ``elem_size`` bytes.  16-byte rows (``vec``):
    ``group`` lanes take a row (8 or 16 when the row is at most that many
    16-byte vectors, else 32), each holding ``nv`` vectors of it in
    registers (1 below 32 lanes; a power of two up to ``MAX_NV``, the rest
    re-read) and ``rows_a_group`` rows at once (``IN_FLIGHT / nv``, at least
    1), over ``grid`` CTAs of ``WARPS`` warps: for sub-warp rows one wave of
    resident CTAs at most, which stride over the rows; for full-warp rows
    one pass, a CTA for every ``WARPS x rows_a_group`` rows (on the H100
    that was 5% faster than a resident wave at d 2048 and 15% slower at
    d_head 128: ``scripts/kernel_variants.py``).  Other rows: a warp a row,
    ``grid`` CTAs covering every row once, ``nv`` and ``rows_a_group`` 0."""
    if not vec:
        return 32, 0, 0, -(-rows // WARPS)
    nvec = d * elem_size // 16
    group = 8 if nvec <= 8 else 16 if nvec <= 16 else 32
    nv = 1
    while group == 32 and nv < MAX_NV and nv * 32 < nvec:
        nv *= 2
    r = max(1, IN_FLIGHT // nv)
    grid = -(-rows // (WARPS * (32 // group) * r))
    if group < 32:
        grid = min(grid, N_SMS * resident_ctas(nv, r))
    return group, nv, r, grid


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm: {msg}")


def row_layout(x: torch.Tensor) -> Optional[tuple]:
    """``(outer, inner, outer stride, inner stride)`` in elements such that
    row ``o * inner + i`` of ``x`` (all dimensions but the last, in order)
    starts at ``o * outer stride + i * inner stride``; None when the leading
    dimensions do not fold into two strided ones or the last is not dense."""
    if x.dim() == 0 or (x.shape[-1] > 1 and x.stride(-1) != 1):
        return None
    dims = []  # (size, stride), outermost first, adjacent dense runs merged
    for n, s in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == n * s:
            dims[-1] = (dims[-1][0] * n, s)
        else:
            dims.append((n, s))
    if not dims:
        return 1, 1, 0, 0
    if len(dims) == 1:
        return dims[0][0], 1, dims[0][1], dims[0][1]
    if len(dims) == 2:
        (no, so), (ni, si) = dims
        return no, ni, so, si
    return None


def rmsnorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """x: (..., d) f32 or bf16; scale: (d,) f32; residual: x's shape and
    dtype, or None.  Returns RMSNorm(x [+ residual]) * (1 + scale) in x's
    dtype, computed in f32.  Differentiable on every device: the plain
    version by autograd, the kernel through ``RMSNorm``."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, residual, eps)
    _require(x.is_cuda or x.is_meta, f"x must be a CUDA, CPU or meta tensor, got {x.device}")
    if needs_grad(x, scale, residual):
        return RMSNorm.apply(x, scale, residual, eps)
    return _forward(x, scale, residual, eps)


class RMSNorm(torch.autograd.Function):
    """The forward kernel, then the backward kernel.  x may be a strided
    view (qk-norm's q and k of the fused projection); its gradient comes
    back contiguous and autograd's view backward places it."""

    @staticmethod
    def forward(ctx, x, scale, residual, eps: float):
        ctx.save_for_backward(x, scale, residual)
        ctx.eps = eps
        return _forward(x, scale, residual, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, residual = ctx.saved_tensors
        dx, dscale = backward(x, scale, dy, residual, eps=ctx.eps)
        return dx, dscale, None if residual is None else dx, None


def cost(x, residual=None) -> tuple:
    """(flops, bytes) of one forward call, as ``PERF.md``'s bound counts
    them: x (and a residual) read and y written once, and the scale; no
    matrix product."""
    return 0, (2 + (residual is not None)) * x.numel() * x.element_size() + 4 * x.shape[-1]


def backward_cost(x) -> tuple:
    """(flops, bytes) of one backward call: x and dy read and dx written
    once, the scale read and d(scale) written."""
    return 0, 3 * x.numel() * x.element_size() + 8 * x.shape[-1]


def _forward(x, scale, residual, eps: float) -> torch.Tensor:
    if x.is_meta:
        record_kernel("rmsnorm", *cost(x, residual))
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out = launch(kernel.library(), x, scale, residual, eps=eps,
                 stream=torch.cuda.current_stream(x.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    return out


def backward(x, scale, dy, residual=None, *, eps: float = 1e-6):
    """One backward launch on the card: (dx, d(scale))."""
    if x.is_meta:
        record_kernel("rmsnorm_bwd", *backward_cost(x))
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty(scale.shape, dtype=torch.float32, device=x.device))
    grads = launch_backward(kernel.backward_library(), x, scale, dy, residual, eps=eps,
                            stream=torch.cuda.current_stream(x.device).cuda_stream)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return grads


def launch(lib, x, scale, residual=None, *, eps: float, stream, plan=None) -> torch.Tensor:
    """Check the operands, allocate the output and call ``lib``'s
    ``rmsnorm_forward`` on ``stream`` with ``launch_plan``'s schedule (or
    ``plan``, a ``(group, nv, rows_a_group, grid)`` of one's own); raises on
    what the kernel does not take or a failed launch."""
    _require(x.dtype in _CODES, f"dtype {x.dtype} (f32 or bf16)")
    d = x.shape[-1] if x.dim() else 0
    _require(d > 0, f"x must be (..., d) with d > 0, got {tuple(x.shape)}")
    _require(scale.shape == (d,) and scale.dtype == torch.float32 and scale.is_contiguous(),
             f"scale must be a contiguous ({d},) f32 vector")
    _require(scale.device == x.device, "scale on x's device")
    if residual is not None:
        _require(residual.shape == x.shape and residual.dtype == x.dtype
                 and residual.device == x.device, "residual must match x's shape, dtype, device")
        residual = residual.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    layout = row_layout(x)
    if layout is None:
        x = x.contiguous()
        layout = row_layout(x)
    outer, inner, so, si = layout
    es = x.element_size()
    vec = (d * es) % 16 == 0 and d * 4 <= SMEM_SCALE_MAX and all(p % 16 == 0 for p in (
        x.data_ptr(), scale.data_ptr(), so * es, si * es,
        residual.data_ptr() if residual is not None else 0))
    group, nv, r, grid = plan or launch_plan(outer * inner, d, es, vec)
    rc = lib.rmsnorm_forward(
        x.data_ptr(), scale.data_ptr(), residual.data_ptr() if residual is not None else None,
        out.data_ptr(), outer, inner, d, so, si, float(eps), int(vec), _CODES[x.dtype],
        group, nv, r, grid, stream,
    )
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (code {rc})")
    return out


BWD_MAX_NV = 8  # 16-byte vectors a lane holds of a row in the backward (x and dy)
CTA_ROW = 32 * WARPS  # lanes of a group that is the whole CTA


def backward_resident_ctas(nv: int, rows: int) -> int:
    """CTAs an SM holds, as the backward kernel's ``__launch_bounds__``
    promise them: 1 when a lane holds 8 vectors of x (and 8 of dy) or more,
    else 2."""
    return 1 if nv * rows >= 8 else 2


def backward_launch_plan(rows: int, d: int, elem_size: int, vec: bool) -> tuple:
    """``(group, nv, rows_a_group, grid)`` of the backward kernel for
    ``rows`` rows of ``d`` elements of ``elem_size`` bytes.  16-byte rows
    (``vec``): ``group`` lanes take a row, the fewest of 8, 16, 32 and the
    whole CTA (``CTA_ROW``) for which ``nv``, the 16-byte vectors a lane
    holds of the row's x and dy, is at most 1 below 32 lanes and
    ``BWD_MAX_NV`` otherwise (a power of two); ``rows_a_group`` rows at once
    (``IN_FLIGHT / nv``, at least 1; 1 for CTA rows); ``grid`` one wave of
    resident CTAs at most, striding over the rows, so each lane's column
    sums of d(scale) cover many rows.  Other rows, and rows wider than
    ``CTA_ROW x BWD_MAX_NV`` vectors: a CTA a row (``group`` ``CTA_ROW``,
    ``nv`` 0), the same wave."""
    nvec = d * elem_size // 16
    if vec and nvec <= CTA_ROW * BWD_MAX_NV:
        group = next(g for g in (8, 16, 32, CTA_ROW)
                     if nvec <= g * (1 if g < 32 else BWD_MAX_NV))
        nv = 1
        while nv * group < nvec:
            nv *= 2
        r = 1 if group == CTA_ROW else max(1, IN_FLIGHT // nv)
    else:
        group, nv, r = CTA_ROW, 0, 1
    per_cta = CTA_ROW // group * r
    grid = min(-(-rows // per_cta), N_SMS * backward_resident_ctas(nv, r))
    return group, nv, r, grid


def launch_backward(lib, x, scale, dy, residual=None, *, eps: float, stream, plan=None):
    """Check the operands, allocate dx (x's shape, contiguous, x's dtype),
    d(scale) (f32) and the f32 scratch (a partial row of d(scale) a CTA),
    and call ``lib``'s ``rmsnorm_backward`` on ``stream`` with
    ``backward_launch_plan``'s schedule (or ``plan``, a ``(group, nv,
    rows_a_group, grid)`` of one's own); x is read in its strided layout
    (``row_layout``), dy and residual contiguous (dy arrives so from
    autograd).  Raises on what the kernel does not take or a failed
    launch."""
    _require(x.dtype in _CODES, f"dtype {x.dtype} (f32 or bf16)")
    d = x.shape[-1] if x.dim() else 0
    _require(d > 0, f"x must be (..., d) with d > 0, got {tuple(x.shape)}")
    _require(scale.shape == (d,) and scale.dtype == torch.float32, f"scale must be ({d},) f32")
    _require(dy.shape == x.shape and dy.dtype == x.dtype, "dy must match x")
    scale, dy = scale.contiguous(), dy.contiguous()
    if residual is not None:
        _require(residual.shape == x.shape and residual.dtype == x.dtype,
                 "residual must match x's shape and dtype")
        residual = residual.contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx, torch.zeros((d,), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)  # the kernel writes it all
    layout = row_layout(x)
    if layout is None:
        x = x.contiguous()
        layout = row_layout(x)
    outer, inner, so, si = layout
    rows = outer * inner
    es = x.element_size()
    vec = (d * es) % 16 == 0 and all(p % 16 == 0 for p in (
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), so * es, si * es,
        residual.data_ptr() if residual is not None else 0))
    group, nv, r, grid = plan or backward_launch_plan(rows, d, es, vec)
    vec = vec and nv > 0  # nv 0: the scalar route (rows too wide for the registers)
    partial = torch.empty((grid, d), dtype=torch.float32, device=x.device)
    rc = lib.rmsnorm_backward(
        x.data_ptr(), scale.data_ptr(), residual.data_ptr() if residual is not None else None,
        dy.data_ptr(), dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
        outer, inner, d, so, si, float(eps), int(vec), _CODES[x.dtype], group, nv, r, grid,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed (code {rc})")
    return dx, dscale

"""Public wrapper of the MM PU kernel (the port's
``repro/kernels/mm_pu/ops.py``).

The JAX wrapper picks a tile from the CAT solver (``core/pu.pick_pu``) and
pads the operands to its multiples.  On the H100 entry that solver has no
feasible tile (``core/pu.derive_pu_family`` raises: a 128-edge tile needs
196,608 bytes against a budget of 116,224), and the result never depends on
the tile.  So the port's ``mm_pu`` takes no ``spec``: its tile is the CUDA
kernels' own (128 x 128 outputs), and the kernels mask ragged M, N and K
themselves, so nothing is padded.  ``pad_overhead`` stays, to price a
TPU-style tile on a shape.  x's dtype alone picks the kernel (``ENTRIES``):
bf16 x runs on tensor cores (bf16 or int8 w, K split across CTAs on narrow
grids: ``launch_plan``), f32 x on CUDA cores (its 1e-5 tolerance rules out
TF32).  CPU tensors go to the plain version (``ref.mm_pu_ref``); CUDA
tensors launch the kernel their dtype selects or raise: there is no
fallback.  On the ``meta`` device (the dry run's trace) it returns an
empty (M, N) output and records one call with ``cost()``: no computation,
no launch counted.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.op_cost import record_kernel
from repro_torch.core.pu import MMTileSpec
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.mm_pu import kernel
from repro_torch.kernels.mm_pu.ref import mm_pu_ref

# Kernel launches so far; a run resets it to show which path it took.
LAUNCHES = 0

ACTIVATIONS = {"none": 0, "gelu": 1, "silu": 2, "relu": 3, "relu2": 4}
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# The C entry point (csrc/mm_pu.cu) each x dtype launches.
ENTRIES = {torch.float32: "mm_pu_forward", torch.bfloat16: "mm_pu_forward_mma"}
# K slices of the two kernels: the CUDA-core one walks K 16 deep, the
# tensor-core one 64 deep over 128 x 128 output tiles.
K_SLICE = {torch.float32: 16, torch.bfloat16: 64}
TILE = 128
N_SMS = 132  # H100 SXM
MIN_SPLIT_SLICES = 4  # K slices a split takes at least


def launch_plan(m: int, n: int, k: int) -> tuple:
    """``(splits, k_per_split)`` of the tensor-core kernel for (m, k) @
    (k, n): a grid of 128 x 128 tiles that covers fewer than ``N_SMS`` SMs
    splits K so that tiles x splits covers them, each split at least
    ``MIN_SPLIT_SLICES`` 64-deep slices, no split empty."""
    slices = -(-k // K_SLICE[torch.bfloat16])
    tiles = -(-m // TILE) * -(-n // TILE)
    splits = 1
    if tiles < N_SMS:
        splits = max(1, min(-(-N_SMS // tiles), slices // MIN_SPLIT_SLICES))
    per = -(-slices // splits)
    return -(-slices // per), per * K_SLICE[torch.bfloat16]


def _aligned(t: torch.Tensor) -> bool:
    """A contiguous matrix whose base and rows are 16-byte aligned."""
    return t.data_ptr() % 16 == 0 and (t.shape[1] * t.element_size()) % 16 == 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mm_pu: {msg}")


def pad_overhead(m: int, n: int, k: int, spec: MMTileSpec) -> float:
    """Fraction of matrix-unit work spent on padding for this (mm, spec)
    pairing."""
    pm = -(-m // spec.block_m) * spec.block_m
    pn = -(-n // spec.block_n) * spec.block_n
    pk = -(-k // spec.block_k) * spec.block_k
    return pm * pn * pk / (m * n * k) - 1.0


def _row_vector(v: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A (1, N) or (N,) epilogue operand as N contiguous f32 values."""
    _require(v.numel() == n and v.shape[-1] == n, f"{name} must be (1, {n})")
    return v.reshape(n).float().contiguous()


def mm_pu(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    w_scale: Optional[torch.Tensor] = None,
    activation: str = "none",
    out_dtype=None,
) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) with the fused epilogue, in this order:
    per-column dequant ``* w_scale (1, N)`` (w int8), ``+ bias (1, N)``,
    ``activation`` (gelu-tanh, silu, relu, relu2 or none), ``+ residual
    (M, N)``.  f32 accumulation; returns (M, N) in ``out_dtype`` (x's dtype
    by default)."""
    _require(activation in ACTIVATIONS, f"activation {activation!r} (one of {list(ACTIVATIONS)})")
    if x.device.type == "cpu":
        return mm_pu_ref(x, w, bias=bias, residual=residual, w_scale=w_scale,
                         activation=activation, out_dtype=out_dtype)
    _require(x.is_cuda or x.is_meta, f"x must be a CUDA, CPU or meta tensor, got {x.device}")
    refuse_grad("mm_pu", "no training path calls it, as in JAX", x, w, bias, residual, w_scale)
    if x.is_meta:
        out_dtype = out_dtype or x.dtype
        record_kernel("mm_pu", *cost(x, w, out_dtype))
        return torch.empty((x.shape[0], w.shape[1]), dtype=out_dtype, device=x.device)
    out = launch(kernel.library(), x, w, bias=bias, residual=residual, w_scale=w_scale,
                 activation=activation, out_dtype=out_dtype,
                 stream=torch.cuda.current_stream(x.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    return out


def cost(x, w, out_dtype) -> tuple:
    """(flops, bytes) of one call, as ``PERF.md``'s bound counts them: 2 M N
    K flops; x, w, the per-column scale and the output each once."""
    M, K = x.shape
    N = w.shape[1]
    out_size = torch.finfo(out_dtype).bits // 8
    return (2 * M * N * K,
            x.numel() * x.element_size() + w.numel() * w.element_size() + 4 * N + M * N * out_size)


def launch(lib, x, w, *, bias, residual, w_scale, activation, out_dtype, stream) -> torch.Tensor:
    """Check the operands, allocate the output (and the split-K workspace)
    and call ``lib``'s entry point for x's dtype (``ENTRIES``) on
    ``stream``; raises on what the kernels do not take or a failed launch."""
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
             f"x (M, K) and w (K, N), got {tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    _require(K > 0, "K must be positive")
    out_dtype = out_dtype or x.dtype
    _require(x.dtype in ENTRIES, f"x dtype {x.dtype} (f32 or bf16)")
    _require(out_dtype in (torch.float32, torch.bfloat16), f"out dtype {out_dtype}")
    int8_w = w_scale is not None
    _require(w.dtype == (torch.int8 if int8_w else x.dtype),
             f"w dtype {w.dtype}: x's dtype, or int8 with w_scale")
    _require(x.is_contiguous() and w.is_contiguous(), "x and w must be contiguous")
    tensors = [x, w] + [t for t in (bias, residual, w_scale) if t is not None]
    _require(all(t.device == x.device for t in tensors), "all tensors on one device")
    if w_scale is not None:
        w_scale = _row_vector(w_scale, N, "w_scale")
    if bias is not None:
        bias = _row_vector(bias, N, "bias")
    if residual is not None:
        _require(residual.shape == (M, N) and residual.dtype in (torch.float32, torch.bfloat16),
                 f"residual must be ({M}, {N}) f32 or bf16")
        residual = residual.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (x.data_ptr(), w.data_ptr(), ptr(w_scale), ptr(bias), ptr(residual), out.data_ptr())
    codes = (_CODES[residual.dtype] if residual is not None else 0, _CODES[out_dtype],
             ACTIVATIONS[activation])
    entry = ENTRIES[x.dtype]
    if x.dtype == torch.float32:
        rc = getattr(lib, entry)(*args, M, N, K, _CODES[x.dtype], _CODES[w.dtype], *codes, stream)
    else:
        splits, k_per_split = launch_plan(M, N, K)
        ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
              if splits > 1 else None)
        rc = getattr(lib, entry)(*args, ptr(ws), M, N, K, _CODES[w.dtype], *codes, splits,
                                 k_per_split, int(_aligned(x) and _aligned(w)), stream)
    if rc != 0:
        raise RuntimeError(f"mm_pu kernel launch failed ({entry}, code {rc})")
    return out

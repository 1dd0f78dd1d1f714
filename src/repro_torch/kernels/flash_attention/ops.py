"""Wrapper of the flash-attention kernels in the model's layout (the port's
``repro/kernels/flash_attention/ops.py`` and, for training,
``backward.py``'s ``custom_vjp``).

q stays (B, Sq, H, D) and k/v (B, Sk, KH, D), with the JAX GQA map (q head
h reads kv head h // G); the kernels index that layout directly, with a
token stride per tensor, so views of the fused QKV projection need no copy.
Ragged Sq/Sk are masked in the kernels (the JAX wrapper halves its block
instead; the results agree).  Head dims 32, 64, 128 and 256 are built
(256: recurrentgemma-9b and paligemma-3b); any other raises.  The dtype
alone picks the kernel
(``ENTRIES``): bf16 runs on tensor cores, f32 on CUDA cores (its 2e-5
tolerance rules out TF32).  CPU tensors go to the plain version
(``repro_torch.models.layers.blocked_attention``, which autograd
differentiates); CUDA tensors launch the kernel their dtype selects or
raise: there is no fallback.

Training: when autograd would record the call (grad enabled, an input
requiring grad), a CUDA call goes through ``FlashAttention``, a
``torch.autograd.Function``.  Its forward launches the forward kernel with
the rows' logsumexp (natural log, f32, (B, H, Sq)) and saves (q, k, v, out,
lse), nothing quadratic; its backward launches ``flash_attention_backward``
(``csrc/flash_attention_bwd.cu``), which recomputes P from q, k and the
logsumexp and returns contiguous dq, dk and dv (dk and dv summed over each
kv head's G query heads).  The backward takes the forward's head dims, 32,
64, 128 and 256 (``BWD_HEAD_DIMS``), and picks its kernel by dtype as the
forward does: bf16 on tensor cores, f32 on CUDA cores.

The dry run (``launch/dryrun.py``) traces on the ``meta`` device: there the
forward and backward entries check their operands as a launch does, return
empty outputs of the right shapes (and the logsumexp) and record one call
with ``cost()`` / ``backward_cost()`` (``core/op_cost.record_kernel``).
They compute nothing and count no launch: the meta route is not a
fallback.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.op_cost import record_kernel
from repro_torch.kernels import needs_grad
from repro_torch.kernels.flash_attention import kernel
from repro_torch.models.layers import blocked_attention

# Kernel launches so far (forward; backward); a run resets them to show
# which path it took.
LAUNCHES = 0
BWD_LAUNCHES = 0

# Largest q/k chunk of the plain version.  JAX takes its chunks from the
# plan's PU tile; the port has no tile search, and the chunking changes no
# result.
PLAIN_CHUNK = 128


def plain_chunk(n: int) -> int:
    """The plain version's chunk along a length ``n``: its largest divisor
    up to ``PLAIN_CHUNK``.  (``blocked_attention`` halves a chunk that does
    not divide the length, JAX's rule, which leaves chunks of 4 at
    whisper-small's 1,500 encoder frames.)"""
    return max(c for c in range(1, min(PLAIN_CHUNK, n) + 1) if n % c == 0)

# The C entry point (csrc/flash_attention.cu) each dtype launches.
ENTRIES = {torch.float32: "flash_attention_forward", torch.bfloat16: "flash_attention_forward_mma"}
_ROWS_MAX = 64  # query rows (G heads x positions) one CTA holds
BWD_HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _token_stride(x: torch.Tensor, name: str) -> int:
    """Elements between consecutive tokens of ``x`` (B, S, heads, D), which
    must be dense within a token and across batch rows."""
    B, S, nh, D = x.shape
    st = x.stride()
    _require(st[3] == 1 and st[2] == D and (B == 1 or st[0] == S * st[1]),
             f"{name} must be (B, S, heads, D) with dense heads, got strides {st}")
    _require(x.data_ptr() % 16 == 0 and (st[1] * x.element_size()) % 16 == 0,
             f"{name} rows must be 16-byte aligned (the kernel loads 16-byte vectors)")
    return st[1]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    prefix: int = 0,
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D).  Returns (B, Sq, H, D) in q's
    dtype: softmax(q k^T / sqrt(D)) v under the causal, sliding-window and
    prefix-LM masks (query i sits at key i), or none of them
    (``causal=False``: bidirectional, and cross-attention with Sq != Sk).
    Differentiable on every device: the plain version by autograd, the
    kernel through ``FlashAttention``."""
    if q.device.type == "cpu":
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=plain_chunk(q.shape[1]), k_chunk=plain_chunk(k.shape[1]),
                                 prefix_len=prefix)
    _require(q.is_cuda or q.is_meta, f"q must be a CUDA, CPU or meta tensor, got {q.device}")
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, prefix)
    return forward_with_lse(q, k, v, causal=causal, window=window, prefix=prefix)[0]


class FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op: the forward kernel with the
    logsumexp, then the backward kernel (``backward.py``'s ``_vjp_fwd`` /
    ``_vjp_bwd``).  q, k and v may be views (of the fused QKV projection);
    their gradients come back contiguous and autograd's view backward
    places them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, prefix: int):
        out, lse = forward_with_lse(q, k, v, causal=causal, window=window, prefix=prefix,
                                    with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, prefix)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, prefix = ctx.mask
        dq, dk, dv = backward(q, k, v, out, lse, dout, causal=causal, window=window,
                              prefix=prefix)
        return dq, dk, dv, None, None, None


def forward_with_lse(q, k, v, *, causal: bool, window: int, prefix: int,
                     with_lse: bool = False):
    """One forward launch on the card: (out, the f32 (B, H, Sq) logsumexp
    or None)."""
    lse = None
    if with_lse:
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                          device=q.device)
    if q.is_meta:
        B, Sq, _, H, _, D = _check(q, k, v, (32, 64, 128, 256))
        record_kernel("flash_attention", *cost(q, k, causal=causal, window=window,
                                               prefix=prefix))
        return torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device), lse
    out = launch(kernel.library(), q, k, v, causal=causal, window=window, prefix=prefix,
                 stream=torch.cuda.current_stream(q.device).cuda_stream, lse=lse)
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def backward(q, k, v, out, lse, dout, *, causal: bool, window: int, prefix: int):
    """One backward launch on the card: (dq, dk, dv)."""
    if q.is_meta:
        _check(q, k, v, BWD_HEAD_DIMS)
        record_kernel("flash_attention_bwd", *backward_cost(q, k, causal=causal, window=window,
                                                            prefix=prefix))
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty(k.shape, dtype=q.dtype, device=q.device),
                torch.empty(k.shape, dtype=q.dtype, device=q.device))
    grads = launch_backward(kernel.backward_library(), q, k, v, out, lse, dout, causal=causal,
                            window=window, prefix=prefix,
                            stream=torch.cuda.current_stream(q.device).cuda_stream)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return grads


def visible_pairs(Sq: int, Sk: int, causal: bool = True, window: int = 0,
                  prefix: int = 0) -> int:
    """(query, key) pairs the masks leave visible (query i sits at key i):
    query i sees keys from ``i - window + 1`` (0 without a window) up to i,
    or up to the prefix's end, or every key without the causal mask."""
    i = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(Sk, np.maximum(i + 1, prefix)) if causal else np.full_like(i, Sk)
    return int(np.maximum(0, hi - lo).sum())


def cost(q, k, *, causal: bool = True, window: int = 0, prefix: int = 0) -> tuple:
    """(flops, bytes) of one forward call, as ``PERF.md``'s bound counts
    them: 4 H D flops a visible (query, key) pair, q, k, v and the output
    each once."""
    B, Sq, H, D = q.shape
    flops = 4 * H * D * B * visible_pairs(Sq, k.shape[1], causal, window, prefix)
    return flops, (2 * q.numel() + 2 * k.numel()) * q.element_size()


def backward_cost(q, k, *, causal: bool = True, window: int = 0, prefix: int = 0) -> tuple:
    """(flops, bytes) of one backward call: 10 H D flops a visible pair;
    q, k, v, o, dO and the logsumexp read, dq, dk, dv written once."""
    B, Sq, H, D = q.shape
    flops = 10 * H * D * B * visible_pairs(Sq, k.shape[1], causal, window, prefix)
    return flops, (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * B * H * Sq


def _check(q, k, v, head_dims) -> tuple:
    _require(q.dim() == 4 and k.dim() == 4, "q (B, Sq, H, D) and k/v (B, Sk, KH, D)")
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    _require(q.dtype in ENTRIES and k.dtype == q.dtype and v.dtype == q.dtype,
             f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (all f32 or all bf16)")
    _require(k.shape == (B, Sk, KH, D) and v.shape == k.shape, "k/v shape")
    _require(D in head_dims, f"head dim {D}")
    _require(KH > 0 and H % KH == 0 and H // KH <= _ROWS_MAX, f"heads H={H} KH={KH}")
    _require(k.device == q.device and v.device == q.device, "all tensors on one device")
    return B, Sq, Sk, H, KH, D


def launch(lib, q, k, v, *, causal: bool, window: int, prefix: int, stream,
           lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check the operands, allocate the output and call ``lib``'s entry
    point for q's dtype (``ENTRIES``) on ``stream``; with ``lse``, a
    contiguous f32 (B, H, Sq) tensor, the kernel also writes each row's
    logsumexp there.  Raises on what the kernels do not take or a failed
    launch."""
    B, Sq, Sk, H, KH, D = _check(q, k, v, (32, 64, 128, 256))
    strides = [_token_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    if lse is not None:
        _require(lse.shape == (B, H, Sq) and lse.dtype == torch.float32 and lse.is_contiguous()
                 and lse.device == q.device, "lse must be a contiguous (B, H, Sq) f32 tensor")
    rows = _ROWS_MAX // (H // KH)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    rc = getattr(lib, ENTRIES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Sk, H, KH, D, *strides, int(causal), int(window), int(prefix), rows,
        1.0 / math.sqrt(D), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({ENTRIES[q.dtype]}, code {rc})")
    return out


def launch_backward(lib, q, k, v, out, lse, dout, *, causal: bool, window: int, prefix: int,
                    stream):
    """Check the operands, allocate dq (B, Sq, H, D), dk and dv (B, Sk, KH,
    D), contiguous in the inputs' dtype, and the f32 (B, H, Sq) scratch of
    rowsum(dO o), then call ``lib``'s ``flash_attention_backward`` on
    ``stream``.  q, k, v keep the forward's strided layouts; out and dout
    are read contiguous (dout is made so).  Raises on what the kernel does
    not take or a failed launch."""
    B, Sq, Sk, H, KH, D = _check(q, k, v, BWD_HEAD_DIMS)
    strides = [_token_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    dout = dout.contiguous()
    _require(out.shape == q.shape and out.dtype == q.dtype and out.is_contiguous(),
             "out must be the forward's (B, Sq, H, D) output")
    _require(dout.shape == q.shape and dout.dtype == q.dtype, "dout must match out")
    _require(lse.shape == (B, H, Sq) and lse.dtype == torch.float32 and lse.is_contiguous(),
             "lse must be a contiguous (B, H, Sq) f32 tensor")
    _require(dout.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0, "out/dout alignment")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B, Sq, Sk, H, KH, D, *strides, int(causal), int(window), int(prefix),
        _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed (code {rc})")
    return dq, dk, dv

"""Wrapper of the flash-attention kernels in the model's layout (the port's
``repro/kernels/flash_attention/ops.py``, forward only).

q stays (B, Sq, H, D) and k/v (B, Sk, KH, D), with the JAX GQA map (q head
h reads kv head h // G); the kernels index that layout directly, with a
token stride per tensor, so views of the fused QKV projection need no copy.
Ragged Sq/Sk are masked in the kernels (the JAX wrapper halves its block
instead; the results agree).  Head dims 32, 64, 128 and 256 are built
(256: recurrentgemma-9b and paligemma-3b); any other raises.  The dtype
alone picks the kernel
(``ENTRIES``): bf16 runs on tensor cores, f32 on CUDA cores (its 2e-5
tolerance rules out TF32).  CPU tensors go to the plain version
(``repro_torch.models.layers.blocked_attention``); CUDA tensors launch the
kernel their dtype selects or raise: there is no fallback.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.models.layers import blocked_attention

# Kernel launches so far; a run resets it to show which path it took.
LAUNCHES = 0

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
    (``causal=False``: bidirectional, and cross-attention with Sq != Sk)."""
    if q.device.type == "cpu":
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=plain_chunk(q.shape[1]), k_chunk=plain_chunk(k.shape[1]),
                                 prefix_len=prefix)
    _require(q.is_cuda, f"q must be a CUDA or CPU tensor, got {q.device}")
    out = launch(kernel.library(), q, k, v, causal=causal, window=window, prefix=prefix,
                 stream=torch.cuda.current_stream(q.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    return out


def launch(lib, q, k, v, *, causal: bool, window: int, prefix: int, stream) -> torch.Tensor:
    """Check the operands, allocate the output and call ``lib``'s entry
    point for q's dtype (``ENTRIES``) on ``stream``; raises on what the
    kernels do not take or a failed launch."""
    _require(q.dim() == 4 and k.dim() == 4, "q (B, Sq, H, D) and k/v (B, Sk, KH, D)")
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    _require(q.dtype in ENTRIES and k.dtype == q.dtype and v.dtype == q.dtype,
             f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (all f32 or all bf16)")
    _require(k.shape == (B, Sk, KH, D) and v.shape == k.shape, "k/v shape")
    _require(D in (32, 64, 128, 256), f"head dim {D}")
    _require(KH > 0 and H % KH == 0 and H // KH <= _ROWS_MAX, f"heads H={H} KH={KH}")
    _require(k.device == q.device and v.device == q.device, "all tensors on one device")
    strides = [_token_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    rows = _ROWS_MAX // (H // KH)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    rc = getattr(lib, ENTRIES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KH, D, *strides, int(causal), int(window), int(prefix), rows,
        1.0 / math.sqrt(D), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({ENTRIES[q.dtype]}, code {rc})")
    return out

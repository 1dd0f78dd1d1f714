"""Wrapper of the flash-attention kernel in the model's layout (the port's
``repro/kernels/flash_attention/ops.py``, forward only).

q stays (B, Sq, H, D) and k/v (B, Sk, KH, D), with the JAX GQA map (q head
h reads kv head h // G); the kernel indexes that layout directly, with a
token stride per tensor, so views of the fused QKV projection need no copy.
Ragged Sq/Sk are masked in the kernel (the JAX wrapper halves its block
instead; the results agree).  CPU tensors go to the plain version
(``repro_torch.models.layers.blocked_attention``); CUDA tensors launch the
kernel or raise: there is no fallback.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.models.layers import blocked_attention

# Kernel launches so far; a run resets it to show which path it took.
LAUNCHES = 0

# q/k chunks of the plain version.  JAX takes them from the plan's PU tile;
# the port has no tile search, and the chunking changes no result.
PLAIN_CHUNK = 128

_CODES = {torch.float32: 0, torch.bfloat16: 1}
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
    prefix-LM masks."""
    if q.device.type == "cpu":
        return blocked_attention(q, k, v, causal=causal, window=window, q_chunk=PLAIN_CHUNK,
                                 k_chunk=PLAIN_CHUNK, prefix_len=prefix)
    lib = kernel.library()
    _require(q.is_cuda, f"q must be a CUDA or CPU tensor, got {q.device}")
    _require(q.dim() == 4 and k.dim() == 4, "q (B, Sq, H, D) and k/v (B, Sk, KH, D)")
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    _require(q.dtype in _CODES and k.dtype == q.dtype and v.dtype == q.dtype,
             f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (all f32 or all bf16)")
    _require(k.shape == (B, Sk, KH, D) and v.shape == k.shape, "k/v shape")
    _require(D in (32, 64, 128), f"head dim {D}")
    _require(KH > 0 and H % KH == 0 and H // KH <= _ROWS_MAX, f"heads H={H} KH={KH}")
    _require(k.device == q.device and v.device == q.device, "all tensors on one device")
    strides = [_token_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    rows = _ROWS_MAX // (H // KH)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    rc = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KH, D, *strides, int(causal), int(window), int(prefix), rows,
        1.0 / math.sqrt(D), _CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return out

"""Wrapper of the paged-attention kernels in the model's layout (the port's
``repro/kernels/paged_attention/ops.py``).

``q`` stays (B, W, H, D) with the JAX package's GQA map, q head
``h = kh * G + g`` reading kv head ``kh``; the kernels index that layout
directly, so no transpose is paid.  The (q, page) dtypes alone pick the C
entry (``ENTRIES``): bf16 q with bf16 pages (qwen3-1.7b's plan) or int8
pages (qwen3-moe-30b-a3b's, widened to bf16 in shared memory, the scales
on S and P) runs on the tensor cores (``paged_attention_forward_mma``: a
work list of live row blocks and key splits, a persistent grid, a combine
pass); f32 q with any pages, and bf16 q with f32 pages, on CUDA cores
(``paged_attention_forward``: f32's 2e-5 tolerance rules out rounding them
to bf16 or TF32).  CPU tensors
go to the plain version in ``ref.py``; CUDA tensors launch the kernel
their dtypes select or raise: there is no fallback.  On the ``meta``
device (the dry run's trace) it checks the operands as a launch does,
returns an empty output and records one call with ``cost()``: no
computation, no launch counted.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.op_cost import record_kernel
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# Kernel launches so far; a run resets it to show which path it took.
LAUNCHES = 0

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ROWS_MAX = 64  # query rows (G heads x slab rows) one CTA holds
# The C entry point (csrc/paged_attention.cu) each (q dtype, page dtype) launches.
ENTRIES = {(q, kv): "paged_attention_forward" for q in _Q_CODES for kv in _KV_CODES}
ENTRIES[torch.bfloat16, torch.bfloat16] = "paged_attention_forward_mma"
ENTRIES[torch.bfloat16, torch.int8] = "paged_attention_forward_mma"
SPLIT = 512  # keys a decode split of the tensor-core kernel (a multiple of 64)
DEC_ROWS = 16  # rows of a decode item: G x q_len at most this


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def paged_attention(
    q: torch.Tensor,
    entry: dict,
    table: torch.Tensor,
    lens: torch.Tensor,
    q_lens: torch.Tensor,
    *,
    block_size: int,
    window: int = 0,
    rows_per_cta: int = 0,
) -> torch.Tensor:
    """q: (B, W, H, D); entry: paged pool entry ({"k","v"[,"k_scale",
    "v_scale"]}, models/cache layout); table (B, MB); lens/q_lens (B,).
    Returns (B, W, H, D); rows >= q_lens[b] are zeros.

    ``rows_per_cta`` (slab rows per CUDA block, default ``64 // G``) changes
    the kernel's schedule, never its numbers.  The model never passes it;
    it exists for ``chip_smoke.py``'s sweep, which holds the outputs equal
    across schedules."""
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, entry, table, lens, q_lens, block_size=block_size, window=window
        )
    _require(q.is_cuda or q.is_meta, f"q must be a CUDA, CPU or meta tensor, got {q.device}")
    refuse_grad("paged_attention", "serving only, as in JAX", q, entry["k"], entry["v"])
    if q.is_meta:
        _check(q, entry, table, lens, q_lens, block_size)
        record_kernel("paged_attention", *cost(q, entry, table, block_size=block_size))
        return torch.empty_like(q)
    lib = kernel.library()
    out = launch(lib, q, entry, table, lens, q_lens, block_size=block_size, window=window,
                 rows_per_cta=rows_per_cta, stream=torch.cuda.current_stream(q.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    return out


def cost(q, entry, table, *, block_size: int) -> tuple:
    """(flops, bytes) of one call, as ``PERF.md``'s bound counts them: the
    live pages' K and V (with int8 pages' scales), the q rows and the
    output once, the block table's lengths; 4 H D flops a (row, key) pair.
    A meta table has no values to read, so every entry of it counts as a
    live page and every row sees all of its slot's keys (the dry run's
    decode slots are full)."""
    B, W, H, D = q.shape
    KH = entry["k"].shape[2]
    kv_bytes = entry["k"].element_size() + (4 / D if "k_scale" in entry else 0)
    keys = B * table.shape[1] * block_size
    nbytes = keys * KH * D * 2 * kv_bytes + 2 * q.numel() * q.element_size() + 3 * B * 4
    return 4 * D * H * W * keys, int(nbytes)


def _check(q, entry, table, lens, q_lens, block_size: int) -> tuple:
    """The operands' checks (a launch's and the meta route's): returns
    (B, W, H, D, KH, MB)."""
    k, v = entry["k"], entry["v"]
    ks, vs = entry.get("k_scale"), entry.get("v_scale")
    B, W, H, D = q.shape
    N, bs, KH, Dk = k.shape
    _require(q.dtype in _Q_CODES, f"q dtype {q.dtype} (f32 or bf16)")
    _require(k.dtype in _KV_CODES and v.dtype == k.dtype, f"pages {k.dtype}/{v.dtype}")
    _require(v.shape == k.shape and Dk == D and bs == block_size, "page shape")
    _require(H % KH == 0 and H // KH <= _ROWS_MAX, f"heads H={H} KH={KH}")
    _require(D in (32, 64, 128), f"head dim {D}")
    quant = k.dtype == torch.int8
    _require(
        not quant
        or (ks is not None and vs is not None and ks.dtype == torch.float32
            and ks.shape == (N, bs, KH, 1) and vs.shape == ks.shape),
        "int8 pages need (N, bs, KH, 1) f32 scales",
    )
    MB = table.shape[1]
    _require(table.shape == (B, MB) and lens.shape == (B,) and q_lens.shape == (B,),
             "table (B, MB), lens and q_lens (B,)")
    return B, W, H, D, KH, MB


def launch(lib, q, entry, table, lens, q_lens, *, block_size: int, window: int,
           rows_per_cta: int, stream, split: int = SPLIT) -> torch.Tensor:
    """Check the operands, allocate the output (and the tensor-core entry's
    work list and split partials) and call ``lib``'s entry point for the
    (q, page) dtypes (``ENTRIES``) on ``stream``, with int8 pages' scale
    pointers (null otherwise); raises on what the kernels do not take or a
    failed launch."""
    B, W, H, D, KH, MB = _check(q, entry, table, lens, q_lens, block_size)
    k, v = entry["k"], entry["v"]
    ks, vs = entry.get("k_scale"), entry.get("v_scale")
    bs = block_size
    quant = k.dtype == torch.int8
    table = table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    q_lens = q_lens.to(device=q.device, dtype=torch.int32).contiguous()
    tensors = [q, k, v] + ([ks, vs] if quant else [])
    _require(all(t.is_contiguous() for t in tensors), "q and pages must be contiguous")
    _require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
             "pages must be 16-byte aligned (the kernel reads them in 16-byte vectors)")
    _require(all(t.device == q.device for t in tensors), "all tensors on one device")
    G = H // KH
    rows = rows_per_cta or _ROWS_MAX // G
    rows = max(1, min(rows, W, _ROWS_MAX // G))
    out = torch.empty_like(q)
    entry_name = ENTRIES[q.dtype, k.dtype]
    scale = 1.0 / math.sqrt(D)
    scales = (ks.data_ptr(), vs.data_ptr()) if quant else (None, None)
    if entry_name == "paged_attention_forward_mma":
        _require(split > 0 and split % 64 == 0, f"split {split} (a multiple of 64)")
        n_splits = -(-MB * bs // split)
        o_part = torch.empty((B, KH, n_splits, DEC_ROWS, D + 2), dtype=torch.float32,
                             device=q.device)
        work = torch.empty(2 + 2 * B * max(-(-W // rows), n_splits), dtype=torch.int32,
                           device=q.device)
        rc = getattr(lib, entry_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, table.data_ptr(),
            lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(), o_part.data_ptr(),
            work.data_ptr(), B, W, H, KH, D, bs, MB, int(window), rows, split, n_splits,
            _KV_CODES[k.dtype], scale, stream,
        )
    else:
        rc = getattr(lib, entry_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, table.data_ptr(),
            lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(), B, W, H, KH, D, bs, MB,
            int(window), rows, scale, _Q_CODES[q.dtype], _KV_CODES[k.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed ({entry_name}, code {rc})")
    return out

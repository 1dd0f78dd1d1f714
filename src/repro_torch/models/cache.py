"""Paged KV cache (the port's ``repro/models/cache.py``, paged subset).

One shared pool of fixed-size blocks per attention layer; a request owns a
set of blocks through its block-table row (position p of slot b lives at
flat pool slot ``table[b, p // bs] * bs + p % bs``).  Block 0 is the trash
block: idle slots and the dead rows of a mixed slab write there, so every
step keeps static shapes.  The int8 option stores pages on a per-(token,
kv-head) grid with an f32 scale beside them.

The pool tree mirrors the parameter tree (``{"stack": ..., "tail": ...}``,
stacked leaves for the stacked groups).  Where JAX donated the pools to the
jitted step, the port writes them in place: ``paged_update`` and
``paged_copy_block`` mutate the tensors they are given.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _kv_vec_scale(x: torch.Tensor) -> torch.Tensor:
    """Int8 grid per (token, kv-head) vector: max |x| over d_head / 127."""
    m = x.float().abs().amax(dim=-1, keepdim=True)
    return torch.clamp(m, min=1e-12) / 127.0


def _quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``repro/train/compression.quantize``'s int8 grid: clip(round(x/s),
    +-127).  ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _paged_layer_entry(cfg, serve, lead: tuple, device) -> dict:
    shape = lead + (serve.n_blocks, serve.block_size, cfg.n_kv_heads, cfg.d_head)
    if serve.kv_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {
            "paged": {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            }
        }
    dt = _DTYPES[serve.kv_dtype]
    return {
        "paged": {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
        }
    }


def init_paged_cache(cfg, plan, serve, device="cpu") -> dict:
    """Zero block pools mirroring the layer tree ({"stack": ..., "tail": ...}).

    ``serve`` is a :class:`repro_torch.core.plan.ServePlan`; only
    attention-kind layers are supported (``serve_feasible`` gates the rest)."""
    pattern = cfg.layer_pattern
    n_full, rem = divmod(cfg.n_layers, len(pattern))
    stack = (
        tuple(_paged_layer_entry(cfg, serve, (n_full,), device) for _ in pattern)
        if n_full
        else None
    )
    tail = tuple(_paged_layer_entry(cfg, serve, (), device) for _ in range(rem))
    return {"layers": {"stack": stack, "tail": tail}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def paged_copy_block(pools: dict, src: int, dst: int) -> None:
    """Copy one block's pages ``src -> dst`` across every layer pool, in
    place: the copy-on-write fork of prefix sharing (k/v and, for int8
    pools, the scales, so the fork is byte-identical)."""
    layers = pools["layers"]
    for x in _leaves(layers["stack"]):
        x[:, dst] = x[:, src]
    for x in _leaves(layers["tail"]):
        x[dst] = x[src]


def paged_flat_slots(
    table: torch.Tensor,
    positions: torch.Tensor,
    block_size: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flat pool slots for ``positions`` (B, S) under block table (B, MB).

    ``valid`` (B, S) bool routes masked positions to the trash block (block
    0).  Positions are clamped into the table extent first (a dead row's
    position may run past ``max_seq_len``)."""
    B, MB = table.shape
    pos = torch.clamp(positions.long(), 0, MB * block_size - 1)
    rows = torch.arange(B, device=table.device)[:, None]
    blk = table.long()[rows, pos // block_size]
    if valid is not None:
        blk = torch.where(valid, blk, 0)
    return blk * block_size + pos % block_size


def paged_update(
    entry: dict,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    table: torch.Tensor,
    block_size: int,
    valid: Optional[torch.Tensor] = None,
) -> dict:
    """Write new (B, S, KV, Dh) keys/values at their slots, in place;
    returns ``entry``.  Slot collisions only happen on the trash block,
    where any winner is fine."""
    B, S = k.shape[:2]
    flat = paged_flat_slots(table, positions, block_size, valid).reshape(-1)

    def put(pool, val):
        fp = pool.view((-1,) + tuple(pool.shape[2:]))
        fp[flat] = val.reshape((B * S,) + tuple(val.shape[2:])).to(fp.dtype)

    if "k_scale" in entry:
        kf, vf = k.float(), v.float()
        sk, sv = _kv_vec_scale(k), _kv_vec_scale(v)
        put(entry["k"], _quantize_int8(kf, sk))
        put(entry["v"], _quantize_int8(vf, sv))
        put(entry["k_scale"], sk)
        put(entry["v_scale"], sv)
    else:
        put(entry["k"], k)
        put(entry["v"], v)
    return entry


def live_blocks(table) -> int:
    """High-water mark of a prefix-dense block table: the columns up to the
    last one that holds a non-trash block (1 when the table is all trash)."""
    live = np.nonzero(np.asarray(table).any(axis=0))[0]
    return int(live[-1]) + 1 if live.size else 1


def paged_gather(
    entry: dict,
    table: torch.Tensor,
    block_size: int,
    max_blocks: Optional[int] = None,
):
    """Materialize each slot's pages in position order: (B, L*bs, KV, Dh).

    Key j of the gathered view sits at sequence position j.  ``L`` is
    clamped to ``max_blocks``, by default the live blocks' high-water mark
    (which reads the table on the host).  int8 pages come back dequantized
    to f32."""
    MB = table.shape[1]
    if max_blocks is None:
        max_blocks = live_blocks(table.cpu().numpy())
    L = min(MB, max_blocks)
    pos = torch.arange(L * block_size, device=table.device)
    blk = table.long()[:, pos // block_size]
    flat = blk * block_size + pos % block_size  # (B, L*bs)

    def take(pool):
        return pool.reshape((-1,) + tuple(pool.shape[2:]))[flat]

    k, v = take(entry["k"]), take(entry["v"])
    if "k_scale" in entry:
        k = k.float() * take(entry["k_scale"])
        v = v.float() * take(entry["v_scale"])
    return k, v

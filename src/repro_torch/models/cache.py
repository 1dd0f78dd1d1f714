"""Decode caches (the port's ``repro/models/cache.py``): the dense cache of
the eager path and the paged KV pool of continuous batching.

Dense cache, per layer kind (the JAX layout):
  attn/swa/local : {"attn": {"k","v": (B, Sc, KV, Dh), "t"}}  Sc = window
                   for windowed layers (a ring buffer at slot ``pos % Sc``;
                   softmax does not care about key order), else cache_len.
  rwkv6          : {"rwkv": {"S": (B, H, D, D) f32, "shift": (B, d) f32},
                    "cmix": (B, d) f32}
  rglru          : {"rglru": {"h": (B, W) f32, "conv": (B, cw - 1, W)}}
An encoder-decoder adds ``{"memory": (B, Se, d)}`` to the cache and
``{"cross_kv": (k, v)}`` (each (B, Se, KV, Dh)) to every decoder layer.
A layer's ``"t"`` (positions already cached) is an int32 tensor kept on the
CPU, (n_groups,) in the stacked groups and 0-d in the tail, so reading it
costs no device sync.  ``init_cache`` builds zero caches;
``cache_from_prefill`` turns a ``collect_cache=True`` forward pass into a
decode-ready cache.

Paged KV pool: one shared pool of fixed-size blocks per attention layer; a
request owns a set of blocks through its block-table row (position p of
slot b lives at flat pool slot ``table[b, p // bs] * bs + p % bs``).  Block
0 is the trash block: idle slots and the dead rows of a mixed slab write
there, so every step keeps static shapes.  The int8 option stores pages on
a per-(token, kv-head) grid with an f32 scale beside them.

Both trees mirror the parameter tree (``{"stack": ..., "tail": ...}``,
stacked leaves for the stacked groups).  Where JAX returned new caches (or
took the pools donated), the port writes them in place: the decode step,
``paged_update`` and ``paged_copy_block`` mutate the tensors they are
given.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _kv_vec_scale(x: torch.Tensor) -> torch.Tensor:
    """Int8 grid per (token, kv-head) vector: max |x| over d_head / 127."""
    m = x.float().abs().amax(dim=-1, keepdim=True)
    return torch.clamp(m, min=1e-12) / 127.0


def _quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``repro/train/compression.quantize``'s int8 grid: clip(round(x/s),
    +-127).  ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _paged_layer_entry(cfg, serve, lead: tuple, device, kv_heads: int) -> dict:
    shape = lead + (serve.n_blocks, serve.block_size, kv_heads, cfg.d_head)
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


def init_paged_cache(cfg, plan, serve, device="cuda", shardings=None) -> dict:
    """Zero block pools mirroring the layer tree ({"stack": ..., "tail": ...}).

    ``serve`` is a :class:`repro_torch.core.plan.ServePlan`; only
    attention-kind layers are supported (``serve_feasible`` gates the rest).
    ``device`` defaults to the card and raises without one unless it is
    ``"cpu"``.  ``shardings`` (``dist.sharding.Shardings``): this rank's
    pools, on n_kv_heads / n heads where tensor-parallel attention runs on
    this rank's heads (``cache_spec``'s KV heads over ``model``)."""
    device = resolve_device(device)
    kv = cfg.n_kv_heads
    if shardings is not None and shardings.attention_sharded():
        kv //= shardings.axis_sizes["model"]
    pattern = cfg.layer_pattern
    n_full, rem = divmod(cfg.n_layers, len(pattern))
    stack = (
        tuple(_paged_layer_entry(cfg, serve, (n_full,), device, kv) for _ in pattern)
        if n_full
        else None
    )
    tail = tuple(_paged_layer_entry(cfg, serve, (), device, kv) for _ in range(rem))
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


# ---------------------------------------------------------------------------
# Dense decode cache (the eager greedy_generate path)
# ---------------------------------------------------------------------------
def layer_window(cfg, kind: str) -> int:
    """The attention window of a layer kind (0: full attention)."""
    if kind == "swa":
        return cfg.sliding_window
    return cfg.local_window if kind == "local" else 0


def _cache_slots(cfg, kind: str, cache_len: int) -> int:
    window = layer_window(cfg, kind)
    return min(window, cache_len) if window else cache_len


def _layer_cache(cfg, kind: str, lead: tuple, B: int, cache_len: int, dtype, device,
                 split: tuple = (1, 1)) -> dict:
    """One layer's dense cache; ``split`` (attention heads' divisor,
    recurrent heads' and channels' divisor) gives this rank's share under
    tensor parallelism."""
    KV, Dh, d = cfg.n_kv_heads // split[0], cfg.d_head, cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    entry: dict = {}
    if kind in ("attn", "swa", "local"):
        Sc = _cache_slots(cfg, kind, cache_len)
        shape = lead + (B, Sc, KV, Dh)
        entry["attn"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "t": torch.zeros(lead, dtype=torch.int32),
        }
    elif kind == "rglru":
        W = (cfg.lru_width or d) // split[1]
        entry["rglru"] = {"h": torch.zeros(lead + (B, W), **f32),
                          "conv": torch.zeros(lead + (B, cfg.conv_width - 1, W), **f32)}
    elif kind == "rwkv6":
        H = cfg.rnn_heads // split[1]
        entry["rwkv"] = {"S": torch.zeros(lead + (B, H, Dh, Dh), **f32),
                         "shift": torch.zeros(lead + (B, d), **f32)}
        entry["cmix"] = torch.zeros(lead + (B, d), **f32)
    else:
        raise ValueError(kind)
    if cfg.enc_dec:
        shape = lead + (B, cfg.enc_seq, KV, Dh)
        entry["cross_kv"] = (torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device))
    return entry


def init_cache(cfg, plan, batch_size: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda", shardings=None) -> dict:
    """Zero dense caches mirroring the layer tree; ``"t"`` is the Python int
    count of positions cached (0); an encoder-decoder adds a zero
    ``"memory"``.  ``device`` defaults to the card.  ``shardings``
    (``dist.sharding.Shardings``) under tensor parallelism: this rank's
    heads, n_kv_heads / n where attention runs on local heads, rnn_heads /
    n and lru_width / n where the recurrent blocks do (``batch_size`` is
    the caller's: this rank's rows)."""
    device = resolve_device(device)
    split = (1, 1)
    if shardings is not None:
        n = shardings.axis_sizes.get("model", 1)
        split = (n if shardings.attention_sharded() else 1,
                 n if shardings.recurrent_sharded() else 1)
    pattern = cfg.layer_pattern
    n_full, rem = divmod(cfg.n_layers, len(pattern))
    stack = (
        tuple(_layer_cache(cfg, kind, (n_full,), batch_size, cache_len, dtype, device, split)
              for kind in pattern)
        if n_full
        else None
    )
    tail = tuple(
        _layer_cache(cfg, pattern[i], (), batch_size, cache_len, dtype, device, split)
        for i in range(rem)
    )
    cache = {"layers": {"stack": stack, "tail": tail}, "t": 0}
    if cfg.enc_dec:
        cache["memory"] = torch.zeros((batch_size, cfg.enc_seq, cfg.d_model), dtype=dtype,
                                      device=device)
    return cache


def _kv_to_ring(k: torch.Tensor, v: torch.Tensor, Sc: int, dtype):
    """Place a prefill's (..., S, KV, D) kv into an Sc-slot cache at slot
    ``pos % Sc`` (any leading dims: the stacked groups convert at once)."""
    S = k.shape[-3]
    if S <= Sc:
        pad = (0, 0, 0, 0, 0, Sc - S)
        return F.pad(k, pad).to(dtype), F.pad(v, pad).to(dtype)
    keep = torch.arange(S - Sc, S, device=k.device)
    slots = keep % Sc

    def ring(x):
        out = x.new_zeros(x.shape[:-3] + (Sc,) + x.shape[-2:], dtype=dtype)
        out[..., slots, :, :] = x[..., keep, :, :].to(dtype)
        return out

    return ring(k), ring(v)


def _convert_entry(entry: dict, kind: str, cfg, cache_len: int, t: torch.Tensor, dtype) -> dict:
    e = dict(entry)
    if "kv_out" in e:
        k, v = e.pop("kv_out")
        kk, vv = _kv_to_ring(k, v, _cache_slots(cfg, kind, cache_len), dtype)
        e["attn"] = {"k": kk, "v": vv, "t": t}
    return e


def _convert_stacked(stack, pattern, cfg, cache_len: int, S: int, dtype):
    """The stacked groups' entries: kv_out (n_groups, B, S, KV, Dh) -> ring."""
    out = []
    for entry, kind in zip(stack, pattern):
        n = entry["kv_out"][0].shape[0] if "kv_out" in entry else 0
        t = torch.full((n,), S, dtype=torch.int32)
        out.append(_convert_entry(entry, kind, cfg, cache_len, t, dtype))
    return tuple(out)


def cache_from_prefill(cfg, plan, prefill_cache: dict, cache_len: int,
                       dtype=torch.bfloat16) -> dict:
    """Convert the ``collect_cache=True`` output of ``forward`` into a
    decode cache of ``cache_len`` positions (windowed layers: a ring of
    ``min(window, cache_len)`` slots).  K/V are stored in ``dtype``; the
    RWKV and RG-LRU states, the cross K/V and the encoder ``memory`` are
    carried as the prefill left them."""
    S = int(prefill_cache["t"])
    pattern = cfg.layer_pattern
    layers = prefill_cache["layers"]
    stack = None
    if layers["stack"] is not None:
        stack = _convert_stacked(layers["stack"], pattern, cfg, cache_len, S, dtype)
    tail = tuple(
        _convert_entry(e, pattern[i % len(pattern)], cfg, cache_len,
                       torch.tensor(S, dtype=torch.int32), dtype)
        for i, e in enumerate(layers["tail"])
    )
    cache = {"layers": {"stack": stack, "tail": tail}, "t": S}
    if "memory" in prefill_cache:
        cache["memory"] = prefill_cache["memory"]
    return cache

"""Checkpointing (the port's ``repro/ckpt/checkpoint.py``): the JAX
package's layout, atomic manifests, async save.

Layout on disk:
    <dir>/step_<k>/arrays.npz      flattened param/opt leaves ("a|b|0" keys)
    <dir>/step_<k>/manifest.json   step, leaf count, bytes, time, meta
The manifest is written LAST and the directory published by an atomic
rename, so a crashed save never yields a "latest" checkpoint.  Keys are the
paths JAX's ``tree_flatten_with_path`` gives a tree of the same shape (a
NamedTuple's field names, dict keys, sequence indices, joined with "|";
``None`` subtrees have no leaves), and bf16/f16 leaves are stored as f32,
so a checkpoint written by either package restores in the other.  Leaves
are saved whole: a run on a mesh gathers its shards first
(``dist.sharding.gather``; a head-aligned ``wqkv`` shard goes back to JAX's
(q | k | v) column order there) and one rank writes.  ``restore_checkpoint(...,
shardings=)`` restores onto a mesh: every rank reads the npz and keeps its
local shard of each leaf (``wqkv`` cut head-aligned), so any layout reads
any checkpoint.  Async: the save copies every leaf to the host
first, then writes on a background thread.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.optimizer import tree_leaves_with_path, tree_map_with_path

Tree = Any
_SEP = "|"


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of ``leaf`` that shares no storage with it, also when the
    leaf is already on the CPU: the launcher donates its state, so the next
    step writes the live tensors while an async save is still writing."""
    wide = leaf.dtype in (torch.bfloat16, torch.float16)  # npz-unfriendly dtypes
    return leaf.detach().to("cpu", torch.float32 if wide else leaf.dtype, copy=True).numpy()


def _flatten(tree: Tree) -> dict:
    """{key: host array} of every tensor leaf (the host copies happen
    here)."""
    return {_key(path): _host(leaf) for path, leaf in tree_leaves_with_path(tree)}


def save_checkpoint(directory: str, step: int, tree: Tree, *, meta: Optional[dict] = None,
                    async_save: bool = False):
    """Write ``tree`` as ``<directory>/step_<step>``; returns the writing
    thread with ``async_save`` (join it before the next save), else None."""
    d = pathlib.Path(directory)
    tmp = d / f"_tmp_step_{step}"
    final = d / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)

    def _write():
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "n_arrays": len(flat),
            "total_bytes": int(sum(a.nbytes for a in flat.values())),
            "time": time.time(),
            **(meta or {}),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(directory: str) -> Optional[int]:
    """The largest k with a published ``step_<k>`` (one with a manifest)."""
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Tree,
                       shardings: Optional[Tree] = None) -> Tree:
    """Restore into the shape of ``like`` (a tree of tensors): each leaf
    cast to the dtype of ``like``'s and placed on its device.  With
    ``shardings`` (a tree of ``dist.sharding.NamedSharding`` shaped like
    ``like``, whose leaves are this rank's shards) each saved leaf is cut to
    this rank's shard first (the elastic restore: any layout reads any
    checkpoint)."""
    d = pathlib.Path(directory) / f"step_{step}"
    with np.load(d / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}

    def get(path, leaf, sharding=None):
        key = _key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        with warnings.catch_warnings():  # npz members load read-only; .to copies
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(flat[key])
        if sharding is not None:
            t = sharding.local(t)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {tuple(t.shape)}, expected "
                             f"{tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype, copy=True).contiguous()

    if shardings is None:
        return tree_map_with_path(get, like)
    return tree_map_with_path(get, like, shardings)

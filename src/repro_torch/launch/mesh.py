"""Meshes over the ranks of ``torch.distributed`` (the port's
``repro/launch/mesh.py``).

JAX builds a ``jax.sharding.Mesh`` over devices; here a ``Mesh`` is a named
grid over the processes of the default process group: ``shape`` maps the
axis names (outermost first, JAX's order ``pod``, ``data``, ``model``) to
their extents, rank r sits at the row-major coordinates of r, and every
subset of the axes that spans more than one rank has a process group per
slice (``group``; over gloo ``GLOO_LANES`` of them, ``lanes``), made at
construction by every rank in the same order.
Without a process group the mesh has one rank and every collective over it
is the identity.  ``DryRunMesh`` is a mesh of any shape seen from one rank
with no process group at all (the dry run's counterpart of JAX's 512
placeholder devices): its ``group`` is the marker ``DRY_RUN``, on which
every collective of ``dist.collectives`` records itself and returns a meta
tensor of its result's shape.

``init_distributed`` starts the process group from ``torchrun``'s
environment: NCCL when each rank has a card of its own, gloo on the CPU or
when ranks share a card (NCCL refuses two ranks on one device; a CUDA
tensor then crosses gloo through host memory, ``dist.collectives``).  A
failed init raises; nothing falls back to another backend.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Optional

import torch
import torch.distributed as dist


# Process groups a slice of the mesh gets over gloo.  Gloo carries one
# operation of a group at a time; chunks of one collective on several groups
# move at once (two ranks sharing an H100: an all-reduce of 1 GB 0.76 ->
# 2.95 GB/s with four, PERF.md).
GLOO_LANES = 4


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A named grid of ranks (JAX's ``Mesh``): ``shape`` (axis -> extent,
    outermost first), ``axis_names``, this rank's ``coords``, and a process
    group per slice of every axis subset wider than one rank."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank, world = _world()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks; the world has {world}")
        self.backend = dist.get_backend() if world > 1 else None
        self.coords = {}
        stride = self.size
        for a in self.axis_names:
            stride //= self.shape[a]
            self.coords[a] = (self.rank // stride) % self.shape[a]
        self._groups: dict = {}
        if world == 1:
            return
        # over gloo every slice has GLOO_LANES groups: a large collective
        # splits into chunks carried by all of them at once
        n_lanes = GLOO_LANES if self.backend == "gloo" else 1
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                others = [a for a in names if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    pin = dict(zip(others, fixed))
                    ranks = [self._rank_at({**pin, **dict(zip(axes, c))})
                             for c in itertools.product(*(range(self.shape[a]) for a in axes))]
                    # every rank makes every group
                    lanes = [dist.new_group(ranks) for _ in range(n_lanes)]
                    if self.rank in ranks:
                        self._groups[axes] = (lanes, ranks)

    def _rank_at(self, coords: dict) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def extent(self, axes) -> int:
        """Ranks spanned by ``axes`` (one name or several; absent axes 1)."""
        return math.prod(self.shape.get(a, 1) for a in self._key(axes))

    def group(self, axes):
        """This rank's process group over ``axes``; None when they span
        one rank (the collective is then the identity)."""
        entry = self._groups.get(self._key(axes))
        return None if entry is None else entry[0][0]

    def lanes(self, axes) -> list:
        """This rank's process groups over ``axes``, ``group(axes)`` first:
        GLOO_LANES of them over gloo, one over NCCL; empty when the axes
        span one rank."""
        entry = self._groups.get(self._key(axes))
        return [] if entry is None else list(entry[0])

    def ranks(self, axes) -> list:
        """Global ranks of this rank's group over ``axes``, in the axes'
        row-major order."""
        entry = self._groups.get(self._key(axes))
        return [self.rank] if entry is None else list(entry[1])

    def index(self, axes) -> int:
        """This rank's position in its group over ``axes``."""
        i = 0
        for a in self._key(axes):
            i = i * self.shape[a] + self.coords[a]
        return i


# The group a ``DryRunMesh`` hands the collectives: they record themselves
# (``core/op_cost``) instead of moving data.
DRY_RUN = "dry-run"


class DryRunMesh(Mesh):
    """A mesh of ``shape`` (the production (data 16, model 16) or (pod 2,
    data 16, model 16), or any other) seen from the rank at ``coords``
    (default the first), with no process group: ``group`` returns
    ``DRY_RUN`` for axes wider than one rank, and nothing here or in the
    collectives touches ``torch.distributed``."""

    backend = None

    def __init__(self, shape: dict, coords: Optional[dict] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.coords = {a: 0 for a in self.axis_names}
        self.coords.update(coords or {})
        if any(not 0 <= self.coords[a] < self.shape[a] for a in self.axis_names):
            raise ValueError(f"coords {self.coords} outside mesh {self.shape}")
        self.rank = self._rank_at(self.coords)
        self._groups = {}

    def group(self, axes):
        return DRY_RUN if self.extent(axes) > 1 else None

    def lanes(self, axes) -> list:
        return [DRY_RUN] if self.extent(axes) > 1 else []

    def ranks(self, axes) -> list:
        key = self._key(axes)
        return [self._rank_at({**self.coords, **dict(zip(key, c))})
                for c in itertools.product(*(range(self.shape[a]) for a in key))]


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` on the card,
    else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def pick_backend(device) -> str:
    """NCCL when each rank of this host has a card of its own; gloo on the
    CPU, or when ranks share a card."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(device="cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> Optional[str]:
    """Start the default process group unless one is running; returns its
    backend, or None for a single process (no ``WORLD_SIZE`` in the
    environment and no ``world_size`` given).  ``torchrun`` sets the
    environment; a caller that spawns its own ranks passes ``init_method``,
    ``rank`` and ``world_size``.  The backend is ``pick_backend``'s unless
    named.  Any failure raises."""
    if dist.is_initialized():
        return dist.get_backend()
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return None
    backend = backend or pick_backend(device)
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if init_method is None else {"init_method": init_method}
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    dist.init_process_group(backend, **kw)
    # one all-reduce proves the backend moves data before any step relies on it
    probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != dist.get_world_size():
        raise RuntimeError(f"{backend} all-reduce probe gave {probe.item()}")
    return backend


def make_production_mesh(*, multi_pod: bool = False, n_pods: int = 2) -> Mesh:
    """(data 16, model 16), or (pod n_pods, data 16, model 16): raises
    unless the world has exactly those 256 or 512 ranks."""
    shape = {"pod": n_pods, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    need = math.prod(shape.values())
    world = _world()[1]
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; the world has {world}")
    return Mesh(shape)


def mesh_axes_dict(mesh) -> dict:
    return dict(mesh.shape)


def host_mesh_shape(n: int, *, pod: int = 1, data: int = 1) -> dict:
    """The extents of ``make_host_mesh`` over ``n`` ranks.

    ``pod=1, data=1``: (data 1, model N).  ``data>1``: (data, model N/data).
    ``pod>1``: (pod, data, model N/(pod*data)), the pipeline topology,
    optionally with data parallelism inside each stage."""
    if pod > 1:
        if n % (pod * data):
            raise ValueError(f"{n} ranks do not split into {pod} pods x {data} dp")
        return {"pod": pod, "data": data, "model": n // (pod * data)}
    if data > 1:
        if n % data:
            raise ValueError(f"{n} ranks do not split into data={data}")
        return {"data": data, "model": n // data}
    return {"data": 1, "model": n}


def make_host_mesh(*, pod: int = 1, data: int = 1) -> Mesh:
    """Every rank of the world as a mesh, as JAX's over host devices, with
    the extents ``host_mesh_shape`` gives."""
    return Mesh(host_mesh_shape(_world()[1], pod=pod, data=data))


def make_pipeline_mesh(n_stage: int = 0) -> Mesh:
    """A 1-D ("pod",) mesh for ``pipeline_forward`` (n_stage=0: all ranks)."""
    return Mesh({"pod": n_stage or _world()[1]})

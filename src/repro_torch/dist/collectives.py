"""Manual collectives over a ``launch.mesh.Mesh`` (the port's
``repro/dist/collectives.py``).

JAX writes these inside ``shard_map`` and differentiates them through
``lax.scan``.  Here every function runs on this rank's local shard, the
view a ``shard_map`` body has, and each differentiable one is a
``torch.autograd.Function`` with its backward written out:

``ring_gather_matmul`` / ``overlap_all_gather_matmul``
    The all-gather-then-matmul as a ring: each rank multiplies the chunk it
    holds while it forwards it to its neighbour (``n - 1`` exchanges, no
    all-gather).  The backward is a reverse ring of partial products
    (``dout_j @ w^T`` summed as it travels, a reduce-scatter by ring) and a
    local ``x^T @ dout`` for the weight.
``seq_scatter``
    The row-parallel partials summed and handed back as each rank's
    sequence chunk (``reduce_scatter_tensor``); its backward is an
    all-gather.
``compressed_psum``
    The gradient sum in a wire format: int8 on a shared ``pmax`` scale,
    summed as int32 words as JAX does; bf16 summed in bf16; otherwise f32.
``fsdp_gather``
    FSDP's gather on use: a weight sharded over data-parallel axes (ZeRO,
    ``dp_over_model``'s split) all-gathered where a layer reads it; its
    backward reduce-scatters the gradient in f32 over the axes that split
    the batch (the data-parallel sum of that leaf, taken here instead of
    after the backward) and keeps this rank's chunk over the others, where
    every rank computed the same gradient.
``column_input`` / ``row_sum``
    Megatron's all-reduce pair for tensor parallelism without SP ("f" and
    "g"): ``column_input`` marks a replicated tensor entering a
    column-parallel block (the identity; its backward sums the ranks'
    partial gradients), ``row_sum`` sums a row-parallel block's partial
    outputs (its backward is the identity).  Both are no-ops on a model
    axis of extent 1.
``tp_gather`` / ``tp_slice``
    The rest of tensor parallelism's traffic in the recurrent blocks:
    ``tp_gather`` makes a column-parallel output whole where a replicated
    product reads it (its backward keeps this rank's block), ``tp_slice``
    takes this rank's block of a whole leaf read per head or per channel
    (its backward gathers the blocks' gradients).

Transport: over NCCL the tensors cross as they are.  Over gloo (ranks that
share a card, or the CPU) a CUDA tensor is copied to pinned host memory,
moved, and copied back, in ``_staged``: that is the transport of ranks
sharing one card, not a fallback, and the compute stays on the card.  A
large collective over gloo is cut into chunks carried by all of the
slice's process groups at once (``Mesh.lanes``; a reduce-scatter as an
in-place all-reduce of which each rank keeps its chunk).  ``STATS``
counts every collective by kind (calls, payload bytes, host seconds) and
every all-reduce by operation and word type (``reduce_ops``, e.g.
``"sum:int32"``); the pair's all-reduces count under kinds of their own,
``"tp_row_sum"`` (g's forward) and ``"tp_grad_sum"`` (f's backward), FSDP's
under ``"fsdp_gather"``, ``"fsdp_regather"`` (a saved weight gathered
again in the backward) and ``"fsdp_scatter"``, the vocab-parallel
cross-entropy's under ``"vocab_max"`` and ``"vocab_sum"`` and the serving
logits' under ``"vocab_gather"``, ``tp_gather`` and ``tp_slice``'s
under their names, for the tests' call counts, the chip script's check
that the int8 wire ran and its collective time.  A staged collective
first synchronizes the card (its host copy would wait for the queued
kernels anyway), so its seconds are the copies and the transport, not the
compute queued before it; over NCCL they are the host's enqueue time.

Dry run: over a ``launch.mesh.DryRunMesh`` (its ``group`` is ``DRY_RUN``)
every collective records itself on the active ``core/op_cost`` recorder,
with JAX's op name (all-reduce, all-gather, reduce-scatter,
collective-permute), its operand bytes on this rank and its group size,
and returns an empty tensor of its result's shape (an all-gather
concatenates the group's copies, a reduce-scatter keeps one chunk).  It
stages nothing and calls no ``torch.distributed`` function; ``STATS``
counts only collectives that moved data.
"""
from __future__ import annotations

import contextlib
import math
import time
import warnings
from collections import Counter
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.op_cost import record_collective, tensor_bytes
from repro_torch.launch.mesh import DRY_RUN
from repro_torch.train.compression import quantize

STATS = {"calls": Counter(), "bytes": Counter(), "seconds": Counter(), "reduce_ops": Counter()}


def reset_stats() -> None:
    for c in STATS.values():
        c.clear()


def _count(kind: str, x: torch.Tensor, seconds: float) -> None:
    STATS["calls"][kind] += 1
    STATS["bytes"][kind] += x.numel() * x.element_size()
    STATS["seconds"][kind] += seconds


def _start(mesh, x: torch.Tensor) -> float:
    """A collective's start time, after the card has finished the kernels
    queued before it when ``x`` is to be staged (see the module's note)."""
    if mesh.backend == "gloo" and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return time.perf_counter()


def _staged(mesh, x: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """The tensor the backend moves: over gloo a CUDA tensor is staged in
    pinned host memory (a copy; ``_arrive`` brings the result back).
    ``copy``: never ``x``'s own storage (the in-place collectives write
    it)."""
    if mesh.backend == "gloo" and x.is_cuda:
        return _host(x.shape, x.dtype, pinned=True).copy_(x.detach())
    x = x.detach().contiguous()
    return x.clone() if copy else x


def _host(shape, dtype, pinned: bool) -> torch.Tensor:
    """A host buffer; pinned for a staged CUDA tensor (the copies then run
    at the bus's rate: ~28 against ~2 GB/s pageable on the H100's host,
    PERF.md)."""
    return torch.empty(shape, dtype=dtype, pin_memory=pinned)


def _arrive(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y if y.device == like.device else y.to(like.device)


# A collective of at least this many bytes over gloo is cut into chunks
# carried by all of the slice's groups at once (``Mesh.lanes``).
LANE_BYTES = 4 << 20


def _lanes(mesh, axes, x: torch.Tensor) -> list:
    lanes = mesh.lanes(axes)
    if mesh.backend != "gloo" or x.numel() * x.element_size() < LANE_BYTES:
        return lanes[:1]
    return lanes


def _wait_all(works) -> None:
    for w in works:
        w.wait()


def _tensor_collective(fn, out, src, group, async_op: bool = False):
    """``fn(out, src, group=group)``; some torch releases mark the
    ``*_tensor`` collectives deprecated, which is not this caller's news."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(out, src, group=group, async_op=async_op)


def _sum_in_place(y: torch.Tensor, lanes: list, op) -> None:
    """``y`` (contiguous, on the host over gloo) reduced in place over the
    groups of ``lanes``, one chunk a group, all at once."""
    if len(lanes) == 1:
        dist.all_reduce(y, op=op, group=lanes[0])
        return
    _wait_all([dist.all_reduce(c, op=op, group=g, async_op=True)
               for c, g in zip(y.view(-1).chunk(len(lanes)), lanes)])


def all_reduce(x: torch.Tensor, axes, mesh, op: str = "sum",
               kind: str = "all_reduce") -> torch.Tensor:
    """Sum (or max) of ``x`` over the ranks of ``axes``; a new tensor,
    counted in ``STATS`` under ``kind``."""
    group = mesh.group(axes)
    if group is None:
        return x.clone()
    if group is DRY_RUN:
        record_collective("all-reduce", tensor_bytes(x), mesh.extent(axes))
        return torch.empty_like(x)
    t0 = _start(mesh, x)
    y = _staged(mesh, x, copy=True)
    _sum_in_place(y, _lanes(mesh, axes, y),
                  dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    y = _arrive(y, x)
    _count(kind, x, time.perf_counter() - t0)
    STATS["reduce_ops"][f"{op}:{str(x.dtype).removeprefix('torch.')}"] += 1
    return y


def all_gather(x: torch.Tensor, axes, mesh, dim: int = 0,
               kind: str = "all_gather") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group order."""
    group = mesh.group(axes)
    if group is None:
        return x.clone()
    n = mesh.extent(axes)
    if group is DRY_RUN:
        record_collective("all-gather", tensor_bytes(x), n)
        shape = list(x.shape)
        shape[dim] *= n
        return x.new_empty(shape)
    t0 = _start(mesh, x)
    src = _staged(mesh, x.movedim(dim, 0).contiguous())
    lanes = _lanes(mesh, axes, src)
    shape = (n * src.shape[0],) + tuple(src.shape[1:])
    if len(lanes) == 1:
        out = src.new_empty(shape)
        _tensor_collective(dist.all_gather_into_tensor, out, src, lanes[0])
    else:  # each group gathers one chunk of every rank's x; then (rank, chunk) order
        parts = src.view(-1).chunk(len(lanes))
        outs = [p.new_empty(n * p.numel()) for p in parts]
        _wait_all([_tensor_collective(dist.all_gather_into_tensor, o, p, g, async_op=True)
                   for o, p, g in zip(outs, parts, lanes)])
        out = _host((n, src.numel()), src.dtype, pinned=x.is_cuda)
        torch.cat([o.view(n, -1) for o in outs], dim=1, out=out)
        out = out.view(shape)
    y = _arrive(out, x).movedim(0, dim)
    _count(kind, x, time.perf_counter() - t0)
    return y


def reduce_scatter(x: torch.Tensor, axes, mesh, dim: int = 0,
                   kind: str = "reduce_scatter") -> torch.Tensor:
    """The ranks' ``x`` summed, this rank's chunk of ``dim`` returned.  A
    large one over gloo sums the whole in place over the slice's groups and
    keeps this rank's chunk (gloo's all-reduce outruns its reduce-scatter)."""
    group = mesh.group(axes)
    if group is None:
        return x.clone()
    n = mesh.extent(axes)
    if group is DRY_RUN:
        record_collective("reduce-scatter", tensor_bytes(x), n)
        shape = list(x.shape)
        shape[dim] //= n
        return x.new_empty(shape)
    t0 = _start(mesh, x)
    src = _staged(mesh, x.movedim(dim, 0).contiguous(), copy=True)
    lanes = _lanes(mesh, axes, src)
    c = src.shape[0] // n
    if mesh.backend != "gloo" or len(lanes) == 1:
        out = src.new_empty((c,) + tuple(src.shape[1:]))
        _tensor_collective(dist.reduce_scatter_tensor, out, src, lanes[0])
    else:
        _sum_in_place(src, lanes, dist.ReduceOp.SUM)
        out = src.narrow(0, mesh.index(axes) * c, c)
    y = _arrive(out, x).movedim(0, dim)
    _count(kind, x, time.perf_counter() - t0)
    return y


class _Exchange:
    """One point-to-point step: send ``x`` to rank ``dst`` and receive a
    tensor of its shape from rank ``src`` (either may be None), started
    now and finished by ``wait`` so compute can run in between."""

    def __init__(self, mesh, axes, x: torch.Tensor, dst, src):
        self.mesh, self.like, self.t0 = mesh, x, _start(mesh, x)
        g = mesh.group(axes)
        self.dry = g is DRY_RUN
        if self.dry:  # the pair's send, one collective-permute of the axis
            record_collective("collective-permute", tensor_bytes(x), mesh.extent(axes))
            self.recv = torch.empty_like(x) if src is not None else None
            return
        self.out = _staged(mesh, x)
        send = self.out
        self.recv = torch.zeros_like(send) if src is not None else None
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send, dst, g))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, self.recv, src, g))
        self.reqs = dist.batch_isend_irecv(ops) if ops else []
        self.seconds = time.perf_counter() - self.t0

    def wait(self):
        if self.dry:
            return self.recv
        t0 = _start(self.mesh, self.like)  # the compute queued since the start is not counted
        for r in self.reqs:
            r.wait()
        got = None if self.recv is None else _arrive(self.recv, self.like)
        _count("permute", self.like, self.seconds + time.perf_counter() - t0)
        return got


def permute(x: torch.Tensor, axes, mesh, dst, src):
    """Send ``x`` to ``dst``, receive from ``src`` (global ranks, None for
    neither); returns what arrived, zeros without a source (JAX's
    ``ppermute`` leaves zeros where no pair sends)."""
    got = _Exchange(mesh, axes, x, dst, src).wait()
    return torch.zeros_like(x) if got is None else got


def _ring_peers(mesh, axis: str, n: int):
    idx, ranks = mesh.index(axis), mesh.ranks(axis)
    return idx, ranks[(idx + 1) % n], ranks[(idx - 1) % n]


class _RingGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, wi, mesh, axis, n, gather_dim):
        idx, nxt, prv = _ring_peers(mesh, axis, n)
        c = xi.shape[gather_dim]
        out_shape = list(xi.shape)
        out_shape[gather_dim] = c * n
        out_shape[-1] = wi.shape[1]
        out = xi.new_empty(out_shape)
        chunks = [None] * n
        chunk = xi
        for i in range(n):
            src = (idx - i) % n  # origin of the chunk held now
            ex = _Exchange(mesh, axis, chunk, nxt, prv) if i < n - 1 else None
            out.narrow(gather_dim, src * c, c).copy_(chunk @ wi)
            chunks[src] = chunk
            if ex is not None:
                chunk = ex.wait()
        ctx.save_for_backward(wi, *chunks)
        ctx.args = (mesh, axis, n, gather_dim, c)
        return out

    @staticmethod
    def backward(ctx, dout):
        wi, *chunks = ctx.saved_tensors
        mesh, axis, n, gather_dim, c = ctx.args
        idx, nxt, prv = _ring_peers(mesh, axis, n)
        dout = dout.contiguous()
        K, N = wi.shape
        x_full = torch.cat(chunks, dim=gather_dim)
        dw = x_full.reshape(-1, K).T @ dout.reshape(-1, N)
        wt = wi.T
        acc, ex = None, None
        for s in range(n):
            # step s adds this rank's product into the partial of chunk
            # idx - 1 - s; after n steps the partial of chunk idx is home
            part = dout.narrow(gather_dim, ((idx - 1 - s) % n) * c, c) @ wt
            acc = part if ex is None else ex.wait() + part
            ex = _Exchange(mesh, axis, acc, nxt, prv) if s < n - 1 else None
        return acc, dw, None, None, None, None


def ring_gather_matmul(xi, wi, axis: str, n: int, gather_dim: int = 0, *, mesh):
    """``xi`` (this rank's chunk of x along ``gather_dim``: 0 for (m, K)
    rows, 1 for (B, s, K) sequence) gathered over ``axis`` while multiplied
    by this rank's (K, N) weight shard ``wi``: after ``n`` steps every rank
    holds the full ``x @ wi``, and no all-gather of x was made.  ``n - 1``
    exchanges; differentiable."""
    if n == 1:
        return xi @ wi
    return _RingGatherMatmul.apply(xi, wi, mesh, axis, n, gather_dim)


def overlap_all_gather_matmul(mesh, x, w, axis: str = "model"):
    """``x @ w`` with x row-sharded over ``axis`` (``x`` is this rank's
    rows) and w replicated: the replicated (M, N) product on every rank."""
    return ring_gather_matmul(x, w, axis, mesh.extent(axis), gather_dim=0, mesh=mesh)


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return reduce_scatter(partial, axis, mesh, dim)

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, dim = ctx.args
        return all_gather(dy.contiguous(), axis, mesh, dim), None, None, None


def seq_scatter(partial, axis: str, scatter_dim: int = 1, *, mesh):
    """Row-parallel partials summed over ``axis``, this rank's chunk of
    ``scatter_dim`` returned (the Megatron-SP reduce-scatter)."""
    if mesh.extent(axis) == 1:
        return partial
    return _SeqScatter.apply(partial, mesh, axis, scatter_dim)


class _SeqGather(torch.autograd.Function):
    """The chunks of ``dim`` gathered; every rank's gradient of the whole is
    the same (the loss after it is replicated), so its backward keeps this
    rank's chunk."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, kind="all_gather"):
        ctx.args = (mesh, axis, dim, x.shape[dim])
        return all_gather(x, axis, mesh, dim, kind=kind)

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, dim, c = ctx.args
        return dy.narrow(dim, mesh.index(axis) * c, c).contiguous(), None, None, None, None


class _SeqChunk(torch.autograd.Function):
    """This rank's chunk of a replicated tensor; the backward gathers every
    rank's chunk gradient, so the replicated producer gets the whole."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, kind="all_gather"):
        n = mesh.extent(axis)
        c = x.shape[dim] // n
        ctx.args = (mesh, axis, dim, kind)
        return x.narrow(dim, mesh.index(axis) * c, c).contiguous()

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, dim, kind = ctx.args
        return all_gather(dy.contiguous(), axis, mesh, dim, kind=kind), None, None, None, None


class _Replicated(torch.autograd.Function):
    """A replicated input of a manual region: the identity, whose backward
    sums the ranks' gradients (the transpose of JAX's implicit broadcast of
    an unsharded ``shard_map`` input).  Megatron's "f"."""

    @staticmethod
    def forward(ctx, x, mesh, axis, kind="all_reduce"):
        ctx.args = (mesh, axis, kind)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, kind = ctx.args
        return all_reduce(dy.contiguous(), axis, mesh, kind=kind), None, None, None


class _RowSum(torch.autograd.Function):
    """Row-parallel partial outputs summed over the ranks; the sum is
    replicated, so each rank's gradient of its partial is the gradient of
    the whole: the identity going back.  Megatron's "g", f's transpose."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, axis, mesh, kind="tp_row_sum")

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _PSum(torch.autograd.Function):
    """A sum over the ranks whose consumers each hold a share of the loss
    (JAX's ``psum``): its transpose is a sum over the ranks too."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return all_reduce(x, axes, mesh, kind="batch_mean")

    @staticmethod
    def backward(ctx, dy):
        mesh, axes = ctx.args
        return all_reduce(dy.contiguous(), axes, mesh, kind="batch_mean"), None, None


def _spec_dims(spec: tuple, ndim: int) -> tuple:
    """(dim, axes) of every sharded entry of ``spec``, which indexes the last
    ``len(spec)`` dims of an ``ndim``-dim tensor."""
    off = ndim - len(spec)
    return tuple((off + i, e if isinstance(e, tuple) else (e,))
                 for i, e in enumerate(spec) if e is not None)


def gather_whole(w: torch.Tensor, spec: tuple, mesh, kind: str = "fsdp_gather") -> torch.Tensor:
    """The whole of ``w`` (this rank's shard under ``spec``), not recorded by
    autograd: FSDP's gather, and its repeat in the backward."""
    for d, axes in _spec_dims(spec, w.ndim):
        w = all_gather(w.contiguous(), axes, mesh, dim=d, kind=kind)
    return w


def _scatter_entry(g: torch.Tensor, d: int, axes: tuple, summed, mesh) -> torch.Tensor:
    """This rank's chunk of dim ``d`` of the whole gradient ``g``, cut over
    ``axes`` as ``local_shard`` cuts it: summed over the axes in ``summed``
    (a reduce-scatter), taken as it is over the others."""
    n = [mesh.extent(a) for a in axes]
    g = g.unflatten(d, (*n, g.shape[d] // math.prod(n)))
    for j in reversed(range(len(axes))):
        if axes[j] not in summed:
            g = g.select(d + j, mesh.coords[axes[j]])
    keep = tuple(a for a in axes if a in summed)
    g = g.flatten(d, d + len(keep))
    return reduce_scatter(g.contiguous(), keep, mesh, dim=d, kind="fsdp_scatter") if keep else g


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, spec, mesh, summed):
        ctx.args = (spec, mesh, summed)
        return gather_whole(w, spec, mesh)

    @staticmethod
    def backward(ctx, dw):
        spec, mesh, summed = ctx.args
        g = dw.float()  # summed in f32, as the replicated path sums
        for d, axes in reversed(_spec_dims(spec, g.ndim)):
            g = _scatter_entry(g, d, axes, summed, mesh)
        return g.contiguous(), None, None, None


def fsdp_gather(w: torch.Tensor, spec: Optional[tuple], mesh, summed=()) -> torch.Tensor:
    """FSDP's gather on use: ``w`` (this rank's shard, cut over ``spec``'s
    data-parallel axes) made whole for the layer that reads it
    (``STATS`` kind ``"fsdp_gather"``).  The backward reduce-scatters the
    gradient in f32 over the axes of ``summed`` (those that split the batch:
    the data-parallel sum of this leaf) and keeps this rank's chunk over the
    spec's other axes (``"fsdp_scatter"``); autograd hands the leaf its own
    dtype.  The identity where ``spec`` shards nothing."""
    if spec is None or all(mesh.extent(axes) == 1 for _, axes in _spec_dims(spec, w.ndim)):
        return w
    return _FSDPGather.apply(w, tuple(spec), mesh, frozenset(summed))


def _storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its views share it); not its data
    pointer, which is 0 for every meta tensor."""
    return t.untyped_storage()._cdata


class FSDPGathers:
    """FSDP's gathers for one pass of the model (``models.transformer``):
    ``specs`` is shaped like the parameters, each leaf's gather spec
    (``Shardings.gather_spec``) or None, and ``summed`` the axes that split
    the pass's batch (``fsdp_gather``'s backward sums over those).

    ``tree`` gathers a subtree where its leaves are read (a stacked group at
    its entry, a tail layer, the embedding and head before the pass).
    Inside ``saved_as_shards`` autograd keeps a gathered weight that a
    product saves for its backward as the shard it came from and gathers
    it again when the backward reads it (a saved-tensor hook pair), so a
    pass without remat does not hold every whole weight until the
    backward; under remat ``torch.utils.checkpoint`` already drops them."""

    def __init__(self, mesh, specs, summed=()):
        self.mesh, self.specs, self.summed = mesh, specs, tuple(summed or ())
        self._live: Optional[dict] = None

    def tree(self, tree, specs):
        from repro_torch.train.optimizer import tree_map

        def one(w, spec):
            if spec is None:
                return w
            whole = fsdp_gather(w, spec, self.mesh, self.summed)
            if self._live is not None and whole is not w:
                self._live[_storage_key(whole)] = (w, spec)
            return whole

        return tree if specs is None else tree_map(one, tree, specs)

    def top(self, params: dict) -> dict:
        """``params`` with every leaf outside the layer stacks (the
        embedding, the head) gathered."""
        return {k: v if k in ("blocks", "encoder") else self.tree(v, self.specs[k])
                for k, v in params.items()}

    @contextlib.contextmanager
    def saved_as_shards(self):
        if not torch.is_grad_enabled():
            yield
            return
        live = self._live = {}

        def pack(t):
            src = live.get(_storage_key(t)) if t.numel() else None
            if src is None:
                return t
            return _Regather(*src, t.size(), t.stride(), t.storage_offset())

        def unpack(saved):
            if not isinstance(saved, _Regather):
                return saved
            whole = gather_whole(saved.shard.detach(), saved.spec, self.mesh,
                                 kind="fsdp_regather")
            return whole.as_strided(saved.size, saved.stride, saved.offset)

        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                yield
        finally:
            self._live = None
            live.clear()


class _Regather(NamedTuple):
    """A saved gathered weight, kept as its shard: the view the backward
    reads is rebuilt on the gathered tensor's storage layout."""

    shard: torch.Tensor
    spec: tuple
    size: torch.Size
    stride: tuple
    offset: int


class _MeanOver(torch.autograd.Function):
    """The mean of a per-rank value over ``axes``; the same on every rank,
    so each rank's backward passes 1/n of the gradient to its own term."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        n = mesh.extent(axes)
        ctx.n = n
        return all_reduce(x, axes, mesh) / n

    @staticmethod
    def backward(ctx, dy):
        return dy / ctx.n, None, None


def _manual(fn, x, mesh, *args):
    return x if mesh is None or mesh.extent(args[0]) == 1 else fn.apply(x, mesh, *args)


def seq_gather(x, axis: str, dim: int, *, mesh):
    """The whole of ``dim`` from every rank's chunk (differentiable)."""
    return _manual(_SeqGather, x, mesh, axis, dim)


def seq_chunk(x, axis: str, dim: int, *, mesh):
    """This rank's chunk of ``dim`` of a replicated ``x`` (differentiable)."""
    return _manual(_SeqChunk, x, mesh, axis, dim)


def tp_gather(x, dim: int, axis: str = "model", *, mesh):
    """A column-parallel block's output columns, this rank's ``dim`` block,
    gathered whole where a replicated product reads them (RWKV-6's
    channel-mix gate; ``STATS`` kind ``"tp_gather"``).  The backward keeps
    this rank's block of the (replicated) gradient."""
    return _manual(_SeqGather, x, mesh, axis, dim % x.ndim, "tp_gather")


def tp_slice(x, dim: int, axis: str = "model", *, mesh):
    """This rank's block of ``dim`` of a whole (replicated) leaf that a
    sharded block reads in part: the per-head or per-channel leaves of
    RWKV-6's time-mix and of the RG-LRU.  The backward gathers every rank's
    block gradient (``STATS`` kind ``"tp_slice"``), so each rank's gradient
    of the leaf is the whole one."""
    return _manual(_SeqChunk, x, mesh, axis, dim % x.ndim, "tp_slice")


def replicated(x, axis, *, mesh):
    """``x`` as a replicated input of a manual region over ``axis``: its
    gradient is summed over the ranks."""
    return _manual(_Replicated, x, mesh, axis, "all_reduce")


def column_input(x, axis: str = "model", *, mesh):
    """f: ``x`` (replicated over ``axis``) entering a column-parallel block;
    the backward sums the ranks' partial gradients of ``x`` (``STATS`` kind
    ``"tp_grad_sum"``)."""
    if mesh is None or mesh.extent(axis) == 1:
        return x
    return _Replicated.apply(x, mesh, axis, "tp_grad_sum")


def row_sum(x, axis: str = "model", *, mesh):
    """g: a row-parallel block's partial output summed over ``axis``
    (``STATS`` kind ``"tp_row_sum"``); the backward is the identity."""
    if mesh is None or mesh.extent(axis) == 1:
        return x
    return _RowSum.apply(x, mesh, axis)


def batch_mean(x, axes, *, mesh):
    """The mean over the ranks of ``axes`` of a per-rank statistic of their
    rows (an MoE layer's mean router probabilities): the whole batch's, on
    every rank.  Each rank's loss carries 1/n of what is computed from it,
    so the backward sums the ranks' gradients (``STATS`` kind
    ``"batch_mean"``, both ways)."""
    if mesh is None or not axes or mesh.extent(axes) == 1:
        return x
    return _PSum.apply(x, mesh, axes) / mesh.extent(axes)


def mean_over(x, axes, *, mesh):
    """The mean over the ranks of ``axes`` (differentiable)."""
    if mesh is None or not axes or mesh.extent(axes) == 1:
        return x
    return _MeanOver.apply(x, mesh, axes)


def compressed_psum(g, axis, mode: str = "int8", *, mesh):
    """Cross-replica gradient sum with a compressed wire format; ``axis`` is
    one name or a tuple.  int8: one scalar max over the ranks sets a shared
    grid (``train/compression.quantize`` with that scale), the ranks' int8
    payloads are summed as int32 words, and one multiply gives f32.  bf16:
    the sum itself runs in bf16, then f32.  Otherwise an f32 sum."""
    if mode == "bf16":
        q, _ = quantize(g, mode)
        return all_reduce(q, axis, mesh).float()
    if mode == "int8":
        g32 = g.float()
        amax = all_reduce(g32.abs().max(), axis, mesh, op="max")  # shared grid scale
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q, _ = quantize(g32, mode, scale=scale)
        return all_reduce(q.to(torch.int32), axis, mesh).float() * scale
    return all_reduce(g, axis, mesh)


def wire_bytes(n_elements: int, mode: str) -> int:
    """Bytes one replica puts on the wire per exchange for ``n_elements``
    gradient values: int8 counts the narrow-wire payload (1 byte + the
    amortized scale), not the int32 words the sum moves."""
    per = {"bf16": 2, "int8": 1}.get(mode, 4)
    return n_elements * per + (4 if mode == "int8" else 0)

"""What one traced step does, counted op by op (the port's counterpart of
``repro/core/hlo_cost.py``).

JAX compiles a step and walks the optimized HLO.  PyTorch has no compiler
to ask: the dry run runs one rank's step eagerly on the ``meta`` device
(shapes, no storage) under ``OpRecorder``, a ``TorchDispatchMode`` that
sees every aten op the step issues and counts:

* FLOPs of every matrix product (``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``
  / convolution, by ``torch.utils.flop_counter``'s formulas), as the HLO
  walker counts ``dot`` and ``convolution``;
* HBM bytes: each op's output plus its inputs (views and allocations move
  nothing; a gather reads only what it returns and a scatter writes only
  its update, JAX's rules for ``gather`` / ``scatter``).  In eager mode
  every op is top level, so this is an upper bound, as JAX's count at the
  CPU backend's fusion boundaries is;
* each hand-written kernel's entry as one op with its own cost
  (``record_kernel``, called by the kernels' meta routes: their ``cost()``
  gives the flops and bytes that ``PERF.md``'s bounds count);
* each collective over a ``launch.mesh.DryRunMesh``, with JAX's op name,
  its operand bytes per device and its group size (``record_collective``,
  called by ``dist.collectives``' dry-run route);
* live bytes: every storage the step makes is tracked until it is freed
  (a ``weakref.finalize`` on the storage's Python object, which PyTorch
  keeps alive as long as the storage), and the high-water mark is the
  step's temporary bytes (JAX's ``temp_size``).
  The step's arguments (``external``) are its argument bytes, not
  temporaries: views of them and in-place updates of them count nothing.

``OpCost`` has JAX's ``HloCost`` fields (``flops``, ``hbm_bytes``,
``collectives`` as (op, operand bytes, group size, multiplier) and
``collective_operand_bytes``) and the kernel calls beside them.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_aten = torch.ops.aten
# Allocations: they move no bytes (JAX's HLO has no op for them).
_ALLOC = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
          _aten.new_empty_strided}
# Reads of what they return only (HLO ``gather``).
_GATHER = {_aten.index, _aten.gather, _aten.embedding, _aten.index_select}
# Writes of their update only (HLO ``scatter`` / ``dynamic-update-slice``).
_SCATTER = {_aten.index_put, _aten.index_put_, _aten._index_put_impl_, _aten.scatter,
            _aten.scatter_, _aten.scatter_add, _aten.scatter_add_, _aten.index_add,
            _aten.index_add_, _aten.index_copy_}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of a tree of tuples, lists, dicts and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input that it does not write."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


@dataclasses.dataclass
class OpCost:
    """What a traced step did (per device: one rank's step)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)  # (op, bytes, g, multiplier)
    kernels: dict = dataclasses.field(default_factory=dict)  # name -> calls, flops, bytes
    peak_bytes: float = 0.0  # high-water mark of the live bytes the step made

    @property
    def collective_operand_bytes(self) -> float:
        return sum(b * m for _, b, _, m in self.collectives)

    def kernel_calls(self) -> dict:
        return {k: v["calls"] for k, v in self.kernels.items()}


_ACTIVE: list = []  # the recorders entered, innermost last


class OpRecorder(TorchDispatchMode):
    """Counts the aten ops, kernel entries and collectives of what runs
    inside it (``with OpRecorder() as rec: ...``; then ``rec.cost``).
    ``external``: a tree of the step's arguments, whose storage is not the
    step's to count as live."""

    def __init__(self, external=None):
        super().__init__()
        self.cost = OpCost()
        self._colls: Counter = Counter()
        self._external = {t.untyped_storage()._cdata for t in _tensors(external)}
        self._live: dict = {}  # live storage -> its bytes
        self._cur = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self.cost.collectives = [(op, b, g, m) for (op, b, g), m in self._colls.items()]
        return super().__exit__(*exc)

    # ------------------------------------------------------------ live bytes
    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed: a storage's
        Python object lives as long as the storage does, so a finalizer on
        it fires when the last tensor holding it (a view, a tensor autograd
        saved) lets go."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._external or key in self._live:
            return
        self._live[key] = storage.nbytes()
        self._cur += self._live[key]
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._cur)
        weakref.finalize(storage, self._release, key)

    def _release(self, key) -> None:
        self._cur -= self._live.pop(key)

    # ------------------------------------------------------------------ ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        packet = func._overloadpacket
        if packet in _ALLOC or _is_view(func):
            return out
        if packet in flop_registry:
            self.cost.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in _GATHER:
            nbytes = 2 * sum(tensor_bytes(t) for t in outs)
        elif packet in _SCATTER:
            ins = _tensors(args)
            nbytes = 2 * tensor_bytes(ins[-1]) if ins else 0
        else:
            nbytes = (sum(tensor_bytes(t) for t in outs)
                      + sum(tensor_bytes(t) for t in _tensors((args, kwargs))))
        self.cost.hbm_bytes += nbytes
        return out

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.cost.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.cost.flops += flops
        self.cost.hbm_bytes += nbytes

    def collective(self, op: str, operand_bytes: int, group: int) -> None:
        if op not in COLLECTIVE_OPS:
            raise ValueError(f"collective {op!r}: one of {COLLECTIVE_OPS}")
        self._colls[(op, int(operand_bytes), int(group))] += 1


def _innermost() -> Optional[OpRecorder]:
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """One call of hand-written kernel ``name`` with its ``cost()``, counted
    by the recorder that is active (none: nothing to count)."""
    rec = _innermost()
    if rec is not None:
        rec.kernel(name, flops, nbytes)


def record_collective(op: str, operand_bytes: int, group: int) -> None:
    """One collective (JAX's op name, operand bytes per device, group size)
    on the active recorder."""
    rec = _innermost()
    if rec is not None:
        rec.collective(op, operand_bytes, group)


def analyze_step(fn, *args) -> tuple:
    """Run ``fn(*args)`` (meta tensors) under an ``OpRecorder`` and
    ``torch.utils.flop_counter.FlopCounterMode``; returns (its result, the
    ``OpCost``, the flop counter's total).  The flop counter sees the aten
    matrix products only: the kernels' meta routes issue none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, OpRecorder(external=args) as rec:
        out = fn(*args)
    return out, rec.cost, float(counter.get_total_flops())

"""Plan -> partition specs (the port's ``repro/dist/sharding.py``).

``Shardings`` turns the ExecutionPlan's SPATIAL / TEMPORAL decision into
Megatron-oriented parameter specs (column-parallel QKV / up projections,
row-parallel output / down projections), decode-cache specs, batch specs
and activation specs, every one through the ``_fit`` divisibility safety
net.  A spec is a tuple with one entry per dimension: None, an axis name,
or a tuple of axis names (JAX's ``PartitionSpec``).  The spec methods read
only ``mesh.shape``, so a shape-only mesh serves them.

JAX hands the specs to GSPMD, which places and moves the arrays.  The port
has no global arrays: each rank holds its local shard, and ``NamedSharding``
/ ``place`` / ``gather`` cut and reassemble those shards by spec and mesh
coordinates (the counterpart of ``jax.device_put`` on ``NamedSharding``s).
The port's manual paths execute ``param_spec``'s layout
(``manual_param_spec``), but for the exceptions ROADMAP lists by name
(below).  Its shards are of two kinds:

* model shards that a layer computes on: the Megatron-SP stack's, tensor
  parallelism without SP (every layer's column / row shards and MoE's
  expert or width split, with Megatron's all-reduce pair,
  ``dist.collectives.column_input`` / ``row_sum``) and, under both, the
  embedding's and LM head's ``vocab`` split (a vocab-parallel lookup and
  cross-entropy, ``models/transformer.py``); the pipeline's per-stage
  slices of the stack (``pod`` on its leading dim, never gathered);
* shards over the data-parallel axes (``fsdp_axes``: ZeRO's ``data`` on the
  complementary dim, TEMPORAL's dp axes on the last dim, the embedding and
  head over ``model`` where ``dp_over_model`` folds it into data
  parallelism): FSDP, each gathered where a layer reads it
  (``dist.collectives.fsdp_gather``, ``gather_spec``) and its gradient
  reduce-scattered in the backward.  Under the pipeline a stage's slice
  carries both: ``pod`` on the group dim and the data split on its ZeRO
  dim, made whole over the data axes at the stage's entry.

Under tensor parallelism each block of a layer, in the decoder and in an
encoder-decoder's encoder, runs on this rank's shards where its heads
divide over ``model`` and whole elsewhere (JAX's ``_fit`` cuts mid-head
there and GSPMD repairs it): attention and cross-attention where the query
and KV heads both divide (``attention_sharded``), an RWKV-6 time-mix or
RG-LRU block where its ``rnn_heads`` do (``recurrent_sharded``); the leaf
names under ``attn`` say which block it is (``block_sharded``).  The
whole leaves such a block reads per head or per channel (RWKV-6's ``u``,
``w0``, the group norm, ``lora_b``'s columns; the RG-LRU's conv, gates and
``lam``) stay whole on every rank, which reads its block of them
(``dist.collectives.tp_slice``).  The fused ``wqkv`` is cut head-aligned
(``QKVSharding``): each rank holds its own heads' q, k and v columns, not
GSPMD's contiguous column block; a data split of its rows composes with
that cut.  Megatron-SP's tail layers run replicated.  ``unexecuted_layout``
names the one plan no manual path runs, ZeRO weights under Megatron-SP,
which the reference cannot run either.  ``constrain`` has nothing to do
here: there is no compiler to hint, each activation already lives where
the manual path put it.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.core.plan import SPATIAL, ExecutionPlan
from repro_torch.train.optimizer import tree_map, tree_map_with_path

Tree = Any

logger = logging.getLogger(__name__)

# Megatron orientation by leaf name.  Column-parallel weights shard their
# output (last) dim; row-parallel weights shard their input (second-to-last)
# dim so the pair needs one collective per stage, not two.
COLUMN_PARALLEL = frozenset(
    {"wqkv", "wq", "wk", "wv", "w1", "w3", "w_x", "w_g", "w_r", "w_k", "w_v"}
)
ROW_PARALLEL = frozenset({"wo", "w2", "w_out", "w_o"})

ACT_NAMES = ("act_hidden", "act_heads", "act_kv", "act_heads_flat")

# The sharded leaves of the recurrent blocks JAX stores under ``attn`` (the
# RG-LRU's and RWKV-6's time-mix); attention's are ``wqkv`` / ``wq`` / ``wk``
# / ``wv`` / ``wo``.
RECURRENT_SHARDED = frozenset({"w_x", "w_g", "w_out", "w_r", "w_k", "w_v", "w_o"})


class PartitionSpec(tuple):
    """A partition spec (JAX's): one entry per dimension, None, an axis name
    or a tuple of them; a leaf to the tree walkers."""

    tree_leaf = True

    def __repr__(self) -> str:
        return f"P{tuple(self)}"


def P(*entries) -> PartitionSpec:
    return PartitionSpec(entries)


def _key_names(path: Sequence) -> list[str]:
    """A tree path as strings (dict keys, field names, sequence indices)."""
    return [str(k) for k in path]


def _entry_axes(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def _entry_extent(entry, mesh) -> int:
    return math.prod(dict(mesh.shape).get(a, 1) for a in _entry_axes(entry))


def _entry_index(entry, mesh) -> int:
    i = 0
    for a in _entry_axes(entry):
        i = i * dict(mesh.shape)[a] + mesh.coords[a]
    return i


def local_shard(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``x`` (a whole tensor) under ``spec``: each
    sharded dimension cut into its axes' extent, the block at this rank's
    coordinates taken (a view)."""
    for i, entry in enumerate(spec):
        n = _entry_extent(entry, mesh)
        if n > 1:
            c = x.shape[i] // n
            x = x.narrow(i, _entry_index(entry, mesh) * c, c)
    return x


def gather_shard(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``local_shard`` (all-gathers)."""
    from repro_torch.dist.collectives import all_gather

    for i, entry in enumerate(spec):
        if _entry_extent(entry, mesh) > 1:
            x = all_gather(x.contiguous(), _entry_axes(entry), mesh, dim=i)
    return x


class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, P(*spec)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return local_shard(x, self.spec, self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_shard(x, self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"


def qkv_cut(x: torch.Tensor, heads: tuple, n: int, r: int) -> torch.Tensor:
    """Rank ``r`` of ``n``'s head-aligned columns of a fused (..., (H + 2 KV)
    Dh) ``wqkv``: its q heads ``[r H/n, (r + 1) H/n)`` and the matching KV
    heads of k and v, side by side (a copy)."""
    H, KV, Dh = heads
    qw, kw = H * Dh // n, KV * Dh // n
    return torch.cat([x[..., r * qw:(r + 1) * qw],
                      x[..., H * Dh + r * kw:H * Dh + (r + 1) * kw],
                      x[..., (H + KV) * Dh + r * kw:(H + KV) * Dh + (r + 1) * kw]], dim=-1)


def qkv_join(blocks: torch.Tensor, heads: tuple, n: int) -> torch.Tensor:
    """The inverse of ``qkv_cut``: the ranks' blocks, concatenated in rank
    order along the last dim, back in JAX's (q | k | v) column order."""
    H, KV, Dh = heads
    qw, kw = H * Dh // n, KV * Dh // n
    parts = torch.split(blocks, qw + 2 * kw, dim=-1)
    return torch.cat([p[..., :qw] for p in parts] + [p[..., qw:qw + kw] for p in parts]
                     + [p[..., qw + kw:] for p in parts], dim=-1)


class QKVSharding(NamedSharding):
    """A fused ``wqkv`` under tensor parallelism: its last dim over
    ``model`` (the spec says so, for the gradient norm and the tests), cut
    head-aligned by ``qkv_cut`` (GSPMD's contiguous block would give rank 0
    all of q at model 2).  ``heads`` is (H, KV, Dh)."""

    def __init__(self, mesh, spec: tuple, heads: tuple):
        super().__init__(mesh, spec)
        self.heads = heads
        self.n = _entry_extent(self.spec[-1], mesh)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        x = local_shard(x, (*self.spec[:-1], None), self.mesh)
        return qkv_cut(x, self.heads, self.n, _entry_index(self.spec[-1], self.mesh))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.dist.collectives import all_gather

        x = gather_shard(x, (*self.spec[:-1], None), self.mesh)
        blocks = all_gather(x.contiguous(), _entry_axes(self.spec[-1]), self.mesh, dim=x.ndim - 1)
        return qkv_join(blocks, self.heads, self.n)

    def __repr__(self) -> str:
        return f"QKVSharding({self.spec}, heads={self.heads})"


def place(tree: Tree, shardings: Tree) -> Tree:
    """Each leaf of ``tree`` (whole tensors) cut to this rank's shard of its
    ``NamedSharding`` (contiguous copies: the shard is the rank's own)."""
    return tree_map(lambda x, s: s.local(x).contiguous(), tree, shardings)


def gather(tree: Tree, shardings: Tree) -> Tree:
    """The whole leaves of a placed tree, on every rank."""
    return tree_map(lambda x, s: s.gather(x), tree, shardings)


def tensor_parallel(plan: ExecutionPlan) -> bool:
    """Whether ``plan`` runs Megatron tensor parallelism without SP: a model
    axis > 1 that neither SP, nor ``dp_over_model``'s fold into data
    parallelism, nor the pipeline takes, with a SPATIAL stage or an MoE
    split."""
    if plan.model_axis <= 1 or plan.seq_parallel_acts or plan.dp_over_model:
        return False
    if plan.pod_role == "pipeline" and plan.pod_axis > 1:
        return False
    return (any(plan.mode_for(s) == SPATIAL for s in ("mha", "ffn"))
            or plan.moe_mode in ("ep", "tp"))


def unexecuted_layout(plan: ExecutionPlan, cfg) -> Optional[str]:
    """Why no manual path of the port executes ``plan``'s parameter layout
    for ``cfg``, or None.  The port runs the Megatron-SP stack's model
    shards, the pipeline's stage slices, tensor parallelism without SP of
    every layer kind (attention, RWKV-6, RG-LRU, an encoder-decoder's
    encoder and cross-attention; MoE included) and FSDP over the
    data-parallel axes (ZeRO, ``dp_over_model``), under the pipeline too.
    ZeRO weights under Megatron-SP are refused: ``derive_plan`` never makes
    that plan (``sp_feasible`` needs ``not zero_weights``, in both
    packages), and the reference's SP stack cannot run it when it is built
    by hand (its ``shard_map`` is handed the ZeRO'd specs, so each shard
    reads half the weight rows)."""
    if plan.zero_weights and plan.data_axis > 1 and plan.seq_parallel_acts:
        return (f"ZeRO weights (sharded over data axis {plan.data_axis}) under Megatron-SP: "
                "derive_plan never makes this plan (sp_feasible requires not zero_weights), "
                "and the reference's SP stack cannot run it either (its shard_map reads the "
                "ZeRO'd weight rows as whole ones)")
    return None


class Shardings:
    """Sharding rules for one (mesh x plan x arch) accelerator instance."""

    def __init__(self, mesh, plan: ExecutionPlan, cfg):
        self.mesh = mesh
        self.plan = plan
        self.cfg = cfg
        self.axis_sizes = dict(mesh.shape)
        self._fit_warned: set = set()  # (dim, axes) pairs already reported

    # ------------------------------------------------------------- helpers
    def _axis(self, name: str) -> int:
        return self.axis_sizes.get(name, 1)

    def _ns(self, spec: tuple) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    def _fit(self, spec: tuple, shape: Sequence[int]) -> tuple:
        """Divisibility safety net: drop mesh axes a dim cannot host, each
        drop logged once per (dim extent, axes) pair."""
        out = []
        for i, entry in enumerate(spec):
            if entry is None:
                out.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            if any(a not in self.axis_sizes for a in axes):
                out.append(None)
                continue
            size = math.prod(self._axis(a) for a in axes)
            ok = i < len(shape) and size > 0 and shape[i] % size == 0
            if not ok:
                dim = shape[i] if i < len(shape) else None
                key = (dim, axes)
                if key not in self._fit_warned:
                    self._fit_warned.add(key)
                    logger.warning(
                        "Shardings safety net: dim %s (index %d of shape %s) "
                        "does not divide over mesh axes %s (extent %d); "
                        "dropping to replicated for arch=%s",
                        dim, i, tuple(shape), axes, size, self.plan.arch,
                    )
            out.append(entry if ok else None)
        return P(*out)

    def _dp_axes(self) -> tuple:
        """Mesh axes that carry data parallelism, outermost first."""
        axes = []
        if self._axis("pod") > 1 and self.plan.pod_role == "data":
            axes.append("pod")
        axes.append("data")
        if self.plan.dp_over_model:
            axes.append("model")  # TEMPORAL: serial PRGs use every rank
        return tuple(axes)

    def batch_axes_for(self, batch: int) -> Optional[tuple]:
        """Largest dp-axis prefix the global batch divides, or None."""
        axes = list(self._dp_axes())
        while axes:
            size = math.prod(self._axis(a) for a in axes)
            if batch > 0 and batch % size == 0:
                return tuple(axes)
            axes.pop()
        return None

    @staticmethod
    def _entry(axes: Optional[tuple]):
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    # ------------------------------------------------------------ parameters
    def param_spec(self, path: Sequence, leaf) -> tuple:
        """The spec of one parameter leaf, by its tree path; leading stack
        dims are absorbed by indexing dims from the end of the shape."""
        names = _key_names(path)
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd <= 1:
            return P(*([None] * nd))
        spec: list = [None] * nd

        stage = "mha" if ("attn" in names or "cross" in names) else "ffn"
        mode = self.plan.mode_for(stage)
        is_moe_w = self.cfg.is_moe and "ffn" in names and name in ("w1", "w2", "w3", "router")

        if name == "embed":
            if self.plan.embed_shard == "vocab":
                spec[-2] = "model"
            elif self.plan.embed_shard == "embed":
                spec[-1] = "model"
        elif name in ("lm_head", "cls_head"):
            if name == "lm_head" and self.plan.embed_shard == "vocab":
                spec[-1] = "model"
        elif is_moe_w:
            if name != "router":  # router (d, E) is tiny: keep replicated
                if self.plan.moe_mode == "ep" and nd >= 3:
                    spec[-3] = "model"  # experts on the stacked leading dim
                elif self.plan.moe_mode == "tp":
                    spec[-2 if name == "w2" else -1] = "model"
        elif mode == SPATIAL:
            if name in COLUMN_PARALLEL:
                spec[-1] = "model"
                if self.plan.zero_weights:
                    spec[-2] = "data"
            elif name in ROW_PARALLEL:
                spec[-2] = "model"
                if self.plan.zero_weights:
                    spec[-1] = "data"
        else:  # TEMPORAL: no tensor parallelism; ZeRO-shard weights over DP
            if (self.plan.dp_over_model or self.plan.zero_weights) and name in (
                COLUMN_PARALLEL | ROW_PARALLEL
            ):
                axes = self._dp_axes() if self.plan.dp_over_model else ("data",)
                spec[-1] = self._entry(axes)
        # Pipeline pods: the stacked layer-group dim is the stage dim.
        if (
            self.plan.pod_role == "pipeline"
            and self._axis("pod") > 1
            and len(names) >= 2
            and names[0] == "blocks"
            and names[1] == "stack"
        ):
            spec[0] = "pod"
        return self._fit(P(*spec), shape)

    def stack_specs(self, stack: Tree) -> Tree:
        """Raw specs of the ``blocks.stack`` subtree (the manual SP stack's
        and the pipeline's), the path re-rooted at ``blocks.stack``."""
        return tree_map_with_path(lambda p, leaf: self.param_spec(p, leaf), stack,
                                  path=("blocks", "stack"))

    def attention_sharded(self) -> bool:
        """Whether tensor parallelism runs attention on this rank's heads:
        the MHA stage SPATIAL and the query and KV heads both dividing over
        ``model`` (otherwise attention runs replicated).  The paged pools
        then hold this rank's KV heads, ``cache_spec``'s split."""
        n = self._axis("model")
        return (tensor_parallel(self.plan) and self.plan.mode_for("mha") == SPATIAL
                and self.cfg.n_heads % n == 0 and self.cfg.n_kv_heads % n == 0)

    def recurrent_sharded(self) -> bool:
        """Whether tensor parallelism runs the RWKV-6 time-mix and the RG-LRU
        block on this rank's shards: the MHA stage (whose leaves they are in
        JAX's tree) SPATIAL and ``rnn_heads`` dividing over ``model``
        (otherwise they run whole)."""
        n = self._axis("model")
        return (tensor_parallel(self.plan) and self.plan.mode_for("mha") == SPATIAL
                and self.cfg.rnn_heads > 0 and self.cfg.rnn_heads % n == 0)

    def block_sharded(self, names: Sequence[str]) -> bool:
        """Whether the block holding the leaf at ``names`` (its key path)
        runs on this rank's shards under tensor parallelism: a recurrent
        block's leaves by ``recurrent_sharded``, attention's and
        cross-attention's by ``attention_sharded``, the FFN's always."""
        if "attn" not in names and "cross" not in names:
            return True
        if "attn" in names and names[-1] in RECURRENT_SHARDED:
            return self.recurrent_sharded()
        return self.attention_sharded()

    def tp_blocks(self) -> tuple:
        """(the blocks that run on this rank's shards, those that run whole)
        under tensor parallelism, by name, for the launcher's log."""
        kinds = {"rwkv6": ("RWKV-6 time-mix", self.recurrent_sharded()),
                 "rglru": ("RG-LRU", self.recurrent_sharded())}
        names = {"attn": "attention", "swa": "sliding-window attention",
                 "local": "local attention"}
        blocks = [kinds.get(k, (names.get(k, k), self.attention_sharded()))
                  for k in dict.fromkeys(self.cfg.layer_pattern)]
        if self.cfg.enc_dec:
            blocks += [("encoder attention", self.attention_sharded()),
                       ("cross-attention", self.attention_sharded())]
        return ([b for b, on in blocks if on], [b for b, on in blocks if not on])

    def model_parallel(self) -> bool:
        """Whether the ``model`` axis splits the compute (tensor parallelism
        without SP, or Megatron-SP) rather than the batch or nothing."""
        return tensor_parallel(self.plan) or self.plan.seq_parallel_acts

    def fsdp_axes(self) -> tuple:
        """The data-parallel axes the weights are sharded over and gathered
        where used (FSDP): ZeRO's ``data`` and ``dp_over_model``'s dp axes,
        under the pipeline too (``pod`` is then a stage axis, not a data
        one)."""
        return self._dp_axes()

    def manual_param_spec(self, path: Sequence, leaf) -> tuple:
        """The spec the port's manual paths execute: ``param_spec``'s entries
        over the FSDP axes (``fsdp_axes``); in ``blocks.stack``, its model
        shards under Megatron-SP and its pod slice under the pipeline; under
        tensor parallelism without SP, its model shards in every layer of
        the decoder (``blocks``) and of an encoder (``encoder``), each
        block's only where ``block_sharded``; under both, the embedding's
        and head's ``vocab`` split.  Every other entry is dropped: the final
        norm, Megatron-SP's tail layers and blocks whose heads do not divide
        run replicated."""
        names = _key_names(path)
        spec = self.param_spec(path, leaf)
        keep = set(self.fsdp_axes())
        if names[:2] == ["blocks", "stack"]:
            if self.plan.seq_parallel_acts:
                keep.add("model")
            if self.plan.pod_role == "pipeline" and self._axis("pod") > 1:
                keep.add("pod")
        if (names[:1] in (["blocks"], ["encoder"]) and tensor_parallel(self.plan)
                and self.block_sharded(names)):
            keep.add("model")
        if (names[-1:] in (["embed"], ["lm_head"]) and self.plan.embed_shard == "vocab"
                and self.model_parallel()):
            keep.add("model")
        return P(*(e if e is not None and set(_entry_axes(e)) <= keep else None for e in spec))

    def gather_spec(self, spec: tuple) -> Optional[tuple]:
        """The part of a manual spec that a layer gathers where it reads the
        leaf (the FSDP axes' entries), or None when there is none."""
        fsdp = set(self.fsdp_axes())
        out = tuple(e if e is not None and set(_entry_axes(e)) <= fsdp
                    and _entry_extent(e, self.mesh) > 1 else None for e in spec)
        return P(*out) if any(e is not None for e in out) else None

    def gather_specs(self, shardings: Tree) -> Tree:
        """``gather_spec`` of every leaf of a tree of manual shardings."""
        return tree_map(lambda s: self.gather_spec(s.spec), shardings)

    def manual_param_shardings(self, params: Tree) -> Tree:
        heads = (self.cfg.n_heads, self.cfg.n_kv_heads, self.cfg.d_head)
        tp = tensor_parallel(self.plan)

        def one(path, leaf):
            spec = self.manual_param_spec(path, leaf)
            if tp and _key_names(path)[-1:] == ["wqkv"] and spec and spec[-1] == "model":
                return QKVSharding(self.mesh, spec, heads)
            return self._ns(spec)

        return tree_map_with_path(one, params)

    # ------------------------------------------------------------ decode cache
    def cache_spec(self, path: Sequence, leaf) -> tuple:
        """Decode-cache leaf spec: batch over data; KV heads over ``model``
        when divisible, else the sequence dim.  Paged pool leaves have no
        batch dim: only their KV-head dim shards."""
        names = _key_names(path)
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        if "paged" in names:
            if name in ("k", "v", "k_scale", "v_scale") and nd >= 4:
                spec[-2] = "model"  # (..., n_blocks, block, KV, Dh/1)
            return self._fit(P(*spec), shape)
        if "cross_kv" in names and nd >= 4:
            spec[-4] = "data"  # encoder memory kv: batch only
        elif name in ("k", "v") and nd >= 4:
            spec[-4] = "data"
            if self.cfg.n_kv_heads % max(self._axis("model"), 1) == 0:
                spec[-2] = "model"
            else:
                spec[-3] = "model"  # shard the sequence dim instead
        elif name == "S" and nd >= 4:
            spec[-4] = "data"  # rwkv state (B, H, Dh, Dh)
        elif name in ("h", "shift", "cmix") and nd >= 2:
            spec[-2] = "data"
        elif name == "conv" and nd >= 3:
            spec[-3] = "data"
        elif name == "memory" and nd >= 3:
            spec[-3] = "data"
        return self._fit(P(*spec), shape)

    # ------------------------------------------------------------ batch inputs
    def batch_spec(self, leaf) -> tuple:
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if not shape:
            return P()
        spec[0] = self._entry(self.batch_axes_for(shape[0]))
        if self.plan.seq_shard and len(shape) >= 2:
            spec[1] = "data"  # long-context: batch < data axis, split the seq
        return self._fit(P(*spec), shape)

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch: dim 0 cut over
        ``batch_axes_for`` (the port runs ``seq_shard``'s sequence split
        replicated: every rank of the data axis takes the whole sequence)."""
        out = {}
        for k, v in batch.items():
            entry = self._entry(self.batch_axes_for(v.shape[0]))
            out[k] = local_shard(v, (entry,), self.mesh)
        return out

    # ------------------------------------------------------------ activations
    def act_spec(self, name: str, shape: Sequence[int]) -> tuple:
        spec: list = [None] * len(shape)
        if not shape:
            return P()
        spec[0] = self._entry(self.batch_axes_for(shape[0]))
        spatial_mha = self.plan.mode_for("mha") == SPATIAL
        if name == "act_hidden":
            if self.plan.seq_shard and len(shape) >= 2:
                spec[1] = "data"
            elif self.plan.seq_parallel_acts and len(shape) >= 2:
                spec[1] = "model"
        elif name == "act_heads" and len(shape) >= 3:
            if spatial_mha and self.plan.head_shards > 1:
                spec[-2] = "model"
        elif name == "act_kv" and len(shape) >= 3:
            if spatial_mha:
                spec[-2] = "model"
        elif name == "act_heads_flat":
            if spatial_mha and self.plan.head_shards > 1:
                spec[-1] = "model"
        return self._fit(P(*spec), shape)

    def constrain(self, x, name: Optional[str] = None):
        """JAX pins an activation's layout for GSPMD here.  The port has no
        compiler to hint: the manual paths put every activation where it
        lives, so this returns ``x``."""
        return x

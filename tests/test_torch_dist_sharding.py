"""The port's ``Shardings`` (``repro_torch.dist.sharding``) against the JAX
package's, spec for spec, on shape-only meshes (JAX's ``FakeMesh``):
``param_spec`` of every leaf of each reduced arch's bridged tree,
``stack_specs``, ``cache_spec``, ``batch_spec``, ``act_spec`` for each
activation name, ``batch_axes_for`` and ``_fit``'s drops and warnings,
over data-parallel, tensor-parallel, Megatron-SP, production and pipeline
layouts.  Then the port's own part: cutting and gathering local shards, the
layout its manual paths execute, and the layouts it refuses."""
import dataclasses

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan as jax_derive_plan
from repro.dist.sharding import ACT_NAMES as JAX_ACT_NAMES
from repro.dist.sharding import Shardings as JaxShardings
from repro.models.params import init_params as jax_init_params
from repro_torch.bridge import from_jax
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.hardware import H100_SXM, HardwareSpec
from repro_torch.core.plan import derive_plan
from repro_torch.dist.sharding import (ACT_NAMES, NamedSharding, Shardings, gather_shard,
                                       local_shard, unexecuted_layout)
from repro_torch.train.optimizer import tree_leaves_with_path
from test_torch_dist_ranks import ShapeMesh


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


class Leaf:
    def __init__(self, shape):
        self.shape = shape


V5E = HardwareSpec(
    **{f.name: getattr(TPU_V5E, f.name) for f in dataclasses.fields(HardwareSpec)}
)
LAYOUTS = [
    ({"data": 2, "model": 2}, {"batch": 8, "seq_len": 32, "force_mode": "spatial"}),
    ({"data": 1, "model": 2}, {"batch": 8, "seq_len": 32, "seq_parallel": True,
                               "force_mode": "spatial"}),
    ({"data": 4, "model": 1}, {"batch": 8, "seq_len": 32}),
    ({"data": 16, "model": 16}, {"batch": 256, "seq_len": 4096}),
    ({"data": 16, "model": 16}, {"batch": 128, "seq_len": 32768, "training": False}),
    ({"pod": 2, "data": 2, "model": 1}, {"batch": 8, "seq_len": 32, "pod_role": "pipeline"}),
    ({"pod": 2, "data": 16, "model": 16}, {"batch": 512, "seq_len": 4096}),
    ({"data": 2, "model": 24}, {"batch": 96, "seq_len": 4096}),
]


def _pair(arch, mesh, kw):
    """Both packages' Shardings on a shape-only mesh, the TPU numbers
    handed to both planners."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jplan = jax_derive_plan(jcfg, mesh, TPU_V5E, **kw)
    plan = derive_plan(cfg, mesh, V5E, **kw)
    return (JaxShardings(FakeMesh(dict(mesh)), jplan, jcfg),
            Shardings(ShapeMesh(dict(mesh)), plan, cfg), jplan, plan)


def _spec(p) -> tuple:
    return tuple(p)


def _trees(arch, jplan):
    """JAX's parameter tree (shapes only, zeros) and its bridged copy."""
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jax_get_config(arch),
                                                    jplan))
    jtree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return jtree, from_jax(jtree, device="cpu")


def _jkey(path) -> str:
    from repro.dist.sharding import _key_names

    return "|".join(_key_names(path))


@pytest.mark.parametrize("arch", [a + "-reduced" for a in ALL_ARCHS])
def test_param_specs_match_jax(arch):
    for mesh, kw in LAYOUTS:
        jsh, sh, jplan, plan = _pair(arch, mesh, kw)
        jtree, tree = _trees(arch, jplan)
        want = {_jkey(p): _spec(jsh.param_spec(p, x))
                for p, x in jtu.tree_flatten_with_path(jtree)[0]}
        got = {"|".join(map(str, p)): sh.param_spec(p, x) for p, x in tree_leaves_with_path(tree)}
        assert got == want, (mesh, kw)
        jstack, stack = jtree["blocks"]["stack"], tree["blocks"]["stack"]
        if stack is not None:
            jflat = jtu.tree_flatten_with_path(jsh.stack_specs(jstack),
                                               is_leaf=lambda s: isinstance(s, JP))[0]
            jspecs = {_jkey(p): _spec(s) for p, s in jflat}
            specs = {"|".join(map(str, p)): s
                     for p, s in tree_leaves_with_path(sh.stack_specs(stack))}
            assert specs == jspecs, (mesh, kw)


CACHE_LEAVES = [
    (("layers", "stack", "attn", "k"), (28, 128, 32768, 8, 128)),
    (("layers", "stack", "attn", "v"), (4, 8, 64, 3, 16)),
    (("layers", "tail", "0", "attn", "k"), (128, 32768, 8, 128)),
    (("layers", "stack", "cross_kv", "k"), (4, 8, 64, 8, 16)),
    (("layers", "stack", "rwkv", "S"), (4, 8, 4, 16, 16)),
    (("layers", "stack", "rwkv", "shift"), (4, 8, 64)),
    (("layers", "stack", "cmix"), (4, 8, 64)),
    (("layers", "stack", "rglru", "h"), (4, 16, 64)),
    (("layers", "stack", "rglru", "conv"), (4, 16, 3, 64)),
    (("memory",), (16, 1500, 768)),
    (("layers", "paged", "k"), (28, 1025, 16, 8, 128)),
    (("layers", "paged", "k_scale"), (28, 1025, 16, 8, 1)),
    (("t",), ()),
]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-135m", "whisper-small", "rwkv6-1.6b"])
def test_cache_batch_act_specs_match_jax(arch):
    for mesh, kw in LAYOUTS:
        jsh, sh, _, _ = _pair(arch, mesh, kw)
        for names, shape in CACHE_LEAVES:
            jpath = [jtu.DictKey(n) for n in names]
            assert sh.cache_spec(names, Leaf(shape)) == _spec(jsh.cache_spec(jpath, Leaf(shape)))
        for shape in [(8, 32), (3, 32), (256, 4096, 7), (16,), (), (128, 32768)]:
            assert sh.batch_spec(Leaf(shape)) == _spec(jsh.batch_spec(Leaf(shape))), shape
        assert ACT_NAMES == JAX_ACT_NAMES
        for name in ACT_NAMES + ("other",):
            for shape in [(8, 32, 64), (8, 32, 16, 8), (3, 32, 4, 8), (256, 4096, 2048), ()]:
                assert sh.act_spec(name, shape) == _spec(jsh.act_spec(name, shape)), (name, shape)
        for b in (0, 1, 2, 3, 4, 8, 16, 48, 96, 256, 512, 1024):
            assert sh.batch_axes_for(b) == jsh.batch_axes_for(b), b


def test_megatron_orientation_and_fold_as_jax():
    """The cases of ``tests/test_sharding.py`` and ``tests/test_dist_extra.py``."""
    jsh, sh, _, plan = _pair("qwen3-1.7b", {"data": 16, "model": 16},
                             {"batch": 256, "seq_len": 4096, "force_mode": "spatial"})
    wqkv = ("blocks", "stack", 0, "attn", "wqkv")
    assert sh.param_spec(wqkv, Leaf((28, 2048, 4096)))[-1] == "model"  # column
    assert sh.param_spec(("attn", "wo"), Leaf((2048, 2048)))[0] == "model"  # row
    assert all(a is None for a in sh.param_spec(("blocks", "stack", 0, "attn", "ln", "scale"),
                                                Leaf((28, 2048))))
    _, sh, _, plan = _pair("smollm-135m", {"data": 16, "model": 16},
                           {"batch": 256, "seq_len": 4096})
    assert plan.dp_over_model
    assert sh.batch_axes_for(512) == ("data", "model")
    assert sh.batch_axes_for(48) == ("data",) and sh.batch_axes_for(3) is None
    assert sh._fit(("model", None), (100, 64))[0] is None
    assert sh._fit((("data", "model"), None), (256, 64))[0] == ("data", "model")
    assert sh._fit(("pod", None), (64, 64))[0] is None  # axis not in the mesh
    for arch, mesh, idx in (("qwen3-moe-30b-a3b", {"data": 16, "model": 16}, 1),
                            ("mixtral-8x7b", {"data": 16, "model": 16}, -1)):
        _, sh, _, plan = _pair(arch, mesh, {"batch": 256, "seq_len": 4096})
        w1 = sh.param_spec(("blocks", "stack", 0, "ffn", "w1"), Leaf((32, 8 if idx < 0 else 128,
                                                                     2048, 768 * 8)))
        assert w1[idx] == "model"
    _, sh, _, plan = _pair("smollm-135m-reduced", {"pod": 2, "data": 2, "model": 1},
                           {"batch": 8, "seq_len": 32, "pod_role": "pipeline"})
    assert sh.param_spec(("blocks", "stack", 0, "attn", "wqkv"), Leaf((2, 64, 128)))[0] == "pod"
    assert sh.param_spec(("embed",), Leaf((512, 64)))[0] != "pod"


def test_fit_warns_once_per_dim_and_axes(caplog):
    jsh, sh, _, _ = _pair("smollm-135m", {"data": 16, "model": 16},
                          {"batch": 256, "seq_len": 4096})
    for shardings, logger in ((jsh, "repro.dist.sharding"), (sh, "repro_torch.dist.sharding")):
        caplog.clear()
        with caplog.at_level("WARNING", logger=logger):
            assert shardings._fit((None, "model"), (256, 100))[1] is None
            assert shardings._fit((None, "model"), (256, 100))[1] is None
            shardings._fit(("data", "model"), (3, 100))
        msgs = [r.getMessage() for r in caplog.records if r.name == logger]
        assert len(msgs) == 2 and "100" in msgs[0] and "model" in msgs[0], msgs
    assert len(sh._fit_warned) == len(jsh._fit_warned) == 2


def test_local_shards_reassemble():
    """``local_shard`` at every coordinate of a (pod 2, data 2, model 2)
    shape mesh cuts the block of its coordinates: concatenating the blocks
    in mesh order gives the tensor back, grouped entries included."""
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    shape = {"pod": 2, "data": 2, "model": 2}

    def at(p, d, m, spec):
        return local_shard(x, spec, ShapeMesh(shape, {"pod": p, "data": d, "model": m}))

    spec = ("pod", None, "model")
    rows = [torch.cat([at(p, 0, m, spec) for m in range(2)], dim=2) for p in range(2)]
    assert torch.equal(torch.cat(rows, dim=0), x)
    assert torch.equal(at(1, 0, 1, spec), at(1, 1, 1, spec))  # replicated over data
    spec = (("data", "model"), None, None)
    assert torch.equal(torch.cat([at(0, d, m, spec) for d in range(2) for m in range(2)]), x)
    one = ShapeMesh({"data": 1, "model": 1})
    assert gather_shard(x, ("data", "model", None), one) is x
    assert NamedSharding(one, (None,)).local(x) is x


def test_manual_layout_and_refusals():
    """The port executes SP's model shards, the pipeline's stage slices of
    the stack, every layer's model shards under tensor parallelism without
    SP, the embedding's and head's vocab split under both, and the FSDP
    shards over the data axes (ZeRO, dp_over_model's fold); the final norm
    and SP's tail layers are replicated.  TP of recurrent layers executes
    its model shards, the per-head leaves whole; ZeRO under the pipeline
    executes, the stage slice sharded over pod and data; ZeRO under
    Megatron-SP is refused with the reference's own reason."""
    _, sh, jplan, plan = _pair("bert-base-reduced", {"data": 1, "model": 2},
                               {"batch": 8, "seq_len": 32, "seq_parallel": True,
                                "force_mode": "spatial"})
    assert plan.seq_parallel_acts and unexecuted_layout(plan, sh.cfg) is None
    assert sh.manual_param_spec(("blocks", "stack", 0, "attn", "wq"), Leaf((2, 64, 64))) == (
        None, None, "model")
    assert plan.embed_shard == "vocab"
    assert sh.manual_param_spec(("embed",), Leaf((512, 64))) == ("model", None)
    assert sh.manual_param_spec(("final_norm", "scale"), Leaf((64,))) == (None,)
    _, sh, _, plan = _pair("smollm-135m-reduced", {"pod": 2, "data": 2, "model": 1},
                           {"batch": 8, "seq_len": 32, "pod_role": "pipeline"})
    assert sh.manual_param_spec(("blocks", "stack", 0, "ffn", "w1"), Leaf((2, 64, 128))) == (
        "pod", None, None)
    # TP without SP on bert-base-reduced executes its model shards
    _, sh, _, tp = _pair("bert-base-reduced", {"data": 1, "model": 2},
                         {"batch": 8, "seq_len": 32, "force_mode": "spatial"})
    assert not tp.seq_parallel_acts and unexecuted_layout(tp, sh.cfg) is None
    assert sh.manual_param_spec(("blocks", "stack", 0, "attn", "wq"), Leaf((2, 64, 64))) == (
        None, None, "model")
    assert sh.manual_param_spec(("blocks", "stack", 0, "attn", "wo"), Leaf((2, 64, 64))) == (
        None, "model", None)
    assert sh.manual_param_spec(("embed",), Leaf((512, 64))) == ("model", None)
    assert sh.gather_spec(("model", None)) is None  # computed on vocab-parallel, not gathered
    # a recurrent arch under TP executes its model shards: the time-mix's
    # w_r by column and w_o by row, its bonus u whole
    _, sh, _, rec = _pair("rwkv6-1.6b-reduced", {"data": 1, "model": 2},
                          {"batch": 8, "seq_len": 32, "force_mode": "spatial"})
    assert unexecuted_layout(rec, sh.cfg) is None and sh.recurrent_sharded()
    assert sh.manual_param_spec(("blocks", "stack", 0, "attn", "w_r"), Leaf((2, 64, 64))) == (
        None, None, "model")
    assert sh.manual_param_spec(("blocks", "stack", 0, "attn", "w_o"), Leaf((2, 64, 64))) == (
        None, "model", None)
    assert sh.manual_param_spec(("blocks", "stack", 0, "attn", "u"), Leaf((2, 2, 32))) == (
        None, None, None)
    # mistral-large-123b's production plan: ZeRO with the model axis folded
    # into data parallelism, now executed as FSDP over (data, model)
    _, sh, _, zero = _pair("mistral-large-123b", {"data": 16, "model": 16},
                           {"batch": 256, "seq_len": 4096})
    assert zero.zero_weights and zero.dp_over_model and unexecuted_layout(zero, sh.cfg) is None
    wq = sh.manual_param_spec(("blocks", "stack", 0, "attn", "wq"), Leaf((88, 12288, 12288)))
    assert wq == (None, None, ("data", "model")) and sh.gather_spec(wq) == wq
    emb = sh.manual_param_spec(("embed",), Leaf((32768, 12288)))
    assert emb == ("model", None) and sh.gather_spec(emb) == emb  # model carries the batch
    # ZeRO with TP: the data split on the complementary dim, gathered; the
    # model split computed on (attention replicated: 8 KV heads over 16)
    _, sh, _, ztp = _pair("mistral-large-123b", {"data": 16, "model": 16},
                          {"batch": 256, "seq_len": 4096, "force_mode": "spatial"})
    assert ztp.zero_weights and unexecuted_layout(ztp, sh.cfg) is None
    w1 = sh.manual_param_spec(("blocks", "stack", 0, "ffn", "w1"), Leaf((88, 12288, 28672)))
    assert w1 == (None, "data", "model") and sh.gather_spec(w1) == (None, "data", None)
    wo = sh.manual_param_spec(("blocks", "stack", 0, "attn", "wo"), Leaf((88, 12288, 12288)))
    assert wo == (None, None, "data")
    # under the pipeline ZeRO executes: the stage slice over pod on the
    # group dim and over the data axes on the ZeRO dim, only the data entry
    # gathered (pod is a stage axis, never gathered)
    _, sh, _, pz = _pair("mistral-large-123b", {"pod": 2, "data": 16, "model": 1},
                         {"batch": 256, "seq_len": 4096, "pod_role": "pipeline"})
    assert pz.zero_weights and pz.pod_role == "pipeline" and unexecuted_layout(pz, sh.cfg) is None
    assert sh.fsdp_axes() == ("data", "model")
    for name, leaf in (("wq", (88, 12288, 12288)), ("wo", (88, 12288, 12288))):
        spec = sh.manual_param_spec(("blocks", "stack", 0, "attn", name), Leaf(leaf))
        assert spec == sh.param_spec(("blocks", "stack", 0, "attn", name), Leaf(leaf)) == (
            "pod", None, ("data", "model"))
        assert sh.gather_spec(spec) == (None, None, ("data", "model"))
    assert sh.manual_param_spec(("blocks", "stack", 0, "attn", "ln", "scale"),
                                Leaf((88, 12288))) == ("pod", None)
    # ZeRO under Megatron-SP is the one layout refused, with the reference's
    # own reason (no derive_plan makes it; JAX's SP stack cannot run it)
    _, sh, _, sp = _pair("bert-base-reduced", {"data": 2, "model": 2},
                         {"batch": 8, "seq_len": 32, "seq_parallel": True,
                          "force_mode": "spatial"})
    assert sp.seq_parallel_acts and not sp.zero_weights and unexecuted_layout(sp, sh.cfg) is None
    why = unexecuted_layout(dataclasses.replace(sp, zero_weights=True), sh.cfg)
    assert "Megatron-SP" in why and "sp_feasible" in why and "reference" in why
    assert "ROADMAP" not in why
    # on the H100 entry qwen3-1.7b's --dp 2 plan folds the model axis into
    # data parallelism: the weights are FSDP shards over the data axes
    cfg = get_config("qwen3-1.7b")
    fold = derive_plan(cfg, {"data": 2, "model": 1}, H100_SXM, batch=8, seq_len=2048)
    assert fold.dp_over_model and not fold.zero_weights and unexecuted_layout(fold, cfg) is None
    fsh = Shardings(ShapeMesh({"data": 2, "model": 1}), fold, cfg)
    w1 = fsh.manual_param_spec(("blocks", "stack", 0, "ffn", "w1"), Leaf((28, 2048, 6144)))
    assert w1 == (None, None, ("data", "model")) and fsh.gather_spec(w1) == w1

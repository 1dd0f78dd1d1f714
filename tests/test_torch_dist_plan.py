"""The port's ``derive_plan`` (``repro_torch.core.plan``) against the JAX
package's, field for field (every field but ``StagePlan.pu``, which the
port does not carry), on the TPU_V5E numbers handed to both packages: every
arch's reduced config and qwen3-1.7b / bert-base at full size, over the
host, production and pipeline meshes, training and serving, the pod roles,
Megatron-SP, forced modes, gradient wire formats and batches that do and
do not split over the mesh.  Then the H100 entry's Factor1 with the named
MM tile, and ``derive_execution_plan`` as the 1 x 1 call of it."""
import dataclasses
import itertools

import pytest

from repro.configs import get_config as jax_get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan as jax_derive_plan
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.hardware import H100_SXM, HardwareSpec
from repro_torch.core.plan import (H100_MM_CTA_TILE, PRG_MAX_PIPELINE_DEPTH, SPATIAL,
                                   TEMPORAL, derive_execution_plan, derive_plan, one_shot_mm)

V5E = HardwareSpec(
    **{f.name: getattr(TPU_V5E, f.name) for f in dataclasses.fields(HardwareSpec)}
)
MESHES = [
    {"data": 1, "model": 1},
    {"data": 2, "model": 1},
    {"data": 1, "model": 2},
    {"data": 2, "model": 2},
    {"pod": 2, "data": 2, "model": 1},
    {"pod": 2, "data": 1, "model": 1},
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
]
KNOBS = [
    {"batch": 8, "seq_len": 32},
    {"batch": 8, "seq_len": 2048, "training": False},
    {"batch": 3, "seq_len": 64},  # a batch that splits over no data axis
    {"batch": 256, "seq_len": 4096, "grad_compression": "int8"},
    {"batch": 8, "seq_len": 32, "pod_role": "pipeline"},
    {"batch": 32, "seq_len": 128, "pod_role": "pipeline", "grad_compression": "bf16"},
    {"batch": 8, "seq_len": 32, "seq_parallel": True, "force_mode": "spatial"},
    {"batch": 16, "seq_len": 64, "seq_parallel": True},
    {"batch": 8, "seq_len": 32, "force_mode": "temporal"},
    {"batch": 8, "seq_len": 32, "moe_dispatch": "sort", "fuse_qkv": False},
]


def _jax_fields(plan) -> dict:
    d = dataclasses.asdict(plan)
    for stage in ("mha", "ffn"):
        d[stage].pop("pu")
    return d


@pytest.mark.parametrize("arch", [a + "-reduced" for a in ALL_ARCHS] + ["qwen3-1.7b",
                                                                          "bert-base"])
def test_derive_plan_matches_jax_field_for_field(arch):
    seen = set()
    for mesh, kw in itertools.product(MESHES, KNOBS):
        theirs = jax_derive_plan(jax_get_config(arch), mesh, TPU_V5E, **kw)
        mine = derive_plan(get_config(arch), mesh, V5E, **kw)
        assert dataclasses.asdict(mine) == _jax_fields(theirs), (mesh, kw)
        assert (mine.pod_axis, mine.data_axis, mine.model_axis) == (
            theirs.pod_axis, theirs.data_axis, theirs.model_axis)
        assert all(mine.mode_for(s) == theirs.mode_for(s) for s in ("mha", "ffn"))
        seen.add((mine.seq_parallel_acts, mine.dp_over_model, mine.pod_role))
    # the grid reaches Megatron-SP and the folded model axis where the arch
    # admits them (GQA reduced configs refuse SP, as in JAX)
    assert any(dp for _, dp, _ in seen)


def test_grid_covers_every_decision():
    """Over the archs, meshes and knobs the grid hits both modes, SP on,
    ZeRO, the pipeline's microbatch fill and a sequence-sharded batch."""
    hits = {"sp": False, "zero": False, "fill": False, "seq_shard": False, "temporal": False,
            "spatial": False}
    for arch in ("bert-base-reduced", "qwen3-1.7b", "mistral-large-123b"):
        for mesh, kw in itertools.product(MESHES, KNOBS):
            p = derive_plan(get_config(arch), mesh, V5E, **kw)
            hits["sp"] |= p.seq_parallel_acts
            hits["zero"] |= p.zero_weights
            hits["fill"] |= p.pod_role == "pipeline" and p.microbatches >= p.pod_axis > 1
            hits["seq_shard"] |= p.seq_shard
            hits["temporal"] |= p.mha.mode == TEMPORAL
            hits["spatial"] |= p.mha.mode == SPATIAL
    assert all(hits.values()), hits


def test_h100_factor1_uses_the_mm_kernel_tile():
    """On the H100 entry the engine's one-shot MM is the tensor-core MM
    kernel's CTA tile (the tile search finds none in its shared memory):
    qwen3-1.7b at 2048 positions on a 1 x 2 mesh."""
    assert one_shot_mm(H100_SXM) == H100_MM_CTA_TILE == (128, 128, 64)
    cfg = get_config("qwen3-1.7b")
    plan = derive_plan(cfg, {"data": 1, "model": 2}, H100_SXM, batch=8, seq_len=2048)
    engine = 2 * 128 * 128 * 64
    assert plan.mha.factor1 == 4.0 * 2048 * cfg.d_model * cfg.n_heads * cfg.d_head / engine
    assert plan.ffn.factor1 == 2.0 * 2048 * cfg.d_model * cfg.d_ff / engine
    assert plan.mha.factor1 >= PRG_MAX_PIPELINE_DEPTH  # training folds the model axis
    assert plan.dp_over_model and plan.mode_for("mha") == TEMPORAL
    # the TPU entry still runs the search, as in JAX
    assert one_shot_mm(V5E) != H100_MM_CTA_TILE


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-135m-reduced", "qwen3-moe-30b-a3b"])
def test_execution_plan_is_derive_plan_on_one_rank(arch):
    """``derive_execution_plan`` is ``derive_plan`` on the 1 x 1 mesh with
    the serving default; the training call equals the JAX training plan's
    1 x 1 decisions."""
    cfg = get_config(arch)
    assert derive_execution_plan(cfg) == derive_plan(cfg, {"data": 1, "model": 1},
                                                     training=False)
    mine = derive_execution_plan(cfg, training=True, batch=8, seq_len=64, hw=V5E)
    theirs = jax_derive_plan(jax_get_config(arch), {"data": 1, "model": 1}, TPU_V5E, batch=8,
                             seq_len=64)
    assert dataclasses.asdict(mine) == _jax_fields(theirs)

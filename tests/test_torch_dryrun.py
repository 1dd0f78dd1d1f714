"""The dry run on the meta device against the JAX package's compiled one.

* ``build_cell`` at (data 1, model 1) for reduced qwen3, qwen3-moe, rwkv6
  and whisper (train, prefill, decode): each cell's argument bytes equal
  those of JAX's ``jax.eval_shape`` argument structures (no compile).
* FLOPs against ``analyze_hlo`` of JAX's compiled cells.  Attention archs
  agree exactly once attention is counted JAX's way: the port prices its
  flash kernel by the (query, key) pairs the mask leaves visible (4 H D a
  pair forward, 10 H D backward), JAX's ``blocked_attention`` computes
  every block (4 H D S^2 forward, twice that in the backward), so the
  port's aten matrix products plus 4 H D S^2 B a layer (x3 in training)
  equal JAX's count.  rwkv6's WKV is priced by its kernel's 6 D^2 (8 D^2
  backward) a token and head where JAX counts ``wkv_chunked``'s chunk
  products: within 5% at S 64 (-4.0% prefill, +2.9% train).
* On a ``DryRunMesh`` (data 2, model 4) each rank's local leaves have JAX's
  shard shapes, collectives are recorded and ``torch.distributed`` is
  never initialized.  The multi-pod pipeline cells record the reason the
  reference's ``check_pipeline_supported`` gives; a ZeRO pipeline cell on
  (pod 2, data 16, model 1) traces with its data-axis gathers and
  scatters.
* The roofline helpers equal JAX's for every arch x shape; the kernels'
  meta routes and the collectives' dry-run route record what they stand
  for.

JAX's cells run in one subprocess: ``repro.launch.dryrun`` sets its 512
placeholder devices when imported."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_SHAPES as JAX_SHAPES
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.core import hardware as jax_hw
from repro.core import roofline as jax_roofline
from repro.core.plan import derive_plan as jax_derive_plan
from repro.dist.sharding import Shardings as JaxShardings
from repro.dist.sharding import _key_names
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import ALL_SHAPES, DECODE_32K, PREFILL_32K, TRAIN_4K, get_config
from repro_torch.core import op_cost
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.roofline import (RooflineReport, _ring_seconds, analytic_memory_floor,
                                       model_flops_for)
from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import Shardings, tensor_parallel
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import DryRunMesh
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves_with_path
from repro_torch.train.train_step import make_train_step
from test_torch_fsdp_layout import FakeMesh, _jax_plan

ROOT = Path(__file__).resolve().parents[1]
TPU = HardwareSpec(**dataclasses.asdict(jax_hw.TPU_V5E))
ARCHS = ("qwen3-1.7b-reduced", "qwen3-moe-30b-a3b-reduced", "rwkv6-1.6b-reduced",
         "whisper-small-reduced")
KINDS = {"train": TRAIN_4K, "prefill": PREFILL_32K, "decode": DECODE_32K}
B, S = 2, 64
FLOP_CELLS = (("qwen3-1.7b-reduced", "train"), ("qwen3-1.7b-reduced", "prefill"),
              ("rwkv6-1.6b-reduced", "train"), ("rwkv6-1.6b-reduced", "prefill"))

_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, numpy as np
from repro.configs import DECODE_32K, PREFILL_32K, TRAIN_4K, get_config
from repro.launch.dryrun import build_cell
from repro.core.hlo_cost import analyze_hlo
mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
kinds = {"train": TRAIN_4K, "prefill": PREFILL_32K, "decode": DECODE_32K}
out = {}
for arch in %(archs)r:
    for kind, base in kinds.items():
        shape = dataclasses.replace(base, seq_len=%(S)d, global_batch=%(B)d)
        fn, args, plan = build_cell(get_config(arch), shape, mesh)
        out[arch + "|" + kind] = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                                     for x in jax.tree.leaves(args))
        if (arch, kind) in %(flops)r:
            out["flops|" + arch + "|" + kind] = analyze_hlo(fn.lower(*args).compile().as_text()).flops
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    code = _JAX % {"archs": ARCHS, "S": S, "B": B, "flops": FLOP_CELLS}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"}, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _cell(arch, kind, mesh=None, hw=TPU):
    cfg = get_config(arch)
    shape = dataclasses.replace(KINDS[kind], seq_len=S, global_batch=B)
    mesh = mesh or DryRunMesh({"data": 1, "model": 1})
    fn, args, plan = dryrun.build_cell(cfg, shape, mesh, hw=hw)
    return cfg, shape, mesh, fn, args, plan


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_arg_bytes_equal_jax(arch, kind, jax_cells):
    cfg, shape, mesh, fn, args, plan = _cell(arch, kind)
    # weights, states, caches and batches are meta; the dense cache's counts are host ints
    assert all(t.is_meta for t in op_cost._tensors(args) if t.dtype != torch.int32
               or t.dim() > 1)
    assert dryrun.cell_arg_bytes(cfg, shape, mesh, args, plan) == jax_cells[f"{arch}|{kind}"]


@pytest.mark.parametrize("arch,kind", FLOP_CELLS)
def test_flops_against_the_compiled_jax_cell(arch, kind, jax_cells):
    cfg, shape, mesh, fn, args, plan = _cell(arch, kind)
    _, cost, counted = op_cost.analyze_step(fn, *args)
    want = jax_cells[f"flops|{arch}|{kind}"]
    kernel_flops = sum(k["flops"] for k in cost.kernels.values())
    assert cost.flops == counted + kernel_flops  # the flop counter sees no kernel
    if cfg.rnn_heads:
        assert cost.flops == pytest.approx(want, rel=0.05)
    else:
        passes = 3 if kind == "train" else 1
        attention = 4 * cfg.n_heads * cfg.d_head * B * S * S * cfg.n_layers * passes
        assert counted + attention == want
        assert cost.kernels["flash_attention"]["calls"] == cfg.n_layers


def test_kernel_calls_of_a_training_cell():
    cfg, shape, mesh, fn, args, plan = _cell("qwen3-1.7b-reduced", "train")
    assert not plan.remat and plan.microbatches == 1
    _, cost, _ = op_cost.analyze_step(fn, *args)
    L = cfg.n_layers
    assert cost.kernel_calls() == {"flash_attention": L, "flash_attention_bwd": L,
                                   "rmsnorm": 4 * L + 1, "rmsnorm_bwd": 4 * L + 1}
    remat = dataclasses.replace(plan, remat=True)
    step = make_train_step(cfg, remat, OptimizerConfig(), device="meta")
    _, cost, _ = op_cost.analyze_step(step, *args)
    assert cost.kernel_calls()["flash_attention"] == 2 * L  # again in the backward
    state = args[0]
    assert cost.peak_bytes > 0 and dryrun.arg_bytes(state) == sum(
        t.numel() * t.element_size() for t in op_cost._tensors(state))


def test_rwkv_cell_prices_the_wkv_kernel():
    cfg, shape, mesh, fn, args, plan = _cell("rwkv6-1.6b-reduced", "train")
    _, cost, _ = op_cost.analyze_step(fn, *args)
    assert cost.kernel_calls()["wkv"] == cost.kernel_calls()["wkv_bwd"] == cfg.n_layers
    from repro_torch.kernels.rwkv6.ops import backward_cost, cost as wkv_cost

    r = torch.empty((B, S, cfg.rnn_heads, cfg.d_head), dtype=torch.bfloat16, device="meta")
    assert cost.kernels["wkv"]["flops"] == cfg.n_layers * wkv_cost(r)[0]
    assert cost.kernels["wkv_bwd"]["bytes"] == cfg.n_layers * backward_cost(r)[1]


# ------------------------------------------------------------ the mesh
def _jax_shards(arch, mesh, plan, kw):
    jcfg = jax_get_config(arch)
    jplan = _jax_plan(jcfg, mesh, plan, **kw)
    jsh = JaxShardings(FakeMesh(dict(mesh)), jplan, jcfg)
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg, jplan))
    want = {}
    for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec = tuple(jsh.param_spec(p, x))
        want["|".join(_key_names(p))] = [
            d // int(np.prod([mesh.get(a, 1) for a in (() if e is None else (
                e if isinstance(e, tuple) else (e,)))])) for d, e in zip(x.shape, spec)]
    return want


@pytest.mark.parametrize("arch,kw", [("qwen3-1.7b", {}), ("qwen3-1.7b", {"force_mode": "spatial"}),
                                     ("rwkv6-1.6b", {})])
def test_dry_run_mesh_shards_equal_jax(arch, kw):
    """Full-size weights as meta tensors on (data 2, model 4): at the first
    and the last rank each local leaf of the cell's state has the shape of
    JAX's shard of it; the step records its collectives, and no process
    group exists before or after."""
    mesh_shape = {"data": 2, "model": 4}
    shape = dataclasses.replace(TRAIN_4K, seq_len=256, global_batch=8)
    cfg = get_config(arch)
    for coords in ({"data": 0, "model": 0}, {"data": 1, "model": 3}):
        mesh = DryRunMesh(mesh_shape, coords)
        fn, (state, batch), plan = dryrun.build_cell(cfg, shape, mesh, plan_overrides=kw)
        want = _jax_shards(arch, mesh_shape, plan, {"batch": 8, "seq_len": 256,
                                                    **kw})
        got = {"|".join(map(str, p)): list(x.shape)
               for p, x in tree_leaves_with_path(state.params)}
        assert got == want
        _, cost, _ = op_cost.analyze_step(fn, state, batch)
        assert cost.collectives and cost.collective_operand_bytes > 0
        assert {g for _, _, g, _ in cost.collectives} <= {2, 4, 8}
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["mistral-large-123b", "mixtral-8x7b"])
def test_multi_pod_refusal_cell_records_the_item(tmp_path, arch):
    """The multi-pod pipeline cells (pod 2, data 16, model 16) record the
    reason the reference's own ``check_pipeline_supported`` gives for its
    plan on that mesh (a model axis the pipeline does not compose with;
    mixtral is MoE too), not a refusal of their ZeRO weights."""
    from repro.models.transformer import check_pipeline_supported as jax_check

    rec = dryrun.run_cell(arch, TRAIN_4K, multi_pod=True, out_dir=tmp_path,
                          plan_overrides={"pod_role": "pipeline"}, tag="__pipeline")
    assert rec["status"] == "error" and "ZeRO" not in rec["error"]
    jplan = jax_derive_plan(jax_get_config(arch), dryrun.MULTI_POD, jax_hw.TPU_V5E,
                            batch=TRAIN_4K.global_batch, seq_len=TRAIN_4K.seq_len,
                            training=True, pod_role="pipeline")
    with pytest.raises(ValueError) as jax_err:
        jax_check(jax_get_config(arch), jplan, TRAIN_4K.global_batch)
    reasons = ["model axis 16 > 1 (pipeline composes with DP, not TP; put the spare devices "
               "on 'data')"] + (["MoE aux losses do not cross stage boundaries yet"]
                                if arch == "mixtral-8x7b" else [])
    for reason in reasons:
        assert reason in rec["error"] and reason in str(jax_err.value), rec["error"]
    assert json.loads((tmp_path / "multi" / f"{arch}__train_4k__pipeline.json")
                      .read_text())["status"] == "error"


def test_zero_pipeline_cell_traces_with_its_data_collectives():
    """A ZeRO pipeline cell on a model-1 mesh (pod 2, data 16, model 1):
    phi4-mini-3.8b ``train_4k``, whose plan there picks ZeRO (mistral-large-
    123b's does too and traces the same way, in ~40 s on the CPU).  Each
    rank's stage slice of the stack is cut over pod and data as JAX's
    shards are; the step records the stage's all-gathers and the gradients'
    reduce-scatters over the 16 data ranks, the ticks' permutes over the 2
    stages, under JAX's op names."""
    arch, mesh_shape = "phi4-mini-3.8b", {"pod": 2, "data": 16, "model": 1}
    cfg = get_config(arch)
    mesh = DryRunMesh(mesh_shape, {"pod": 1, "data": 15, "model": 0})
    fn, (state, batch), plan = dryrun.build_cell(cfg, TRAIN_4K, mesh,
                                                 plan_overrides={"pod_role": "pipeline"})
    assert plan.zero_weights and plan.pod_role == "pipeline" and plan.model_axis == 1
    wq = state.params["blocks"]["stack"][0]["attn"]["wqkv" if plan.fuse_qkv else "wq"]
    width = (cfg.n_heads + (2 * cfg.n_kv_heads if plan.fuse_qkv else 0)) * cfg.d_head
    assert tuple(wq.shape) == (cfg.n_layers // 2, cfg.d_model, width // 16)
    _, cost, _ = op_cost.analyze_step(fn, state, batch)
    groups = {(op, g) for op, _, g, _ in cost.collectives}
    assert {("all-gather", 16), ("reduce-scatter", 16), ("collective-permute", 2)} <= groups
    assert not torch.distributed.is_initialized()


PLAN_FIELDS = ("mha_mode", "ffn_mode", "mha_factor1", "ffn_factor1", "fuse_qkv", "p_atb",
               "head_shards", "remat", "microbatches", "embed_shard", "moe_mode", "moe_dispatch",
               "seq_shard", "seq_parallel_acts", "grad_compression", "pod_role",
               "pipeline_stages", "pipeline_bubble", "serve")


def test_cli_writes_the_record(tmp_path, capsys):
    """``--arch qwen3-1.7b --shape train_4k --mesh single``: JAX's plan
    fields and every ``RooflineReport`` field, collectives on the 256-rank
    mesh; then ``--family --hardware h100`` prints a frontier."""
    dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k", "--mesh", "single",
                 "--out-dir", str(tmp_path / "dryrun")])
    rec = json.loads((tmp_path / "dryrun" / "single" / "qwen3-1.7b__train_4k.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert set(PLAN_FIELDS) == set(rec["plan"])
    assert {f.name for f in dataclasses.fields(RooflineReport)} <= set(rec)
    assert rec["n_collectives"] > 0 and rec["collective_s"] > 0
    assert rec["kernel_calls"]["flash_attention"] == 2 * rec["kernel_calls"][
        "flash_attention_bwd"]  # remat: the forward runs again in the backward
    assert "ok" in capsys.readouterr().out
    dryrun.main(["--family", "--hardware", "h100", "--out-dir", str(tmp_path / "dryrun")])
    out = capsys.readouterr().out
    assert "Accelerator family: qwen3-1.7b on h100" in out and "| 0 |" in out
    assert (tmp_path / "family" / "h100__qwen3-1.7b.json").exists()


# ------------------------------------------------------- roofline helpers
def test_ring_seconds_equal_jax():
    for op in op_cost.COLLECTIVE_OPS:
        for g in (1, 2, 16, 256):
            for bw in (0.0, 50e9, 450e9):
                assert _ring_seconds(op, 3.5e8, g, bw) == jax_roofline._ring_seconds(
                    op, 3.5e8, g, bw)


def test_model_flops_and_memory_floor_equal_jax():
    for arch in ASSIGNED_ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for shape, jshape in zip(ALL_SHAPES, JAX_SHAPES):
            for mesh in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}):
                n = int(np.prod(list(mesh.values())))
                plan = jax_derive_plan(jcfg, mesh, jax_hw.TPU_V5E, batch=jshape.global_batch,
                                       seq_len=jshape.seq_len, training=jshape.kind == "train")
                assert analytic_memory_floor(cfg, shape, plan, n) == \
                    jax_roofline.analytic_memory_floor(jcfg, jshape, plan, n), (arch, shape)
            for training in (False, True):
                assert model_flops_for(cfg, shape, training) == jax_roofline.model_flops_for(
                    jcfg, jshape, training)


# ------------------------------------------------ meta routes and recorder
def test_kernel_meta_routes_record_their_cost():
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.mm_pu import ops as mm
    from repro_torch.kernels.paged_attention import ops as paged
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6 import ops as wkv

    meta = dict(device="meta")
    launches = (flash.LAUNCHES, flash.BWD_LAUNCHES, rms.LAUNCHES, rms.BWD_LAUNCHES,
                wkv.LAUNCHES, wkv.BWD_LAUNCHES, paged.LAUNCHES, mm.LAUNCHES)
    q = torch.empty((2, 64, 4, 32), dtype=torch.bfloat16, **meta, requires_grad=True)
    kv = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16, **meta, requires_grad=True)
    x = torch.empty((2, 64, 96), dtype=torch.bfloat16, **meta, requires_grad=True)
    scale = torch.empty((96,), dtype=torch.float32, **meta, requires_grad=True)
    r = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16, **meta, requires_grad=True)
    w = torch.empty((2, 64, 2, 32), dtype=torch.float32, **meta)
    u = torch.empty((2, 32), dtype=torch.float32, **meta)
    with op_cost.OpRecorder() as rec:
        o = flash.flash_attention(q, kv, kv, causal=True)
        y = rms.rmsnorm(x, scale)
        h = wkv.wkv(r, r, r, w, u)
        (o.float().sum() + y.float().sum() + h.sum()).backward()
        pq = torch.empty((3, 1, 4, 32), dtype=torch.bfloat16, **meta)
        entry = {"k": torch.empty((9, 16, 2, 32), dtype=torch.bfloat16, **meta)}
        entry["v"] = entry["k"]
        table = torch.empty((3, 3), dtype=torch.int32, **meta)
        lens = torch.empty((3,), dtype=torch.int32, **meta)
        po = paged.paged_attention(pq, entry, table, lens, lens, block_size=16)
        mo = mm.mm_pu(torch.empty((8, 64), dtype=torch.bfloat16, **meta),
                      torch.empty((64, 48), dtype=torch.bfloat16, **meta))
    assert o.shape == q.shape and y.shape == x.shape and h.shape == r.shape
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape and scale.grad.shape == (96,)
    assert po.shape == pq.shape and mo.shape == (8, 48)
    k = rec.cost.kernels
    assert {n: v["calls"] for n, v in k.items()} == {
        "flash_attention": 1, "flash_attention_bwd": 1, "rmsnorm": 1, "rmsnorm_bwd": 1,
        "wkv": 1, "wkv_bwd": 1, "paged_attention": 1, "mm_pu": 1}
    assert (k["flash_attention"]["flops"], k["flash_attention"]["bytes"]) == flash.cost(q, kv)
    assert k["flash_attention"]["flops"] == 4 * 4 * 32 * 2 * (64 * 65 // 2)
    assert k["flash_attention_bwd"]["flops"] == 10 * 4 * 32 * 2 * (64 * 65 // 2)
    assert k["rmsnorm"]["bytes"] == 2 * x.numel() * 2 + 4 * 96
    assert k["paged_attention"]["flops"] == 4 * 32 * 4 * 1 * 3 * 3 * 16
    assert k["mm_pu"]["flops"] == 2 * 8 * 48 * 64
    assert (flash.LAUNCHES, flash.BWD_LAUNCHES, rms.LAUNCHES, rms.BWD_LAUNCHES, wkv.LAUNCHES,
            wkv.BWD_LAUNCHES, paged.LAUNCHES, mm.LAUNCHES) == launches


def test_collectives_on_a_dry_run_mesh():
    mesh = DryRunMesh({"pod": 2, "data": 2, "model": 4}, {"pod": 1, "data": 0, "model": 3})
    x = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
    stats = dict(C.STATS["calls"])
    with op_cost.OpRecorder() as rec:
        assert C.all_reduce(x, ("data", "model"), mesh).shape == (8, 6)
        assert C.all_gather(x, "model", mesh, dim=1).shape == (8, 24)
        assert C.reduce_scatter(x, "model", mesh, dim=0).shape == (2, 6)
        assert C.permute(x, "pod", mesh, dst=mesh.ranks("pod")[0], src=None).shape == (8, 6)
        assert C.all_reduce(x, "pod", DryRunMesh({"pod": 1})).shape == (8, 6)  # one rank
    nb = 8 * 6 * 2
    assert sorted(rec.cost.collectives) == sorted([
        ("all-reduce", nb, 8, 1), ("all-gather", nb, 4, 1), ("reduce-scatter", nb, 4, 1),
        ("collective-permute", nb, 2, 1)])
    assert dict(C.STATS["calls"]) == stats and not torch.distributed.is_initialized()
    assert mesh.rank == 1 * 8 + 0 * 4 + 3 and mesh.ranks("model") == [8, 9, 10, 11]


def test_recorder_counts_products_bytes_and_live_peak():
    a = torch.empty((64, 128), device="meta")
    b = torch.empty((128, 32), device="meta")

    def step(a, b):
        h = a @ b  # 64 x 32 f32
        h2 = torch.relu(h)
        del h
        return h2.sum()

    _, cost, counted = op_cost.analyze_step(step, a, b)
    assert cost.flops == counted == 2 * 64 * 128 * 32
    assert cost.hbm_bytes == (64 * 32 + 64 * 128 + 128 * 32) * 4 + 2 * 64 * 32 * 4 + (
        64 * 32 + 1) * 4
    assert cost.peak_bytes == 2 * 64 * 32 * 4  # h and h2 live at once; the arguments not


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b", "whisper-small"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cells_run_on_each_ranks_shards(arch, kind):
    """Under tensor parallelism (SPATIAL forced on (data 2, model 4)) the
    serving cells run sharded: a rank's rows, its heads' dense cache
    (``init_cache(shardings=)``), g's all-reduces recorded, the logits'
    vocab columns gathered where the head is cut."""
    cfg = get_config(arch)
    shape = dataclasses.replace(KINDS[kind], seq_len=256, global_batch=8)
    mesh = DryRunMesh({"data": 2, "model": 4}, {"data": 1, "model": 2})
    fn, args, plan = dryrun.build_cell(cfg, shape, mesh, plan_overrides={"force_mode": "spatial"})
    assert tensor_parallel(plan)
    sh = Shardings(mesh, plan, cfg)
    tokens = args[1] if kind == "decode" else args[1]["tokens"]
    assert tokens.shape[0] == 4  # this rank's rows
    logits, cache = op_cost.analyze_step(fn, *args)[0]
    assert logits.shape == (4, 1, cfg.vocab_size) and logits.is_meta
    if kind == "decode":
        entry = cache["layers"]["stack"][0]
        if "attn" in entry and sh.attention_sharded():
            assert entry["attn"]["k"].shape[-2] == cfg.n_kv_heads // 4
        if "rwkv" in entry and sh.recurrent_sharded():
            assert entry["rwkv"]["S"].shape[-3] == cfg.rnn_heads // 4
    _, cost, _ = op_cost.analyze_step(fn, *args)
    ops = {o for o, _, _, _ in cost.collectives}
    assert "all-reduce" in ops and {g for _, _, g, _ in cost.collectives} <= {4}

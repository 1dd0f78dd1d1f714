"""The weight layouts of the FSDP slice without training: what
``derive_plan`` picks on the H100 entry for two ranks, each rank's local
leaves of full-size trees against JAX's shard shapes on the same mesh and
plan, and checkpoints across the FSDP, one-rank and TP layouts.

The JAX package has no H100 entry (its tile search finds no tile there), so
JAX's plan is derived on the TPU entry and given the port's layout fields
(``dp_over_model``, ``zero_weights``, the stage modes, ``embed_shard``,
``moe_mode``, ``seq_parallel_acts``, ``fuse_qkv``); its ``param_spec`` then
gives each leaf's shard shape.  Every leaf of every case matches: none of
them reaches an exception ROADMAP lists (attention whose heads do not
divide, SP's tail layers, the pipeline's data axes)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan as jax_derive_plan
from repro.dist.sharding import Shardings as JaxShardings
from repro.dist.sharding import _key_names
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.plan import derive_plan
from repro_torch.dist.sharding import Shardings, unexecuted_layout
from repro_torch.launch.train import launch_plan
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import tree_leaves_with_path
from test_torch_dist_ranks import ShapeMesh, run_ranks
from torch_tp import HEADS, port_cfg


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi4-mini-3.8b", "rwkv6-1.6b",
                                  "whisper-small"])
def test_two_ranks_fold_on_the_h100_entry(arch):
    """The flag-free two-rank launch and ``--dp 2`` at B 8 x 2048 fold the
    model axis into data parallelism; phi4-mini-3.8b's ``--dp 2`` also takes
    ZeRO.  Every plan executes (plans only: no weights)."""
    cfg = get_config(arch)
    for flags, shape in (({}, {"data": 1, "model": 2}), ({"dp": 2}, {"data": 2, "model": 1})):
        got, plan = launch_plan(cfg, 2, batch=8, seq=2048, **flags)
        assert got == shape and plan.dp_over_model, (arch, flags)
        assert unexecuted_layout(plan, cfg) is None
        assert plan.zero_weights == (arch == "phi4-mini-3.8b" and flags == {"dp": 2})


def _meta_tree(cfg, plan, monkeypatch):
    from repro_torch.models import params as P

    meta = lambda self, shape, scale=0.02: torch.empty(tuple(shape), device="meta")  # noqa: E731
    monkeypatch.setattr(P._Init, "normal", meta)
    monkeypatch.setattr(P._Init, "zeros", meta)
    return init_params(cfg, plan, torch.float32, device="cpu")


def _jax_plan(jcfg, mesh, plan, **kw):
    """JAX's plan on the TPU entry with the port's layout fields."""
    jplan = jax_derive_plan(jcfg, mesh, TPU_V5E, training=True, **kw)
    return dataclasses.replace(
        jplan, dp_over_model=plan.dp_over_model, zero_weights=plan.zero_weights,
        embed_shard=plan.embed_shard, moe_mode=plan.moe_mode,
        seq_parallel_acts=plan.seq_parallel_acts, fuse_qkv=plan.fuse_qkv,
        mha=dataclasses.replace(jplan.mha, mode=plan.mha.mode),
        ffn=dataclasses.replace(jplan.ffn, mode=plan.ffn.mode))


LAYOUTS = {
    "phi4-mini fold": ("phi4-mini-3.8b", {"data": 1, "model": 2}, {}),
    "phi4-mini dp 2 ZeRO": ("phi4-mini-3.8b", {"data": 2, "model": 1}, {}),
    "qwen3 dp 2": ("qwen3-1.7b", {"data": 2, "model": 1}, {}),
    "rwkv6 fold": ("rwkv6-1.6b", {"data": 1, "model": 2}, {}),
    "whisper fold": ("whisper-small", {"data": 1, "model": 2}, {}),
    "mistral ZeRO 16 x 16": ("mistral-large-123b", {"data": 16, "model": 16},
                             {"batch": 256, "seq_len": 4096}),
    "qwen3 TP vocab": ("qwen3-1.7b", {"data": 1, "model": 2},
                       {"batch": 4, "force_mode": "spatial"}),
    "qwen3 SP vocab": ("qwen3-1.7b", {"data": 1, "model": 2},
                       {"batch": 8, "force_mode": "spatial", "seq_parallel": True}),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_local_leaves_are_jax_shards(case, monkeypatch):
    """Full-size trees as meta tensors on a shape-only mesh: at the first
    and the last rank's coordinates every local leaf has the shape of JAX's
    shard of it."""
    arch, mesh, kw = LAYOUTS[case]
    kw = {"batch": 8, "seq_len": 2048, **kw}
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    plan = derive_plan(cfg, mesh, H100_SXM, training=True, **kw)
    assert unexecuted_layout(plan, cfg) is None
    jsh = JaxShardings(FakeMesh(dict(mesh)), _jax_plan(jcfg, mesh, plan, **kw), jcfg)
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg,
                                                    _jax_plan(jcfg, mesh, plan, **kw)))
    want = {}
    for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec = tuple(jsh.param_spec(p, x)) + (None,) * (len(x.shape) - len(jsh.param_spec(p, x)))
        want["|".join(_key_names(p))] = [d // int(np.prod([mesh.get(a, 1) for a in (
            () if e is None else (e if isinstance(e, tuple) else (e,)))])) for d, e in zip(
            x.shape, spec)]
    tree = _meta_tree(cfg, plan, monkeypatch)
    last = {a: n - 1 for a, n in mesh.items()}
    sharded = 0
    for coords in ({a: 0 for a in mesh}, last):
        sh = Shardings(ShapeMesh(mesh, coords), plan, cfg)
        shard = sh.manual_param_shardings(tree)
        got = {"|".join(map(str, p)): list(s.local(x).shape) for (p, x), (_, s) in zip(
            tree_leaves_with_path(tree), tree_leaves_with_path(shard))}
        assert got == want
        sharded += sum(g != list(x.shape) for g, (_, x) in zip(got.values(),
                                                               tree_leaves_with_path(tree)))
    assert sharded > 0


# ------------------------------------------------------------------ checkpoints
def _layouts(cfg, mesh):
    """The FSDP (dp_over_model) and the TP plan of ``cfg`` on ``mesh``."""
    fsdp = dataclasses.replace(derive_plan(cfg, mesh, batch=4, seq_len=16, training=True),
                               dp_over_model=True)
    tp = derive_plan(cfg, mesh, batch=4, seq_len=16, training=True, force_mode="spatial")
    return fsdp, tp


def _ckpt_rank(rank, ckpt_dir):
    """Each layout's shards saved (gathered, rank 0 writes) and every save
    restored onto every layout."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.dist.sharding import gather, place
    from repro_torch.launch.mesh import Mesh

    cfg = port_cfg("qwen3-1.7b", HEADS)
    mesh = Mesh({"data": 1, "model": 2})
    plans = dict(zip(("fsdp", "tp"), _layouts(cfg, dict(mesh.shape))))
    full = init_params(cfg, plans["tp"], torch.float32,
                       generator=torch.Generator().manual_seed(3), device="cpu")
    out = {}
    for name, plan in plans.items():
        shard = Shardings(mesh, plan, cfg).manual_param_shardings(full)
        local = place(full, shard)
        whole = gather(local, shard)  # every rank gathers; rank 0 writes
        if rank == 0:
            save_checkpoint(f"{ckpt_dir}/{name}", 1, whole)
        out[name] = {"local": local, "shard": shard}
    torch.distributed.barrier()
    for name, o in out.items():
        o["restored"] = {src: restore_checkpoint(f"{ckpt_dir}/{src}", 1, o["local"],
                                                 shardings=o["shard"])
                         for src in ("one", "fsdp", "tp")}
        del o["shard"]
    return out


def test_checkpoints_round_trip_across_layouts(tmp_path):
    """One process's checkpoint, an FSDP layout's and a TP layout's: each
    restored onto each layout (and the two-rank saves on one process)
    bit-exact; the FSDP ranks hold different halves of every projection."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import tree_leaves

    cfg = port_cfg("qwen3-1.7b", HEADS)
    full = init_params(cfg, _layouts(cfg, {"data": 1, "model": 2})[1], torch.float32,
                       generator=torch.Generator().manual_seed(3), device="cpu")
    save_checkpoint(str(tmp_path / "one"), 1, full)
    res = run_ranks(_ckpt_rank, 2, tmp_path, str(tmp_path))
    for src in ("fsdp", "tp"):
        back = restore_checkpoint(str(tmp_path / src), 1, full)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(full)))
    for r in res:
        for name in ("fsdp", "tp"):
            for src, got in r[name]["restored"].items():
                assert all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(got), tree_leaves(r[name]["local"]))), (name, src)
    w1 = [r["fsdp"]["local"]["blocks"]["stack"][0]["ffn"]["w1"] for r in res]
    assert w1[0].shape[-1] * 2 == full["blocks"]["stack"][0]["ffn"]["w1"].shape[-1]
    assert not torch.equal(w1[0], w1[1])

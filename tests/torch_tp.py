"""Shared set-up for the tensor-parallel tests (``tests/test_torch_tp_*.py``):
JAX's GSPMD runs on fake host devices in a subprocess, the port's manual
tensor parallelism on gloo ranks on the CPU (``test_torch_dist_ranks``),
both from the same weights (JAX's ``init_params`` at key 0) and the same
numpy batches, f32.

Not a test module.  The reduced configs have one KV head, which cannot
split over two ranks, so the cases widen them to 4 query and 2 KV heads in
both packages (``dataclasses.replace``).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

B, S = 4, 16
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
HEADS = {"n_heads": 4, "n_kv_heads": 2}
# the MoE width split: 3 experts do not divide over 2 ranks, and a width
# of 512 leaves each rank 256 columns, at least the TPU entry's MXU edge,
# so derive_plan picks moe_mode "tp"
MOE_TP = {**HEADS, "n_experts": 3, "moe_d_ff": 512}

# JAX's tensor-parallel train steps under GSPMD on ``n`` fake devices: the
# launcher's recipe (param shardings, the constrain callable, the gradient
# shardings), three AdamW steps; prints the losses, writes the parameters.
_JAX_TP = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + sys.argv[1]
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan
from repro.dist.sharding import Shardings, _key_names
from repro.launch.mesh import make_host_mesh
from repro.models.params import init_params
from repro.train.optimizer import OptimizerConfig, init_state
from repro.train.train_step import make_train_step
spec = json.loads(sys.argv[2])
cfg = dataclasses.replace(get_config(spec["arch"]).reduced(), **spec["replace"])
mesh = make_host_mesh(data=spec["data"])
plan = derive_plan(cfg, dict(mesh.shape), TPU_V5E, batch=spec["batch"], seq_len=spec["seq"],
                   training=True, force_mode="spatial", moe_dispatch=spec["dispatch"])
sh = Shardings(mesh, plan, cfg)
params = init_params(jax.random.PRNGKey(0), cfg, plan, dtype=jnp.float32)
param_sh = sh.param_shardings(params)
params = jax.device_put(params, param_sh)
step = jax.jit(make_train_step(cfg, plan, OptimizerConfig(**spec["opt"]), shard=sh.constrain,
                               grad_shardings=param_sh, mesh=mesh))
state = init_state(params)
z = np.load(spec["batches"])
losses = []
for i in range(spec["steps"]):
    b = {k: jnp.asarray(z[f"{k}{i}"]) for k in ("tokens", "targets")}
    state, m = step(state, jax.device_put(b, sh.batch_shardings(b)))
    losses.append(float(m["loss"]))
flat = {"|".join(_key_names(p)): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(state.params)[0]}
np.savez(spec["batches"] + ".params.npz", **flat)
print(json.dumps({"losses": losses, "moe_mode": plan.moe_mode, "fuse_qkv": plan.fuse_qkv,
                  "microbatches": plan.microbatches, "remat": plan.remat}))
"""


def tp_batches(cfg, seed, n=3):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")} for _ in range(n)]


def tp_plan(cfg, shape):
    """The port's training plan on ``shape`` with the TPU entry's numbers,
    SPATIAL forced (a tiny plan would fold to TEMPORAL): tensor parallel,
    and executed."""
    from repro_torch.core.plan import derive_plan
    from repro_torch.dist.sharding import tensor_parallel, unexecuted_layout

    plan = derive_plan(cfg, shape, v5e(), batch=B, seq_len=S, force_mode="spatial")
    assert tensor_parallel(plan) and unexecuted_layout(plan, cfg) is None
    return plan


def v5e():
    """The port's HardwareSpec with the TPU entry's numbers, so both
    packages derive the same plan."""
    from repro.core.hardware import TPU_V5E
    from repro_torch.core.hardware import HardwareSpec

    return HardwareSpec(**{f.name: getattr(TPU_V5E, f.name)
                           for f in dataclasses.fields(HardwareSpec)})


def port_cfg(arch: str, replace: dict):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), **replace)


def jax_params(arch: str, replace: dict, dispatch: str = "gshard"):
    """JAX's initial weights at key 0 as numpy (the subprocess draws the
    same), on the 1 x 1 plan (the fusion is the mesh plan's too)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core.plan import derive_plan
    from repro.models.params import init_params

    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    plan = derive_plan(cfg, {"data": 1, "model": 1}, batch=B, seq_len=S, moe_dispatch=dispatch)
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg, plan,
                                                dtype=jnp.float32))


def jax_tp_steps(tmp_path, arch: str, replace: dict, batches: list, *, data: int = 1,
                 dispatch: str = "gshard"):
    """Start JAX's GSPMD steps on (data, model 2) fake devices in a
    subprocess; the returned function waits for them and gives (the JSON
    record, the parameters after the steps keyed as ``keyed``), so the
    port's ranks can run meanwhile."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "batches.npz"
    np.savez(path, **{f"{k}{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    spec = {"arch": arch, "replace": replace, "data": data, "batch": batches[0]["tokens"].shape[0],
            "seq": batches[0]["tokens"].shape[1], "steps": len(batches), "opt": OPT,
            "dispatch": dispatch, "batches": str(path)}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_TP, str(2 * data), json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=".",
                            env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})

    def finish():
        try:
            out, err = proc.communicate(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-3000:]
        return (json.loads(out.strip().splitlines()[-1]),
                dict(np.load(str(path) + ".params.npz")))

    return finish


def keyed(tree) -> dict:
    from repro_torch.train.optimizer import tree_leaves_with_path

    return {"|".join(map(str, p)): x for p, x in tree_leaves_with_path(tree)}


def tp_train_rank(rank, cfg, plan, mesh_shape, np_params, batches, control=None):
    """This rank's three steps on its shards (``make_train_step`` over the
    mesh); returns the losses and the whole parameters after them.
    ``control`` plants one of ``chip_smoke.tp_controls_plant``'s faults
    (g skipped after the first layer's ``wo``; the replicated leaves'
    gradients summed over ``model``)."""
    from repro_torch.bridge import from_jax
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import Shardings, gather, place
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.optimizer import OptimizerConfig, init_state
    from repro_torch.train.train_step import make_train_step

    mesh = Mesh(mesh_shape)
    full = from_jax(np_params, device="cpu")
    shard = Shardings(mesh, plan, cfg).manual_param_shardings(full)
    state = init_state(place(full, shard), with_residual=False)
    step = make_train_step(cfg, plan, OptimizerConfig(**OPT), device="cpu", mesh=mesh,
                           grad_shardings=shard)
    from chip_smoke import tp_controls_plant  # the chip script's own controls

    undo = tp_controls_plant(control, mesh)
    C.reset_stats()
    losses = []
    try:
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    finally:
        undo()
    return {"losses": losses, "params": keyed(gather(state.params, shard)),
            "calls": dict(C.STATS["calls"])}


def tp_control_rank(rank, cfg, plan, mesh_shape, np_params, batches, control):
    """``tp_train_rank`` without and then with ``control``, in one process
    group."""
    return [tp_train_rank(rank, cfg, plan, mesh_shape, np_params, batches, c)
            for c in (None, control)]

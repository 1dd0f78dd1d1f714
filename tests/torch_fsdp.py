"""Shared set-up for the FSDP tests (``tests/test_torch_fsdp_*.py``): the
weight layouts with a data-parallel axis (ZeRO, ``dp_over_model``'s split)
and the vocab-split embedding and head under TP and SP.  JAX's GSPMD runs on
fake host devices in a subprocess, the port on gloo ranks on the CPU
(``test_torch_dist_ranks``), both from the same weights (JAX's
``init_params`` at key 0) and the same numpy batches, f32, three AdamW
steps (``tests/torch_tp.py``'s recipe and bounds: losses within 1e-5,
parameters within 1e-4).

Not a test module.  The reduced archs are too small for ``derive_plan`` to
choose ZeRO or the fold, so a case sets ``dp_over_model`` / ``zero_weights``
(and ``remat``) with ``dataclasses.replace`` on the same plan in both
packages.  The JAX subprocess also reports each leaf's shard shape
(``NamedSharding.shard_shape`` of ``Shardings.param_shardings``), which each
port rank's local leaves must equal.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import torch

from torch_tp import B, OPT, S, keyed, port_cfg, v5e

# Each case of argv[2] (a JSON list) on its own (data, model) mesh of the
# first devices, or (pod, data, model) where the case has a pod axis: the
# launcher's recipe under GSPMD, the case's steps; one
# JSON line a case (losses, each leaf's shard shape, the plan's fields),
# the parameters after the steps in "<batches>.params.npz".
_JAX_STEPS = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + sys.argv[1]
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan
from repro.dist.sharding import Shardings, _key_names
from repro.models.params import init_params
from repro.train.optimizer import OptimizerConfig, init_state
from repro.train.train_step import make_train_step
key = lambda p: "|".join(_key_names(p))
for spec in json.loads(sys.argv[2]):
    cfg = dataclasses.replace(get_config(spec["arch"]).reduced(), **spec["replace"])
    names = ("pod", "data", "model") if spec["pod"] > 1 else ("data", "model")
    shape = tuple(spec[a] for a in names)
    mesh = jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names),
                         devices=jax.devices()[:int(np.prod(shape))])
    plan = derive_plan(cfg, dict(mesh.shape), TPU_V5E, batch=spec["batch"],
                       seq_len=spec["seq"], training=True, **spec["derive"])
    plan = dataclasses.replace(plan, **spec["plan"])
    sh = Shardings(mesh, plan, cfg)
    params = init_params(jax.random.PRNGKey(0), cfg, plan, dtype=jnp.float32)
    param_sh = sh.param_shardings(params)
    shapes = {key(p): list(s.shard_shape(x.shape)) for (p, x), s in zip(
        jax.tree_util.tree_flatten_with_path(params)[0], jax.tree_util.tree_leaves(param_sh))}
    params = jax.device_put(params, param_sh)
    step = jax.jit(make_train_step(cfg, plan, OptimizerConfig(**spec["opt"]),
                                   shard=sh.constrain, grad_shardings=param_sh, mesh=mesh))
    state = init_state(params)
    z = np.load(spec["batches"])
    losses = []
    for i in range(spec["steps"]):
        b = {k: jnp.asarray(z[f"{k}{i}"]) for k in spec["keys"]}
        state, m = step(state, jax.device_put(b, sh.batch_shardings(b)))
        losses.append(float(m["loss"]))
    flat = {key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    np.savez(spec["batches"] + ".params.npz", **flat)
    print(json.dumps({"losses": losses, "shard_shapes": shapes, "remat": plan.remat,
                      "microbatches": plan.microbatches, "dp_over_model": plan.dp_over_model,
                      "zero_weights": plan.zero_weights, "embed_shard": plan.embed_shard,
                      "seq_parallel_acts": plan.seq_parallel_acts}), flush=True)
"""


def batches(cfg, seed, n=3):
    """``n`` numpy batches of B x S: tokens and targets, and an
    encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
        if cfg.enc_dec:
            b["enc_embeds"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


def fsdp_plan(cfg, shape: dict, derive: dict, plan: dict):
    """The port's training plan on ``shape`` with the TPU entry's numbers and
    ``derive``'s flags, then ``plan``'s fields replaced (as the JAX
    subprocess does)."""
    from repro_torch.core.plan import derive_plan

    p = derive_plan(cfg, shape, v5e(), batch=B, seq_len=S, training=True, **derive)
    return dataclasses.replace(p, **plan)


def jax_params(arch: str, replace: dict, fuse_qkv: bool):
    """JAX's initial weights at key 0 as numpy (the subprocess draws the
    same), with the case's q / k / v fusion."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core.plan import derive_plan
    from repro.models.params import init_params

    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    plan = derive_plan(cfg, {"data": 1, "model": 1}, batch=B, seq_len=S, fuse_qkv=fuse_qkv)
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg, plan,
                                                dtype=jnp.float32))


def jax_steps(tmp_path, arch: str, replace: dict, shape: dict, derive: dict, plan: dict,
              batch_list: list):
    """Start JAX's GSPMD steps on ``shape``'s fake devices in a subprocess;
    the returned function waits for them and gives (the JSON record, the
    parameters after the steps keyed as ``keyed``)."""
    done = jax_cases(tmp_path, [(arch, replace, shape, derive, plan, batch_list)])
    return lambda: done()[0]


def jax_cases(tmp_path, cases: list):
    """``jax_steps`` of every case of ``cases`` (tuples of its arguments) in
    one subprocess, each on a mesh of the first fake devices; the returned
    function waits for them and gives each case's (record, parameters)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    specs, paths = [], []
    for i, (arch, replace, shape, derive, plan, batch_list) in enumerate(cases):
        path = tmp_path / f"batches{i}.npz"
        np.savez(path, **{f"{k}{j}": v for j, b in enumerate(batch_list) for k, v in b.items()})
        paths.append(path)
        specs.append({"arch": arch, "replace": replace, "pod": shape.get("pod", 1),
                      "data": shape["data"], "model": shape["model"], "derive": derive,
                      "plan": plan, "batch": B,
                      "seq": S, "steps": len(batch_list), "opt": OPT,
                      "keys": sorted(batch_list[0]), "batches": str(path)})
    n = max(s["pod"] * s["data"] * s["model"] for s in specs)
    proc = subprocess.Popen([sys.executable, "-c", _JAX_STEPS, str(n), json.dumps(specs)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=".",
                            env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    result = []

    def finish():
        if not result:
            try:
                out, err = proc.communicate(timeout=400)
            finally:
                if proc.poll() is None:
                    proc.kill()
            assert proc.returncode == 0, err[-3000:]
            lines = out.strip().splitlines()[-len(cases):]
            result.extend((json.loads(line), dict(np.load(str(path) + ".params.npz")))
                          for line, path in zip(lines, paths))
        return result

    return finish


def fsdp_train_rank(rank, cfg, plan, shape, np_params, batch_list, control=None,
                    keep_state=False):
    """This rank's steps on its shards (``make_train_step`` over the mesh,
    the manual shardings handed to it); returns the losses, the whole
    parameters after them, the collectives' calls, each local leaf's shape
    and the state's bytes on this rank.  ``control`` plants one of
    ``chip_smoke.fsdp_controls_plant``'s faults, or of
    ``tp_controls_plant``'s (the chip script's own controls).
    ``keep_state``: the record also holds the trained state, the parameters'
    shardings and the mesh (for a caller in the same rank; they do not
    cross a process)."""
    from chip_smoke import FSDP_CONTROLS, PZ_CONTROLS, fsdp_controls_plant, tp_controls_plant
    from repro_torch.bridge import from_jax
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import Shardings, gather, place
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.optimizer import OptimizerConfig, init_state, tree_leaves
    from repro_torch.train.train_step import make_train_step

    mesh = Mesh(shape)
    full = from_jax(np_params, device="cpu")
    shard = Shardings(mesh, plan, cfg).manual_param_shardings(full)
    state = init_state(place(full, shard), with_residual=False)
    local = {k: list(v.shape) for k, v in keyed(state.params).items()}
    step = make_train_step(cfg, plan, OptimizerConfig(**OPT), device="cpu", mesh=mesh,
                           grad_shardings=shard)
    undo = (fsdp_controls_plant(control, cfg)
            if control is None or control in FSDP_CONTROLS + PZ_CONTROLS
            else tp_controls_plant(control, mesh))
    C.reset_stats()
    losses = []
    try:
        for b in batch_list:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    finally:
        undo()
    state_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves((state.params, state.m, state.v)))
    out = {"losses": losses, "params": keyed(gather(state.params, shard)),
           "calls": dict(C.STATS["calls"]), "local_shapes": local, "state_bytes": state_bytes}
    if keep_state:
        out.update(state=state, shard=shard, mesh=mesh, full=full)
    return out


def fsdp_control_rank(rank, cfg, plan, shape, np_params, batch_list, control):
    """``fsdp_train_rank`` without and then with ``control``, in one process
    group."""
    return [fsdp_train_rank(rank, cfg, plan, shape, np_params, batch_list, c)
            for c in (None, control)]


def check_against_jax(tmp_path, arch, replace, shape, derive, plan_fields, *, seed=80,
                      jax_run=None, whole=(), rank_fn=None, rank_args=()):
    """Three steps on the port's ranks and on JAX's fake devices: losses
    within 1e-5, every parameter within 1e-4, every rank's local leaf shapes
    equal to JAX's shard shapes (but the leaves of ``whole``, which the port
    does not cut over ``model`` where JAX does: ROADMAP's deliberate
    divergences),
    and the ranks' losses equal.  ``jax_run``: JAX's (record, parameters) of
    this case, from a ``jax_cases`` subprocess started with ``batches(cfg,
    seed)``; by default a subprocess of its own.  ``rank_fn`` (default
    ``fsdp_train_rank``) runs each rank, with ``rank_args`` after
    ``fsdp_train_rank``'s.  Returns the port's rank records and JAX's
    record."""
    from test_torch_dist_ranks import run_ranks

    cfg = port_cfg(arch, replace)
    plan = fsdp_plan(cfg, shape, derive, plan_fields)
    from repro_torch.dist.sharding import unexecuted_layout

    assert unexecuted_layout(plan, cfg) is None
    batch_list = batches(cfg, seed)
    done = jax_run or jax_steps(tmp_path / "jax", arch, replace, shape, derive, plan_fields,
                                batch_list)
    world = math.prod(shape.values())
    res = run_ranks(rank_fn or fsdp_train_rank, world, tmp_path, cfg, plan, shape,
                    jax_params(arch, replace, plan.fuse_qkv), batch_list, *rank_args)
    jx, jp = done()
    assert (jx["remat"], jx["microbatches"], jx["dp_over_model"], jx["zero_weights"],
            jx["embed_shard"], jx["seq_parallel_acts"]) == (
        plan.remat, plan.microbatches, plan.dp_over_model, plan.zero_weights, plan.embed_shard,
        plan.seq_parallel_acts)
    for r in res:
        assert max(abs(a - b) for a, b in zip(r["losses"], jx["losses"])) < 1e-5, (
            r["losses"], jx["losses"])
        assert r["params"].keys() == jp.keys()
        for k, p in r["params"].items():
            np.testing.assert_allclose(p.numpy(), jp[k], rtol=0, atol=1e-4, err_msg=k)
        for k in whole:  # not cut over model in the port, cut in JAX
            local, cut = r["local_shapes"][k], jx["shard_shapes"][k]
            assert np.prod(local) == shape["model"] * np.prod(cut), (k, local, cut)
        assert ({k: v for k, v in r["local_shapes"].items() if k not in whole}
                == {k: v for k, v in jx["shard_shapes"].items() if k not in whole})
        assert r["losses"][0] != r["losses"][-1]
    assert all(r["losses"] == res[0]["losses"] for r in res)
    return res, jx

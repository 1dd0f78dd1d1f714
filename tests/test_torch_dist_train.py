"""The port's mesh training paths against JAX's single-device results, f32
on bridged weights, ranks over gloo on the CPU:

* Megatron-SP on 2 ranks (model axis 2) for bert-base-reduced (JAX's
  ``tests/test_seq_parallel.py`` case) and qwen3-1.7b-reduced with 4 query /
  2 KV heads (the reduced config's single KV head cannot split over 2
  ranks, as JAX's test notes for GQA configs): ``forward`` within 1e-4 and
  every ``lm_loss`` gradient within 1e-5 of JAX's single-device
  ``forward`` / ``jax.grad`` (JAX's own bounds), remat on and off; the SP
  stack's forward issues no all-gather and ``n - 1`` ring steps per
  gather-matmul.
* The pipeline, 2 stages x DP 2 on 4 ranks, smollm-135m-reduced: three
  AdamW steps within 1e-4 of JAX's single-device steps (JAX's
  ``tests/test_pipeline_train.py`` bound), and the losses move.
* The int8 gradient wire on 2 ranks against JAX's wire path on 2 fake
  devices (a subprocess): losses within 1e-4, parameters within 1e-4 but
  for a share of int8 flips.  The wire quantizes each replica's f32
  gradient on a shared grid; the two packages' gradients agree to ~1e-7,
  so an element on a rounding boundary can land one code apart, which Adam
  turns into up to lr a step (``test_torch_train.py``'s rule).
* rwkv6-reduced under DP 2 (the WKV plain versions on each rank's rows):
  the first loss within 1e-5 of JAX's, and two steps within 1e-5 of the
  port's one-process steps.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax
from repro_torch.core.plan import derive_plan
from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import Shardings, gather, place
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.optimizer import OptimizerConfig, init_state, tree_leaves_with_path
from repro_torch.train.train_step import make_train_step, value_and_grad
from test_torch_dist_ranks import ShapeMesh, run_ranks

B, S = 4, 16
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _keyed(tree) -> dict:
    return {"|".join(map(str, p)): x for p, x in tree_leaves_with_path(tree)}


def _jax_keyed(tree) -> dict:
    import jax.tree_util as jtu

    from repro.dist.sharding import _key_names

    return {"|".join(_key_names(p)): np.asarray(x)
            for p, x in jtu.tree_flatten_with_path(tree)[0]}


def _batch(cfg, seed, batch=B):
    from test_torch_train import numpy_batch

    return numpy_batch(cfg, seed=seed, batch=batch, seq=S)


# --------------------------------------------------------------------- SP
def _sp_rank(rank, cfg, np_params, np_batch):
    mesh = Mesh({"data": 1, "model": 2})
    plan = derive_plan(cfg, dict(mesh.shape), batch=B, seq_len=S, seq_parallel=True,
                       force_mode="spatial")
    assert plan.seq_parallel_acts and not plan.fuse_qkv
    full = from_jax(np_params, device="cpu")
    shard = Shardings(mesh, plan, cfg).manual_param_shardings(full)
    params = place(full, shard)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    with torch.no_grad():
        x, _ = T.forward(params, batch, cfg=cfg, plan=plan, mesh=mesh)
        # the embedding is cut over the vocabulary: looked up vocab-parallel
        emb, pos, _ = T._embed_inputs(params, batch, cfg, None, torch.float32,
                                      T._vocab_split(params, cfg, plan, mesh))
        C.reset_stats()
        T.sp_stack_forward(params["blocks"]["stack"], emb, cfg=cfg, plan=plan, mesh=mesh,
                           positions=pos)
        calls = dict(C.STATS["calls"])
    out = {"x": x, "calls": calls}
    for remat in (False, True):
        p = dataclasses.replace(plan, remat=remat)
        loss, grads = value_and_grad(
            lambda pp, b: T.lm_loss(pp, b, cfg=cfg, plan=p, mesh=mesh), params, batch)
        out[remat] = (loss, gather(grads, shard))
    return out


@pytest.mark.parametrize("arch,replace", [("bert-base", {}),
                                          ("qwen3-1.7b", {"n_heads": 4, "n_kv_heads": 2})])
def test_seq_parallel_matches_jax(tmp_path, arch, replace):
    import jax
    import jax.numpy as jnp

    from repro.core.plan import derive_plan as jax_derive_plan
    from repro.models import transformer as JT
    from repro.models.params import init_params as jax_init_params
    from torch_parity import MESH1, configs

    jcfg, cfg = configs(arch, **replace)
    jplan = jax_derive_plan(jcfg, MESH1, batch=B, seq_len=S, fuse_qkv=False)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg, jplan, dtype=jnp.float32)
    nb = _batch(cfg, seed=3)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    res = run_ranks(_sp_rank, 2, tmp_path, cfg, _np_tree(jparams), nb)
    want_x = np.asarray(JT.forward(jparams, jb, cfg=jcfg, plan=jplan)[0])
    want_loss = float(JT.lm_loss(jparams, jb, cfg=jcfg, plan=jplan))
    want_g = _jax_keyed(jax.grad(lambda p: JT.lm_loss(p, jb, cfg=jcfg, plan=jplan))(jparams))
    n_layers = cfg.n_layers
    for r in res:
        assert float(np.abs(r["x"].numpy() - want_x).max()) < 1e-4
        # the SP stack: two ring gather-matmuls (n - 1 = 1 step each) and two
        # reduce-scatters a layer, no all-gather
        assert r["calls"] == {"permute": 2 * n_layers, "reduce_scatter": 2 * n_layers}
        for remat in (False, True):
            loss, grads = r[remat]
            assert abs(float(loss) - want_loss) < 1e-5, remat
            got = _keyed(grads)
            assert got.keys() == want_g.keys()
            for k, g in got.items():
                err = float(np.abs(g.numpy() - want_g[k]).max())
                assert err < 1e-5, (remat, k, err)


# ----------------------------------------------------------- training steps
def _train_rank(rank, cfg, plan, mesh_shape, np_params, batches, comp):
    mesh = Mesh(mesh_shape)
    full = from_jax(np_params, device="cpu")
    shard = Shardings(mesh, plan, cfg).manual_param_shardings(full)
    state = init_state(place(full, shard), with_residual=False)
    step = make_train_step(cfg, plan, OptimizerConfig(**OPT), CompressionConfig(comp),
                           device="cpu", mesh=mesh, grad_shardings=shard)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms, "params": _keyed(gather(state.params, shard)),
            "residual": state.residual}


def _jax_steps(jcfg, jplan, jparams, batches):
    import jax
    import jax.numpy as jnp

    from repro.train.optimizer import OptimizerConfig as JaxOpt
    from repro.train.optimizer import init_state as jax_init_state
    from repro.train.train_step import make_train_step as jax_make_step

    step = jax.jit(jax_make_step(jcfg, jplan, JaxOpt(**OPT)))
    state = jax_init_state(jparams)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, _jax_keyed(state.params)


def test_pipeline_steps_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.core.plan import derive_plan as jax_derive_plan
    from repro.models.params import init_params as jax_init_params
    from torch_parity import MESH1, configs

    jcfg, cfg = configs("smollm-135m")
    mesh_shape = {"pod": 2, "data": 2, "model": 1}
    plan = derive_plan(cfg, mesh_shape, batch=8, seq_len=S, pod_role="pipeline")
    assert plan.pod_role == "pipeline" and plan.microbatches >= 2
    jplan = jax_derive_plan(jcfg, MESH1, batch=8, seq_len=S)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg, jplan, dtype=jnp.float32)
    batches = [_batch(cfg, seed=20 + i, batch=8) for i in range(3)]
    res = run_ranks(_train_rank, 4, tmp_path, cfg, plan, mesh_shape, _np_tree(jparams), batches,
                    "none")
    jl, jn, jp = _jax_steps(jcfg, jplan, jparams, batches)
    for r in res:
        assert max(abs(a - b) for a, b in zip(r["losses"], jl)) < 1e-4, (r["losses"], jl)
        np.testing.assert_allclose(r["norms"], jn, rtol=1e-4)
        for k, p in r["params"].items():
            np.testing.assert_allclose(p.numpy(), jp[k], rtol=0, atol=1e-4, err_msg=k)
        assert r["losses"][0] != r["losses"][-1]


_JAX_WIRE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan
from repro.launch.mesh import make_host_mesh
from repro.models.params import init_params
from repro.train.compression import CompressionConfig
from repro.train.optimizer import OptimizerConfig, init_state
from repro.train.train_step import make_train_step, wire_compression_axes
cfg = get_config("smollm-135m-reduced")
mesh = make_host_mesh(data=2)
plan = derive_plan(cfg, dict(mesh.shape), TPU_V5E, batch=8, seq_len=int(sys.argv[2]),
                   training=True, grad_compression="int8")
assert wire_compression_axes(plan, mesh, 8) == ("data",)
params = init_params(jax.random.PRNGKey(0), cfg, plan, dtype=jnp.float32)
opt = OptimizerConfig(**json.loads(sys.argv[3]))
step = jax.jit(make_train_step(cfg, plan, opt, compression=CompressionConfig("int8"), mesh=mesh))
state = init_state(params)
z = np.load(sys.argv[1])
losses = []
for i in range(3):
    state, m = step(state, {"tokens": jnp.asarray(z[f"tokens{i}"]),
                            "targets": jnp.asarray(z[f"targets{i}"])})
    losses.append(float(m["loss"]))
flat = {"|".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(state.params)[0]}
np.savez(sys.argv[1] + ".params.npz", **flat)
print(json.dumps({"losses": losses, "fuse_qkv": plan.fuse_qkv}))
"""


def test_int8_wire_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.core.hardware import TPU_V5E
    from repro.core.plan import derive_plan as jax_derive_plan
    from repro.models.params import init_params as jax_init_params
    from repro_torch.core.hardware import HardwareSpec
    from repro_torch.train.train_step import wire_compression_axes
    from torch_parity import configs

    jcfg, cfg = configs("smollm-135m")
    batches = [_batch(cfg, seed=40 + i, batch=8) for i in range(3)]
    path = tmp_path / "batches.npz"
    np.savez(path, **{f"{k}{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    out = subprocess.run([sys.executable, "-c", _JAX_WIRE, str(path), str(S), json.dumps(OPT)],
                         capture_output=True, text=True, timeout=400, cwd=".",
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    jx = json.loads(out.stdout.strip().splitlines()[-1])
    v5e = HardwareSpec(**{f.name: getattr(TPU_V5E, f.name)
                          for f in dataclasses.fields(HardwareSpec)})
    mesh_shape = {"data": 2, "model": 1}
    plan = derive_plan(cfg, mesh_shape, v5e, batch=8, seq_len=S, grad_compression="int8")
    assert wire_compression_axes(plan, ShapeMesh(mesh_shape), 8) == ("data",)
    jplan = jax_derive_plan(jcfg, mesh_shape, TPU_V5E, batch=8, seq_len=S,
                            grad_compression="int8")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg, jplan, dtype=jnp.float32)
    res = run_ranks(_train_rank, 2, tmp_path, cfg, plan, mesh_shape, _np_tree(jparams), batches,
                    "int8")
    jp = dict(np.load(str(path) + ".params.npz"))
    for r in res:
        assert r["residual"] is None  # the wire needs no error feedback
        assert max(abs(a - b) for a, b in zip(r["losses"], jx["losses"])) < 1e-4
        n_out = n_all = 0
        for k, p in r["params"].items():
            d = np.abs(p.numpy() - jp[k])
            assert d.max() <= 2 * OPT["peak_lr"] * 3, k
            n_out += int((d > 1e-4).sum())
            n_all += d.size
        assert n_out <= 5e-4 * n_all, (n_out, n_all)


def test_rwkv_data_parallel(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.core.plan import derive_plan as jax_derive_plan
    from repro.models import transformer as JT
    from repro.models.params import init_params as jax_init_params
    from torch_parity import MESH1, configs

    jcfg, cfg = configs("rwkv6-1.6b")
    jplan = jax_derive_plan(jcfg, MESH1, batch=4, seq_len=S)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg, jplan, dtype=jnp.float32)
    batches = [_batch(cfg, seed=60 + i) for i in range(2)]
    plan2 = derive_plan(cfg, {"data": 2, "model": 1}, batch=4, seq_len=S)
    plan1 = derive_plan(cfg, {"data": 1, "model": 1}, batch=4, seq_len=S)
    res = run_ranks(_train_rank, 2, tmp_path, cfg, plan2, {"data": 2, "model": 1},
                    _np_tree(jparams), batches, "none")
    mesh1 = Mesh({"data": 1, "model": 1})
    full = from_jax(_np_tree(jparams), device="cpu")
    step = make_train_step(cfg, plan1, OptimizerConfig(**OPT), device="cpu", mesh=mesh1)
    state = init_state(full)
    ones = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        ones.append(float(m["loss"]))
    jl = float(JT.lm_loss(jparams, {k: jnp.asarray(v) for k, v in batches[0].items()}, cfg=jcfg,
                          plan=jplan))
    for r in res:
        assert abs(r["losses"][0] - jl) < 1e-5
        assert max(abs(a - b) for a, b in zip(r["losses"], ones)) < 1e-5

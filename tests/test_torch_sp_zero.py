"""ZeRO weights under Megatron-SP: the one layout the port refuses, and a
limit of the reference, not of the port.  Neither package's
``derive_plan`` makes that plan (``sp_feasible`` requires ``not
zero_weights``), over every registered arch, full size and reduced, the
host, production and pipeline meshes up to 2 x 16 x 16, and the tests'
batches, with SP asked for (the two packages' plans equal field for field
on the TPU numbers; the H100 entry checked on the port's).  Built by hand,
JAX's step cannot run it: its SP stack hands ``shard_map`` the ZeRO'd
specs, and a matmul's contracting dims disagree.  The port's
``unexecuted_layout`` says so."""
import dataclasses
import itertools
import json
import subprocess
import sys

import pytest

from repro.configs import get_config as jax_get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan as jax_derive_plan
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.plan import derive_plan
from repro_torch.dist.sharding import unexecuted_layout
from test_torch_dist_plan import MESHES, V5E, _jax_fields
from torch_tp import HEADS, port_cfg

SP_KNOBS = [
    {"batch": 4, "seq_len": 16},
    {"batch": 8, "seq_len": 32},
    {"batch": 16, "seq_len": 64},
    {"batch": 8, "seq_len": 2048},
    {"batch": 256, "seq_len": 4096},
    {"batch": 8, "seq_len": 32, "force_mode": "spatial"},
    {"batch": 8, "seq_len": 2048, "force_mode": "spatial"},
    {"batch": 8, "seq_len": 32, "pod_role": "pipeline"},
]


def _sp_plans(arch):
    """(mesh, knobs, JAX's plan, the port's plan, the port's on the H100
    entry) over the grid, SP asked for."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for mesh, kw in itertools.product(MESHES, SP_KNOBS):
        kw = {**kw, "seq_parallel": True}
        yield (mesh, kw, jax_derive_plan(jcfg, mesh, TPU_V5E, **kw),
               derive_plan(cfg, mesh, V5E, **kw), derive_plan(cfg, mesh, H100_SXM, **kw))


@pytest.mark.parametrize("arch", list(ALL_ARCHS) + [a + "-reduced" for a in ALL_ARCHS])
def test_no_derive_plan_pairs_zero_with_sp(arch):
    for mesh, kw, theirs, mine, h100 in _sp_plans(arch):
        assert dataclasses.asdict(mine) == _jax_fields(theirs), (mesh, kw)
        for p in (theirs, mine, h100):
            assert not (p.zero_weights and p.seq_parallel_acts), (mesh, kw)
            assert unexecuted_layout(p, get_config(arch)) is None, (mesh, kw)


def test_the_grid_reaches_sp_and_zero():
    """The grid is not empty of either: SP is on somewhere and ZeRO is on
    somewhere, each where the other is asked for too."""
    seen = {"sp": False, "zero": False}
    for arch in ("bert-base", "mistral-large-123b", "qwen3-1.7b"):
        for _, _, _, mine, h100 in _sp_plans(arch):
            for p in (mine, h100):
                seen["sp"] |= p.seq_parallel_acts
                seen["zero"] |= p.zero_weights
    assert seen == {"sp": True, "zero": True}


# JAX's SP train step on 4 fake devices, the plan built by hand: SP on
# (data 2, model 2), then zero_weights set.  Prints the exception the step
# raises, or "ran".
_JAX_SP_ZERO = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan
from repro.dist.sharding import Shardings
from repro.launch.mesh import make_host_mesh
from repro.models.params import init_params
from repro.train.optimizer import OptimizerConfig, init_state
from repro.train.train_step import make_train_step
cfg = dataclasses.replace(get_config("qwen3-1.7b-reduced"), **json.loads(sys.argv[1]))
mesh = make_host_mesh(data=2)
plan = derive_plan(cfg, dict(mesh.shape), TPU_V5E, batch=8, seq_len=32, training=True,
                   seq_parallel=True, force_mode="spatial")
assert plan.seq_parallel_acts and not plan.zero_weights
plan = dataclasses.replace(plan, zero_weights=True)
sh = Shardings(mesh, plan, cfg)
params = init_params(jax.random.PRNGKey(0), cfg, plan, dtype=jnp.float32)
param_sh = sh.param_shardings(params)
step = jax.jit(make_train_step(cfg, plan, OptimizerConfig(), shard=sh.constrain,
                               grad_shardings=param_sh, mesh=mesh))
rng = np.random.default_rng(0)
b = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32))
     for k in ("tokens", "targets")}
try:
    step(init_state(jax.device_put(params, param_sh)), jax.device_put(b, sh.batch_shardings(b)))
    print(json.dumps({"raised": None}))
except Exception as e:
    print(json.dumps({"raised": type(e).__name__, "message": str(e)[:2000]}))
"""


def test_the_reference_cannot_run_sp_with_zero():
    """JAX's step on the hand-built SP + ZeRO plan raises (each shard of
    its SP stack reads half the weight rows); the port refuses the same
    plan, naming that reason."""
    out = subprocess.run([sys.executable, "-c", _JAX_SP_ZERO, json.dumps(HEADS)],
                         capture_output=True, text=True, timeout=400, cwd=".",
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["raised"] == "TypeError", res
    assert "dot_general requires contracting dimensions to have the same shape" in res["message"]
    cfg = port_cfg("qwen3-1.7b", HEADS)
    plan = derive_plan(cfg, {"data": 2, "model": 2}, V5E, batch=8, seq_len=32, training=True,
                       seq_parallel=True, force_mode="spatial")
    assert plan.seq_parallel_acts and unexecuted_layout(plan, cfg) is None
    why = unexecuted_layout(dataclasses.replace(plan, zero_weights=True), cfg)
    assert why is not None and "Megatron-SP" in why and "sp_feasible" in why
    assert "reference's SP stack cannot run it" in why

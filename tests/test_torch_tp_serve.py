"""Sharded continuous serving: the port's ``ServingEngine(shardings=)`` on
two gloo ranks on the CPU (tensor-parallel shards, pools of each rank's KV
heads, the ranks' tokens compared once a step by ``check_replicas``)
against JAX's sharded engine on two fake devices, in JAX's
``test_engine_sharded_mesh_matches_single`` setup (f32 pages, 8-token
blocks, three prompts of 9 tokens, 5 new each): greedy tokens identical,
by the kernel route (the paged-attention wrapper on local heads; on the CPU
its plain version) and by the gather path (``fused=False``, JAX's route on
a mesh), and through the fault ladder's gather rung and back.
smollm-135m-reduced is JAX's own case (one KV head: attention runs
replicated); qwen3-1.7b-reduced widened to 4 query / 2 KV heads runs
attention on local heads; both hold the embedding cut over the vocabulary.
Then the launcher under the ranks: the host
mesh, rank 0 alone printing, the same tokens as one process."""
import contextlib
import dataclasses
import io
import json
import subprocess
import sys

import numpy as np
import pytest

from test_torch_dist_ranks import run_ranks
from torch_tp import HEADS, jax_params

_JAX_ENGINE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.plan import derive_plan, derive_serve_plan
from repro.dist.sharding import Shardings
from repro.launch.mesh import make_host_mesh
from repro.models.params import init_params
from repro.serve import Request, ServingEngine
spec = json.loads(sys.argv[1])
MESH1 = {"data": 1, "model": 1}
cfg = dataclasses.replace(get_config(spec["arch"]).reduced(), **spec["replace"])
plan_1 = derive_plan(cfg, MESH1, batch=4, seq_len=16, training=False)
serve = derive_serve_plan(cfg, MESH1, **spec["serve"])
params = init_params(jax.random.PRNGKey(0), cfg, plan_1, dtype=jnp.float32)
mesh = make_host_mesh()
plan = derive_plan(cfg, dict(mesh.shape), batch=4, seq_len=16, training=False)
sh = Shardings(mesh, plan, cfg)
eng = ServingEngine(jax.device_put(params, sh.param_shardings(params)), cfg, plan, serve,
                    shardings=sh)
got = eng.run([Request(rid=f"m{i}", prompt=p, max_new_tokens=5)
               for i, p in enumerate(spec["prompts"])])
print(json.dumps({"tokens": {k: [int(t) for t in v] for k, v in got.items()},
                  "fused": eng.fused}))
"""
SERVE = dict(max_seq_len=64, decode_batch=4, block_size=8, kv_dtype="fp32", prefill_chunk=8)
ARCHS = {"smollm-135m": {}, "qwen3-1.7b": HEADS}


def _prompts(vocab):
    rng = np.random.default_rng(4)
    return [[int(t) for t in rng.integers(0, vocab, 9)] for _ in range(3)]


def _engine_rank(rank, arch, replace, np_params, prompts):
    from repro_torch.bridge import from_jax
    from repro_torch.configs import get_config
    from repro_torch.core.plan import derive_plan, derive_serve_plan
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import Shardings, place
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve import FaultInjector, Request, ServingEngine

    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    mesh = Mesh({"data": 1, "model": 2})
    plan = derive_plan(cfg, dict(mesh.shape), batch=4, seq_len=16, training=False)
    serve = derive_serve_plan(cfg, {"data": 1, "model": 1}, **SERVE)
    sh = Shardings(mesh, plan, cfg)
    full = from_jax(np_params, device="cpu")
    params = place(full, sh.manual_param_shardings(full))
    out = {"attention_sharded": sh.attention_sharded()}
    for fused in (True, False):
        C.reset_stats()
        eng = ServingEngine(params, cfg, plan, serve, shardings=sh, fused=fused, device="cpu",
                            check_replicas=True)
        got = eng.run([Request(rid=f"m{i}", prompt=p, max_new_tokens=5)
                       for i, p in enumerate(prompts)])
        out[fused] = {"tokens": got, "calls": dict(C.STATS["calls"]),
                      "kv_heads": eng.pools["layers"]["stack"][0]["paged"]["k"].shape[-2],
                      "summary_mesh": eng.summary()["mesh"], "engine_fused": eng.fused}
    # the fault ladder under the mesh: from the mixed floor (no rolled
    # loop), one transient burst past the retry budget steps every rank
    # down to the gather rung and back up
    ladder = dataclasses.replace(serve, rolled_steps=1, retry_limit=2, ladder_recovery=3,
                                 retry_backoff_s=0.0)
    inj = FaultInjector(11, transient_rate=1.0, transient_burst=4, horizon=1)
    eng = ServingEngine(params, cfg, plan, ladder, shardings=sh, device="cpu", injector=inj,
                        check_replicas=True)
    out["ladder"] = {"tokens": eng.run([Request(rid=f"m{i}", prompt=p, max_new_tokens=5)
                                        for i, p in enumerate(prompts)]),
                     "fallback": eng.dispatch_counts.get("fallback_step", 0),
                     "down": eng.stats["rung_escalations"], "up": eng.stats["rung_recoveries"]}
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_engine_matches_jax_sharded_engine(tmp_path, arch):
    from repro_torch.configs import get_config

    replace = ARCHS[arch]
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    prompts = _prompts(cfg.vocab_size)
    spec = {"arch": arch, "replace": replace, "serve": SERVE, "prompts": prompts}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_ENGINE, json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=".",
                            env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    try:
        res = run_ranks(_engine_rank, 2, tmp_path, arch, replace, jax_params(arch, replace),
                        prompts)
        out, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    jx = json.loads(out.strip().splitlines()[-1])
    assert jx["fused"] is False  # JAX's sharded engine takes the gather path
    sharded_heads = arch == "qwen3-1.7b"
    for r in res:
        assert r["attention_sharded"] == sharded_heads
        for fused in (True, False):
            run = r[fused]
            assert run["tokens"] == jx["tokens"], (fused, run["tokens"], jx["tokens"])
            assert run["engine_fused"] == fused and run["summary_mesh"] == {"data": 1,
                                                                            "model": 2}
            assert run["kv_heads"] == (cfg.n_kv_heads // 2 if sharded_heads else cfg.n_kv_heads)
            # the debug check ran once a dispatch, and nothing else crossed
            # the ranks but g's sums (the vocab-parallel lookup's among them)
            # and the logit columns of the head cut over the vocabulary
            assert set(run["calls"]) <= {"all_gather", "tp_row_sum", "vocab_gather"}
            assert run["calls"]["tp_row_sum"] > 0 and run["calls"]["vocab_gather"] > 0
        lad = r["ladder"]
        assert lad["tokens"] == jx["tokens"]
        assert lad["fallback"] > 0 and lad["down"] >= 1 and lad["up"] >= 1, lad


def _launcher_rank(rank, argv):
    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = main(argv)
    return {"stdout": buf.getvalue(), "generated": summary["generated_tokens"],
            "mesh": summary["mesh"], "fused": summary["fused_attention"]}


def test_launcher_serves_on_the_host_mesh(tmp_path):
    """``launch.serve`` under two ranks: the host mesh (data 1, model 2),
    the tensor-parallel shards, ``--check-replicas`` every step, rank 0
    alone printing; the same tokens as the one-process launcher."""
    argv = ["--arch", "qwen3-1.7b-reduced", "--device", "cpu", "--dtype", "fp32",
            "--requests", "3", "--prompt-len", "8", "--gen", "4", "--max-seq", "64",
            "--fix-batch", "--batch", "2", "--check-replicas"]
    res = run_ranks(_launcher_rank, 2, tmp_path, argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        from repro_torch.launch.serve import main

        one = main(argv)
    assert res[1]["stdout"] == ""
    assert "'data': 1, 'model': 2" in res[0]["stdout"]
    assert res[0]["mesh"] == {"data": 1, "model": 2} and res[0]["fused"]
    served = [ln for ln in res[0]["stdout"].splitlines() if ln.startswith("served")]
    assert served == [ln for ln in buf.getvalue().splitlines() if ln.startswith("served")]
    assert res[0]["generated"] == one["generated_tokens"] == 12

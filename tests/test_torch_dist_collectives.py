"""The port's manual collectives and pipeline (``repro_torch.dist``) on 2, 4
and 8 gloo ranks on the CPU: the ring gather-matmul and its standalone
wrapper equal ``x @ w`` and one process's autograd, with ``n - 1`` ring
steps and no all-gather; ``seq_scatter`` and its gradient;
``compressed_psum`` against JAX's (int8 bit for bit, bf16 within one bf16
step of the sum) on the same per-replica numpy gradients, JAX on 4 fake
devices in a subprocess as ``tests/test_collectives.py`` runs it;
``wire_bytes`` and ``bubble_fraction`` equal to JAX's; and
``pipeline_forward`` over 2 and 4 stages with DP 2 inside each stage equal
to the stages run in sequence, gradients included.  f64 where the port
alone is checked."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.dist import collectives as C
from repro_torch.dist.pipeline import bubble_fraction, pipeline_forward
from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_pipeline_mesh,
                                     make_production_mesh)
from test_torch_dist_ranks import run_ranks

F64 = torch.float64


def _ring_data():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 24, generator=g, dtype=F64)
    w = torch.randn(24, 12, generator=g, dtype=F64)
    return x, w


def _per_replica_grads(n):
    rng = np.random.default_rng(7)
    return (rng.standard_normal((n, 40, 24)) * np.logspace(-3, 1, n)[:, None, None]
            ).astype(np.float32)


def _collectives_rank(rank, n):
    mesh = make_host_mesh(data=1)  # (data 1, model n)
    assert dict(mesh.shape) == {"data": 1, "model": n} and mesh.coords["model"] == rank
    x, w = _ring_data()
    c = x.shape[1] // n
    out = {}
    # ring gather-matmul on the sequence dim, forward and backward
    xi = x[:, rank * c:(rank + 1) * c].clone().requires_grad_(True)
    wi = w.clone().requires_grad_(True)
    C.reset_stats()
    y = C.ring_gather_matmul(xi, wi, "model", n, gather_dim=1, mesh=mesh)
    out["fwd_calls"] = dict(C.STATS["calls"])
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(10 + rank), dtype=F64)
    y.backward(dy)
    out.update(y=y.detach(), dy=dy, dx=xi.grad, dw=wi.grad, bwd_calls=dict(C.STATS["calls"]))
    # the standalone wrapper: rows over the model axis, w replicated
    rows = x.reshape(-1, 24)
    r = rows.shape[0] // n
    xr = rows[rank * r:(rank + 1) * r].clone().requires_grad_(True)
    y2 = C.overlap_all_gather_matmul(mesh, xr, w)
    (y2 * dy.reshape(-1, 12)[: y2.shape[0]]).sum().backward()
    out.update(y2=y2.detach(), dxr=xr.grad)
    # seq_scatter: partial sums to this rank's chunk; the backward gathers
    p = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(20 + rank), dtype=F64)
    p.requires_grad_(True)
    C.reset_stats()
    s = C.seq_scatter(p, "model", 1, mesh=mesh)
    s.backward(torch.full_like(s, float(rank + 1)))
    out.update(p=p.detach(), s=s.detach(), dp=p.grad, scatter_calls=dict(C.STATS["calls"]))
    # compressed_psum on this rank's replica gradient
    g = torch.from_numpy(_per_replica_grads(n)[rank])
    out["int8"] = C.compressed_psum(g, "model", "int8", mesh=mesh)
    out["bf16"] = C.compressed_psum(g, "model", "bf16", mesh=mesh)
    out["f32"] = C.compressed_psum(g, "model", "none", mesh=mesh)
    return out


_JAX_PSUM = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.dist.collectives import compressed_psum, wire_bytes
g = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("model",), axis_types=(jax.sharding.AxisType.Auto,))
out = {}
for mode in ("int8", "bf16", "none"):
    f = shard_map(lambda gi: compressed_psum(gi[0], "model", mode), mesh=mesh,
                  in_specs=P("model", None, None), out_specs=P())
    out[mode] = np.asarray(f(g), np.float32).tolist()
out["wire"] = [wire_bytes(n, m) for n in (0, 1, 1000, 2**20) for m in ("int8", "bf16", "none")]
print(json.dumps(out))
"""


@pytest.mark.parametrize("n", [2, 4])
def test_ring_scatter_and_psum(tmp_path, n):
    res = run_ranks(_collectives_rank, n, tmp_path, n)
    x, w = _ring_data()
    x.requires_grad_(True)
    w.requires_grad_(True)
    want = x @ w
    for r in res:
        assert torch.equal(r["y"], want) or float((r["y"] - want).abs().max()) < 1e-12
        # n - 1 ring steps, no all-gather, forward; the backward's reverse ring adds n - 1
        assert r["fwd_calls"] == {"permute": n - 1}
        assert r["bwd_calls"] == {"permute": 2 * (n - 1)}
        assert r["scatter_calls"] == {"reduce_scatter": 1, "all_gather": 1}
    # every rank's loss sum(y * dy_r): one process's autograd of their sum
    sum((want * r["dy"]).sum() for r in res).backward()
    c = x.shape[1] // n
    torch.testing.assert_close(torch.cat([r["dx"] for r in res], 1), x.grad, rtol=0, atol=1e-12)
    torch.testing.assert_close(sum(r["dw"] for r in res), w.grad, rtol=0, atol=1e-12)
    rows = x.detach().reshape(-1, 24)
    for r in res:
        torch.testing.assert_close(r["y2"], rows @ w.detach(), rtol=0, atol=1e-12)
    total = sum(r["p"] for r in res)
    for i, r in enumerate(res):
        torch.testing.assert_close(r["s"], total[:, i * c:(i + 1) * c], rtol=0, atol=1e-12)
        want_dp = torch.cat([torch.full((2, c, 8), float(j + 1), dtype=F64) for j in range(n)], 1)
        assert torch.equal(r["dp"], want_dp)
    g = _per_replica_grads(n)
    if n == 4:  # JAX's compressed_psum on 4 fake devices, same replicas
        path = tmp_path / "g.npy"
        np.save(path, g)
        out = subprocess.run([sys.executable, "-c", _JAX_PSUM, str(path)], capture_output=True,
                             text=True, timeout=300, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
                             cwd=".")
        assert out.returncode == 0, out.stderr[-2000:]
        jx = json.loads(out.stdout.strip().splitlines()[-1])
        j8 = np.array(jx["int8"], np.float32)
        for r in res:
            assert np.array_equal(r["int8"].numpy(), j8)  # bit for bit
            # bf16 sums in another order: within one bf16 step (8 significant
            # bits) at the magnitude of the element's largest partial sum
            jb = np.array(jx["bf16"], np.float32)
            gb = torch.from_numpy(g).bfloat16().float().numpy()
            big = np.maximum(np.abs(np.cumsum(gb, 0)).max(0), np.abs(gb).max(0))
            step = 2.0 ** (np.floor(np.log2(big)) - 7)
            assert np.all(np.abs(r["bf16"].numpy() - jb) <= step)
            np.testing.assert_allclose(r["f32"].numpy(), jx["none"], rtol=1e-6, atol=1e-6)
        assert jx["wire"] == [C.wire_bytes(k, m) for k in (0, 1, 1000, 2**20)
                              for m in ("int8", "bf16", "none")]
    for r in res:
        np.testing.assert_allclose(r["int8"].numpy(), g.sum(0), rtol=0,
                                   atol=float(np.abs(g).max()) / 127 * n)


def _stage_weights():
    g = torch.Generator().manual_seed(3)
    return (torch.randn(8, 6, 6, generator=g, dtype=F64) * 0.4,
            torch.randn(5, 4, 6, generator=g, dtype=F64))


def _stage_fn(wl, x):
    for wi in wl:  # the stage's groups: a list of them, or the stacked weights
        x = torch.tanh(x @ wi)
    return x


def _pipeline_rank(rank, n_stage, dp):
    mesh = Mesh({"pod": n_stage, "data": dp})
    s, d = mesh.coords["pod"], mesh.coords["data"]
    w, micro = _stage_weights()
    per, rows = w.shape[0] // n_stage, micro.shape[1] // dp
    wl = w[s * per:(s + 1) * per].clone().requires_grad_(True)
    ml = micro[:, d * rows:(d + 1) * rows].clone().requires_grad_(True)
    C.reset_stats()
    y = pipeline_forward(_stage_fn, mesh, "pod", ("data",))(wl, ml)
    calls = dict(C.STATS["calls"])
    y.backward(torch.ones_like(y) * (1 + torch.arange(y.shape[0], dtype=F64))[:, None, None])
    return {"y": y.detach(), "dw": wl.grad, "dm": ml.grad, "stage": s, "d": d, "calls": calls}


@pytest.mark.parametrize("n_stage,dp", [(2, 2), (4, 2)])
def test_pipeline_matches_sequential(tmp_path, n_stage, dp):
    res = run_ranks(_pipeline_rank, n_stage * dp, tmp_path, n_stage, dp)
    w, micro = _stage_weights()
    w.requires_grad_(True)
    micro.requires_grad_(True)
    ys = [_stage_fn(w, micro[m]) for m in range(micro.shape[0])]  # the stages in sequence
    want = torch.stack(ys)
    (want * (1 + torch.arange(want.shape[0], dtype=F64))[:, None, None]).sum().backward()
    rows, per, M = micro.shape[1] // dp, w.shape[0] // n_stage, micro.shape[0]
    for r in res:
        cols = slice(r["d"] * rows, (r["d"] + 1) * rows)
        assert torch.equal(r["y"], want.detach()[:, cols])  # bit-identical on every stage
        torch.testing.assert_close(r["dm"], micro.grad[:, cols], rtol=0, atol=1e-13)
        # every stage sends on every tick (the last receives only), one
        # result psum: the same calls on every rank
        assert r["calls"] == {"permute": M + n_stage - 1, "all_reduce": 1}
    for s in range(n_stage):
        dws = sum(r["dw"] for r in res if r["stage"] == s)
        torch.testing.assert_close(dws, w.grad[s * per:(s + 1) * per], rtol=0, atol=1e-13)


def test_bubble_fraction_matches_jax():
    from repro.dist.pipeline import bubble_fraction as jax_bubble

    for m in range(0, 70):
        for s in range(0, 9):
            assert bubble_fraction(m, s) == jax_bubble(m, s), (m, s)


def test_one_rank_meshes_need_no_process_group():
    """Without ``torch.distributed`` a mesh has one rank and every
    collective is the identity (no group); meshes that need more raise."""
    mesh = make_host_mesh()
    assert dict(mesh.shape) == {"data": 1, "model": 1} and mesh.group("model") is None
    assert dict(make_pipeline_mesh().shape) == {"pod": 1}
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(C.all_reduce(x, "model", mesh), x)
    assert C.ring_gather_matmul(x, torch.eye(3), "model", 1, mesh=mesh).equal(x)
    assert C.seq_scatter(x, "model", 1, mesh=mesh) is x
    with pytest.raises(ValueError, match="do not split"):
        make_host_mesh(data=2)
    with pytest.raises(ValueError, match="holds 4 ranks"):
        Mesh({"pod": 2, "data": 2})
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)


def _lanes_rank(rank, shape):
    """Collectives above ``LANE_BYTES`` (carried by all of a slice's gloo
    groups at once) against the same on one group, on every axis subset."""
    mesh = Mesh(shape)
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(1024, 1536, generator=g)  # 6 MiB: above LANE_BYTES
    assert x.numel() * 4 >= C.LANE_BYTES and len(mesh.lanes("data")) == 4
    out = {}
    for axes in ("data", "model", ("data", "model")):
        if mesh.group(axes) is None:
            continue
        n = mesh.extent(axes)
        out[str(axes)] = {
            "sum": C.all_reduce(x, axes, mesh),
            "max": C.all_reduce(x, axes, mesh, op="max"),
            "gather1": C.all_gather(x, axes, mesh, dim=1),
            "scatter0": C.reduce_scatter(x, axes, mesh, dim=0),
            "one": [torch.randn(1024, 1536, generator=torch.Generator().manual_seed(r))
                    for r in mesh.ranks(axes)],
            "index": mesh.index(axes), "n": n}
    return out


@pytest.mark.parametrize("shape", [{"data": 2, "model": 1}, {"data": 2, "model": 2}])
def test_large_collectives_on_several_groups(tmp_path, shape):
    """Each rank's results equal the sums, maxima, concatenations and chunks
    of the ranks' tensors (the exact ones for two ranks; four sum in another
    order, within f32 rounding)."""
    world = shape["data"] * shape["model"]
    for r in run_ranks(_lanes_rank, world, tmp_path, shape):
        for got in r.values():
            xs, i, n = got["one"], got["index"], got["n"]
            whole = torch.stack(xs).sum(0)
            tol = 0 if n == 2 else 1e-5
            torch.testing.assert_close(got["sum"], whole, rtol=0, atol=tol)
            assert torch.equal(got["max"], torch.stack(xs).amax(0))
            assert torch.equal(got["gather1"], torch.cat(xs, dim=1))
            c = whole.shape[0] // n
            torch.testing.assert_close(got["scatter0"], whole[i * c:(i + 1) * c], rtol=0, atol=tol)

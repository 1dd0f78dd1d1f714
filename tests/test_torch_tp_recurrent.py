"""Tensor parallelism of the recurrent layers against JAX's GSPMD
(``tests/torch_fsdp.py``'s recipe and bounds: three f32 AdamW steps from
JAX's weights, losses within 1e-5, every parameter within 1e-4, each rank's
local leaf shapes equal to JAX's shard shapes), SPATIAL forced:
rwkv6-1.6b-reduced (the time-mix's ``w_r`` / ``w_k`` / ``w_v`` / ``w_g``
by column and ``w_o`` by row, the WKV on each rank's heads; the
channel-mix's ``w1`` and gate ``w_r`` by column, ``w2`` by row) and
recurrentgemma-9b-reduced (the RG-LRU's ``w_x`` / ``w_g`` by column and
``w_out`` by row, the conv and the scan on each rank's channels) at (data
1, model 2), and recurrentgemma-9b-reduced with ZeRO at (data 2, model 2).
The whole leaves the blocks read per head or channel stay whole on every
rank.  recurrentgemma's local attention has one KV head and runs whole
(ROADMAP's deliberate divergences), the one leaf-shape exception.  Every
case's JAX steps run in one subprocess; full-size trees' layouts; the chip
script's planted controls fall outside the bounds."""
import pytest

from test_torch_dist_ranks import run_ranks
from test_torch_fsdp_layout import _jax_plan, _meta_tree, FakeMesh
from torch_fsdp import (batches, check_against_jax, fsdp_control_rank, fsdp_plan, jax_cases,
                        jax_params)
from torch_tp import port_cfg

SPATIAL = {"force_mode": "spatial"}
CASES = {
    "rwkv6": ("rwkv6-1.6b", {"data": 1, "model": 2}, {}),
    "recurrentgemma": ("recurrentgemma-9b", {"data": 1, "model": 2}, {}),
    "recurrentgemma ZeRO": ("recurrentgemma-9b", {"data": 2, "model": 2}, {"zero_weights": True}),
}
SEED = 90
# recurrentgemma's local attention (pattern position 2): one KV head
LOCAL_ATTENTION = ("blocks|stack|2|attn|wqkv", "blocks|stack|2|attn|wo")


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """Every case's JAX steps, started once in one subprocess at the
    module's first test (the cases come last, so it runs meanwhile)."""
    done = jax_cases(tmp_path_factory.mktemp("jax"), [
        (arch, {}, shape, SPATIAL, fields, batches(port_cfg(arch, {}), SEED))
        for arch, shape, fields in CASES.values()])
    return {case: (lambda i=i: done()[i]) for i, case in enumerate(CASES)}


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_full_size_local_leaves_are_jax_shards(arch, monkeypatch):
    """The full-size tree (meta tensors) at (data 1, model 2) on the H100
    entry with SPATIAL forced: at both ranks' coordinates every local leaf
    has JAX's shard shape, but recurrentgemma's local attention (one KV
    head: whole in the port)."""
    full_size_layout(arch, monkeypatch)


def full_size_layout(arch, monkeypatch):
    """``arch``'s full-size local leaves against JAX's shards (the layout
    tests here and in ``test_torch_tp_encdec.py``)."""
    import jax
    import numpy as np

    from repro.configs import get_config as jax_get_config
    from repro.dist.sharding import Shardings as JaxShardings
    from repro.dist.sharding import _key_names
    from repro.models.params import init_params as jax_init_params
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.plan import derive_plan
    from repro_torch.dist.sharding import Shardings, tensor_parallel
    from repro_torch.train.optimizer import tree_leaves_with_path
    from test_torch_dist_ranks import ShapeMesh

    mesh, kw = {"data": 1, "model": 2}, {"batch": 8, "seq_len": 2048, **SPATIAL}
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    plan = derive_plan(cfg, mesh, H100_SXM, training=True, **kw)
    assert tensor_parallel(plan)
    jplan = _jax_plan(jcfg, mesh, plan, **kw)
    jsh = JaxShardings(FakeMesh(dict(mesh)), jplan, jcfg)
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg, jplan))
    want = {}
    for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec = tuple(jsh.param_spec(p, x))
        want["|".join(_key_names(p))] = [d // (2 if e == "model" else 1)
                                         for d, e in zip(x.shape, spec)]
    tree = _meta_tree(cfg, plan, monkeypatch)
    # recurrentgemma's local attention (one KV head), whisper-small's
    # embedding (split over d_model: its vocabulary is odd) run whole
    whole = {"recurrentgemma-9b": LOCAL_ATTENTION, "whisper-small": ("embed",)}.get(arch, ())
    for r in range(2):
        shard = Shardings(ShapeMesh(mesh, {"data": 0, "model": r}), plan,
                          cfg).manual_param_shardings(tree)
        got = {"|".join(map(str, p)): list(s.local(x).shape) for (p, x), (_, s) in zip(
            tree_leaves_with_path(tree), tree_leaves_with_path(shard))}
        assert {k: v for k, v in got.items() if k not in whole} == {
            k: v for k, v in want.items() if k not in whole}
        for k in whole:
            assert np.prod(got[k]) == 2 * np.prod(want[k])


@pytest.mark.parametrize("arch,control", [("rwkv6-1.6b", "slice_grad_chunk"),
                                          ("recurrentgemma-9b", "neighbour_slice")])
def test_planted_controls_fall_outside(tmp_path, arch, control):
    """The chip script's controls at the bounds: each moves the losses or
    the parameters after 2 steps past them (against the unplanted run)."""
    import numpy as np

    cfg = port_cfg(arch, {})
    shape = {"data": 1, "model": 2}
    plan = fsdp_plan(cfg, shape, SPATIAL, {})
    good, bad = run_ranks(fsdp_control_rank, 2, tmp_path, cfg, plan, shape,
                          jax_params(arch, {}, plan.fuse_qkv), batches(cfg, SEED, n=2),
                          control)[0]
    loss_dev = max(abs(a - b) for a, b in zip(bad["losses"], good["losses"]))
    param_dev = max(float(np.abs(bad["params"][k].numpy() - p.numpy()).max())
                    for k, p in good["params"].items())
    assert loss_dev > 1e-5 or param_dev > 1e-4, (control, loss_dev, param_dev)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_steps_match_jax_gspmd(tmp_path, jax_runs, case):
    arch, shape, fields = CASES[case]
    whole = LOCAL_ATTENTION if arch == "recurrentgemma-9b" else ()
    res, _ = check_against_jax(tmp_path, arch, {}, shape, SPATIAL, fields, seed=SEED,
                               jax_run=jax_runs[case], whole=whole)
    for r in res:
        calls = r["calls"]
        # f and g, and the whole leaves' blocks (their gradients gathered)
        assert calls["tp_row_sum"] > 0 and calls["tp_grad_sum"] > 0 and calls["tp_slice"] > 0
        assert (calls.get("tp_gather", 0) > 0) == (arch == "rwkv6-1.6b")  # the gate's columns
        assert (calls.get("fsdp_scatter", 0) > 0) == bool(fields)
        local = {k: v for k, v in r["local_shapes"].items() if k.startswith("blocks|stack|0|")}
        whole = {k: list(r["params"][k].shape) for k in local}
        col, row, kept = (("w_r", "w_o", "u") if arch == "rwkv6-1.6b"
                          else ("w_x", "w_out", "lam"))
        at = "blocks|stack|0|attn|"
        assert local[at + col][-1] == whole[at + col][-1] // 2  # by column
        assert local[at + row][-2] == whole[at + row][-2] // 2  # by row
        assert local[at + kept] == whole[at + kept]  # whole on every rank

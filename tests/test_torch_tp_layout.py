"""The layout of tensor parallelism without SP in the port: the fused
``wqkv``'s head-aligned cut and its inverse, the specs the manual path
executes (attention on local heads only where the heads divide; the
embedding and the head cut over the vocabulary, the norms replicated;
MoE's expert split), the
pools of each rank's KV heads, the recurrent and encoder-decoder plans that
``unexecuted_layout`` no longer refuses, a
checkpoint written under TP restored on one rank and the other way round,
and the flag-free two-rank launch, which now trains with TP."""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.plan import derive_plan, derive_serve_plan
from repro_torch.dist.sharding import (QKVSharding, Shardings, qkv_cut, qkv_join,
                                       tensor_parallel, unexecuted_layout)
from repro_torch.models.cache import init_paged_cache
from repro_torch.models.params import init_params
from test_torch_dist_ranks import ShapeMesh, run_ranks
from torch_tp import HEADS, port_cfg, tp_plan


@pytest.mark.parametrize("H,KV,n", [(16, 8, 2), (4, 2, 2), (8, 4, 4), (32, 4, 4), (6, 6, 3)])
def test_qkv_cut_and_join_are_inverses(H, KV, n):
    Dh = 4
    x = torch.randn(3, 5, (H + 2 * KV) * Dh)
    blocks = [qkv_cut(x, (H, KV, Dh), n, r) for r in range(n)]
    assert torch.equal(qkv_join(torch.cat(blocks, dim=-1), (H, KV, Dh), n), x)
    for r, blk in enumerate(blocks):  # each rank's own heads' q, k and v
        q, k, v = torch.split(blk, [H // n * Dh, KV // n * Dh, KV // n * Dh], dim=-1)
        qs, ks = slice(r * H // n * Dh, (r + 1) * H // n * Dh), KV // n * Dh
        assert torch.equal(q, x[..., qs])
        assert torch.equal(k, x[..., H * Dh + r * ks:H * Dh + (r + 1) * ks])
        assert torch.equal(v, x[..., (H + KV) * Dh + r * ks:(H + KV) * Dh + (r + 1) * ks])


def test_qkv_sharding_is_head_aligned_not_contiguous():
    """At model 2 on qwen3-1.7b GSPMD's contiguous column block would give
    rank 0 all of q (16 x 128 = 2048 of 4096 columns); the manual cut gives
    each rank 8 q heads and 4 KV heads of k and of v."""
    cfg = get_config("qwen3-1.7b")
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = torch.arange((H + 2 * KV) * Dh, dtype=torch.float32)[None].expand(2, -1)
    got = []
    for r in range(2):
        mesh = ShapeMesh({"data": 1, "model": 2}, {"data": 0, "model": r})
        s = QKVSharding(mesh, (None, "model"), (H, KV, Dh))
        got.append(s.local(x)[0])
    assert got[0][:H // 2 * Dh].equal(x[0, :H // 2 * Dh])
    assert got[1][:H // 2 * Dh].equal(x[0, H // 2 * Dh:H * Dh])
    assert got[1][H // 2 * Dh:].min() >= H * Dh  # rank 1's k and v columns, not q
    assert not got[0].equal(x[0, :x.shape[1] // 2])


def _specs(arch, mesh, monkeypatch):
    """The manual shardings of ``arch``'s full-size tree, its big leaves
    drawn as meta tensors (shapes only)."""
    from repro_torch.models import params as P

    meta = lambda self, shape, scale=0.02: torch.empty(tuple(shape), device="meta")  # noqa: E731
    monkeypatch.setattr(P._Init, "normal", meta)
    monkeypatch.setattr(P._Init, "zeros", meta)
    cfg = get_config(arch)
    plan = derive_plan(cfg, mesh, H100_SXM, training=False, batch=8, seq_len=2048)
    sh = Shardings(ShapeMesh(mesh), plan, cfg)
    params = init_params(cfg, plan, torch.float32, device="cpu")
    return cfg, plan, sh, {"|".join(map(str, s_p)): s for s_p, s in _flat(
        sh.manual_param_shardings(params))}


def _flat(tree):
    from repro_torch.train.optimizer import tree_leaves_with_path

    return tree_leaves_with_path(tree)


def test_manual_specs_follow_the_heads(monkeypatch):
    # qwen3-1.7b: 16 / 8 heads divide over 2, so attention runs on local
    # heads (the fused wqkv head-aligned); the tied embedding cut over the
    # vocabulary (vocab-parallel lookup and head); the norms replicated
    cfg, plan, sh, specs = _specs("qwen3-1.7b", {"data": 1, "model": 2}, monkeypatch)
    assert tensor_parallel(plan) and sh.attention_sharded()
    assert isinstance(specs["blocks|stack|0|attn|wqkv"], QKVSharding)
    assert specs["blocks|stack|0|attn|wo"].spec == (None, "model", None)
    assert specs["blocks|stack|0|ffn|w2"].spec == (None, "model", None)
    assert plan.embed_shard == "vocab" and specs["embed"].spec == ("model", None)
    for k in ("final_norm|scale", "blocks|stack|0|attn|q_norm",
              "blocks|stack|0|attn|ln|scale"):
        assert all(e is None for e in specs[k].spec), k
    # smollm-135m: 9 / 3 heads do not divide over 2: attention replicated,
    # the FFN still sharded (JAX's _fit would cut mid-head)
    _, _, sh, specs = _specs("smollm-135m", {"data": 1, "model": 2}, monkeypatch)
    assert not sh.attention_sharded()
    assert specs["blocks|stack|0|attn|wqkv"].spec == (None, None, None)
    assert specs["blocks|stack|0|attn|wo"].spec == (None, None, None)
    assert specs["blocks|stack|0|ffn|w1"].spec == (None, None, "model")
    # qwen3-moe-30b-a3b: the expert split (128 experts, 64 a rank), router whole
    _, plan, sh, specs = _specs("qwen3-moe-30b-a3b", {"data": 1, "model": 2}, monkeypatch)
    assert plan.moe_mode == "ep" and sh.attention_sharded()
    assert specs["blocks|stack|0|ffn|w1"].spec == (None, "model", None, None)
    assert specs["blocks|stack|0|ffn|router"].spec == (None, None, None)


def test_pools_hold_this_ranks_kv_heads():
    cfg = port_cfg("qwen3-1.7b", HEADS)
    mesh = {"data": 1, "model": 2}
    serve = derive_serve_plan(cfg, mesh, max_seq_len=64, decode_batch=2, block_size=8,
                              kv_dtype="int8", prefill_chunk=8)
    sh = Shardings(ShapeMesh(mesh), tp_plan(cfg, mesh), cfg)
    pools = init_paged_cache(cfg, None, serve, "cpu", shardings=sh)
    entry = pools["layers"]["stack"][0]["paged"]
    assert entry["k"].shape[-2] == entry["k_scale"].shape[-2] == cfg.n_kv_heads // 2
    one = init_paged_cache(cfg, None, serve, "cpu")
    assert one["layers"]["stack"][0]["paged"]["k"].shape[-2] == cfg.n_kv_heads


@pytest.mark.parametrize("arch,what", [("rwkv6-1.6b-reduced", "RWKV-6 time-mix"),
                                       ("recurrentgemma-9b-reduced", "RG-LRU"),
                                       ("whisper-small-reduced", "cross-attention")])
def test_tp_of_recurrent_and_encoder_decoder_archs_is_refused(arch, what):
    """No longer refused: their tensor-parallel plans execute, the recurrent
    blocks and an encoder-decoder's cross-attention on local heads
    (``tests/test_torch_tp_recurrent.py``, ``_encdec.py`` hold them to
    JAX); recurrentgemma's local attention (one KV head) runs whole."""
    cfg = get_config(arch)
    plan = derive_plan(cfg, {"data": 1, "model": 2}, batch=8, seq_len=32, force_mode="spatial")
    assert tensor_parallel(plan) and unexecuted_layout(plan, cfg) is None
    on, whole = Shardings(ShapeMesh({"data": 1, "model": 2}), plan, cfg).tp_blocks()
    assert what in on and whole == (["local attention"] if "recurrentgemma" in arch else [])


def _ckpt_rank(rank, arch, replace, ckpt_dir):
    """Save a TP layout's state (gathered, rank 0 writes) and restore one
    process's checkpoint onto the TP layout."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.dist.sharding import gather, place
    from repro_torch.launch.mesh import Mesh

    cfg = port_cfg(arch, replace)
    mesh = Mesh({"data": 1, "model": 2})
    plan = tp_plan(cfg, dict(mesh.shape))
    full = init_params(cfg, plan, torch.float32, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    shard = Shardings(mesh, plan, cfg).manual_param_shardings(full)
    local = place(full, shard)
    whole = gather(local, shard)
    if rank == 0:
        save_checkpoint(f"{ckpt_dir}/tp", 1, whole)
    torch.distributed.barrier()
    back = restore_checkpoint(f"{ckpt_dir}/one", 1, local, shardings=shard)
    return {"whole": whole, "local": local, "restored": back}


def test_checkpoint_round_trips_across_layouts(tmp_path):
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import tree_leaves

    arch, replace = "qwen3-1.7b", HEADS
    cfg = port_cfg(arch, replace)
    plan = tp_plan(cfg, {"data": 1, "model": 2})
    full = init_params(cfg, plan, torch.float32, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    save_checkpoint(str(tmp_path / "one"), 1, full)  # one process's checkpoint
    res = run_ranks(_ckpt_rank, 2, tmp_path, arch, replace, str(tmp_path))
    # the TP save is JAX's whole layout: restored on one rank it is the tree
    back = restore_checkpoint(str(tmp_path / "tp"), 1, full)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(full)))
    for r in res:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r["whole"]), tree_leaves(full)))
        # one process's checkpoint restored onto the TP layout: each rank's shards
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r["restored"]),
                                                     tree_leaves(r["local"])))
    wqkv0 = res[0]["local"]["blocks"]["stack"][0]["attn"]["wqkv"]
    assert wqkv0.shape[-1] == (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head // 2


def _launch_rank(rank, argv):
    from repro_torch.launch.train import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = main(argv)
    return {"losses": losses, "stdout": buf.getvalue()}


def test_flag_free_two_rank_launch_trains_tp(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train`` with no
    layout flags: the host mesh (data 1, model 2), a TP plan, which used to
    be refused; both ranks' losses equal, and they equal one process's."""
    argv = ["--arch", "qwen3-1.7b-reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "32"]
    res = run_ranks(_launch_rank, 2, tmp_path, argv)
    assert res[0]["losses"] == res[1]["losses"] and res[1]["stdout"] == ""
    assert "'data': 1, 'model': 2" in res[0]["stdout"]
    assert "tensor parallelism: model axis 2" in res[0]["stdout"]
    with contextlib.redirect_stdout(io.StringIO()):
        from repro_torch.launch.train import main

        one = main(argv)
    assert max(abs(a - b) for a, b in zip(res[0]["losses"], one)) < 1e-5
    assert all(np.isfinite(res[0]["losses"]))

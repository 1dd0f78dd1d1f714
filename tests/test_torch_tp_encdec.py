"""Tensor parallelism of an encoder-decoder against JAX's GSPMD
(``tests/torch_fsdp.py``'s recipe and bounds), SPATIAL forced, at (data 1,
model 2): whisper-small-reduced, the encoder's attention and FFN cut as the
decoder's, cross-attention's ``wq`` / ``wk`` / ``wv`` by column and ``wo``
by row, and one f on the encoder memory that every decoder layer reads.
The full-size tree's layout; checkpoints written under tensor parallelism
read on one rank and the other way round, bit-exact, for whisper-small and
recurrentgemma-9b; the chip script's control (the memory's f left out)
falls outside the bounds."""
import numpy as np
import pytest
import torch

from test_torch_dist_ranks import run_ranks
from test_torch_tp_layout import _ckpt_rank
from test_torch_tp_recurrent import full_size_layout
from torch_fsdp import batches, check_against_jax, fsdp_control_rank, fsdp_plan, jax_params
from torch_tp import port_cfg, tp_plan

ARCH = "whisper-small"
SHAPE = {"data": 1, "model": 2}
SPATIAL = {"force_mode": "spatial"}


def test_tp_steps_match_jax_gspmd(tmp_path):
    res, jx = check_against_jax(tmp_path, ARCH, {}, SHAPE, SPATIAL, {}, seed=91)
    for r in res:
        calls = r["calls"]
        assert calls["tp_row_sum"] > 0 and calls["tp_grad_sum"] > 0
        for k in ("encoder|stack|0|attn|wqkv", "blocks|stack|0|cross|wq",
                  "blocks|stack|0|cross|wk"):
            assert r["local_shapes"][k][-1] == r["params"][k].shape[-1] // 2, k
        for k in ("encoder|stack|0|attn|wo", "blocks|stack|0|cross|wo",
                  "encoder|stack|0|ffn|w2"):
            assert r["local_shapes"][k][-2] == r["params"][k].shape[-2] // 2, k


def test_full_size_local_leaves_are_jax_shards(monkeypatch):
    """whisper-small's full-size tree at (data 1, model 2), SPATIAL forced on
    the H100 entry: every local leaf, encoder and cross-attention included,
    has JAX's shard shape at both ranks' coordinates, but the embedding:
    its odd vocabulary (51,865) makes JAX split it over d_model, which the
    port runs whole (ROADMAP's deliberate divergences)."""
    full_size_layout(ARCH, monkeypatch)


@pytest.mark.parametrize("arch", ["whisper-small", "recurrentgemma-9b"])
def test_checkpoint_round_trips_across_layouts(tmp_path, arch):
    """A tensor-parallel state saved (gathered: JAX's whole layout and keys)
    restores on one process bit for bit, and one process's checkpoint
    restores onto the tensor-parallel layout as each rank's shards."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import tree_leaves

    cfg = port_cfg(arch, {})
    full = init_params(cfg, tp_plan(cfg, SHAPE), torch.float32,
                       generator=torch.Generator().manual_seed(3), device="cpu")
    save_checkpoint(str(tmp_path / "one"), 1, full)
    res = run_ranks(_ckpt_rank, 2, tmp_path, arch, {}, str(tmp_path))
    back = restore_checkpoint(str(tmp_path / "tp"), 1, full)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(full)))
    for r in res:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r["whole"]), tree_leaves(full)))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r["restored"]),
                                                     tree_leaves(r["local"])))
    sharded = sum(a.shape != b.shape for a, b in zip(tree_leaves(res[0]["local"]),
                                                     tree_leaves(full)))
    assert sharded > 0


def test_planted_control_falls_outside(tmp_path):
    """The encoder memory without its f: each rank's encoder takes only its
    heads' part of the memory's gradient, which moves the parameters after 2
    steps past the bound (against the unplanted run)."""
    cfg = port_cfg(ARCH, {})
    plan = fsdp_plan(cfg, SHAPE, SPATIAL, {})
    good, bad = run_ranks(fsdp_control_rank, 2, tmp_path, cfg, plan, SHAPE,
                          jax_params(ARCH, {}, plan.fuse_qkv), batches(cfg, 91, n=2),
                          "skip_memory_f")[0]
    loss_dev = max(abs(a - b) for a, b in zip(bad["losses"], good["losses"]))
    param_dev = max(float(np.abs(bad["params"][k].numpy() - p.numpy()).max())
                    for k, p in good["params"].items())
    assert loss_dev > 1e-5 or param_dev > 1e-4, (loss_dev, param_dev)

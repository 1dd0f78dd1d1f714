"""The port's checkpoints (``repro_torch.ckpt.checkpoint``) against the JAX
package's (``repro.ckpt.checkpoint``): a checkpoint written by either
restores in the other with identical leaves (bf16 included, the key
strings equal), manifests published last, async saves (which keep the
values they were given while the state is updated in place), the restore
onto a mesh (``shardings``: each rank keeps its shard), and the launcher's
stop-and-resume run reproducing the uninterrupted one bit for bit on the
CPU (the counterpart of
``tests/test_checkpoint.py::test_train_resume_bitexact``)."""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jax_ckpt
from repro.train.optimizer import init_state as jax_init_state
from repro_torch.bridge import from_jax
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.train.optimizer import init_state, tree_leaves
from torch_parity import model_pair, to_numpy

ARCHS = ["smollm-135m", "rwkv6-1.6b"]


def jax_state(arch, seed=0):
    """A JAX ``TrainState`` of ``arch``-reduced with bf16 params, random f32
    moments and residual and step 7, so that no leaf is trivially zero."""
    _, _, params, *_ = model_pair(arch, dtype=jnp.bfloat16, seed=seed)
    st = jax_init_state(params, with_residual=True)
    g = np.random.default_rng(seed)
    rand = lambda x: jnp.asarray(g.standard_normal(x.shape).astype(np.float32))  # noqa: E731
    return st._replace(step=jnp.int32(7), m=jax.tree.map(rand, st.m),
                       v=jax.tree.map(rand, st.v), residual=jax.tree.map(rand, st.residual))


def port_like(state):
    """A fresh port state of the same shape (zeros where JAX's are random)."""
    return init_state(from_jax(to_numpy(state.params), device="cpu"), with_residual=True)


def as_bits(x) -> np.ndarray:
    """A leaf's raw bits, so that bf16 compares exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_leaves(port_state, jax_state_):
    ours, theirs = tree_leaves(port_state), jax.tree.leaves(jax_state_)
    assert len(ours) == len(theirs)
    flat_j = jax_ckpt._flatten(jax_state_)
    flat_t = ckpt._flatten(port_state)
    assert set(flat_j) == set(flat_t)
    for key in flat_j:
        np.testing.assert_array_equal(flat_t[key], flat_j[key], err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_key_strings_match_jax(arch):
    """The port names every leaf as JAX's ``tree_flatten_with_path`` does
    (``TrainState`` field, dict keys, tuple indices; None skipped)."""
    st = jax_state(arch)
    keys_t = set(ckpt._flatten(port_like(st)))
    assert keys_t == set(jax_ckpt._flatten(st))
    assert "step" in keys_t and any(k.startswith("params|") for k in keys_t)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    st = jax_state(arch)
    jax_ckpt.save_checkpoint(str(tmp_path), 7, st)
    like = port_like(st)
    got = ckpt.restore_checkpoint(str(tmp_path), 7, like)
    for a, b, want in zip(tree_leaves(got), tree_leaves(like), jax.tree.leaves(st)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(as_bits(a), as_bits(want))
    assert int(got.step) == 7 and got.params["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    st = jax_state(arch, seed=1)
    ours = ckpt.restore_checkpoint(*_saved_by_jax(tmp_path, st), port_like(st))
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, ours, meta={"arch": arch})
    like = jax_init_state(st.params, with_residual=True)
    got = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), 3, like)
    for a, want in zip(jax.tree.leaves(got), tree_leaves(ours)):
        np.testing.assert_array_equal(as_bits(a), as_bits(want))
    assert_same_leaves(ours, got)
    m = json.loads((tmp_path / "port" / "step_3" / "manifest.json").read_text())
    assert m["step"] == 3 and m["arch"] == arch and m["n_arrays"] == len(tree_leaves(ours))


def _saved_by_jax(tmp_path, st):
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 2, st)
    return str(tmp_path / "jax"), 2


def test_latest_step_ignores_incomplete(tmp_path):
    """A save with no manifest (crashed before its rename) is never
    "latest"; neither is an unpublished ``_tmp_step_*``."""
    st = port_like(jax_state("smollm-135m"))
    ckpt.save_checkpoint(str(tmp_path), 5, st)
    ckpt.save_checkpoint(str(tmp_path), 10, st)
    (tmp_path / "step_15").mkdir()
    (tmp_path / "_tmp_step_20").mkdir()
    (tmp_path / "_tmp_step_20" / "manifest.json").write_text("{}")
    assert ckpt.latest_step(str(tmp_path)) == 10
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


def test_async_save_joins(tmp_path):
    st = port_like(jax_state("smollm-135m"))
    thread = ckpt.save_checkpoint(str(tmp_path), 3, st, async_save=True)
    thread.join()
    assert ckpt.latest_step(str(tmp_path)) == 3
    m = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert m["step"] == 3 and m["n_arrays"] == len(tree_leaves(st))
    assert not (tmp_path / "_tmp_step_3").exists()


def test_async_save_keeps_the_values_it_was_given(tmp_path, monkeypatch):
    """An async save holds the values the state had when it was called,
    also when the caller updates that state in place (the launcher donates
    its state to the step) before the writer thread reads it: the host
    copies share no storage with the live CPU tensors.  The writer is held
    back until the update is done, so the order is fixed."""
    import threading

    st = port_like(jax_state("smollm-135m"))
    want = {k: np.array(v, copy=True) for k, v in ckpt._flatten(st).items()}
    go, savez = threading.Event(), np.savez

    def held(*args, **kw):
        assert go.wait(timeout=60)
        savez(*args, **kw)

    monkeypatch.setattr(ckpt.np, "savez", held)
    thread = ckpt.save_checkpoint(str(tmp_path), 1, st, async_save=True)
    for leaf in tree_leaves(st):
        leaf.add_(1)  # what the next donated step does to every leaf
    go.set()
    thread.join()
    with np.load(tmp_path / "step_1" / "arrays.npz") as z:
        assert set(z.files) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(z[key], value, err_msg=key)


@pytest.mark.parametrize("coords", [{"data": 0, "model": 0}, {"data": 1, "model": 1}])
def test_restore_onto_a_mesh_keeps_local_shards(tmp_path, coords):
    """``restore_checkpoint(shardings=)``: each rank of a (data 2, model 2)
    mesh reads the whole leaves and keeps the block its spec and
    coordinates give; a leaf whose shard does not match ``like`` raises."""
    from repro_torch.dist.sharding import NamedSharding, local_shard
    from test_torch_dist_ranks import ShapeMesh
    from repro_torch.train.optimizer import tree_map

    st = port_like(jax_state("smollm-135m"))
    ckpt.save_checkpoint(str(tmp_path), 1, st)
    mesh = ShapeMesh({"data": 2, "model": 2}, coords)

    def spec(x):  # the last dim over model where it splits, else replicated
        return NamedSharding(mesh, (None,) * (x.dim() - 1) + ("model",)
                             if x.dim() and x.shape[-1] % 2 == 0 else (None,) * x.dim())

    shardings = tree_map(spec, st)
    like = tree_map(lambda x, s: s.local(x).contiguous(), st, shardings)
    got = ckpt.restore_checkpoint(str(tmp_path), 1, like, shardings=shardings)
    n_cut = 0
    for x, s, g in zip(tree_leaves(st), tree_leaves(shardings), tree_leaves(got)):
        assert torch.equal(g, local_shard(x, s.spec, mesh))
        n_cut += g.numel() < x.numel()
    assert n_cut > 0
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path), 1, st, shardings=shardings)


def test_restore_missing_key_raises(tmp_path):
    st = port_like(jax_state("smollm-135m"))
    ckpt.save_checkpoint(str(tmp_path), 1, st._replace(residual=None))
    with pytest.raises(KeyError, match="residual"):
        ckpt.restore_checkpoint(str(tmp_path), 1, st)


def test_train_resume_bitexact(tmp_path):
    """Kill and restart: a run stopped after step 4 and resumed gives the
    uninterrupted run's losses and final state bit for bit."""
    from repro_torch.launch.train import run

    kw = dict(steps=8, batch=2, seq=32, log_every=0, device="cpu")
    losses_a, state_a = run("smollm-135m-reduced", ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    assert ckpt.latest_step(str(tmp_path)) == 8
    shutil.rmtree(tmp_path / "step_8")  # the run stopped after step 4's save
    losses_c, state_c = run("smollm-135m-reduced", ckpt_dir=str(tmp_path), ckpt_every=100,
                            resume=True, **kw)
    assert losses_c == losses_a[4:]
    assert int(state_c.step) == 8
    for a, b in zip(tree_leaves(state_c), tree_leaves(state_a)):
        assert torch.equal(a, b)

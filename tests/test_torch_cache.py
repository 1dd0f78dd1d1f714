"""Port paged cache vs ``repro.models.cache`` on the same numpy inputs:
flat slots with trash-block routing, in-place paged_update for f32, bf16
and int8 pages (int8 values equal, scales within 1e-7), and paged_gather.
The trash block (block 0) is compared only where the contract fixes it:
dead rows collide there and any writer may win."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import derive_serve_plan as jax_serve_plan
from repro.models import cache as JC
from repro_torch.core.plan import derive_serve_plan
from repro_torch.models import cache as TC
from torch_parity import MESH1, configs, t2n


def _case(seed=0, B=3, S=4, KH=2, D=16, bs=4, MB=6):
    rng = np.random.default_rng(seed)
    N = 1 + B * MB
    table = np.zeros((B, MB), np.int32)
    lens = rng.integers(0, MB * bs - S, B).astype(np.int32)
    q_lens = rng.integers(0, S + 1, B).astype(np.int32)
    for b in range(B):
        nb = -(-(int(lens[b]) + S) // bs)
        table[b, :nb] = 1 + b * MB + np.arange(nb)
    pos = (lens[:, None] + np.arange(S)[None]).astype(np.int32)
    valid = np.arange(S)[None] < q_lens[:, None]
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    return N, table, pos, valid, k, v


def test_flat_slots_route_dead_rows_to_trash():
    N, table, pos, valid, _, _ = _case()
    for vd in (None, valid):
        got = TC.paged_flat_slots(
            torch.from_numpy(table), torch.from_numpy(pos), 4,
            None if vd is None else torch.from_numpy(vd),
        )
        want = JC.paged_flat_slots(jnp.asarray(table), jnp.asarray(pos), 4,
                                   None if vd is None else jnp.asarray(vd))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dead = ~valid
    assert (got.numpy()[dead] < 4).all()  # every dead row lands in block 0
    # positions past the table extent are clamped, never out of bounds
    far = np.full_like(pos, 10_000)
    got = TC.paged_flat_slots(torch.from_numpy(table), torch.from_numpy(far), 4)
    assert int(got.max()) < N * 4


@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16", "int8"])
def test_paged_update_and_gather_match(kv_dtype):
    jcfg, tcfg = configs("smollm-135m")
    serve_kw = dict(max_seq_len=24, decode_batch=3, block_size=4, kv_dtype=kv_dtype)
    jserve = jax_serve_plan(jcfg, MESH1, **serve_kw)
    serve = derive_serve_plan(tcfg, MESH1, **serve_kw)
    KH, D = tcfg.n_kv_heads, tcfg.d_head
    N, table, pos, valid, k, v = _case(seed=1, KH=KH, D=D, MB=serve.max_blocks_per_seq)
    serve = dataclasses.replace(serve, n_blocks=N)
    jserve = dataclasses.replace(jserve, n_blocks=N)

    jentry = JC.init_paged_cache(jcfg, None, jserve)["layers"]["stack"][0]["paged"]
    jentry = {key: x[0] for key, x in jentry.items()}  # layer 0 of the stack
    tentry = TC.init_paged_cache(tcfg, None, serve, device="cpu")["layers"]["stack"][0]["paged"]
    tentry = {key: x[0] for key, x in tentry.items()}
    before = {key: x.clone() for key, x in tentry.items()}
    for _ in range(2):  # a second write over the first: in-place semantics
        jentry = JC.paged_update(jentry, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                 jnp.asarray(table), 4, jnp.asarray(valid))
        out = TC.paged_update(tentry, torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos), torch.from_numpy(table), 4,
                              torch.from_numpy(valid))
        assert out is tentry
        k, v = k * 0.5, v * 2.0
    for key in tentry:
        got, want = t2n(tentry[key])[1:], np.asarray(jentry[key], np.float32)[1:]
        if key.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
        assert not torch.equal(tentry[key], before[key])  # written in place

    gk, gv = TC.paged_gather(tentry, torch.from_numpy(table), 4)
    jk, jv = JC.paged_gather(jentry, jnp.asarray(table), 4)
    assert gk.shape == jk.shape  # clamped to the same live high-water mark
    live = np.asarray(table).repeat(4, axis=1)[:, : gk.shape[1]] > 0
    for got, want in ((gk, jk), (gv, jv)):
        np.testing.assert_allclose(t2n(got)[live], np.asarray(want, np.float32)[live],
                                   rtol=1e-7, atol=1e-7)


def test_copy_block_forks_every_leaf():
    _, tcfg = configs("smollm-135m")
    serve = derive_serve_plan(tcfg, MESH1, max_seq_len=16, decode_batch=2, block_size=4,
                              kv_dtype="int8")
    pools = TC.init_paged_cache(tcfg, None, serve, device="cpu")
    for x in TC._leaves(pools):
        x[:, 3] = 7
    TC.paged_copy_block(pools, 3, 5)
    for x in TC._leaves(pools):
        assert torch.equal(x[:, 5], x[:, 3])

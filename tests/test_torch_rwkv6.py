"""RWKV-6 in the port against the JAX package, on the same numpy inputs:
the plain WKV versions (the port's ``wkv_chunked`` / ``wkv_scan_ref``, the
kernel-layout ``kernels/rwkv6/ref.py`` and ``ops.wkv`` on CPU tensors)
against the JAX Pallas kernel (interpret mode, as the JAX kernel test runs
it) and ``wkv_chunked``, on the JAX test's shapes, chunks, strong decay and
state carry; then the time-mix and channel-mix blocks on bridged weights,
with ``collect=True`` and one decode token over the cache.  f32.
Tolerances are the JAX tests': 1e-5 relative to the largest output (1e-4
under strong decay) for the WKV, 1e-5 for the blocks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ops import wkv as jax_wkv
from repro.models import rwkv6 as JR
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv_ref
from repro_torch.models import rwkv6 as R
from torch_parity import model_pair, t2n


def _mk(B, S, H, D, decay_lo=0.45, decay_hi=0.95, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((B, S, H, D))))) * (decay_hi - decay_lo) + decay_lo
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    return r, k, v, w.astype(np.float32), u


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _to_kernel(x, B, S, H, D):
    return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, S, D)


def _plains(r, k, v, w, u, chunk):
    """Every plain WKV of the port on the same inputs, in the model layout."""
    B, S, H, D = r.shape
    T = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    lw = _to_kernel(np.log(w), B, S, H, D)
    kern = wkv_ref(*(_to_kernel(x, B, S, H, D) for x in (r, k, v)), lw, T[4], n_heads=H)
    return {
        "ops.wkv": t2n(ops.wkv(*T, chunk=chunk)),
        "wkv_chunked": t2n(R.wkv_chunked(*T, chunk=chunk)),
        "wkv_scan_ref": t2n(R.wkv_scan_ref(*T)),
        "ref.wkv_ref": t2n(kern.reshape(B, H, S, D).permute(0, 2, 1, 3)),
    }


def _check(shape, chunk, tol, **kw):
    r, k, v, w, u = _mk(*shape, **kw)
    jargs = [jnp.asarray(x) for x in (r, k, v, w, u)]
    want = {"pallas": np.asarray(jax_wkv(*jargs, chunk=chunk)),
            "jax wkv_chunked": np.asarray(JR.wkv_chunked(*jargs, chunk=chunk))}
    for name, got in _plains(r, k, v, w, u, chunk).items():
        assert np.isfinite(got).all(), name
        for ref, x in want.items():
            assert _rel(got, x) < tol, f"{name} vs {ref}: {_rel(got, x):.2e}"


@pytest.mark.parametrize("shape", [(2, 128, 2, 32), (1, 96, 3, 64), (1, 256, 1, 64)])
def test_plain_wkv_matches_jax_kernel(shape):
    _check(shape, 32, 1e-5)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_wkv_chunk_invariance(chunk):
    _check((1, 128, 2, 32), chunk, 1e-5)


def test_plain_wkv_strong_decay():
    """exp(L_{t-1} - L_j) survives decays ~ 0 (log w ~ -7)."""
    _check((1, 128, 2, 32), 32, 1e-4, decay_lo=0.001, decay_hi=0.01)


def test_wkv_state_carry_matches_jax():
    """Two halves with the state passed on equal the whole pass, and the
    final state equals JAX ``wkv_chunked(return_state=True)``'s."""
    B, S, H, D = 1, 64, 2, 32
    r, k, v, w, u = _mk(B, S, H, D, seed=1)
    T = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    full, s_full = ops.wkv(*T, chunk=16, return_state=True)
    h1, st = ops.wkv(*(x[:, :32] for x in T[:4]), T[4], chunk=16, return_state=True)
    h2, s2 = ops.wkv(*(x[:, 32:] for x in T[:4]), T[4], chunk=16, state=st, return_state=True)
    np.testing.assert_allclose(t2n(torch.cat([h1, h2], dim=1)), t2n(full), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t2n(s2), t2n(s_full), rtol=2e-5, atol=2e-5)
    jo, js = JR.wkv_chunked(*(jnp.asarray(x) for x in (r, k, v, w, u)), chunk=16,
                            return_state=True)
    np.testing.assert_allclose(t2n(full), np.asarray(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t2n(s_full), np.asarray(js), rtol=2e-5, atol=2e-5)


def test_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises: here,
    with no CUDA toolkit or card, it raises instead of computing."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    m = torch.empty((1, 32, 2, 32), device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        ops.wkv(m, m, m, m, torch.empty((2, 32), device="meta"))
    with pytest.raises((RuntimeError, ValueError)):
        flash_ops.flash_attention(m, m, m)


def _group0(tree):
    """Layer 0 of the stacked groups (every leaf's index 0)."""
    return {k: _group0(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]


def _layer(arch="rwkv6-1.6b"):
    jcfg, _, jparams, tcfg, _, tparams = model_pair(arch)
    jl, tl = _group0(jparams["blocks"]["stack"][0]), _group0(tparams["blocks"]["stack"][0])
    # non-zero token-shift mixes and decay so every term is exercised
    rng = np.random.default_rng(3)
    for part, names in (("attn", ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w")),
                        ("ffn", ("mix_k", "mix_r"))):
        for n in names:
            x = rng.uniform(0, 1, jl[part][n].shape).astype(np.float32)
            jl[part][n], tl[part][n] = jnp.asarray(x), torch.from_numpy(x)
    return jcfg, jl, tl


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=tol, atol=tol)


def test_time_mix_prefill_and_decode_match_jax():
    jcfg, jl, tl = _layer()
    H, D = jcfg.rnn_heads, jcfg.d_head
    x = np.random.default_rng(4).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jy, jc = JR.rwkv6_time_mix(jl["attn"], jnp.asarray(x[:, :11]), n_heads=H, d_head=D,
                               collect=True)
    ty, tc = R.rwkv6_time_mix(tl["attn"], torch.from_numpy(x[:, :11]), n_heads=H, d_head=D,
                              collect=True)
    _close(ty, jy)
    _close(tc["S"], jc["S"])
    _close(tc["shift"], jc["shift"])
    jy1, jc1 = JR.rwkv6_time_mix(jl["attn"], jnp.asarray(x[:, 11:]), n_heads=H, d_head=D,
                                 cache=jc)
    ty1, tc1 = R.rwkv6_time_mix(tl["attn"], torch.from_numpy(x[:, 11:]), n_heads=H, d_head=D,
                                cache=tc)
    assert tc1 is tc  # the decode step writes the cache in place
    _close(ty1, jy1)
    _close(tc1["S"], jc1["S"])
    _close(tc1["shift"], jc1["shift"])


def test_channel_mix_prefill_and_decode_match_jax():
    jcfg, jl, tl = _layer()
    x = np.random.default_rng(5).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    jy, jc = JR.rwkv6_channel_mix(jl["ffn"], jnp.asarray(x[:, :8]), collect=True)
    ty, tc = R.rwkv6_channel_mix(tl["ffn"], torch.from_numpy(x[:, :8]), collect=True)
    _close(ty, jy)
    _close(tc, jc)
    jy1, jc1 = JR.rwkv6_channel_mix(jl["ffn"], jnp.asarray(x[:, 8:]), cache=jc)
    ty1, tc1 = R.rwkv6_channel_mix(tl["ffn"], torch.from_numpy(x[:, 8:]), cache=tc)
    assert tc1 is tc
    _close(ty1, jy1)
    _close(tc1, jc1)

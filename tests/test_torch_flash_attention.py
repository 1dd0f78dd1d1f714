"""Flash attention in the port against the JAX package, on the same numpy
inputs: the port's plain versions (``layers.blocked_attention``, the
kernel-layout ``kernels/flash_attention/ref.py`` and ``ops.flash_attention``
on CPU tensors) against the JAX Pallas kernel (interpret mode, as the JAX
kernel test runs it) and JAX ``blocked_attention``, on the JAX test's six
CASES (GQA, causal, non-causal, sliding window, prefix-LM, D=128) at 1e-5
(f32) and its bf16 case at its 3e-2; plus a ragged length against the JAX
exact softmax."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.layers import blocked_attention as jax_blocked
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.layers import blocked_attention
from torch_parity import t2n

# tests/test_kernels_flash_attention.py::CASES
CASES = [
    dict(B=2, S=256, H=4, KH=2, D=64, causal=True, window=0, prefix=0),
    dict(B=1, S=128, H=3, KH=1, D=32, causal=True, window=0, prefix=0),
    dict(B=2, S=256, H=4, KH=4, D=64, causal=False, window=0, prefix=0),
    dict(B=1, S=256, H=2, KH=1, D=64, causal=True, window=64, prefix=0),
    dict(B=1, S=128, H=2, KH=2, D=64, causal=True, window=0, prefix=32),
    dict(B=1, S=512, H=1, KH=1, D=128, causal=True, window=128, prefix=0),
]


def _mk(B, S, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    return q, k, v


def _port_plains(q, k, v, *, causal, window, prefix, dtype=torch.float32):
    """Every plain version of the port, in the model layout."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    kl = lambda x, n: x.permute(0, 2, 1, 3).reshape(B * n, S, D)  # noqa: E731
    ref = flash_attention_ref(kl(tq, H), kl(tk, KH), kl(tv, KH), n_q_per_kv=H // KH,
                              causal=causal, window=window, prefix=prefix)
    return {
        "ops.flash_attention": ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                                   prefix=prefix),
        "blocked_attention": blocked_attention(tq, tk, tv, causal=causal, window=window,
                                               q_chunk=64, k_chunk=64, prefix_len=prefix),
        "ref.flash_attention_ref": ref.reshape(B, H, S, D).permute(0, 2, 1, 3),
    }


@pytest.mark.parametrize("case", CASES)
def test_plain_flash_matches_jax(case):
    q, k, v = _mk(case["B"], case["S"], case["H"], case["KH"], case["D"])
    kw = dict(causal=case["causal"], window=case["window"], prefix=case["prefix"])
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = {
        "pallas": np.asarray(jax_flash(jq, jk, jv, block_q=64, block_k=64, **kw)),
        "jax blocked_attention": np.asarray(jax_blocked(
            jq, jk, jv, causal=kw["causal"], window=kw["window"], q_chunk=64, k_chunk=64,
            prefix_len=kw["prefix"])),
    }
    for name, got in _port_plains(q, k, v, **kw).items():
        assert got.dtype == torch.float32, name
        for ref, x in want.items():
            np.testing.assert_allclose(t2n(got), x, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} vs {ref}")


def test_plain_flash_bf16_matches_jax():
    q, k, v = _mk(1, 128, 2, 1, 64, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal=True), np.float32)
    for name, got in _port_plains(q, k, v, causal=True, window=0, prefix=0,
                                  dtype=torch.bfloat16).items():
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(t2n(got), want, rtol=3e-2, atol=3e-2, err_msg=name)


def test_plain_flash_ragged_length():
    """A length no block divides (the kernel masks the ragged tile; the plain
    version halves its chunk) against the JAX exact softmax."""
    q, k, v = _mk(1, 100, 4, 2, 32, seed=2)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                              window=40)
    qr = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(4, 100, 32)
    kr, vr = (jnp.asarray(x).transpose(0, 2, 1, 3).reshape(2, 100, 32) for x in (k, v))
    want = jax_ref(qr, kr, vr, n_q_per_kv=2, causal=True, window=40)
    want = np.asarray(want).reshape(1, 4, 100, 32).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(t2n(got), want, rtol=1e-5, atol=1e-5)

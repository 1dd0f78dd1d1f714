"""Flash attention in the port against the JAX package, on the same numpy
inputs: the port's plain versions (``layers.blocked_attention``, the
kernel-layout ``kernels/flash_attention/ref.py`` and ``ops.flash_attention``
on CPU tensors) against the JAX Pallas kernel (interpret mode, as the JAX
kernel test runs it) and JAX ``blocked_attention``, on the JAX test's six
CASES (GQA, causal, non-causal, sliding window, prefix-LM, D=128) at 1e-5
(f32) and its bf16 case at its 3e-2; plus a ragged length against the JAX
exact softmax.  The bf16 tensor-core kernel's numeric scheme
(``ref.flash_attention_mma_ref``: P V with P as bf16 hi + lo) against the
Pallas kernel and the f32 plain version at the card's bf16 tolerance, and
why P is split (rounded once, it breaks that tolerance); and, with the
kernel library replaced by counting stubs, which C entry each dtype
launches.  At d_head 256 (recurrentgemma-9b's local layers, paligemma-3b's
prefix-LM): the plain versions under causal + window, prefix and
non-causal masks, with Sq != Sk (whisper-small's cross-attention, Sq 1 in
decode), against the Pallas kernel and JAX ``blocked_attention``; the
tensor-core scheme at D 256 (32-key tiles) within one bf16 step; the
wrapper takes D 256 on both entries and refuses any other D (96); and the
plain version's chunk along a length no power of two divides."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.layers import blocked_attention as jax_blocked
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_mma_ref, flash_attention_ref
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


# chip_smoke.py's bf16 tolerance (atol, rtol): one bf16 step of the output.
BF16_TOL = (1e-4, 2.0**-7)
MMA_CASE = dict(B=1, S=512, H=4, KH=2, D=128)


def _outside(got, want, tol=BF16_TOL) -> float:
    """Share of elements with |got - want| > atol + rtol |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) > tol[0] + tol[1] * np.abs(want)).mean())


def _mma_scheme(q, k, v, *, p_split):
    """The kernel's scheme on (B, S, heads, D) bf16 tensors, model layout."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    kl = lambda x, n: x.permute(0, 2, 1, 3).reshape(B * n, S, D)  # noqa: E731
    out = flash_attention_mma_ref(kl(q, H), kl(k, KH), kl(v, KH), n_q_per_kv=H // KH,
                                  causal=True, p_split=p_split)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)


def _mma_refs(seed):
    """(bf16 q, k, v; the Pallas kernel's bf16 output; the f32 plain
    version's output on the same bf16 values), causal."""
    q, k, v = _mk(**MMA_CASE, seed=seed)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(t2n(t), jnp.bfloat16) for t in (tq, tk, tv))
    pallas = np.asarray(jax_flash(jq, jk, jv, causal=True, block_q=128, block_k=128), np.float32)
    f32 = t2n(blocked_attention(tq.float(), tk.float(), tv.float(), causal=True, window=0,
                                q_chunk=128, k_chunk=128))
    return (tq, tk, tv), {"pallas": pallas, "f32 plain": f32}


@pytest.mark.parametrize("seed", [0, 1])
def test_mma_scheme_within_bf16_tolerance(seed):
    """bf16 q k^T with f32 sums, f32 online softmax, P as bf16 hi + lo:
    every element within one bf16 step of the Pallas kernel (interpret
    mode) and of the f32 plain version."""
    (tq, tk, tv), refs = _mma_refs(seed)
    got = _mma_scheme(tq, tk, tv, p_split=True)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    for name, want in refs.items():
        assert _outside(t2n(got), want) == 0.0, name


@pytest.mark.parametrize("seed", [0, 1])
def test_single_bf16_p_breaks_the_tolerance(seed):
    """Why the kernel splits P: the same scheme with P rounded once to bf16
    puts a few percent of the elements outside one bf16 step."""
    (tq, tk, tv), refs = _mma_refs(seed)
    got = t2n(_mma_scheme(tq, tk, tv, p_split=False))
    for name, want in refs.items():
        assert _outside(got, want) > 0.01, name


class _Library:
    """Stands in for the kernel library: every C entry point counts its
    calls and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = Counter(), rc

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] += 1
            return self.rc
        return entry


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "flash_attention_forward_mma"),
                                         (torch.float32, "flash_attention_forward")])
def test_dtype_selects_the_kernel(dtype, entry):
    """bf16 launches the tensor-core entry, f32 the CUDA-core one, once;
    a failed launch raises (no fallback), and fp16 is refused."""
    q = torch.zeros((2, 40, 4, 64), dtype=dtype)
    k = v = torch.zeros((2, 40, 2, 64), dtype=dtype)
    lib = _Library()
    out = ops.launch(lib, q, k, v, causal=True, window=0, prefix=0, stream=None)
    assert lib.calls == Counter({entry: 1})
    assert out.shape == q.shape and out.dtype == dtype
    with pytest.raises(RuntimeError, match=entry):
        ops.launch(_Library(rc=1), q, k, v, causal=True, window=0, prefix=0, stream=None)
    with pytest.raises(ValueError, match="dtypes"):
        ops.launch(lib, q.half(), k.half(), v.half(), causal=True, window=0, prefix=0,
                   stream=None)
    assert lib.calls == Counter({entry: 1})


# d_head 256 and cross-attention shapes: (B, Sq, Sk, H, KH, D, causal, window, prefix)
D256_CASES = [
    (1, 128, 128, 4, 1, 256, True, 48, 0),   # recurrentgemma-9b's local layers (G 16 there)
    (1, 128, 128, 2, 1, 256, True, 0, 32),   # paligemma-3b's prefix-LM
    (2, 16, 96, 2, 2, 256, False, 0, 0),     # bidirectional, Sq != Sk
    (2, 8, 24, 4, 4, 64, False, 0, 0),       # whisper-small's cross-attention ...
    (2, 1, 24, 4, 4, 64, False, 0, 0),       # ... in a decode step
]


@pytest.mark.parametrize("case", D256_CASES)
def test_plain_flash_d256_and_cross_match_jax(case):
    """Every plain version of the port (the wrapper on CPU tensors,
    ``blocked_attention``, the kernel-layout ref, and for the non-causal
    cases ``plain_cross_attention``) against the Pallas kernel (interpret
    mode) and JAX ``blocked_attention``, f32, 1e-5."""
    from repro.models.layers import plain_cross_attention as jax_cross
    from repro_torch.models.layers import plain_cross_attention

    B, Sq, Sk, H, KH, D, causal, window, prefix = case
    rng = np.random.default_rng(sum(case[:6]))
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, KH, D)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, prefix=prefix)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = {
        "pallas": np.asarray(jax_flash(jq, jk, jv, block_q=64, block_k=64, **kw)),
        "jax blocked_attention": np.asarray(jax_blocked(
            jq, jk, jv, causal=causal, window=window, q_chunk=64, k_chunk=64,
            prefix_len=prefix)),
    }
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kl = lambda x, n: x.permute(0, 2, 1, 3).reshape(B * n, x.shape[1], D)  # noqa: E731
    ref = flash_attention_ref(kl(tq, H), kl(tk, KH), kl(tv, KH), n_q_per_kv=H // KH, **kw)
    got = {
        "ops.flash_attention": ops.flash_attention(tq, tk, tv, **kw),
        "blocked_attention": blocked_attention(tq, tk, tv, causal=causal, window=window,
                                               q_chunk=32, k_chunk=32, prefix_len=prefix),
        "ref.flash_attention_ref": ref.reshape(B, H, Sq, D).permute(0, 2, 1, 3),
    }
    if not causal:
        got["plain_cross_attention"] = plain_cross_attention(tq, tk, tv)
        want["jax plain_cross_attention"] = np.asarray(jax_cross(jq, jk, jv))
    for name, x in got.items():
        assert x.shape == (B, Sq, H, D), name
        for rname, w in want.items():
            np.testing.assert_allclose(t2n(x), w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} vs {rname}")


def _mma_d256(seed, *, p_split):
    """(the tensor-core scheme at D 256 with the kernel's 32-key tiles, the
    Pallas kernel's output, the f32 plain version's) on bf16 q, k, v:
    B 1, S 256, H 2, KH 1, causal, window 96."""
    q, k, v = _mk(1, 256, 2, 1, 256, seed=seed)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(t2n(t), jnp.bfloat16) for t in (tq, tk, tv))
    pallas = np.asarray(jax_flash(jq, jk, jv, causal=True, window=96, block_q=128,
                                  block_k=128), np.float32)
    f32 = t2n(blocked_attention(tq.float(), tk.float(), tv.float(), causal=True, window=96,
                                q_chunk=128, k_chunk=128))
    kl = lambda x: x.permute(0, 2, 1, 3).reshape(-1, 256, 256)  # noqa: E731
    got = flash_attention_mma_ref(kl(tq), kl(tk), kl(tv), n_q_per_kv=2, causal=True,
                                  window=96, p_split=p_split, tile=32)
    return t2n(got.reshape(1, 2, 256, 256).permute(0, 2, 1, 3)), {"pallas": pallas,
                                                                  "f32 plain": f32}


@pytest.mark.parametrize("seed", [0, 1])
def test_mma_scheme_d256_within_bf16_tolerance(seed):
    """At D 256 the tensor-core kernel's scheme (32-key tiles, P as bf16 hi
    + lo) stays within one bf16 step of the Pallas kernel and of the f32
    plain version; P rounded once does not."""
    got, refs = _mma_d256(seed, p_split=True)
    for name, want in refs.items():
        assert _outside(got, want) == 0.0, name
    once, _ = _mma_d256(seed, p_split=False)
    for name, want in refs.items():
        assert _outside(once, want) > 0.0, name


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "flash_attention_forward_mma"),
                                         (torch.float32, "flash_attention_forward")])
def test_d256_launches_and_other_head_dims_raise(dtype, entry):
    """D 256 reaches the entry its dtype selects (G 16: 4 positions a CTA);
    a head dim the kernels were not built for (96) raises before any
    launch."""
    q = torch.zeros((1, 8, 16, 256), dtype=dtype)
    k = v = torch.zeros((1, 8, 1, 256), dtype=dtype)
    lib = _Library()
    assert ops.launch(lib, q, k, v, causal=True, window=0, prefix=0, stream=None).shape == q.shape
    assert lib.calls == Counter({entry: 1})
    q96 = torch.zeros((1, 8, 2, 96), dtype=dtype)
    k96 = torch.zeros((1, 8, 1, 96), dtype=dtype)
    with pytest.raises(ValueError, match="head dim 96"):
        ops.launch(lib, q96, k96, k96, causal=True, window=0, prefix=0, stream=None)
    assert lib.calls == Counter({entry: 1})


@pytest.mark.parametrize("n,chunk", [(2048, 128), (1500, 125), (2100, 105), (97, 97), (1, 1),
                                     (300, 100)])
def test_plain_chunk_divides(n, chunk):
    """The plain version's chunk: the largest divisor up to 128 (whisper's
    1,500 frames take 125, not the 4 that halving from 128 would reach)."""
    assert ops.plain_chunk(n) == chunk and n % chunk == 0

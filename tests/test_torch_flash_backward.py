"""The flash-attention backward: the port's plain versions (``ref.
fwd_with_lse``, ``ref.vjp_bwd``, in the model layout
``flash_forward_lse_ref`` / ``flash_backward_ref``) against the JAX
package's ``backward.py`` (``flash_attention_grad``, ``_fwd_with_lse``) on
``tests/test_flash_backward.py``'s three cases and on the prefix-LM and Sq
!= Sk cases; the planted faults the card's checks plant (lse in log2
units, delta dropped, one head of each group folded) fail the tolerance;
``FlashAttention`` (the autograd Function) routes the forward's lse to the
backward and returns the gradients of fused-QKV views, with the plain
versions standing in for the kernels; the backward launcher's checks; the
bf16 tensor-core kernel's numeric scheme (``flash_backward_mma_ref``: P
and dS as bf16 hi + lo) within one bf16 step of the f32 plain backward,
and P and dS rounded once outside it.  Tolerances: the JAX test's 2e-4
(rtol and atol) on the gradients, 1e-5 on the lse and the output; the
scheme, ``chip_smoke.py``'s ``GRAD_BF16_TOL``."""
import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.backward import _fwd_with_lse as jax_fwd_with_lse
from repro.kernels.flash_attention.backward import flash_attention_grad
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (flash_backward_mma_ref, flash_backward_ref,
                                                     flash_forward_lse_ref, fwd_with_lse)
from repro_torch.models.layers import blocked_attention
from torch_parity import t2n

TOL = 2e-4

CASES = [
    # tests/test_flash_backward.py's three, D as given
    dict(B=2, S=64, H=4, KH=2, D=32, causal=True, window=0, prefix=0),
    dict(B=1, S=128, H=2, KH=1, D=16, causal=True, window=32, prefix=0),
    dict(B=1, S=64, H=3, KH=3, D=16, causal=False, window=0, prefix=0),
    # prefix-LM, and the G 3 of smollm-135m
    dict(B=2, S=48, H=6, KH=2, D=32, causal=True, window=0, prefix=20),
    # Sq != Sk: cross-attention (non-causal) and a causal query block
    dict(B=2, S=24, Sk=40, H=4, KH=4, D=32, causal=False, window=0, prefix=0),
    dict(B=1, S=24, Sk=40, H=4, KH=2, D=32, causal=True, window=8, prefix=0),
    # D 256: paligemma-3b's G 8 with a prefix, recurrentgemma-9b's G 16
    # with a window that cuts
    dict(B=1, S=40, H=8, KH=1, D=256, causal=True, window=0, prefix=12),
    dict(B=1, S=48, H=16, KH=1, D=256, causal=True, window=20, prefix=0),
]


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    Sk = c.get("Sk", c["S"])
    q = rng.standard_normal((c["B"], c["S"], c["H"], c["D"])).astype(np.float32)
    k = rng.standard_normal((c["B"], Sk, c["KH"], c["D"])).astype(np.float32)
    v = rng.standard_normal((c["B"], Sk, c["KH"], c["D"])).astype(np.float32)
    return q, k, v


def _mask_kw(c):
    return dict(causal=c["causal"], window=c["window"], prefix=c["prefix"])


def _jax_grads(q, k, v, c):
    """JAX's custom_vjp gradients of sum(o^2) (so dO = 2 o), and o."""
    def loss(q, k, v):
        return jnp.sum(jnp.square(flash_attention_grad(q, k, v, **_mask_kw(c))))

    o = flash_attention_grad(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **_mask_kw(c))
    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in g]


def _port_grads(q, k, v, c, lse_scale=1.0, **controls):
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = flash_forward_lse_ref(tq, tk, tv, **_mask_kw(c))
    grads = flash_backward_ref(tq, tk, tv, o, lse * lse_scale, 2 * o, **_mask_kw(c), **controls)
    return t2n(o), lse, [t2n(x) for x in grads]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax(case):
    q, k, v = _inputs(case)
    jo, jg = _jax_grads(q, k, v, case)
    to, _, tg = _port_grads(q, k, v, case)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_plain_lse_matches_jax(case):
    """The logsumexp rows (natural log) against JAX's ``_fwd_with_lse``, in
    the kernel layout."""
    q, k, v = _inputs(case, seed=1)
    B, S, H, D = q.shape
    KH = k.shape[2]
    kl = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], D)  # noqa: E731
    jo, jlse = jax_fwd_with_lse(jnp.asarray(kl(q)), jnp.asarray(kl(k)), jnp.asarray(kl(v)),
                                n_q_per_kv=H // KH, scale=1.0 / math.sqrt(D), **_mask_kw(case))
    to, tlse = fwd_with_lse(*(torch.from_numpy(kl(x)) for x in (q, k, v)), n_q_per_kv=H // KH,
                            **_mask_kw(case))
    np.testing.assert_allclose(t2n(tlse), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2n(to), np.asarray(jo), rtol=1e-5, atol=1e-5)
    _, mlse = flash_forward_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)), **_mask_kw(case))
    np.testing.assert_array_equal(t2n(mlse).reshape(-1, S), t2n(tlse))


def _outside(got, want):
    return max(float(np.mean(np.abs(a - b) > TOL + TOL * np.abs(b))) for a, b in zip(got, want))


@pytest.mark.parametrize("control", ["lse in log2 units", "delta dropped",
                                     "one head of each group folded"])
def test_planted_faults_break_the_tolerance(control):
    """What a kernel with each planted bug would give misses the tolerance
    on a GQA causal case (G 2, as qwen3-1.7b)."""
    case = CASES[0]
    q, k, v = _inputs(case, seed=2)
    _, jg = _jax_grads(q, k, v, case)
    kw = {"lse in log2 units": dict(lse_scale=1 / math.log(2)),
          "delta dropped": dict(drop_delta=True),
          "one head of each group folded": dict(fold_first_only=True)}[control]
    _, _, tg = _port_grads(q, k, v, case, **kw)
    assert _outside(tg, jg) > 0.05


@pytest.fixture
def plain_kernels(monkeypatch):
    """The Function's two launches, with the plain versions standing in
    for the kernels on CPU tensors; yields the launch counts."""
    calls = Counter()

    def fwd(q, k, v, *, causal, window, prefix, with_lse=False):
        calls["forward"] += 1
        o, lse = flash_forward_lse_ref(q, k, v, causal=causal, window=window, prefix=prefix)
        return o, (lse if with_lse else None)

    def bwd(q, k, v, out, lse, dout, *, causal, window, prefix):
        calls["backward"] += 1
        assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
        return flash_backward_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                  prefix=prefix)

    monkeypatch.setattr(ops, "forward_with_lse", fwd)
    monkeypatch.setattr(ops, "backward", bwd)
    return calls


@pytest.mark.parametrize("prefix", [0, 6])
def test_function_on_fused_qkv_views(plain_kernels, prefix):
    """q, k and v as views of one fused projection (qwen3's layout): the
    Function's gradient of the projection equals autograd's through the
    plain attention, one forward and one backward launch."""
    B, S, H, KH, D = 2, 20, 4, 2, 32
    rng = np.random.default_rng(3)
    qkv0 = torch.from_numpy(rng.standard_normal((B, S, (H + 2 * KH) * D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))

    def views(t):
        q, k, v = torch.split(t, [H * D, KH * D, KH * D], dim=-1)
        return q.reshape(B, S, H, D), k.reshape(B, S, KH, D), v.reshape(B, S, KH, D)

    a = qkv0.clone().requires_grad_()
    out = ops.FlashAttention.apply(*views(a), True, 0, prefix)
    (out * w).sum().backward()
    b = qkv0.clone().requires_grad_()
    ref = blocked_attention(*views(b), causal=True, q_chunk=4, k_chunk=4, prefix_len=prefix)
    (ref * w).sum().backward()
    assert plain_kernels == Counter({"forward": 1, "backward": 1})
    np.testing.assert_allclose(t2n(out), t2n(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2n(a.grad), t2n(b.grad), rtol=TOL, atol=TOL)


def test_cpu_wrapper_differentiates_the_plain_version():
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    k = torch.randn(1, 8, 1, 32, requires_grad=True)
    out = ops.flash_attention(q, k, k)
    assert out.grad_fn is not None


class _Library:
    """Stands in for the backward library: counts its calls, returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = Counter(), rc

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] += 1
            self.args = args
            return self.rc
        return entry


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_backward_checks(dtype):
    """One launch of the C entry with the dtype's code; the outputs are
    contiguous in the inputs' dtype; D 256 reaches the entry, a head dim
    the kernels are not built for (96) and a failed launch raise; the
    forward launcher passes an lse buffer through."""
    B, S, H, KH, D = 2, 40, 4, 2, 64
    q = torch.zeros((B, S, H, D), dtype=dtype)
    k = v = torch.zeros((B, S, KH, D), dtype=dtype)
    o = torch.zeros_like(q)
    lse = torch.zeros((B, H, S))
    lib = _Library()
    dq, dk, dv = ops.launch_backward(lib, q, k, v, o, lse, o.transpose(1, 2).contiguous()
                                     .transpose(1, 2), causal=True, window=0, prefix=0,
                                     stream=None)
    assert lib.calls == Counter({"flash_attention_backward": 1})
    assert lib.args[-3] == {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert all(x.dtype == dtype and x.is_contiguous() for x in (dq, dk, dv))
    with pytest.raises(RuntimeError, match="backward kernel launch failed"):
        ops.launch_backward(_Library(rc=1), q, k, v, o, lse, o, causal=True, window=0,
                            prefix=0, stream=None)
    q256, k256 = torch.zeros((B, S, H, 256), dtype=dtype), torch.zeros((B, S, KH, 256), dtype=dtype)
    dq, dk, _ = ops.launch_backward(lib, q256, k256, k256, q256, lse, q256, causal=True,
                                    window=0, prefix=0, stream=None)
    assert lib.calls == Counter({"flash_attention_backward": 2}) and lib.args[15] == 256
    assert dq.shape == q256.shape and dk.shape == k256.shape
    q96, k96 = torch.zeros((B, S, H, 96), dtype=dtype), torch.zeros((B, S, KH, 96), dtype=dtype)
    with pytest.raises(ValueError, match="head dim 96"):
        ops.launch_backward(lib, q96, k96, k96, q96, lse, q96, causal=True, window=0,
                            prefix=0, stream=None)
    assert lib.calls == Counter({"flash_attention_backward": 2})
    fwd = _Library()
    ops.launch(fwd, q, k, v, causal=True, window=0, prefix=0, stream=None, lse=lse)
    assert fwd.args[4] == lse.data_ptr()
    ops.launch(fwd, q, k, v, causal=True, window=0, prefix=0, stream=None)
    assert fwd.args[4] is None


# chip_smoke.py's GRAD_BF16_TOL: (atol x max(1, max |want|), rtol)
GRAD_BF16_TOL = (1e-4, 2.0 ** -7)


def _outside_bf16(got, want):
    """Share of each gradient's elements outside GRAD_BF16_TOL."""
    atol, rtol = GRAD_BF16_TOL
    shares = []
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        tol = atol * max(1.0, float(b.abs().max())) + rtol * b.abs()
        shares.append(float(((a - b).abs() > tol).float().mean()))
    return shares


@pytest.mark.parametrize("split", [True, False], ids=["hi+lo", "rounded-once"])
@pytest.mark.parametrize("shape", [
    # qwen3-1.7b's heads, causal; paligemma-3b's with its 256-long prefix
    # cut to 64; recurrentgemma-9b's with a window that cuts
    dict(B=2, S=192, H=16, KH=8, D=128, causal=True, window=0, prefix=0),
    dict(B=2, S=192, H=8, KH=1, D=256, causal=True, window=0, prefix=64),
    dict(B=1, S=256, H=16, KH=1, D=256, causal=True, window=96, prefix=0),
], ids=["qwen3-D128", "paligemma-D256", "recurrentgemma-D256"])
def test_mma_scheme_within_one_bf16_step(shape, split):
    """The bf16 kernel's scheme (P and dS as bf16 hi + lo in the products,
    f32 sums) stays within GRAD_BF16_TOL of the f32 plain backward on bf16
    inputs; P and dS rounded once to bf16 put elements of each gradient
    outside it (the planted control phase 29 holds the kernel to)."""
    g = torch.Generator().manual_seed(5)
    B, S, H, KH, D = (shape[n] for n in ("B", "S", "H", "KH", "D"))
    q = torch.randn((B, S, H, D), generator=g).bfloat16()
    k, v = (torch.randn((B, S, KH, D), generator=g).bfloat16() for _ in range(2))
    kw = _mask_kw(shape)
    o, lse = flash_forward_lse_ref(q, k, v, **kw)
    do = torch.randn(o.shape, generator=g).bfloat16()
    want = flash_backward_ref(q, k, v, o, lse, do, **kw)
    got = flash_backward_mma_ref(q, k, v, o, lse, do, **kw, split=split)
    assert all(a.dtype == torch.bfloat16 and a.shape == b.shape for a, b in zip(got, want))
    shares = _outside_bf16(got, want)
    if split:
        assert shares == [0.0, 0.0, 0.0], shares
    else:
        assert min(shares) > 1e-3, shares

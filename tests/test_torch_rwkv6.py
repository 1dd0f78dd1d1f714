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
from repro_torch.kernels.rwkv6.ref import tf32, tf32_split, wkv_ref, wkv_split_ref
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


def _worst(got, want):
    """Where |got - want| is largest: the index, both values and the torch
    threads in use (for a failure that does not repeat)."""
    i = np.unravel_index(int(np.argmax(np.abs(got - want))), got.shape)
    return (f"worst at {tuple(int(x) for x in i)}: got {got[i]!r}, want {want[i]!r}, "
            f"torch threads {torch.get_num_threads()}")


def _check(shape, chunk, tol, **kw):
    r, k, v, w, u = _mk(*shape, **kw)
    jargs = [jnp.asarray(x) for x in (r, k, v, w, u)]
    want = {"pallas": np.asarray(jax_wkv(*jargs, chunk=chunk)),
            "jax wkv_chunked": np.asarray(JR.wkv_chunked(*jargs, chunk=chunk))}
    for name, got in _plains(r, k, v, w, u, chunk).items():
        assert np.isfinite(got).all(), name
        for ref, x in want.items():
            assert _rel(got, x) < tol, (f"{name} vs {ref}: {_rel(got, x):.2e}; "
                                        f"{_worst(got, x)}")


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


def _jax_wants(r, k, v, w, u, chunk):
    """The JAX Pallas kernel (interpret mode) and JAX ``wkv_chunked`` on the
    same inputs; both halve ``chunk`` until it divides S, as the JAX
    wrapper does."""
    S = r.shape[1]
    c = min(chunk, S)
    while S % c:
        c //= 2
    jargs = [jnp.asarray(x) for x in (r, k, v, w, u)]
    return {"pallas": np.asarray(jax_wkv(*jargs, chunk=c)),
            "jax wkv_chunked": np.asarray(JR.wkv_chunked(*jargs, chunk=c))}


# (shape, chunk, _mk options, tolerance): the JAX test's shapes, chunks and
# strong decay, a ragged S (the last chunk padded) and a D 64 chunk 64.
SPLIT_CASES = [
    ((2, 128, 2, 32), 32, {}, 1e-5),
    ((1, 96, 3, 64), 32, {}, 1e-5),
    ((1, 256, 1, 64), 32, {}, 1e-5),
    ((1, 128, 2, 32), 16, {}, 1e-5),
    ((1, 128, 2, 32), 64, {}, 1e-5),
    ((1, 128, 2, 32), 32, {"decay_lo": 0.001, "decay_hi": 0.01}, 1e-4),
    ((2, 100, 2, 64), 32, {}, 1e-5),
    ((1, 128, 2, 64), 64, {"seed": 2}, 1e-5),
]


@pytest.mark.parametrize("bf16_inputs", [False, True], ids=["f32", "bf16-rounded"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: f"{c[0]}-c{c[1]}-{len(c[2])}")
def test_split_scheme_matches_jax(case, bf16_inputs):
    """The tensor-core entry's arithmetic, emulated on the CPU, against the
    JAX kernel and model path; with ``bf16_inputs`` r/k/v are rounded to
    bf16 first (the main path's inputs, exact in TF32) for both sides."""
    shape, chunk, kw, tol = case
    r, k, v, w, u = _mk(*shape, **kw)
    if bf16_inputs:
        r, k, v = (t2n(torch.from_numpy(x).bfloat16()) for x in (r, k, v))
    got = t2n(wkv_split_ref(*(torch.from_numpy(x) for x in (r, k, v, w, u)), chunk=chunk))
    assert np.isfinite(got).all()
    for ref, want in _jax_wants(r, k, v, w, u, chunk).items():
        assert _rel(got, want) < tol, f"vs {ref}: {_rel(got, want):.2e}"


def test_split_scheme_state_carry():
    """The emulation continues from a state passed in: two halves equal the
    whole, and the final state equals JAX ``wkv_chunked(return_state=True)``'s."""
    B, S, H, D = 1, 96, 2, 64
    r, k, v, w, u = _mk(B, S, H, D, seed=1)
    T = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    full, s_full = wkv_split_ref(*T, chunk=32, return_state=True)
    h1, st = wkv_split_ref(*(x[:, :48] for x in T[:4]), T[4], chunk=32, return_state=True)
    h2, s2 = wkv_split_ref(*(x[:, 48:] for x in T[:4]), T[4], chunk=32, state=st,
                           return_state=True)
    jo, js = JR.wkv_chunked(*(jnp.asarray(x) for x in (r, k, v, w, u)), chunk=32,
                            return_state=True)
    for got, want in ((full, jo), (torch.cat([h1, h2], dim=1), jo), (s_full, js), (s2, js)):
        assert _rel(t2n(got), np.asarray(want)) < 1e-5


@pytest.mark.parametrize("control", ["split=False", "drop_diagonal"])
def test_split_scheme_controls_rejected(control):
    """The planted controls of the tensor-core scheme fall outside the
    tolerance: operands rounded once to TF32 (no lo), and the diagonal
    halves' per-element weights left out."""
    r, k, v, w, u = _mk(1, 256, 1, 64)
    opts = {"split": False} if control == "split=False" else {"drop_diagonal": True}
    got = t2n(wkv_split_ref(*(torch.from_numpy(x) for x in (r, k, v, w, u)), chunk=32, **opts))
    want = _jax_wants(r, k, v, w, u, 32)["jax wkv_chunked"]
    assert _rel(got, want) >= 1e-5


def test_tf32_rounding():
    """``tf32`` rounds to 10 mantissa bits, to nearest with ties away from
    zero; ``tf32_split``'s hi + lo (lo truncated) carries x to 2^-21."""
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-11, 3.0],
                     dtype=torch.float32)
    np.testing.assert_array_equal(t2n(tf32(x)), [1 + 2**-10, -(1 + 2**-10), 1.0,
                                                1 + 2**-9, 3.0])
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi, lo = tf32_split(y)
    assert torch.equal(hi, tf32(y)) and torch.equal(tf32(lo.abs()) >= lo.abs(),
                                                    torch.ones_like(y, dtype=torch.bool))
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0**-21


class _StandIn:
    """A stand-in for the kernel library: records each entry's call."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if not name.startswith("wkv_forward"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or self.rc


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_routes_by_dtype(dtype):
    """bf16 r/k/v go to the tensor-core entry, f32 to the CUDA-core one,
    with the dtype code each takes; a nonzero return code raises."""
    r, k, v, w, u = (torch.from_numpy(x) for x in _mk(1, 64, 2, 32))
    r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
    lib = _StandIn()
    out, st = ops.launch(lib, r, k, v, w, u, chunk=32, state=None, return_state=True, stream=0)
    assert out.shape == r.shape and out.dtype == torch.float32 and st.shape == (1, 2, 32, 32)
    (name, args), = lib.calls
    want = "wkv_forward_mma" if dtype == torch.bfloat16 else "wkv_forward"
    assert name == want == ops.ENTRIES[dtype]
    assert args[8:14] == (1, 64, 2, 32, 32, 1 if dtype == torch.bfloat16 else 0)
    with pytest.raises(RuntimeError, match=want):
        ops.launch(_StandIn(rc=700), r, k, v, w, u, chunk=32, state=None, return_state=False,
                   stream=0)
    with pytest.raises(ValueError):
        ops.launch(lib, r, k, v, w, u, chunk=48, state=None, return_state=False, stream=0)


def test_wrappers_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: here,
    with no CUDA toolkit or card, the kernels' builds raise instead of
    computing.  On the meta device the wrappers take the dry run's route,
    which records one call and computes nothing; the plain versions are
    never called and no launch is counted."""
    from repro_torch.core.op_cost import OpRecorder
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import layers

    def refuse(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(R, "wkv_chunked", refuse)
    monkeypatch.setattr(layers, "blocked_attention", refuse)
    monkeypatch.setattr(flash_ops, "blocked_attention", refuse)
    monkeypatch.setattr(ops.kernel, "_lib", None)
    monkeypatch.setattr(flash_ops.kernel, "_lib", None)
    for build in (ops.kernel.library, flash_ops.kernel.library):
        with pytest.raises(RuntimeError):
            build()
    m = torch.empty((1, 32, 2, 32), device="meta")
    launches = (ops.LAUNCHES, flash_ops.LAUNCHES)
    with OpRecorder() as rec:
        assert ops.wkv(m, m, m, m, torch.empty((2, 32), device="meta")).shape == m.shape
        assert flash_ops.flash_attention(m, m, m).shape == m.shape
    assert rec.cost.kernel_calls() == {"wkv": 1, "flash_attention": 1}
    assert (ops.LAUNCHES, flash_ops.LAUNCHES) == launches


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

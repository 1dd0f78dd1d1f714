"""Port layers vs ``repro.models.layers`` on the same numpy inputs, f32:
rmsnorm, layernorm, rope, sinusoidal positions (with an offset, against a
slice of JAX's table), the three MLPs, the gather-path paged attention and
the cross-attention.  Tolerance 1e-5 (f32 sums taken in a different
order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_norms_match():
    rng = np.random.default_rng(0)
    x, s, b = _rand(rng, 3, 5, 64), _rand(rng, 64, scale=0.1), _rand(rng, 64, scale=0.1)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(s)))
    _close(TL.layernorm(*map(torch.from_numpy, (x, s, b))),
           JL.layernorm(*map(jnp.asarray, (x, s, b))))
    # bf16 activations: f32 math, cast back (same rounding both sides)
    xb = torch.from_numpy(x).bfloat16()
    got = TL.rmsnorm(xb, torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    want = JL.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_split_halves_per_slot_positions(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 6, 4, 32)  # (B, S, H, D)
    pos = (rng.integers(0, 2000, (3, 1)) + np.arange(6)[None]).astype(np.int32)
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta), tol=2e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(activation):
    rng = np.random.default_rng(2)
    p = {"w1": _rand(rng, 64, 128, scale=0.1), "w2": _rand(rng, 128, 64, scale=0.1)}
    if activation != "gelu":
        p["w3"] = _rand(rng, 64, 128, scale=0.1)
    x = _rand(rng, 2, 5, 64)
    got = TL.mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), activation)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), activation)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 5])
def test_gather_paged_attention_matches(window):
    rng = np.random.default_rng(3)
    B, S, H, KH, D, Skv = 3, 4, 4, 2, 32, 24
    q, k, v = _rand(rng, B, S, H, D), _rand(rng, B, Skv, KH, D), _rand(rng, B, Skv, KH, D)
    pos = (rng.integers(0, Skv - S, (B, 1)) + np.arange(S)[None]).astype(np.int32)
    got = TL.paged_attention(*map(torch.from_numpy, (q, k, v, pos)), window=window)
    want = JL.paged_attention(*map(jnp.asarray, (q, k, v, pos)), window=window)
    _close(got, want)


@pytest.mark.parametrize("seq_len,d_model,offset", [(10, 16, 0), (7, 64, 0), (1, 768, 1499),
                                                    (3, 32, 100_000)])
def test_sinusoidal_positions_at_an_offset(seq_len, d_model, offset):
    """Rows ``offset ..`` equal the same rows of JAX's table from 0 (which
    JAX's decode step slices out of a ``max_seq_len`` table).  Tolerance
    1e-5 plus 4 f32 ulps of the largest angle (the position itself, in
    radians): sin and cos of an angle rounded to f32 differ by that much."""
    got = TL.sinusoidal_positions(seq_len, d_model, offset)
    assert got.shape == (seq_len, d_model) and got.dtype == torch.float32
    want = np.asarray(JL.sinusoidal_positions(offset + seq_len, d_model))[offset:]
    tol = TOL + (offset + seq_len) * 2.0**-22
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JL.sinusoidal_positions(seq_len, d_model, offset)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Sk", [(5, 12), (1, 12), (16, 7)])
def test_plain_cross_attention_matches(Sq, Sk):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, Sq, 4, 8), _rand(rng, 2, Sk, 2, 8), _rand(rng, 2, Sk, 2, 8)
    _close(TL.plain_cross_attention(*map(torch.from_numpy, (q, k, v))),
           JL.plain_cross_attention(*map(jnp.asarray, (q, k, v))))

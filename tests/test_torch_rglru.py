"""The port's RG-LRU block (``repro_torch/models/rglru.py``) against the JAX
package on the same numpy inputs: the four properties of
tests/test_recurrent.py (the log-depth scan equals the sequential oracle,
decode steps continue a scan, the causal conv streams, the state stays
bounded), each held against JAX's ``rglru`` and ``rglru_scan_ref`` as
well; the scan under the strongest decay over a long sequence, where a
closed form exp(cumsum(log a)) breaks; and ``rglru_block`` (prefill with
the harvested state, then decode steps on it) against JAX's.  All f32;
tolerances are the JAX test's (1e-5 for the scan and the conv, 1e-4 for
decode steps) unless a test says otherwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jr
from repro_torch.models import rglru as tr
from torch_parity import t2n


def _gparams(W, H, seed=0, lam=(-2.0, 1.0)):
    """Gate weights as tests/test_recurrent.py draws them (normal x 0.1,
    zero biases, lam a linspace), from numpy."""
    rng = np.random.default_rng(seed)
    bh = W // H
    return {
        "w_gate_a": (rng.standard_normal((H, bh, bh)) * 0.1).astype(np.float32),
        "b_gate_a": np.zeros((W,), np.float32),
        "w_gate_x": (rng.standard_normal((H, bh, bh)) * 0.1).astype(np.float32),
        "b_gate_x": np.zeros((W,), np.float32),
        "lam": np.linspace(lam[0], lam[1], W).astype(np.float32),
    }


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _u(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_associative_scan_equals_sequential():
    B, S, W, H = 2, 32, 16, 2
    jp, tp = _both(_gparams(W, H))
    u = _u((B, S, W), 5)
    y1, h1 = tr.rglru(tp, torch.from_numpy(u), H)
    y2, h2 = tr.rglru_scan_ref(tp, torch.from_numpy(u), H)
    np.testing.assert_allclose(t2n(y1), t2n(y2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2n(h1), t2n(h2), rtol=1e-5, atol=1e-5)
    for name, (jy, jh) in {"rglru": jr.rglru(jp, jnp.asarray(u), H),
                           "rglru_scan_ref": jr.rglru_scan_ref(jp, jnp.asarray(u), H)}.items():
        np.testing.assert_allclose(t2n(y1), np.asarray(jy), rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(t2n(h1), np.asarray(jh), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("S", [1, 2, 3, 31, 64, 100])
def test_scan_with_initial_state_matches_jax(S):
    """Every length the doubling handles at its edges (S = 1, powers of
    two and between), with a carried-in state h0."""
    B, W, H = 2, 8, 2
    jp, tp = _both(_gparams(W, H, seed=1))
    u, h0 = _u((B, S, W), 6), _u((B, W), 7)
    y, h = tr.rglru(tp, torch.from_numpy(u), H, h0=torch.from_numpy(h0))
    ys, hs = tr.rglru_scan_ref(tp, torch.from_numpy(u), H, h0=torch.from_numpy(h0))
    jy, jh = jr.rglru(jp, jnp.asarray(u), H, h0=jnp.asarray(h0))
    for got, want in ((y, jy), (h, jh), (ys, jy), (hs, jh)):
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_decode_steps_continue_scan():
    B, S, W, H = 1, 16, 8, 2
    jp, tp = _both(_gparams(W, H))
    u = _u((B, S, W), 6)
    tu = torch.from_numpy(u)
    y_full, _ = tr.rglru(tp, tu, H)
    _, h = tr.rglru(tp, tu[:, :8], H)
    outs = []
    for t in range(8, S):
        y1, h = tr.rglru_decode_step(tp, tu[:, t], h, H)
        outs.append(t2n(y1))
    got = np.stack(outs, axis=1)
    np.testing.assert_allclose(got, t2n(y_full[:, 8:]), rtol=1e-4, atol=1e-4)
    jy, _ = jr.rglru(jp, jnp.asarray(u), H)
    np.testing.assert_allclose(got, np.asarray(jy[:, 8:]), rtol=1e-4, atol=1e-4)


def test_causal_conv_streaming():
    B, S, W, cw = 2, 12, 8, 4
    x, w = _u((B, S, W), 0), _u((cw, W), 1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    full, _ = tr.causal_conv1d(tx, tw)
    y1, st = tr.causal_conv1d(tx[:, :5], tw)
    y2, _ = tr.causal_conv1d(tx[:, 5:], tw, st)
    got = torch.cat([y1, y2], dim=1)
    np.testing.assert_allclose(t2n(got), t2n(full), rtol=1e-5, atol=1e-6)
    jfull, jst = jr.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(t2n(full), np.asarray(jfull), rtol=1e-5, atol=1e-6)
    _, tst = tr.causal_conv1d(tx, tw)
    np.testing.assert_array_equal(t2n(tst), np.asarray(jst))


@pytest.mark.parametrize("S", [8, 16, 33])
@pytest.mark.parametrize("W", [8, 16])
def test_rglru_state_bounded(S, W):
    """|h_t| stays bounded: a in (0,1) and b scaled by sqrt(1-a^2); the
    port's values equal JAX's."""
    H = 2
    jp, tp = _both(_gparams(W, H))
    u = np.full((1, S, W), 3.0, np.float32)
    y, h = tr.rglru(tp, torch.from_numpy(u), H)
    assert np.all(np.isfinite(t2n(y)))
    assert np.max(np.abs(t2n(h))) < 100.0
    jy, _ = jr.rglru(jp, jnp.asarray(u), H)
    np.testing.assert_allclose(t2n(y), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_strong_decay_long_sequence():
    """lam up to 8 (softplus ~ 8: log a down to about -64 a step where the
    gate opens) over 1,024 steps: the scan equals the sequential oracle
    and JAX, while the closed form exp(cumsum(log a)) leaves f32 range
    (the running sum passes -88 within a few steps) and is wrong."""
    B, S, W, H = 1, 1024, 16, 2
    jp, tp = _both(_gparams(W, H, seed=3, lam=(0.0, 8.0)))
    u = _u((B, S, W), 8)
    tu = torch.from_numpy(u)
    y, _ = tr.rglru(tp, tu, H)
    ys, _ = tr.rglru_scan_ref(tp, tu, H)
    np.testing.assert_allclose(t2n(y), t2n(ys), rtol=1e-5, atol=1e-5)
    jy, _ = jr.rglru(jp, jnp.asarray(u), H)
    np.testing.assert_allclose(t2n(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    a, b = tr._gates(tp, tu, H)
    cum = torch.cumsum(torch.log(a), dim=1)
    closed = torch.exp(cum) * torch.cumsum(b * torch.exp(-cum), dim=1)
    bad = ~torch.isfinite(closed) | ((closed - ys).abs() > 1e-3)
    assert bool(bad.any())


def _block_params(d, W, H, cw, seed):
    rng = np.random.default_rng(seed)
    p = _gparams(W, H, seed=seed)
    p.update({
        "w_x": (rng.standard_normal((d, W)) * 0.1).astype(np.float32),
        "w_g": (rng.standard_normal((d, W)) * 0.1).astype(np.float32),
        "conv_w": (rng.standard_normal((cw, W)) * 0.1).astype(np.float32),
        "w_out": (rng.standard_normal((W, d)) * 0.1).astype(np.float32),
    })
    return _both(p)


def test_rglru_block_prefill_then_decode_matches_jax():
    """``rglru_block``: the prefill's output and harvested state equal
    JAX's, and decode steps on that state (written in place) equal JAX's
    steps and the full pass (1e-4, as decode steps above)."""
    B, S0, EXTRA, d, W, H, cw = 2, 9, 4, 12, 16, 2, 4
    jp, tp = _block_params(d, W, H, cw, seed=4)
    x = _u((B, S0 + EXTRA, d), 9)
    tx = torch.from_numpy(x)
    y, entry = tr.rglru_block(tp, tx[:, :S0], n_heads=H, collect=True)
    jy, jentry = jr.rglru_block(jp, jnp.asarray(x[:, :S0]), n_heads=H, collect=True)
    np.testing.assert_allclose(t2n(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(t2n(entry[k]), np.asarray(jentry[k]), rtol=1e-5, atol=1e-5)
    assert tr.rglru_block(tp, tx[:, :S0], n_heads=H)[1] is None
    cache = {"h": entry["h"].clone(), "conv": entry["conv"].clone()}
    jcache = jentry
    y_full, _ = tr.rglru_block(tp, tx, n_heads=H)
    for t in range(S0, S0 + EXTRA):
        y1, same = tr.rglru_block(tp, tx[:, t:t + 1], n_heads=H, cache=cache)
        assert same is cache
        jy1, jcache = jr.rglru_block(jp, jnp.asarray(x[:, t:t + 1]), n_heads=H, cache=jcache)
        np.testing.assert_allclose(t2n(y1), np.asarray(jy1), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(t2n(y1[:, 0]), t2n(y_full[:, t]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(cache["h"]), np.asarray(jcache["h"]), rtol=1e-4, atol=1e-4)

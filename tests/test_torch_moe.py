"""The port's ``models/moe.py`` against ``repro.models.moe`` on the CPU:
``router_topk`` (gates, indices, aux), ``moe_gshard``, ``moe_sort`` and
``moe_ffn`` on the cases of tests/test_moe.py and more (capacity drops,
T not a multiple of the group, a 3-D input, bf16), with the same numpy
inputs.  f32 within 2e-5; where capacity drops tokens, both packages must
drop the same (token, expert) choices, read off the rows each hands its
expert FFN.  A planted control (queue ranks counted over the whole T
instead of per group) must be rejected."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe

TOL = 2e-5


def _params(d, E, F, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.standard_normal((d, E)) * 0.1).astype(np.float32),
        "w1": (rng.standard_normal((E, d, F)) * 0.05).astype(np.float32),
        "w3": (rng.standard_normal((E, d, F)) * 0.05).astype(np.float32),
        "w2": (rng.standard_normal((E, F, d)) * 0.05).astype(np.float32),
    }


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _settings(E, K, **kw):
    return moe.MoESettings(E, K, **kw), jax_moe.MoESettings(E, K, **kw)


def _to_torch(p, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}


def _to_jax(p, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


def _routed(recorded, x):
    """{(token, expert)} of the rows one call handed its expert FFN (each
    slot row is some token's row of x exactly, or zeros)."""
    xe = np.asarray(recorded, np.float32)
    rows = {x[t].tobytes(): t for t in range(x.shape[0])}
    out = set()
    for e in range(xe.shape[0]):
        for row in xe[e]:
            if np.any(row):
                out.add((rows[row.tobytes()], e))
    return out


def _run_both(monkeypatch, p, x, E, K, dispatch, activation="swiglu", **kw):
    """(port y, JAX y, port aux, JAX aux, port routed, JAX routed)."""
    st, jst = _settings(E, K, dispatch=dispatch, **kw)
    seen = {}

    def recorder(name, orig):
        def ffn(params, xe, activation):
            seen[name] = np.asarray(xe.float() if isinstance(xe, torch.Tensor) else xe)
            return orig(params, xe, activation)
        return ffn

    monkeypatch.setattr(moe, "_expert_ffn", recorder("port", moe._expert_ffn))
    monkeypatch.setattr(jax_moe, "_expert_ffn", recorder("jax", jax_moe._expert_ffn))
    y, aux = moe.moe_ffn(_to_torch(p), torch.from_numpy(x), st, activation)
    jy, jaux = jax_moe.moe_ffn(_to_jax(p), jnp.asarray(x), jst, activation)
    flat = x.reshape(-1, x.shape[-1])
    return (y.numpy(), np.asarray(jy), float(aux), float(jaux),
            _routed(seen["port"], flat), _routed(seen["jax"], flat))


def test_gshard_equals_sort_when_dropfree(monkeypatch):
    """tests/test_moe.py's case: each dispatch against its JAX counterpart
    (2e-5) and against the other (2e-4, as JAX holds its pair)."""
    d, E, F, T = 32, 4, 64, 64
    p, x = _params(d, E, F), _x((T, d), 9)
    ys = {}
    for dispatch in ("gshard", "sort"):
        y, jy, aux, jaux, routed, jrouted = _run_both(
            monkeypatch, p, x, E, 2, dispatch, capacity_factor=float(E))
        np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(aux, jaux, rtol=1e-6)
        assert routed == jrouted and len(routed) == T * 2  # drop-free
        ys[dispatch] = y
    np.testing.assert_allclose(ys["gshard"], ys["sort"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("E,K", [(8, 2), (4, 1), (128, 8)])
def test_router_topk_matches_jax(E, K):
    """Gates, indices and aux.  Indices are compared exactly on tokens whose
    k-th and (k+1)-th probabilities differ by more than 1e-5 (summation
    order may flip a closer pair); the count under it is reported."""
    from repro.models.moe import router_topk as jax_router

    d, T = 16, 64
    x = _x((T, d), 1)
    w = _x((d, E), 2)
    gates, idx, aux = moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), K)
    jg, ji, jaux = jax_router(jnp.asarray(x), jnp.asarray(w), K)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
    top = torch.sort(probs, -1, descending=True).values
    clear = ((top[:, K - 1] - top[:, K]) > 1e-5).numpy() if K < E else np.ones(T, bool)
    print(f"E={E} K={K}: {int((~clear).sum())} of {T} tokens within 1e-5 at the k-th choice")
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(ji)[clear])
    np.testing.assert_allclose(gates.numpy()[clear], np.asarray(jg)[clear], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) >= 1.0 - 1e-5  # E * sum(me * ce) >= 1 by Cauchy-Schwarz
    assert idx.dtype == torch.int64 and int(idx.max()) < E


def test_router_ties_take_the_lower_expert_first():
    """``lax.top_k``'s order on exact ties: descending, lower index first."""
    x = torch.zeros((3, 4))
    w = torch.zeros((4, 6))  # every expert ties
    _, idx, _ = moe.router_topk(x, w, 3)
    assert idx.tolist() == [[0, 1, 2]] * 3
    from repro.models.moe import router_topk as jax_router

    _, ji, _ = jax_router(jnp.zeros((3, 4)), jnp.zeros((4, 6)), 3)
    assert np.asarray(ji).tolist() == idx.tolist()


@pytest.mark.parametrize("dispatch", ["gshard", "sort"])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_capacity_drops_match_jax(monkeypatch, dispatch, cf):
    """tests/test_moe.py's drop case (d 16, E 4, F 32, T 64), with a row
    shared by every token added so that the routing is skewed and both
    capacities drop: the same output and the same dropped (token, k)
    choices as JAX."""
    d, E, F, T = 16, 4, 32, 64
    p, x = _params(d, E, F), _x((T, d), 5)
    x = x + _x((1, d), 6) * 1.5
    y, jy, aux, jaux, routed, jrouted = _run_both(monkeypatch, p, x, E, 2, dispatch,
                                                  capacity_factor=cf)
    np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)
    assert routed == jrouted
    assert len(routed) < T * 2  # the case drops
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


@pytest.mark.parametrize("T,group", [(48, 32), (40, 16), (24, 1024)])
def test_gshard_groups_when_T_is_not_a_multiple(monkeypatch, T, group):
    """The ``g //= 2`` loop: group sizes that do not divide T halve until
    they do (48 -> g 16, G 3; 40 -> g 8, G 5), at capacity factor 1.25."""
    d, E, F = 16, 4, 32
    p, x = _params(d, E, F, seed=3), _x((T, d), 7)
    y, jy, _, _, routed, jrouted = _run_both(monkeypatch, p, x, E, 2, "gshard",
                                             group_size=group)
    np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)
    assert routed == jrouted
    g, G, cap = moe.gshard_groups(T, moe.MoESettings(E, 2, group_size=group))
    assert g * G == T and (G > 1) == (group < T)


@pytest.mark.parametrize("T,E,K,dispatch", list(itertools.product(
    [16, 32, 64], [2, 4, 8], [1, 2], ["gshard", "sort"]))[::3])
def test_moe_ffn_default_capacity_matches_jax(monkeypatch, T, E, K, dispatch):
    """tests/test_moe.py's finite-output grid (capacity factor 1.25), each
    case against JAX: outputs, aux and the routed choices."""
    d, F = 16, 32
    p, x = _params(d, E, F, seed=T + E), _x((T, d), T + E)
    y, jy, aux, jaux, routed, jrouted = _run_both(monkeypatch, p, x, E, K, dispatch)
    assert np.all(np.isfinite(y)) and np.isfinite(aux)
    np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)
    assert routed == jrouted


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_three_d_input_and_activations(monkeypatch, activation):
    """A (B, W, d) input is the row-major (B W, d) flatten, as the paged
    step's slab hands it; every expert activation."""
    d, E, F = 16, 4, 32
    p, x = _params(d, E, F, seed=11), _x((2, 24, d), 12)
    y, jy, _, _, routed, jrouted = _run_both(monkeypatch, p, x, E, 2, "gshard",
                                             activation=activation, group_size=16)
    assert y.shape == (2, 24, d)
    np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)
    assert routed == jrouted


@pytest.mark.parametrize("dispatch", ["gshard", "sort"])
def test_bf16_inputs_one_step(dispatch):
    """bf16 x and weights: outputs in bf16 within one bf16 step of JAX's
    (both round the expert FFN and the output to bf16) on the same routing."""
    d, E, F, T = 32, 4, 64, 64
    p, x = _params(d, E, F, seed=13), _x((T, d), 14)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    st, jst = _settings(E, 2, dispatch=dispatch, capacity_factor=float(E))
    y, _ = moe.moe_ffn(_to_torch(p, torch.bfloat16), xb, st, "swiglu")
    jy, _ = jax_moe.moe_ffn(_to_jax(p, jnp.bfloat16), jnp.asarray(xb.float().numpy(),
                                                                  jnp.bfloat16), jst, "swiglu")
    assert y.dtype == torch.bfloat16
    got, want = y.float().numpy(), np.asarray(jy, np.float32)
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=1e-3)


def test_planted_control_whole_T_ranks_is_rejected(monkeypatch):
    """Queue ranks counted over the whole T (not per group) drop later
    groups' choices that JAX keeps: the comparison must reject it."""
    d, E, F, T = 16, 4, 32, 64
    p, x = _params(d, E, F), _x((T, d), 5)
    st, jst = _settings(E, 2, group_size=16)
    jy, _ = jax_moe.moe_ffn(_to_jax(p), jnp.asarray(x), jst, "swiglu")
    y, _ = moe.moe_ffn(_to_torch(p), torch.from_numpy(x), st, "swiglu")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    orig = moe.queue_ranks

    def whole_t(idxg, n_experts):
        G, g, K = idxg.shape
        return orig(idxg.reshape(1, G * g, K), n_experts).reshape(G, g, K)

    monkeypatch.setattr(moe, "queue_ranks", whole_t)
    bad, _ = moe.moe_ffn(_to_torch(p), torch.from_numpy(x), st, "swiglu")
    assert not np.allclose(bad.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("slice_above", [None, 1000])
def test_init_params_moe_tree_matches_jax(monkeypatch, slice_above):
    """``init_params`` on reduced qwen3-moe-30b-a3b builds JAX's tree (keys,
    shapes) with the MoE leaves at JAX's scale; leaves drawn a leading-axis
    slice at a time (a small ``SLICE_ABOVE`` forces it) keep shape, dtype,
    scale and determinism."""
    import jax

    from repro_torch.models import params as P
    from torch_parity import model_pair

    if slice_above is not None:
        monkeypatch.setattr(P, "SLICE_ABOVE", slice_above)
    jcfg, jplan, jparams, tcfg, tplan, _ = model_pair("qwen3-moe-30b-a3b")
    mine = P.init_params(tcfg, tplan, torch.bfloat16, device="cpu")
    again = P.init_params(tcfg, tplan, torch.bfloat16, device="cpu")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        elif tree is not None:
            yield path, tree

    theirs = {p: tuple(np.shape(v)) for p, v in leaves(jax.tree.map(np.asarray, jparams))}
    got = dict(leaves(mine))
    assert {p: tuple(v.shape) for p, v in got.items()} == theirs
    ffn = mine["blocks"]["stack"][0]["ffn"]
    assert ffn["w1"].shape == (tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff)
    for name in ("router", "w1", "w3", "w2"):
        assert ffn[name].dtype == torch.bfloat16
        assert abs(float(ffn[name].float().std()) - 0.02) < 2e-3, name
    for p, v in leaves(again):
        assert torch.equal(v, got[p]), p

"""The WKV backward's plain version (``kernels/rwkv6/ref.wkv_backward_ref``)
and the port's ``WKV`` autograd Function (its CPU branch: ``wkv_chunked``
forward, ``wkv_backward_ref`` backward) against ``jax.grad`` of
``repro.models.rwkv6.wkv_chunked``, both packages on the same numpy
inputs: the JAX WKV test's shapes, chunks 16/32/64, strong decay, a ragged
S, a state passed in with a state returned, decays below the 1e-12 clamp;
every planted control rejected; and a rwkv6-reduced ``lm_loss`` gradient
through the Function.  Tolerance: the JAX WKV test's, 1e-5 of each
gradient's largest magnitude (1e-4 under strong decay)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv_backward_ref, wkv_backward_split_ref

TOL, STRONG_TOL = 1e-5, 1e-4
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")

# (B, S, H, D, chunk, decay range, state in and out, w below the clamp)
CASES = {
    "shape (2, 128, 2, 32)": (2, 128, 2, 32, 32, (0.45, 0.95), False, False),
    "shape (1, 96, 3, 64)": (1, 96, 3, 64, 32, (0.45, 0.95), False, False),
    "shape (1, 256, 1, 64)": (1, 256, 1, 64, 32, (0.45, 0.95), False, False),
    "chunk 16": (1, 128, 2, 32, 16, (0.45, 0.95), False, False),
    "chunk 32": (1, 128, 2, 32, 32, (0.45, 0.95), False, False),
    "chunk 64": (1, 128, 2, 32, 64, (0.45, 0.95), False, False),
    "strong decay": (1, 128, 2, 32, 32, (0.001, 0.01), False, False),
    "ragged S=100": (2, 100, 2, 64, 32, (0.45, 0.95), False, False),
    "state in and out": (2, 128, 2, 64, 32, (0.45, 0.95), True, False),
    "w below 1e-12": (2, 64, 2, 32, 16, (0.45, 0.95), True, True),
}


@functools.lru_cache(maxsize=None)
def case(name, bf16_inputs=False):
    """(numpy inputs r, k, v, w, u, dO, state or None, d(state) or None,
    chunk, tolerance, JAX's gradients dr, dk, dv, dw, du[, dstate]); with
    ``bf16_inputs`` r/k/v are rounded to bf16 values first (the training
    path's inputs, exact in TF32), for both packages."""
    B, S, H, D, chunk, (lo, hi), with_state, clamp = CASES[name]
    g = np.random.default_rng(list(CASES).index(name))
    r, k, v, do = (g.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    if bf16_inputs:
        r, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (r, k, v))
    w = (1 / (1 + np.exp(-g.standard_normal((B, S, H, D)))) * (hi - lo) + lo).astype(np.float32)
    if clamp:
        w[:, ::7, :, ::3] = 1e-14
    u = (g.standard_normal((H, D)) * 0.1).astype(np.float32)
    st = (g.standard_normal((B, H, D, D)) * 0.1).astype(np.float32) if with_state else None
    dst = g.standard_normal((B, H, D, D)).astype(np.float32) if with_state else None

    def loss(r_, k_, v_, w_, u_, st_):
        out, s_last = jax_wkv_chunked(r_, k_, v_, w_, u_, chunk=chunk, state=st_,
                                      return_state=True)
        tot = jnp.sum(out * do)
        return tot + jnp.sum(s_last * dst) if with_state else tot

    argnums = (0, 1, 2, 3, 4, 5) if with_state else (0, 1, 2, 3, 4)
    grads = jax.grad(loss, argnums=argnums)(r, k, v, w, u, st)
    tol = STRONG_TOL if lo < 0.1 else TOL
    return (r, k, v, w, u, do, st, dst, chunk, tol, [np.asarray(x) for x in grads])


def torch_inputs(name, bf16_inputs=False):
    r, k, v, w, u, do, st, dst, chunk, *_ = case(name, bf16_inputs)
    t = lambda x: None if x is None else torch.from_numpy(x.copy())  # noqa: E731
    return [t(x) for x in (r, k, v, w, u)], t(do), t(st), t(dst), chunk


def rel_errs(got, want):
    """{name: max |got - want| / max |want|} gradient by gradient."""
    return {n: float(np.abs(np.asarray(a, np.float64) - b).max() / (np.abs(b).max() + 1e-30))
            for n, a, b in zip(NAMES, got, want)}


def ref_grads(name, fn=wkv_backward_ref, bf16_inputs=False, **controls):
    """``fn``'s gradients (``wkv_backward_ref`` or ``wkv_backward_split_ref``)
    with d(w) from d(log w), as numpy."""
    (r, k, v, w, u), do, st, dst, chunk = torch_inputs(name, bf16_inputs)
    dr, dk, dv, dlogw, du, dstate = fn(r, k, v, w, u, do, chunk=chunk, state=st, dstate=dst,
                                       **controls)
    out = [dr, dk, dv, ops.dw_from_dlogw(dlogw, w), du] + ([dstate] if st is not None else [])
    return [x.numpy() for x in out]


@pytest.mark.parametrize("name", list(CASES))
def test_ref_matches_jax(name):
    """dr, dk, dv, dw, du (and d(state)) within the JAX WKV test's tolerance
    of ``jax.grad`` of ``wkv_chunked``; dw is 0 where w is below the clamp,
    as JAX's ``maximum`` makes it."""
    tol, want = case(name)[9], case(name)[10]
    got = ref_grads(name)
    errs = rel_errs(got, want)
    assert max(errs.values()) < tol, errs
    if CASES[name][7]:
        below = case(name)[3] < 1e-12
        assert below.any() and (got[3][below] == 0).all() and (want[3][below] == 0).all()


@pytest.mark.parametrize("name", list(CASES))
def test_split_scheme_matches_jax(name):
    """``wkv_backward_split_ref`` (the tensor-core entry's arithmetic: 16-token
    tiles, per-element 8-token halves, adjacent pairs out of the products,
    TF32 hi + lo operands) on r/k/v rounded to bf16 values, within the
    tolerance of ``jax.grad`` on the same inputs."""
    tol, want = case(name, True)[9], case(name, True)[10]
    got = ref_grads(name, wkv_backward_split_ref, bf16_inputs=True)
    errs = rel_errs(got, want)
    assert all(np.isfinite(x).all() for x in got) and max(errs.values()) < tol, errs


@pytest.mark.parametrize("control,name", [
    ({"split": False}, "shape (1, 96, 3, 64)"),
    ({"drop_diagonal": True}, "shape (1, 96, 3, 64)"),
    ({"keep_adjacent": True}, "strong decay"),
], ids=["split=False", "drop_diagonal", "keep_adjacent"])
def test_split_scheme_controls_are_rejected(control, name):
    """Operands rounded once to TF32, the diagonal halves' per-element sums
    left out, or the adjacent pairs kept in the products and in d(log w)'s
    a and b (under strong decay their suffixes then cancel to a small
    difference): outside the tolerance."""
    got = ref_grads(name, wkv_backward_split_ref, bf16_inputs=True, **control)
    errs = rel_errs(got, case(name, True)[10])
    assert max(errs.values()) >= case(name, True)[9], errs


@pytest.mark.parametrize("name", ["shape (2, 128, 2, 32)", "ragged S=100", "state in and out",
                                  "strong decay"])
def test_function_matches_jax(name):
    """``ops.wkv`` on CPU tensors that require grad records ``WKV`` (its
    CPU branch), and autograd through it gives JAX's gradients."""
    (r, k, v, w, u), do, st, dst, chunk = torch_inputs(name)
    leaves = [x.requires_grad_() for x in (r, k, v, w, u)] + ([st.requires_grad_()]
                                                                if st is not None else [])
    out, s_last = ops.wkv(r, k, v, w, u, chunk=chunk, state=st, return_state=True)
    assert type(out.grad_fn).__name__ == "WKVBackward"
    loss = (out * do).sum() + ((s_last * dst).sum() if dst is not None else 0.0)
    got = [x.numpy() for x in torch.autograd.grad(loss, leaves)]
    errs = rel_errs(got, case(name)[10])
    assert max(errs.values()) < case(name)[9], errs


def test_function_without_grad_is_the_plain_forward():
    """Without autograd the wrapper returns the plain forward, no graph."""
    (r, k, v, w, u), *_ = torch_inputs("chunk 16")
    out = ops.wkv(r, k, v, w, u, chunk=16)
    assert out.grad_fn is None and out.shape == r.shape


def assert_rejected(got, name):
    errs = rel_errs(got, case(name)[10])
    assert max(errs.values()) >= case(name)[9], errs


def test_control_state_not_carried_is_rejected():
    assert_rejected(ref_grads("state in and out", carry=False), "state in and out")


def test_control_state_out_term_dropped_is_rejected():
    got = ref_grads("state in and out", state_out_term=False)
    errs = rel_errs(got, case("state in and out")[10])
    assert errs["dw"] >= TOL and max(v for n, v in errs.items() if n != "dw") < TOL, errs


def test_control_clamp_dropped_is_rejected():
    (r, k, v, w, u), do, st, dst, chunk = torch_inputs("w below 1e-12")
    dlogw = wkv_backward_ref(r, k, v, w, u, do, chunk=chunk, state=st, dstate=dst)[3]
    got = ref_grads("w below 1e-12")
    got[3] = ops.dw_from_dlogw(dlogw, w, clamp=False).numpy()
    assert_rejected(got, "w below 1e-12")


def test_control_du_over_one_row_is_rejected():
    assert_rejected(ref_grads("ragged S=100", du_rows=1), "ragged S=100")


def test_dw_from_dlogw():
    w = torch.tensor([0.5, 1e-12, 1e-14, 0.0, 0.9])
    dlogw = torch.tensor([1.0, 2.0, 3.0, 4.0, 0.9])
    assert ops.dw_from_dlogw(dlogw, w).tolist() == pytest.approx([2.0, 0.0, 0.0, 0.0, 1.0])


def test_rwkv_lm_loss_grads_through_the_function():
    """rwkv6-reduced ``lm_loss``: every WKV call is a ``WKV`` node of the
    graph, and the loss and every gradient leaf match
    ``test_torch_lm_loss``'s JAX gradients."""
    from repro.core.plan import derive_plan
    from repro.models.transformer import lm_loss as jax_lm_loss
    from repro_torch.core.plan import derive_execution_plan
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.train_step import value_and_grad
    from test_torch_train import B, GRAD_TOL, LOSS_RTOL, S, assert_trees_close, both, numpy_batch
    from torch_parity import MESH1, model_pair

    jcfg, _, jparams, tcfg, _, tparams = model_pair("rwkv6-1.6b")
    jplan = derive_plan(jcfg, MESH1, batch=B, seq_len=S)
    tplan = derive_execution_plan(tcfg, training=True, batch=B, seq_len=S)
    jb, tb = both(numpy_batch(jcfg))
    jloss, jgrads = jax.value_and_grad(lambda p: jax_lm_loss(p, jb, cfg=jcfg, plan=jplan))(jparams)
    calls = []
    apply = ops.WKV.apply

    def counted(*a):
        calls.append(1)
        return apply(*a)

    ops.WKV.apply = counted
    try:
        tloss, tgrads = value_and_grad(lambda p, b: lm_loss(p, b, cfg=tcfg, plan=tplan),
                                       tparams, tb)
    finally:
        ops.WKV.apply = apply
    assert len(calls) == tcfg.n_layers
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert_trees_close(tgrads, jgrads, GRAD_TOL, GRAD_TOL, "rwkv6 grad")

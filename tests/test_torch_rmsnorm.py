"""RMSNorm in the port against the JAX package, on the same numpy inputs:
the port's wrapper (``ops.rmsnorm``, which runs the plain version for CPU
tensors) and ``ref.rmsnorm_ref`` against the JAX Pallas kernel (interpret
mode, as the JAX kernel test runs it) and the JAX oracle, over the JAX
test's shapes and dtypes and the fused residual, at its tolerances (f32
1e-5, bf16 2e-2); the row layout the CUDA kernel is given for strided qk
views; the kernel's launch plan (whole groups of lanes that cover every
row once, no idle lane at d_head 128 bf16) and the wrapper's arguments to
it (a stand-in library records them); the routed forward against the JAX
``forward``; and ``fused=False`` through both serving entry points
launching no kernel (a counting stub stands in for each kernel's launch on
the CPU).  The backward: the plain version (``ref.rmsnorm_backward_ref``)
against ``jax.grad`` of ``repro.models.layers.rmsnorm`` on strided q/k
views of a fused projection and with a residual (f32: 1e-5 relative to
each gradient's scale), the planted ``1 + scale`` -> ``scale`` fault
failing it, the ``RMSNorm`` autograd Function with the plain versions
standing in for its kernels, the backward launcher's arguments, its
launch plan (whole groups, each column one lane's, every row once) and
d(scale) summed in the kernel's fixed order against ``jax.grad``."""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.models.transformer import forward as jax_forward
from repro_torch.core.plan import derive_serve_plan
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mm_pu import ops as mm_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_backward_ref, rmsnorm_backward_split_ref,
                                             rmsnorm_ref)
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models import layers
from repro_torch.models import transformer
from repro_torch.models.transformer import forward
from repro_torch.serve import Request, ServingEngine, greedy_generate
from torch_parity import MESH1, model_pair, t2n

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    return x, s


@pytest.mark.parametrize("shape", [(64, 128), (2, 100, 64), (7, 33)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matches_jax(shape, dtype):
    x, s = _inputs(shape)
    jx = jnp.asarray(x, dtype)
    want = {"pallas": np.asarray(jax_rmsnorm(jx, jnp.asarray(s)), np.float32),
            "jax ref": np.asarray(jax_rmsnorm_ref(jx, jnp.asarray(s)), np.float32)}
    tx, ts = torch.from_numpy(x).to(_TORCH[dtype]), torch.from_numpy(s)
    got = {"ops.rmsnorm": ops.rmsnorm(tx, ts), "rmsnorm_ref": rmsnorm_ref(tx, ts)}
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    for name, g in got.items():
        assert g.dtype == tx.dtype and g.shape == tx.shape, name
        for ref, w in want.items():
            np.testing.assert_allclose(t2n(g), w, rtol=tol, atol=tol, err_msg=f"{name} vs {ref}")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_residual(dtype):
    x, s = _inputs((32, 64), seed=1)
    r = np.random.default_rng(2).standard_normal((32, 64)).astype(np.float32)
    jx, jr = jnp.asarray(x, dtype), jnp.asarray(r, dtype)
    want = np.asarray(jax_rmsnorm(jx, jnp.asarray(s), residual=jr), np.float32)
    tx, tr = (torch.from_numpy(a).to(_TORCH[dtype]) for a in (x, r))
    got = ops.rmsnorm(tx, torch.from_numpy(s), residual=tr)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(t2n(got), want, rtol=tol, atol=tol)
    # the residual form is the norm of the f32 sum
    np.testing.assert_allclose(
        t2n(got), t2n(layers.rmsnorm(tx.float() + tr.float(), torch.from_numpy(s)).to(tx.dtype)),
        rtol=tol, atol=tol)


def _qkv_views(B=2, S=5, H=4, KV=2, D=32, seed=3):
    """q and k as the model hands them to qk-norm: views of one fused QKV
    projection, tokens (H + 2 KV) D elements apart."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, S, (H + 2 * KV) * D)).astype(np.float32))
    q, k, _ = torch.split(qkv, [H * D, KV * D, KV * D], dim=-1)
    return q.reshape(B, S, H, D), k.reshape(B, S, KV, D)


def test_strided_qk_view_equals_contiguous():
    q, k = _qkv_views()
    s = torch.from_numpy(_inputs((32,), seed=4)[1])
    for view in (q, k):
        assert not view.is_contiguous()
        got = ops.rmsnorm(view, s)
        assert got.is_contiguous()
        np.testing.assert_array_equal(t2n(got), t2n(ops.rmsnorm(view.contiguous(), s)))
        np.testing.assert_allclose(t2n(got), np.asarray(jax_rmsnorm(jnp.asarray(t2n(view)),
                                                                    jnp.asarray(t2n(s)))),
                                   rtol=1e-5, atol=1e-5)


def _rows_of(x, layout):
    """The rows the CUDA kernel reads for ``layout``, gathered on the CPU
    from x's storage as the kernel indexes it."""
    outer, inner, so, si = layout
    d = x.shape[-1]
    flat = torch.as_strided(x, (x.untyped_storage().nbytes() // x.element_size(),), (1,), 0)
    base = x.storage_offset()
    rows = [flat[base + o * so + i * si: base + o * so + i * si + d]
            for o in range(outer) for i in range(inner)]
    return torch.stack(rows)


@pytest.mark.parametrize("case", ["2d", "3d", "q view", "k view", "one row", "transposed"])
def test_row_layout(case):
    """``row_layout`` folds x's leading dimensions into the (outer, inner)
    rows the kernel indexes, in order; a layout that does not fold gives
    None (the wrapper copies it first)."""
    q, k = _qkv_views()
    x = {
        "2d": torch.arange(7 * 33.0).reshape(7, 33),
        "3d": torch.arange(2 * 10 * 8.0).reshape(2, 10, 8),
        "q view": q,
        "k view": k,
        "one row": torch.arange(16.0).reshape(1, 1, 16),
        "transposed": torch.arange(24.0).reshape(4, 6).T,
    }[case]
    layout = ops.row_layout(x)
    if case == "transposed":
        assert layout is None
        return
    assert layout[0] * layout[1] == x.numel() // x.shape[-1]
    np.testing.assert_array_equal(_rows_of(x, layout).numpy(),
                                  x.reshape(-1, x.shape[-1]).numpy())
    if case == "q view":  # the token stride, heads D apart
        assert layout == (2 * 5, 4, (4 + 2 * 2) * 32, 32)


def _rows_visited(rows, plan):
    """Each row's visits under ``plan`` as the CUDA kernel's grid-stride
    loop makes them: warp w of CTA c, group g, row k of an iteration, pass
    p takes row ((c * WARPS + w) * groups + p * grid * WARPS * groups) * R
    + g + groups * k."""
    group, nv, r, grid = plan
    gpw = 32 // group
    warps = np.arange(grid * ops.WARPS)
    stride = grid * ops.WARPS * gpw * r
    counts = np.zeros(rows, np.int64)
    for p in range(-(-rows // stride)):
        for g in range(gpw):
            for k in range(r):
                row = warps * gpw * r + p * stride + g + gpw * k
                np.add.at(counts, row[row < rows], 1)
    return counts


@pytest.mark.parametrize("d", [32, 64, 128, 576, 2048, 4096, 12288])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_covers_every_row_once(d, dtype):
    """At every model width (d_head 128 for qk-norm) and odd row counts,
    the plan's groups are whole (8, 16 or 32 lanes), a sub-warp group holds
    its row in one vector a lane, a full warp's registers hold the row up
    to 16 vectors a lane, the grid is one wave of resident CTAs at most for
    sub-warp rows and one pass for full-warp rows, and the grid-stride loop
    visits each row exactly once."""
    es = torch.finfo(dtype).bits // 8
    nvec = d * es // 16
    for rows in (1, 37, 4097):
        group, nv, r, grid = plan = ops.launch_plan(rows, d, es, True)
        assert group in (8, 16, 32) and grid >= 1 and r >= 1
        if group < 32:
            assert nvec <= group and nv == 1
        else:
            assert nvec > 16 and (group * nv >= nvec or nv == ops.MAX_NV)
        per_cta = ops.WARPS * (32 // group) * r
        if group < 32:
            assert grid == min(-(-rows // per_cta), ops.N_SMS * ops.resident_ctas(nv, r))
        else:
            assert grid == -(-rows // per_cta)
        assert (_rows_visited(rows, plan) == 1).all()


def test_no_idle_lane_at_d_head_128_bf16():
    """qk-norm's rows (d_head 128 bf16: 16 vectors of 16 bytes) take 16
    lanes each, two rows a warp, one vector a lane; the slab's q view
    (65,536 x 16 rows) fills one wave of resident CTAs."""
    group, nv, r, grid = ops.launch_plan(65536 * 16, 128, 2, True)
    assert (group, nv) == (16, 1) and 128 * 2 // 16 == group
    assert grid == ops.N_SMS * ops.resident_ctas(nv, r)


class _Library:
    """Stands in for the kernel library: records ``rmsnorm_forward``'s
    arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.args, self.rc = [], rc

    def rmsnorm_forward(self, *args):
        self.args.append(args)
        return self.rc


@pytest.mark.parametrize("case", ["bf16 slab rows", "f32 d=33", "q view", "residual"])
def test_launch_passes_the_plan(case):
    """The wrapper hands the kernel its row layout and ``launch_plan``'s
    schedule: 16-byte rows take the vector kernel, rows that are not
    (d = 33 f32) the one-warp-a-row kernel with a grid covering them; a
    failed launch raises."""
    q, _ = _qkv_views(H=16, KV=8, D=128)
    x, res = {
        "bf16 slab rows": (torch.zeros((64, 2048), dtype=torch.bfloat16), None),
        "f32 d=33": (torch.zeros((7, 33)), None),
        "q view": (q, None),
        "residual": (torch.zeros((5, 256)), torch.ones((5, 256))),
    }[case]
    d = x.shape[-1]
    lib = _Library()
    out = ops.launch(lib, x, torch.zeros(d), res, eps=1e-6, stream=None)
    assert out.shape == x.shape and out.dtype == x.dtype and out.is_contiguous()
    (args,) = lib.args
    outer, inner, dd, so, si, _, vec, _, group, nv, r, grid = args[4:16]
    rows = outer * inner
    assert dd == d and (outer, inner, so, si) == ops.row_layout(x)
    assert bool(vec) == (case != "f32 d=33")
    assert (group, nv, r, grid) == ops.launch_plan(rows, d, x.element_size(), bool(vec))
    if not vec:
        assert grid * ops.WARPS >= rows
    with pytest.raises(RuntimeError, match="code 1"):
        ops.launch(_Library(rc=1), x, torch.zeros(d), res, eps=1e-6, stream=None)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-135m"])
def test_routed_forward_matches_jax(arch, fused):
    """The port's forward, with its norms routed through the wrapper (or
    the plain norm), equals the JAX forward (jnp norms) on the same
    weights: f32, the no-cache pass."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch)
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jx, _, _ = jax_forward(jparams, {"tokens": jnp.asarray(tokens)}, cfg=jcfg, plan=jplan)
    tx, _ = forward(tparams, {"tokens": torch.from_numpy(tokens)}, cfg=tcfg, plan=tplan,
                    fused=fused)
    np.testing.assert_allclose(t2n(tx), np.asarray(jx), rtol=1e-4, atol=1e-4)


# Each kernel's wrapper, as the model paths reach it: (module holding the
# LAUNCHES count, the module attribute the path calls through, its name).
_WRAPPERS = [
    (ops, ops, "rmsnorm"),
    (flash_ops, flash_ops, "flash_attention"),
    (wkv_ops, wkv_ops, "wkv"),
    (paged_ops, transformer, "paged_attention"),
    (mm_ops, mm_ops, "mm_pu"),
]


@pytest.fixture
def counting(monkeypatch):
    """Every kernel wrapper counts a launch on the CPU too (as it does on
    the card), then runs the plain version; yields the counts."""
    for counter, owner, name in _WRAPPERS:
        monkeypatch.setattr(counter, "LAUNCHES", 0)
        fn = getattr(owner, name)

        def stub(*a, _fn=fn, _counter=counter, **kw):
            _counter.LAUNCHES += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(owner, name, stub)
    return lambda: {name: counter.LAUNCHES for counter, _, name in _WRAPPERS}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("entry", ["greedy_generate", "ServingEngine"])
def test_fused_false_launches_no_kernel(counting, entry, fused):
    """``fused=False`` runs every kernel's plain version on both entry
    points; ``fused=True`` reaches the RMSNorm wrapper once per norm per
    forward (4 a layer with qk-norm, plus the final norm)."""
    _, _, _, tcfg, tplan, tparams = model_pair("qwen3-1.7b")
    per_forward = 4 * tcfg.n_layers + 1
    prompt = [3, 1, 4, 1, 5, 9]
    if entry == "greedy_generate":
        greedy_generate(tparams, tcfg, tplan, {"tokens": torch.tensor([prompt])}, n_steps=4,
                        cache_len=10, cache_dtype=torch.float32, device="cpu", fused=fused)
        forwards = 4  # the prefill + 3 decode steps
        expect = {"rmsnorm": per_forward * forwards, "flash_attention": tcfg.n_layers}
    else:
        serve = derive_serve_plan(tcfg, MESH1, max_seq_len=32, decode_batch=2, block_size=4,
                                  kv_dtype="fp32", prefill_chunk=4, rolled_steps=1)
        engine = ServingEngine(tparams, tcfg, tplan, serve, fused=fused, device="cpu")
        engine.run([Request(rid="r0", prompt=prompt, max_new_tokens=3)])
        forwards = engine.summary()["steps"]
        expect = {"rmsnorm": per_forward * forwards, "paged_attention": tcfg.n_layers * forwards}
    counts = counting()
    if fused:
        assert counts == {name: expect.get(name, 0) for name in counts}
    else:
        assert counts == {name: 0 for name in counts}


# ---------------------------------------------------------------- backward
def _jax_grads(qkv, scale, w, H, KH, D, part, residual=None):
    """jax.grad of sum(rmsnorm(view [+ residual]) * w) over the fused
    projection ``qkv`` (B, S, (H + 2 KH) D) and the scale, ``view`` its q
    (``part`` 0) or k (1) heads."""
    from repro.models.layers import rmsnorm as jax_layers_rmsnorm

    B, S, _ = qkv.shape

    def f(t, sc, r):
        q, k, _ = jnp.split(t, [H * D, (H + KH) * D], axis=-1)
        x = (q.reshape(B, S, H, D), k.reshape(B, S, KH, D))[part]
        if r is not None:
            x = x + r
        return jnp.sum(jax_layers_rmsnorm(x, sc) * w)

    r = None if residual is None else jnp.asarray(residual)
    return jax.grad(f, argnums=(0, 1, 2) if r is not None else (0, 1))(
        jnp.asarray(qkv), jnp.asarray(scale), r)


def _views(t, H, KH, D):
    B, S, _ = t.shape
    q, k, _ = torch.split(t, [H * D, KH * D, KH * D], dim=-1)
    return q.reshape(B, S, H, D), k.reshape(B, S, KH, D)


def _close_scaled(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(t2n(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("part", [0, 1])
def test_plain_backward_matches_jax_grad(part, residual):
    """dx (the view's gradient) and d(scale), f32, on qwen3-1.7b-like
    strided q and k views (H 4, KH 2, D 32; G 2), with and without a
    residual (whose gradient is dx)."""
    B, S, H, KH, D = 2, 6, 4, 2, 32
    rng = np.random.default_rng(10 + part)
    qkv = rng.standard_normal((B, S, (H + 2 * KH) * D)).astype(np.float32)
    n = (H, KH)[part]
    scale = (0.1 * rng.standard_normal(D)).astype(np.float32)
    w = rng.standard_normal((B, S, n, D)).astype(np.float32)
    r = rng.standard_normal((B, S, n, D)).astype(np.float32) if residual else None
    jg = _jax_grads(qkv, scale, w, H, KH, D, part, r)
    x = _views(torch.from_numpy(qkv), H, KH, D)[part]
    assert not x.is_contiguous()
    dx, dscale = rmsnorm_backward_ref(x, torch.from_numpy(scale), torch.from_numpy(w),
                                      None if r is None else torch.from_numpy(r))
    jdx = np.asarray(jg[0])[..., [0, H * D][part]:][..., :n * D].reshape(B, S, n, D)
    _close_scaled(dx, jdx)
    _close_scaled(dscale, jg[1])
    if residual:
        _close_scaled(dx, jg[2])
    bad, _ = rmsnorm_backward_ref(x, torch.from_numpy(scale), torch.from_numpy(w),
                                  None if r is None else torch.from_numpy(r), one_plus=False)
    diff = np.abs(t2n(bad) - jdx)
    assert (diff > 1e-5 * max(1.0, float(np.abs(jdx).max()))).mean() > 0.5


@pytest.fixture
def plain_norm_kernels(monkeypatch):
    """The Function's launches with the plain versions standing in."""
    calls = Counter()

    def fwd(x, scale, residual, eps):
        calls["forward"] += 1
        return rmsnorm_ref(x, scale, residual, eps)

    def bwd(x, scale, dy, residual=None, *, eps):
        calls["backward"] += 1
        return rmsnorm_backward_ref(x, scale, dy, residual, eps)

    monkeypatch.setattr(ops, "_forward", fwd)
    monkeypatch.setattr(ops, "backward", bwd)
    return calls


@pytest.mark.parametrize("residual", [False, True])
def test_function_on_strided_view(plain_norm_kernels, residual):
    """``RMSNorm`` on the k view of a fused projection: the gradients of
    the projection, the scale and the residual equal autograd's through
    the plain norm; one forward and one backward launch."""
    B, S, H, KH, D = 2, 5, 4, 2, 32
    g = torch.Generator().manual_seed(4)
    qkv0 = torch.randn((B, S, (H + 2 * KH) * D), generator=g)
    s0 = 0.1 * torch.randn(D, generator=g)
    r0 = torch.randn((B, S, KH, D), generator=g) if residual else None
    w = torch.randn((B, S, KH, D), generator=g)
    grads = []
    for use_fn in (True, False):
        t = qkv0.clone().requires_grad_()
        sc = s0.clone().requires_grad_()
        r = None if r0 is None else r0.clone().requires_grad_()
        k = _views(t, H, KH, D)[1]
        y = ops.RMSNorm.apply(k, sc, r, 1e-6) if use_fn else rmsnorm_ref(k, sc, r)
        (y * w).sum().backward()
        grads.append([t.grad, sc.grad] + ([] if r is None else [r.grad]))
    assert plain_norm_kernels == Counter({"forward": 1, "backward": 1})
    for a, b in zip(*grads):
        np.testing.assert_allclose(t2n(a), t2n(b), rtol=1e-5, atol=1e-6)


class _BackwardLibrary:
    """Stands in for the backward library: records ``rmsnorm_backward``'s
    arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.args, self.rc = None, rc

    def rmsnorm_backward(self, *args):
        self.args = args
        return self.rc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_backward_passes_the_layout(dtype):
    """The strided k view goes in place (its (outer, inner) strides), dy is
    made dense, dx comes back dense in x's dtype, d(scale) f32; a failed
    launch raises."""
    B, S, H, KH, D = 2, 5, 4, 2, 64
    t = torch.zeros((B, S, (H + 2 * KH) * D), dtype=dtype)
    k = _views(t, H, KH, D)[1]
    scale = torch.zeros(D)
    dy = torch.zeros((B, S, KH, D), dtype=dtype).transpose(0, 1).contiguous().transpose(0, 1)
    lib = _BackwardLibrary()
    dx, dscale = ops.launch_backward(lib, k, scale, dy, eps=1e-6, stream=None)
    assert dx.shape == k.shape and dx.dtype == dtype and dx.is_contiguous()
    assert dscale.shape == (D,) and dscale.dtype == torch.float32
    args = lib.args
    assert args[0] == k.data_ptr()
    assert args[7:12] == (B * S, KH, D, (H + 2 * KH) * D, D)
    assert args[14] == (0 if dtype == torch.float32 else 1)
    assert args[15:19] == ops.backward_launch_plan(B * S * KH, D, k.element_size(), True)
    with pytest.raises(RuntimeError, match="backward kernel launch failed"):
        ops.launch_backward(_BackwardLibrary(rc=1), k, scale, dy, eps=1e-6, stream=None)


@pytest.mark.parametrize("d,dtype,vec", [(12288, torch.float32, False), (4096, torch.float32, True),
                                         (33, torch.float32, False)])
def test_launch_backward_routes_wide_and_unaligned_rows(d, dtype, vec):
    """Rows wider than the CTA's registers hold (f32 d 12288: 3072 vectors)
    and unaligned rows (d 33 f32) reach the kernel as the scalar route (vec
    0, nv 0, a CTA a row); f32 d 4096 takes the CTA's vector route."""
    x = torch.zeros((5, d), dtype=dtype)
    lib = _BackwardLibrary()
    ops.launch_backward(lib, x, torch.zeros(d), torch.zeros_like(x), eps=1e-6, stream=None)
    plan = ops.backward_launch_plan(5, d, 4, d * 4 % 16 == 0)
    assert lib.args[15:19] == plan and bool(lib.args[13]) == vec == (plan[1] > 0)
    assert plan[0] == ops.CTA_ROW


def _backward_row_order(rows, plan):
    """The rows each group of each CTA of the backward kernel takes under
    ``plan``, in order (``order[cta][group]``), as csrc/rmsnorm_bwd.cu's
    loops take them: warp w of CTA c starts at row (c x WARPS + w) x groups
    a warp x R (a CTA row at c x R), group g takes that + g + groups a warp
    x k for k < R, and every pass adds the grid's rows."""
    group, _, r, grid = plan
    gpw = 1 if group == ops.CTA_ROW else 32 // group
    gpc = 1 if group == ops.CTA_ROW else ops.WARPS * gpw
    stride = grid * gpc * r
    order = []
    for c in range(grid):
        groups = []
        for me in range(gpc):
            w, g = divmod(me, gpw)
            base = c * r if group == ops.CTA_ROW else (c * ops.WARPS + w) * gpw * r
            seq = (b + g + gpw * k for b in range(base, rows, stride) for k in range(r))
            groups.append([row for row in seq if row < rows])
        order.append(groups)
    return order


@pytest.mark.parametrize("d", [32, 64, 128, 576, 2048, 4096, 12288])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_launch_plan_covers_every_row_once(d, dtype):
    """At every model width (d_head 32-128 for qk-norm) and odd row counts,
    the backward's plan takes whole groups (8, 16, 32 lanes or the CTA),
    the fewest lanes whose registers hold the row (one vector a lane below
    32 lanes, at most ``BWD_MAX_NV``), so every column is one lane's, once;
    the grid is one wave of resident CTAs at most; the kernel's loops visit
    every row exactly once; rows wider than the CTA's registers (f32 d
    12288) take the CTA-a-row scalar route."""
    es = torch.finfo(dtype).bits // 8
    nvec = d * es // 16
    for rows in (1, 37, 4097):
        group, nv, r, grid = plan = ops.backward_launch_plan(rows, d, es, True)
        assert group in (8, 16, 32, ops.CTA_ROW) and grid >= 1 and r >= 1
        per_cta = ops.CTA_ROW // group * r
        assert grid == min(-(-rows // per_cta), ops.N_SMS * ops.backward_resident_ctas(nv, r))
        if nv == 0:  # the scalar route
            assert nvec > ops.CTA_ROW * ops.BWD_MAX_NV and (group, r) == (ops.CTA_ROW, 1)
        else:
            assert 1 <= nv <= (1 if group < 32 else ops.BWD_MAX_NV) and group * nv >= nvec
            assert group == 8 or nvec > {16: 8, 32: 16, ops.CTA_ROW: 32 * ops.BWD_MAX_NV}[group]
            vec = 16 // es  # columns of a vector; lane l holds vectors l + group x t
            cols = np.concatenate([np.arange(j * vec, (j + 1) * vec) for lane in range(group)
                                   for j in range(lane, nvec, group)[:nv]])
            np.testing.assert_array_equal(np.sort(cols), np.arange(d))
        order = _backward_row_order(rows, plan)
        assert len(order) == grid
        assert sorted(row for groups in order for g in groups for row in g) == list(range(rows))


def test_backward_plan_at_the_training_shapes():
    """qwen3-1.7b's training rows: the norm rows (16,384 x 2048 bf16) take a
    warp a row, 8 vectors a lane (64 columns), one CTA an SM; the q view
    (262,144 x 128 bf16) 16 lanes a row, one vector a lane (8 columns), 4
    rows a group, two CTAs an SM."""
    assert ops.backward_launch_plan(16384, 2048, 2, True) == (32, 8, 1, ops.N_SMS)
    assert ops.backward_launch_plan(8 * 2048 * 16, 128, 2, True) == (16, 1, 4, 2 * ops.N_SMS)


# (B, S, H, KH, D, part): the view's rows take groups of 8 and 16 lanes, a
# warp (8 vectors a lane), the CTA (2 vectors a lane) and the scalar route
SPLIT_SUM_CASES = {
    "d 32 q view, 8 lanes": (2, 6, 4, 2, 32, 0),
    "d 64 k view, 16 lanes": (2, 5, 4, 2, 64, 1),
    "d 576, a warp": (1, 40, 1, 1, 576, 0),
    "d 2048, the CTA": (1, 9, 1, 1, 2048, 0),
    "d 33, scalar": (2, 7, 1, 1, 33, 0),
}


@pytest.mark.parametrize("case", list(SPLIT_SUM_CASES))
def test_backward_split_sum_matches_jax_grad(case):
    """d(scale) summed in the backward kernel's fixed order (each lane's
    columns over its rows, a CTA's groups in order, the partial rows by 8
    lanes then in order; ``ref.rmsnorm_backward_split_ref``), f32, against
    ``jax.grad`` of the JAX norm on the view, at the f32 tolerance (1e-5
    of the gradient's scale), under the plan and under a 3-CTA grid that
    makes the groups stride; dx too."""
    B, S, H, KH, D, part = SPLIT_SUM_CASES[case]
    rng = np.random.default_rng(20)
    qkv = rng.standard_normal((B, S, (H + 2 * KH) * D)).astype(np.float32)
    n = (H, KH)[part]
    scale = (0.1 * rng.standard_normal(D)).astype(np.float32)
    w = rng.standard_normal((B, S, n, D)).astype(np.float32)
    jg = _jax_grads(qkv, scale, w, H, KH, D, part)
    x = _views(torch.from_numpy(qkv), H, KH, D)[part]
    rows = B * S * n
    vec = D * 4 % 16 == 0
    plan = ops.backward_launch_plan(rows, D, 4, vec)
    assert (plan[1] == 0) == (case == "d 33, scalar")
    jdx = np.asarray(jg[0])[..., [0, H * D][part]:][..., :n * D].reshape(B, S, n, D)
    for p in (plan, plan[:3] + (3,)):
        dx, dscale = rmsnorm_backward_split_ref(
            x, torch.from_numpy(scale), torch.from_numpy(w),
            order=_backward_row_order(rows, p))
        _close_scaled(dx, jdx)
        _close_scaled(dscale, jg[1])

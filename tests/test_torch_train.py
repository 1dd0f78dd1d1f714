"""Training, both packages on the same bridged f32 weights and the same
numpy batches (the per-arch ``lm_loss`` and gradient parity is in
``test_torch_lm_loss.py``): remat changes no gradient,
``chunked_softmax_xent`` against JAX's, the compression against JAX's, and
three steps of ``make_train_step`` against JAX's (loss, grad norm, lr,
parameters, m and v) with microbatches 1 and 2, remat on and off, and int8
and bf16 compression with error feedback.  On the CPU the port's kernel
wrappers run their plain versions, which autograd differentiates.

Tolerances: the loss within rtol 1e-5; gradients within 2e-4 (rtol and
atol: the JAX flash-backward test's); after three AdamW steps at peak_lr
1e-3 the parameters within 1e-4, m within 2e-4 x its scale, and v within
1e-3 relative to its scale (v holds squared gradients).  int8 compression
rounds g / scale to the nearest integer, a step function: a gradient that
the two packages' f32 sums (equal to ~1e-7) put on either side of a
rounding boundary moves one quantum, and Adam turns a 0-vs-1 quantum into
up to lr a step.  So with int8 at most ``PARAM_FLIP_SHARE`` of the
parameters (1 element of 106,944 reads so) may miss their tolerance, each
within 2 lr per step, and at most ``RESIDUAL_FLIP_SHARE`` of the residual
(10 read so), each within ``RESIDUAL_FLIP_BOUND`` (one quantum: 7.0e-4
read); m and v stay within their tolerances everywhere (one quantum moves
m by (1 - b1) of it).  ``test_compress_grads_matches_jax`` holds the
compression itself exactly, on the same gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import derive_plan
from repro.models.transformer import chunked_softmax_xent as jax_xent
from repro.train.compression import CompressionConfig as JaxCompression
from repro.train.optimizer import OptimizerConfig as JaxOpt
from repro.train.optimizer import init_state as jax_init_state
from repro.train.train_step import make_train_step as jax_make_step
from repro_torch.core.plan import derive_execution_plan
from repro_torch.models.transformer import chunked_softmax_xent, lm_loss
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.optimizer import OptimizerConfig, init_state
from repro_torch.train.train_step import make_train_step, value_and_grad
from torch_parity import MESH1, model_pair, t2n

B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
PARAM_FLIP_SHARE = 5e-5
RESIDUAL_FLIP_SHARE = 3e-4
RESIDUAL_FLIP_BOUND = 2e-3


def leaves_with_paths(tree, path=""):
    """(path, leaf) for every array leaf, dict keys sorted (both packages'
    trees have the same shape)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def numpy_batch(cfg, seed=0, batch=B, seq=S):
    """The batch both packages see: tokens/targets, prefix embeddings (a
    frontend), encoder frames (enc-dec), labels (a classifier)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vocab_size > 1:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        out["targets"] = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    if cfg.frontend != "none" and cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["enc_embeds"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.n_classes:
        out["label"] = rng.integers(0, cfg.n_classes, (batch,)).astype(np.int32)
    return out


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def assert_trees_close(got, want, rtol, atol, what, scale_atol=False, flips=0.0,
                       flip_bound=None):
    """Every leaf within ``atol + rtol |want|`` (``atol`` times the leaf's
    largest magnitude, at least 1, with ``scale_atol``); with ``flips``, at
    most that share of the tree's elements outside, each within
    ``flip_bound``."""
    got = dict(leaves_with_paths(got))
    want = dict(leaves_with_paths(want))
    assert got.keys() == want.keys(), (what, set(got) ^ set(want))
    n_out = n_all = 0
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        g = t2n(got[path])
        a = atol * max(1.0, float(np.abs(w).max())) if scale_atol else atol
        if not flips:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=a, err_msg=f"{what} {path}")
            continue
        diff = np.abs(g - w)
        n_out += int((diff > a + rtol * np.abs(w)).sum())
        n_all += diff.size
        if flip_bound is not None:
            assert diff.max() <= flip_bound, f"{what} {path}: {diff.max():.3g}"
    assert n_out <= flips * n_all, f"{what}: {n_out} of {n_all} elements outside"


def test_remat_changes_no_gradient():
    """plan.remat recomputes each group in the backward: same loss, same
    gradients (bit for bit: the same ops run again)."""
    _, _, _, tcfg, _, tparams = model_pair("qwen3-1.7b")
    _, tb = both(numpy_batch(tcfg))
    plan = derive_execution_plan(tcfg, training=True, batch=B, seq_len=S)
    out = {}
    for remat in (False, True):
        p = dataclasses.replace(plan, remat=remat)
        out[remat] = value_and_grad(lambda pp, b: lm_loss(pp, b, cfg=tcfg, plan=p), tparams, tb)
    assert float(out[True][0]) == float(out[False][0])
    for (path, a), (_, b) in zip(leaves_with_paths(out[True][1]),
                                 leaves_with_paths(out[False][1])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("Bx,Sx,V,chunk", [(1, 8, 50, 8), (2, 32, 128, 8), (2, 24, 64, 16)])
def test_chunked_softmax_xent_matches_jax(Bx, Sx, V, chunk, masked):
    """Summed loss and token count against JAX's, with and without a loss
    mask (the chunk halves until it divides S)."""
    rng = np.random.default_rng(Bx * 100 + Sx)
    x = rng.standard_normal((Bx, Sx, 16)).astype(np.float32)
    w = rng.standard_normal((16, V)).astype(np.float32)
    t = rng.integers(0, V, (Bx, Sx)).astype(np.int32)
    m = (rng.random((Bx, Sx)) < 0.6).astype(np.float32) if masked else None
    jt, jn = jax_xent(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
                      None if m is None else jnp.asarray(m), chunk=chunk)
    tt, tn = chunked_softmax_xent(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(t), None if m is None else torch.from_numpy(m),
                                  chunk=chunk)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    assert float(tn) == float(jn)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_chunk_function_equals_its_checkpoint(dtype, tied):
    """The cross-entropy chunk's autograd Function (its logits' gradient
    formed in one f32 buffer) gives the loss and gradients of
    ``torch.utils.checkpoint`` of the plain chunk, bit for bit, the chunks'
    ``w`` gradients summed as autograd sums them; a tied head's ``w`` is
    the embedding's transpose, a column-major view."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import transformer as T

    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 64, 48, generator=g).to(dtype)
    w = (torch.randn(48, 1000, generator=g) * 0.2).to(dtype)
    t = torch.randint(0, 1000, (3, 64), generator=g)
    m = (torch.rand(3, 64, generator=g) > 0.2).float()
    out = []
    for route in ("function", "checkpoint"):
        xx = x.clone().requires_grad_()
        embed = w.T.contiguous().requires_grad_()
        ww = embed.T if tied else w.clone().requires_grad_()
        total = 0
        for i in range(0, 64, 16):
            a = (xx[:, i:i + 16], ww, t[:, i:i + 16], m[:, i:i + 16])
            total = total + (T._XentChunk.apply(*a) if route == "function"
                             else checkpoint(lambda *c: T._xent_chunk(*c)[0], *a,
                                             use_reentrant=False))
        leaf = embed if tied else ww
        out.append((total.detach(), *torch.autograd.grad(total * 0.37, [xx, leaf])))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("donate", [False, True])
def test_adamw_slices_are_bit_identical(monkeypatch, donate):
    """AdamW's update of a leaf a slice at a time (``UPDATE_SLICE``
    elements; here 7, so every matrix and vector is cut, unevenly) equals
    the whole-leaf update bit for bit, donated or not, bf16 weights with f32
    moments, weight decay on matrices only."""
    from repro_torch.train import optimizer as O

    g = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(5, 9, generator=g).to(torch.bfloat16),
              "b": torch.randn(11, generator=g), "s": torch.randn((), generator=g)}
    grads = O.tree_map(lambda p: torch.randn(p.shape, generator=g).to(p.dtype), params)
    moments = [O.tree_map(lambda p: torch.rand(p.shape, generator=g), params) for _ in "mv"]
    opt = O.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    out = {}
    for slice_ in (1 << 26, 7):
        monkeypatch.setattr(O, "UPDATE_SLICE", slice_)
        m, v = (O.tree_map(torch.clone, t) for t in moments)
        state = O.init_state(O.tree_map(torch.clone, params))._replace(m=m, v=v)
        for _ in range(2):
            state, _ = O.adamw_update(state, grads, opt, donate=donate)
        out[slice_] = state
    for a, b in zip(O.tree_leaves(out[1 << 26]), O.tree_leaves(out[7])):
        assert a.dtype == b.dtype and torch.equal(a, b)


STEP_CASES = [
    # (arch, microbatches, remat, compression)
    ("qwen3-1.7b", 1, False, "none"),
    ("qwen3-1.7b", 2, True, "none"),
    ("qwen3-1.7b", 1, True, "int8"),
    ("qwen3-1.7b", 2, False, "bf16"),
    ("qwen3-moe-30b-a3b", 2, True, "int8"),
]


@pytest.mark.parametrize("arch,micro,remat,comp", STEP_CASES)
def test_train_steps_match_jax(arch, micro, remat, comp):
    """Three steps on the same batches: loss, grad norm and lr each step,
    then parameters, m, v (and the error-feedback residual) after."""
    jcfg, _, jparams, tcfg, _, tparams = model_pair(arch)
    knobs = dict(remat=remat, microbatches=micro, grad_compression=comp)
    jplan = dataclasses.replace(derive_plan(jcfg, MESH1, batch=4, seq_len=S), **knobs)
    tplan = dataclasses.replace(
        derive_execution_plan(tcfg, training=True, batch=4, seq_len=S), **knobs)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_step(jcfg, jplan, JaxOpt(**kw), compression=JaxCompression(comp)))
    tstep = make_train_step(tcfg, tplan, OptimizerConfig(**kw),
                            compression=CompressionConfig(comp), device="cpu")
    jstate = jax_init_state(jparams, with_residual=comp != "none")
    tstate = init_state(tparams, with_residual=comp != "none")
    for step in range(3):
        jb, tb = both(numpy_batch(jcfg, seed=10 + step, batch=4))
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    int8 = comp == "int8"
    assert_trees_close(tstate.params, jstate.params, 0, 1e-4, "params",
                       flips=PARAM_FLIP_SHARE if int8 else 0.0, flip_bound=2 * kw["peak_lr"] * 3)
    assert_trees_close(tstate.m, jstate.m, 0, 2e-4, "m", scale_atol=True)
    assert_trees_close(tstate.v, jstate.v, 1e-3, 1e-3, "v", scale_atol=True)
    if comp != "none":
        assert_trees_close(tstate.residual, jstate.residual, 0, 2e-4, "residual",
                           scale_atol=True, flips=RESIDUAL_FLIP_SHARE if int8 else 0.0,
                           flip_bound=RESIDUAL_FLIP_BOUND)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compress_grads_matches_jax(mode):
    """The compression with error feedback over three steps on the same
    gradients: the same values and residuals (int8: the same codes)."""
    from repro.train.compression import compress_grads as jax_compress
    from repro.train.compression import init_residual as jax_init_residual
    from repro_torch.train.compression import compress_grads, init_residual

    rng = np.random.default_rng(5)
    shapes = {"w": (33, 17), "b": (17,), "stack": ({"x": (2, 5, 3)},)}
    jres = jax_init_residual({"w": jnp.zeros((33, 17)), "b": jnp.zeros(17),
                              "stack": ({"x": jnp.zeros((2, 5, 3))},)})
    tres = init_residual({"w": torch.zeros(33, 17), "b": torch.zeros(17),
                          "stack": ({"x": torch.zeros(2, 5, 3)},)})
    for _ in range(3):
        g = {"w": rng.standard_normal(shapes["w"]).astype(np.float32),
             "b": 1e-3 * rng.standard_normal(shapes["b"]).astype(np.float32),
             "stack": ({"x": rng.standard_normal(shapes["stack"][0]["x"]).astype(np.float32)},)}
        jg, jres = jax_compress(jax.tree.map(jnp.asarray, g), jres, JaxCompression(mode))
        tg, tres = compress_grads(
            {"w": torch.from_numpy(g["w"]), "b": torch.from_numpy(g["b"]),
             "stack": ({"x": torch.from_numpy(g["stack"][0]["x"])},)},
            tres, CompressionConfig(mode))
        assert_trees_close(tg, jg, 0, 1e-7, f"{mode} grads", scale_atol=True)
        assert_trees_close(tres, jres, 0, 1e-7, f"{mode} residual", scale_atol=True)


@pytest.fixture
def card_path(monkeypatch):
    """The card's routing on CPU tensors: the flash and RMSNorm wrappers
    take their CUDA branch (the autograd Functions when autograd records,
    else a forward launch), each launch a counted plain version; returns
    the four counters."""
    from repro_torch.kernels import needs_grad
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (flash_backward_ref,
                                                         flash_forward_lse_ref)
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref, rmsnorm_ref

    counts = {"flash": 0, "flash_bwd": 0, "rmsnorm": 0, "rmsnorm_bwd": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fops, "forward_with_lse", count(
        "flash", lambda q, k, v, *, causal, window, prefix, with_lse=False: flash_forward_lse_ref(
            q, k, v, causal=causal, window=window, prefix=prefix)))
    monkeypatch.setattr(fops, "backward", count("flash_bwd", flash_backward_ref))
    monkeypatch.setattr(rops, "_forward", count("rmsnorm", rmsnorm_ref))
    monkeypatch.setattr(rops, "backward", count(
        "rmsnorm_bwd", lambda x, s, dy, r=None, *, eps: rmsnorm_backward_ref(x, s, dy, r, eps)))

    def flash(q, k, v, *, causal=True, window=0, prefix=0):
        if needs_grad(q, k, v):
            return fops.FlashAttention.apply(q, k, v, causal, window, prefix)
        return fops.forward_with_lse(q, k, v, causal=causal, window=window, prefix=prefix)[0]

    def norm(x, scale, residual=None, *, eps=1e-6):
        if needs_grad(x, scale, residual):
            return rops.RMSNorm.apply(x, scale, residual, eps)
        return rops._forward(x, scale, residual, eps)

    monkeypatch.setattr(fops, "flash_attention", flash)
    monkeypatch.setattr(rops, "rmsnorm", norm)
    return counts


@pytest.mark.parametrize("remat", [False, True])
def test_kernel_launches_of_a_training_step(card_path, remat):
    """One loss and backward on the card's routing: flash forward once a
    layer (twice with remat: each group runs again in the backward),
    backward once; RMSNorm forward once a norm (4 a layer with qk-norm,
    plus the final norm; again for each layer with remat), backward once a
    norm.  chip_smoke.py holds qwen3-1.7b to these counts (28 layers, remat
    on: 56, 28, 225, 113); the gradients equal the plain path's."""
    _, _, _, tcfg, _, tparams = model_pair("qwen3-1.7b")
    _, tb = both(numpy_batch(tcfg))
    plan = dataclasses.replace(derive_execution_plan(tcfg, training=True, batch=B, seq_len=S),
                               remat=remat)
    L = tcfg.n_layers
    loss, grads = value_and_grad(lambda p, b: lm_loss(p, b, cfg=tcfg, plan=plan), tparams, tb)
    assert card_path == {"flash": L * (1 + remat), "flash_bwd": L,
                         "rmsnorm": 4 * L + 1 + 4 * L * remat, "rmsnorm_bwd": 4 * L + 1}
    ploss, pgrads = value_and_grad(
        lambda p, b: lm_loss(p, b, cfg=tcfg, plan=plan, fused=False), tparams, tb)
    np.testing.assert_allclose(float(loss), float(ploss), rtol=1e-6)
    assert_trees_close(grads, pgrads, 1e-5, 1e-6, "kernel-path grad")

"""MM PU in the port against the JAX package, on the same numpy inputs: the
port's wrapper (``ops.mm_pu``, which runs the plain version for CPU
tensors) and ``ref.mm_pu_ref`` against the JAX Pallas kernel (interpret
mode, as the JAX kernel test runs it) and the JAX oracle, over the JAX
test's SHAPES and dtypes, every activation with bias and residual, the
int8 dequant and random shapes, at its tolerances (f32 1e-5 / 1e-4, bf16
2e-2, random 1e-4 / 1e-3); ``quantize_weights_int8`` bit for bit; the int8
FFN stage of tests/test_int8_serving.py; the copied tile solver
(``core/pu.py``) and ``pad_overhead`` against JAX's.  For the tensor-core
kernel: its launch plan (split-K on narrow grids), its split-K order
emulated (fixed-order f32 partial sums, then the epilogue) against JAX
``mm_pu``, the exact int8 -> bf16 widening, and, with the kernel library
replaced by counting stubs, which C entry each x dtype launches."""
import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import hypothesis.strategies as st
from hypothesis import given, settings

from repro.core import pu as jax_pu
from repro.core.hardware import TPU_V5E
from repro.kernels.mm_pu.ops import mm_pu as jax_mm_pu
from repro.kernels.mm_pu.ops import pad_overhead as jax_pad_overhead
from repro.kernels.mm_pu.ref import mm_pu_ref as jax_mm_pu_ref
from repro.kernels.mm_pu.ref import quantize_weights_int8 as jax_quantize
from repro_torch.core import pu
from repro_torch.core.hardware import H100_SXM, HardwareSpec
from repro_torch.kernels.mm_pu import ops
from repro_torch.kernels.mm_pu.ref import _act, mm_pu_ref, quantize_weights_int8
from repro_torch.models.layers import mlp
from torch_parity import t2n

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SHAPES = [(128, 128, 128), (256, 512, 384), (197, 768, 768), (64, 100, 32), (300, 64, 513)]
ACTIVATIONS = ["gelu", "silu", "relu", "relu2", "none"]


def _mk(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return x, w


def _both(x, w, dtype=jnp.float32, **kw):
    """(port results by name, JAX results by name), f32 numpy; ``kw`` are
    numpy epilogue operands plus ``activation``."""
    act = kw.pop("activation", "none")
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(np.array(v)) for k, v in kw.items()}
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype if w.dtype != np.int8 else jnp.int8)
    tx = torch.from_numpy(x).to(_TORCH[dtype])
    tw = torch.from_numpy(np.array(w))
    tw = tw if w.dtype == np.int8 else tw.to(_TORCH[dtype])
    mine = {"ops.mm_pu": ops.mm_pu(tx, tw, activation=act, **tkw),
            "mm_pu_ref": mm_pu_ref(tx, tw, activation=act, **tkw)}
    for name, got in mine.items():
        assert got.dtype == tx.dtype and got.shape == (x.shape[0], w.shape[1]), name
    theirs = {"pallas": jax_mm_pu(jx, jw, activation=act, **jkw),
              "jax ref": jax_mm_pu_ref(jx, jw, activation=act, **jkw)}
    return ({k: t2n(v) for k, v in mine.items()},
            {k: np.asarray(v, np.float32) for k, v in theirs.items()})


def _close(mine, theirs, rtol, atol):
    for name, got in mine.items():
        for ref, want in theirs.items():
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=f"{name} vs {ref}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matmul_matches_jax(shape, dtype):
    m, k, n = shape
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    _close(*_both(*_mk(m, k, n), dtype), rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_epilogue_activation_matches_jax(activation):
    x, w = _mk(256, 256, 256)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((1, 256)).astype(np.float32)
    r = rng.standard_normal((256, 256)).astype(np.float32)
    _close(*_both(x, w, bias=b, residual=r, activation=activation), rtol=1e-5, atol=1e-4)


def test_int8_dequant_matches_jax():
    x, w = _mk(256, 384, 512)
    q, s = jax_quantize(jnp.asarray(w))
    q, s = np.asarray(q), np.asarray(s)
    mine, theirs = _both(x, q, w_scale=s)
    _close(mine, theirs, rtol=1e-5, atol=1e-4)
    full = x @ w  # the quantized product approximates the fp one
    assert np.abs(mine["ops.mm_pu"] - full).max() / np.abs(full).max() < 0.05


@given(m=st.integers(8, 300), k=st.integers(8, 300), n=st.integers(8, 300))
@settings(max_examples=10, deadline=None)
def test_property_random_shapes(m, k, n):
    _close(*_both(*_mk(m, k, n, seed=m * k + n)), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_matches_jax(dtype):
    """The same int8 values and f32 scales, bit for bit, computed in w's
    dtype (round half to even, +-127)."""
    _, w = _mk(8, 96, 40, seed=3)
    w[:, 0] = 0.0  # an all-zero column takes the 1e-8 floor
    jq, js = jax_quantize(jnp.asarray(w, dtype))
    tq, ts = quantize_weights_int8(torch.from_numpy(w).to(_TORCH[dtype]))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (1, 40)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _ffn_weights(d=64, F=128, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.1).astype(np.float32)
            for shape in ((d, F), (d, F), (F, d))]


def test_int8_ffn_stage_matches_jax():
    """tests/test_int8_serving.py's SwiGLU stage through three int8 mm_pu
    products: the port's equals JAX's (1e-5) and stays within 0.05 of the
    fp FFN (``layers.mlp``)."""
    x = np.random.default_rng(5).standard_normal((32, 64)).astype(np.float32)
    w1, w3, w2 = _ffn_weights()

    def jax_stage(x):
        (q1, s1), (q3, s3), (q2, s2) = (jax_quantize(jnp.asarray(w)) for w in (w1, w3, w2))
        h = jax_mm_pu(x, q1, w_scale=s1, activation="silu")
        g = jax_mm_pu(x, q3, w_scale=s3)
        return np.asarray(jax_mm_pu(h * g, q2, w_scale=s2))

    def port_stage(x):
        (q1, s1), (q3, s3), (q2, s2) = (quantize_weights_int8(torch.from_numpy(w))
                                        for w in (w1, w3, w2))
        h = ops.mm_pu(x, q1, w_scale=s1, activation="silu")
        g = ops.mm_pu(x, q3, w_scale=s3)
        return ops.mm_pu(h * g, q2, w_scale=s2)

    tx = torch.from_numpy(x)
    got = t2n(port_stage(tx))
    np.testing.assert_allclose(got, jax_stage(jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    fp = t2n(mlp({"w1": torch.from_numpy(w1), "w3": torch.from_numpy(w3),
                  "w2": torch.from_numpy(w2)}, tx, "swiglu"))
    assert np.abs(got - fp).max() / np.abs(fp).max() < 0.05


def _port_spec(jax_spec) -> HardwareSpec:
    """The port's HardwareSpec carrying a JAX spec's numbers."""
    names = [f.name for f in dataclasses.fields(HardwareSpec)]
    return HardwareSpec(**{n: getattr(jax_spec, n) for n in names})


def test_pad_overhead_matches_jax():
    """Paper §V.D: ViT L=197 pads to 256 on a 128 tile."""
    spec, jspec = pu.MMTileSpec("t", 128, 128, 128), jax_pu.MMTileSpec("t", 128, 128, 128)
    for m, n, k in [(197, 768, 768), (256, 768, 768), (300, 64, 513)]:
        assert ops.pad_overhead(m, n, k, spec) == jax_pad_overhead(m, n, k, jspec)
    assert ops.pad_overhead(197, 768, 768, spec) > 0.25
    assert ops.pad_overhead(256, 768, 768, spec) == 0.0


@pytest.mark.parametrize("dtype_bytes", [1, 2])
def test_tile_solver_copy_matches_jax(dtype_bytes):
    """The copied solver gives JAX's family and picks on TPU v5e's numbers."""
    hw = _port_spec(TPU_V5E)
    as_tuple = lambda s: (s.name, s.block_m, s.block_n, s.block_k, s.dtype_bytes)  # noqa: E731
    mine = pu.solve_mm_tiles(hw, dtype_bytes)
    theirs = jax_pu.solve_mm_tiles(TPU_V5E, dtype_bytes)
    assert [as_tuple(s) for s in mine] == [as_tuple(s) for s in theirs] and mine
    assert [pu.is_compute_bound(s, hw) for s in mine] == \
        [jax_pu.is_compute_bound(s, TPU_V5E) for s in theirs]
    fam, jfam = pu.derive_pu_family(hw, dtype_bytes), jax_pu.derive_pu_family(TPU_V5E, dtype_bytes)
    assert {k: as_tuple(v) for k, v in fam.items()} == {k: as_tuple(v) for k, v in jfam.items()}
    for m, n, k in SHAPES + [(4096, 4096, 4096), (197, 3072, 768)]:
        assert as_tuple(pu.pick_pu(m, n, k, hw, dtype_bytes)) == \
            as_tuple(jax_pu.pick_pu(m, n, k, TPU_V5E, dtype_bytes))


def test_tile_solver_has_no_h100_tile():
    """A 128-edge tile needs 2*2*(2*128^2) + 4*128^2 = 196,608 bytes against
    the H100 budget of 232,448 / 2 = 116,224: no feasible tile, so the
    port's mm_pu takes none from the solver."""
    assert pu.MMTileSpec("t", 128, 128, 128).vmem_bytes == 196_608 > H100_SXM.vmem_bytes / 2
    assert pu.solve_mm_tiles(H100_SXM) == []
    with pytest.raises(RuntimeError, match="no feasible MM tile"):
        pu.derive_pu_family(H100_SXM)
    with pytest.raises(RuntimeError, match="no feasible MM tile"):
        pu.pick_pu(256, 256, 256)  # the port's default hardware is the H100


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="activation"):
        ops.mm_pu(x, torch.zeros((8, 2)), activation="tanh")


@pytest.mark.parametrize("m,k,n,split", [(256, 6144, 2048, True), (2048, 2048, 6144, False),
                                         (256, 512, 384, True), (64, 100, 32, False)])
def test_launch_plan(m, k, n, split):
    """Narrow grids split K until tiles x splits covers the H100's 132 SMs
    (the int8 FFN stage's T=256 w2 product) or each split is down to its
    least depth; wide ones do not split (its T=2048 w1 product).  Splits
    are whole slices of the kernel's depth, none empty."""
    splits, kps = ops.launch_plan(m, n, k)
    tiles = -(-m // 128) * -(-n // 128)
    depth = ops.K_SLICE[torch.bfloat16]
    assert (splits > 1) == split
    assert kps % depth == 0 and (splits - 1) * kps < k <= splits * kps
    if split:
        assert kps >= ops.MIN_SPLIT_SLICES * depth
        assert tiles * splits >= ops.N_SMS or kps == ops.MIN_SPLIT_SLICES * depth
    else:
        assert kps >= k


def _split_k_emulation(x, w, *, w_scale, bias, residual, activation):
    """The tensor-core kernel's order: f32 partial products over
    ``launch_plan``'s K splits, summed in split order, then the epilogue
    (scale after the product, bias, activation, residual)."""
    M, K = x.shape
    splits, kps = ops.launch_plan(M, w.shape[1], K)
    assert splits > 1
    parts = [x[:, k0:k0 + kps].float() @ w[k0:k0 + kps].float() for k0 in range(0, K, kps)]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    if w_scale is not None:
        acc = acc * w_scale
    return _act(acc + bias, activation) + residual


@pytest.mark.parametrize("int8", [True, False])
def test_split_k_emulation_matches_jax(int8):
    """bf16-valued x, int8 (with its scale) or bf16-valued w, silu, bias and
    residual: the split-K order equals JAX ``mm_pu`` to f32 rounding."""
    x, w = _mk(256, 512, 384, seed=6)
    x = t2n(torch.from_numpy(x).to(torch.bfloat16).float())
    rng = np.random.default_rng(7)
    b = rng.standard_normal((1, 384)).astype(np.float32)
    r = rng.standard_normal((256, 384)).astype(np.float32)
    if int8:
        q, s = (np.array(a) for a in jax_quantize(jnp.asarray(w)))
        want = jax_mm_pu(jnp.asarray(x), jnp.asarray(q), w_scale=jnp.asarray(s),
                         bias=jnp.asarray(b), residual=jnp.asarray(r), activation="silu")
        tw, ts = torch.from_numpy(q), torch.from_numpy(s)
    else:
        w = t2n(torch.from_numpy(w).to(torch.bfloat16).float())
        want = jax_mm_pu(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
                         residual=jnp.asarray(r), activation="silu")
        tw, ts = torch.from_numpy(w), None
    got = _split_k_emulation(torch.from_numpy(x), tw, w_scale=ts, bias=torch.from_numpy(b),
                             residual=torch.from_numpy(r), activation="silu")
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_int8_widens_to_bf16_exactly():
    """Every int8 value is exact in bf16 (8 significant bits), so the
    kernel's widened weight equals the reference's f32 upcast."""
    v = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert torch.equal(v.float().to(torch.bfloat16).float(), v.float())


class _Library:
    """Stands in for the kernel library: every C entry point records its
    arguments and returns 0."""

    def __init__(self):
        self.calls = Counter()
        self.args = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] += 1
            self.args[name] = args
            return 0
        return entry


def _launch(lib, x, w, **kw):
    kw = {"bias": None, "residual": None, "w_scale": None, "activation": "none",
          "out_dtype": None, **kw}
    return ops.launch(lib, x, w, stream=None, **kw)


@pytest.mark.parametrize("m,k,n,int8", [(256, 6144, 2048, True), (128, 128, 128, False),
                                        (64, 100, 32, True), (300, 64, 513, False)])
def test_bf16_x_launches_the_tensor_core_entry(m, k, n, int8):
    """bf16 x (bf16 or int8 w) launches ``mm_pu_forward_mma`` with
    ``launch_plan``'s splits, a workspace when it splits, and 16-byte copies
    only where every row is aligned (K 100 bf16 rows are 200 bytes; N 513)."""
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    w = torch.zeros((k, n), dtype=torch.int8 if int8 else torch.bfloat16)
    scale = torch.ones((1, n)) if int8 else None
    lib = _Library()
    out = _launch(lib, x, w, w_scale=scale, activation="silu")
    assert lib.calls == Counter({"mm_pu_forward_mma": 1})
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    args = lib.args["mm_pu_forward_mma"]
    splits, kps = ops.launch_plan(m, n, k)
    assert args[7:10] == (m, n, k) and args[10] == (2 if int8 else 1)
    assert args[14:16] == (splits, kps) and (args[6] is not None) == (splits > 1)
    assert args[16] == int(k % 8 == 0 and n % (16 if int8 else 8) == 0)


@pytest.mark.parametrize("int8", [True, False])
def test_f32_x_launches_the_cuda_core_entry(int8):
    """f32 x (f32 or int8 w) launches ``mm_pu_forward`` once."""
    x = torch.zeros((64, 96))
    w = torch.zeros((96, 40), dtype=torch.int8) if int8 else torch.zeros((96, 40))
    lib = _Library()
    out = _launch(lib, x, w, w_scale=torch.ones((1, 40)) if int8 else None)
    assert lib.calls == Counter({"mm_pu_forward": 1})
    assert out.shape == (64, 40) and out.dtype == torch.float32

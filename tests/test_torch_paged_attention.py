"""Port paged attention vs the JAX package on the same numpy inputs.

The port's plain version (``ref.py``) and its wrapper on CPU tensors
(``ops.paged_attention``, which takes the plain version there) are held to
the JAX Pallas kernel, run in interpret mode as the JAX tests run it, and to
the JAX oracle, over the JAX tests' six CASES, the tile sweep and the
corrupted-dead-page SWA case.  Tolerances are the JAX test's: 2e-5 for f32
and int8 pages, 3e-2 for bf16 pages (the Pallas kernel rounds q to bf16);
dead rows are exactly 0.  The bf16 tensor-core kernel's arithmetic (key
splits with f32 partials merged in order, P as bf16 hi + lo), emulated by
``ref.paged_attention_split_ref``, is held at one bf16 step to the Pallas
kernel and the JAX oracle on the same bf16 values, and its two planted
controls (P rounded once, a split left out) fail that step; with int8
pages (scales on S and on P before its split) the same holds on the JAX
test's int8 cases and G 8 decode and verify rows.  The CUDA
kernels themselves run only on the card (``chip_smoke.py``); here the
wrapper's routing by dtype runs against a counting stand-in library, and a
non-CPU tensor must raise, never fall back."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_attention as jax_kernel
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref, paged_attention_split_ref

CASES = [
    # (B, W, H, KH, D, bs, MB, kv_dtype, window, pages_per_tile)
    (3, 1, 4, 2, 32, 4, 8, "float32", 0, 2),  # pure decode, GQA
    (3, 4, 4, 2, 32, 4, 8, "float32", 0, 8),  # mixed slab, one-tile sweep
    (2, 8, 2, 1, 64, 8, 16, "bfloat16", 0, 4),  # bf16 pages, prefill rows
    (2, 4, 4, 2, 32, 4, 16, "int8", 0, 16),  # int8 in-kernel dequant
    (3, 4, 2, 2, 32, 4, 16, "float32", 12, 1),  # SWA, page-at-a-time
    (2, 1, 4, 1, 64, 8, 8, "int8", 20, 2),  # SWA decode past the window
]


def make_case(B, W, H, KH, D, bs, MB, kv_dtype, seed=0):
    """Numpy inputs: random pools, prefix-dense tables with ragged
    lens/q_lens, slot 0 empty on the trash block."""
    rng = np.random.default_rng(seed)
    N = 1 + B * MB
    q = rng.standard_normal((B, W, H, D)).astype(np.float32)
    k = rng.standard_normal((N, bs, KH, D)).astype(np.float32)
    v = rng.standard_normal((N, bs, KH, D)).astype(np.float32)
    if kv_dtype == "int8":
        entry = {}
        for name, x in (("k", k), ("v", v)):
            s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12) / np.float32(127.0)
            entry[name] = np.clip(np.round(x / s), -127, 127).astype(np.int8)
            entry[name + "_scale"] = s.astype(np.float32)
    else:
        entry = {"k": k, "v": v}
    lens = rng.integers(0, MB * bs - W, B).astype(np.int32)
    q_lens = rng.integers(1, W + 1, B).astype(np.int32)
    table = np.zeros((B, MB), np.int32)
    for b in range(B):
        nb = -(-(int(lens[b]) + W) // bs)
        table[b, :nb] = 1 + b * MB + np.arange(nb)
    table[0], lens[0], q_lens[0] = 0, 0, 0  # empty slot on trash block 0
    return q, entry, table, lens, q_lens


def _jax_in(q, entry, table, lens, q_lens, kv_dtype):
    je = {k: jnp.asarray(x) for k, x in entry.items()}
    if kv_dtype == "bfloat16":
        je = {k: x.astype(jnp.bfloat16) for k, x in je.items()}
    return jnp.asarray(q), je, jnp.asarray(table), jnp.asarray(lens), jnp.asarray(q_lens)


def _torch_in(q, entry, table, lens, q_lens, kv_dtype):
    te = {k: torch.from_numpy(x) for k, x in entry.items()}
    if kv_dtype == "bfloat16":
        # the same bf16 pages JAX sees (round to nearest even both ways)
        te = {k: x.bfloat16() for k, x in te.items()}
    return (torch.from_numpy(q), te, torch.from_numpy(table), torch.from_numpy(lens),
            torch.from_numpy(q_lens))


@pytest.mark.parametrize("case", CASES)
def test_port_matches_jax_kernel_and_oracle(case):
    B, W, H, KH, D, bs, MB, kv_dtype, window, ppt = case
    inputs = make_case(B, W, H, KH, D, bs, MB, kv_dtype)
    jin, tin = _jax_in(*inputs, kv_dtype), _torch_in(*inputs, kv_dtype)
    want_kernel = np.asarray(
        jax_kernel(*jin, block_size=bs, window=window, pages_per_tile=ppt), np.float32
    )
    want_ref = np.asarray(jax_ref(*jin, block_size=bs, window=window), np.float32)
    mine = paged_attention_ref(*tin, block_size=bs, window=window).numpy()
    via_ops = ops.paged_attention(*tin, block_size=bs, window=window).numpy()
    np.testing.assert_array_equal(via_ops, mine)  # CPU tensors take the plain version
    tol = 3e-2 if kv_dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(mine, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(mine, want_ref, rtol=2e-5, atol=2e-5)
    dead = np.arange(W)[None] >= inputs[4][:, None]  # (B, W) rows >= q_lens
    assert not mine[dead].any() and not want_kernel[dead].any()


def test_tile_sweep_invariance_against_port():
    """Every pages_per_tile schedule of the JAX kernel agrees with the port."""
    inputs = make_case(2, 4, 4, 2, 32, 4, 16, "float32")
    mine = paged_attention_ref(*_torch_in(*inputs, "float32"), block_size=4).numpy()
    jin = _jax_in(*inputs, "float32")
    for ppt in (1, 2, 4, 16):
        got = np.asarray(jax_kernel(*jin, block_size=4, pages_per_tile=ppt))
        np.testing.assert_allclose(mine, got, rtol=2e-5, atol=2e-5)


def test_swa_ignores_pages_below_window():
    """Corrupting pages wholly below the window changes nothing, in the
    port and in the JAX kernel alike."""
    q, entry, _, _, _ = make_case(1, 1, 2, 1, 32, 4, 8, "float32")
    table = (np.arange(8, dtype=np.int32) + 1)[None]
    lens, q_lens = np.array([28], np.int32), np.array([1], np.int32)
    smashed = {"k": entry["k"].copy(), "v": entry["v"].copy()}
    smashed["k"][1:4], smashed["v"][1:4] = 1e3, -1e3  # positions 0..11, all dead
    outs = []
    for e in (entry, smashed):
        mine = paged_attention_ref(*_torch_in(q, e, table, lens, q_lens, "float32"),
                                   block_size=4, window=8).numpy()
        jk = np.asarray(jax_kernel(*_jax_in(q, e, table, lens, q_lens, "float32"),
                                   block_size=4, window=8, pages_per_tile=2))
        np.testing.assert_allclose(mine, jk, rtol=2e-5, atol=2e-5)
        outs.append(mine)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)


def test_non_cpu_tensors_raise_without_a_built_kernel(monkeypatch):
    """The wrapper takes the plain version only for CPU tensors.  A tensor
    anywhere else goes to the kernel, whose build raises here (no nvcc;
    PyTorch here has no CUDA), or, on the meta device, to the dry run's
    meta route, which records one call and computes nothing; the plain
    version is never called and no launch is counted."""
    from repro_torch.core.op_cost import OpRecorder

    def refuse(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ops, "paged_attention_ref", refuse)
    monkeypatch.setattr(ops.kernel, "_lib", None)
    q, entry, table, lens, q_lens = _torch_in(*make_case(2, 1, 4, 2, 32, 4, 8, "float32"),
                                              "float32")
    meta = {k: x.to("meta") for k, x in entry.items()}
    before = ops.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.kernel.library()
    with OpRecorder() as rec:
        out = ops.paged_attention(q.to("meta"), meta, table, lens, q_lens, block_size=4)
    assert out.is_meta and out.shape == q.shape
    assert rec.cost.kernel_calls() == {"paged_attention": 1}
    assert ops.LAUNCHES == before


# One bf16 step of the output (chip_smoke.py's bf16 tolerance): both sides
# compute in f32 and round once to bf16.
BF16_TOL = (1e-4, 2.0**-7)
SPLIT_CASES = [c[:7] + ("bfloat16",) + c[8:] for c in CASES] + [
    # (B, W, H, KH, D, bs, MB, kv_dtype, window, pages_per_tile)
    (2, 1, 4, 2, 64, 16, 64, "bfloat16", 0, 8),  # long decode contexts: several splits
    (2, 2, 4, 1, 64, 16, 64, "bfloat16", 100, 8),  # SWA decode past the window
    (3, 24, 4, 2, 32, 8, 16, "bfloat16", 0, 4),  # prefill rows past one 16-row block
]


def _outside(got, want, tol=BF16_TOL) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) > tol[0] + tol[1] * np.abs(want)).mean())


def _split_inputs(case, seed=0):
    """The case's inputs with q and pages as bf16 (torch), the same values
    as f32 (JAX), and long contexts for the long cases."""
    B, W, H, KH, D, bs, MB, _, window, ppt = case
    q, entry, table, lens, q_lens = make_case(B, W, H, KH, D, bs, MB, "float32", seed=seed)
    if MB * bs >= 1024:  # contexts that span several 256-key splits
        lens = np.array([900, 700][:B], np.int32)
        q_lens = np.array([W, 1][:B], np.int32)
        table[:] = 1 + np.arange(B)[:, None] * MB + np.arange(MB)[None]
    tq = torch.from_numpy(q).bfloat16()
    te = {k: torch.from_numpy(x).bfloat16() for k, x in entry.items()}
    f32 = (tq.float().numpy(), {k: x.float().numpy() for k, x in te.items()})
    return (tq, te, torch.from_numpy(table), torch.from_numpy(lens),
            torch.from_numpy(q_lens)), f32 + (table, lens, q_lens)


def _jax_wants(case, jin):
    bs, window, ppt = case[5], case[8], case[9]
    jq, je, jt, jl, jql = jin
    args = (jnp.asarray(jq), {k: jnp.asarray(x) for k, x in je.items()}, jnp.asarray(jt),
            jnp.asarray(jl), jnp.asarray(jql))
    return {"pallas": np.asarray(jax_kernel(*args, block_size=bs, window=window,
                                            pages_per_tile=ppt), np.float32),
            "jax oracle": np.asarray(jax_ref(*args, block_size=bs, window=window), np.float32)}


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_scheme_matches_jax(case):
    """The tensor-core kernel's arithmetic, with 64-key splits (several
    splits a slot even in the JAX test's short cases), within one bf16 step
    of the Pallas kernel (interpret mode) and the JAX oracle, run on f32
    copies of the same bf16 values: the Pallas kernel with bf16 pages rounds
    P once to bf16 (kernel.py:163), which is what the scheme avoids.  Dead
    rows exactly 0."""
    tin, jin = _split_inputs(case)
    got = paged_attention_split_ref(*tin, block_size=case[5], window=case[8], split=64)
    assert got.dtype == torch.bfloat16 and got.shape == tin[0].shape
    for name, want in _jax_wants(case, jin).items():
        assert _outside(got.float().numpy(), want) == 0.0, name
    dead = np.arange(case[1])[None] >= jin[4][:, None]
    assert not got.float().numpy()[dead].any()


@pytest.mark.parametrize("control", ["P rounded once", "split dropped"])
def test_split_controls_break_the_tolerance(control):
    """The planted controls: P rounded once to bf16, and the second of a
    slot's 256-key splits left out of the combine, each put elements
    outside one bf16 step of the JAX oracle on the long-context case."""
    case = SPLIT_CASES[6]
    tin, jin = _split_inputs(case)
    kw = {"p_split": False} if control == "P rounded once" else {"drop_split": 1}
    bad = paged_attention_split_ref(*tin, block_size=case[5], split=256, **kw)
    assert _outside(bad.float().numpy(), _jax_wants(case, jin)["jax oracle"]) > 0.0


def test_split_size_changes_only_rounding():
    """The split (the kernel's schedule over keys) moves results by less
    than one bf16 step: 64-, 256- and 1024-key splits on the long case."""
    case = SPLIT_CASES[6]
    tin, jin = _split_inputs(case)
    want = _jax_wants(case, jin)["jax oracle"]
    for split in (64, 256, 1024):
        got = paged_attention_split_ref(*tin, block_size=case[5], split=split)
        assert _outside(got.float().numpy(), want) == 0.0, split


# bf16 q with int8 pages on the tensor cores (``paged_attention_split_ref``
# with the pages' scales): the JAX test's two int8 cases, a G 8 decode case
# whose contexts cross several 64-key splits, and G 8 verify rows (q_len
# 2-5: 16-40 rows, so row blocks as well as decode items).
# (B, W, H, KH, D, bs, MB, kv_dtype, window, pages_per_tile)
INT8_SPLIT_CASES = [c for c in CASES if c[7] == "int8"] + [
    (4, 1, 16, 2, 64, 16, 128, "int8", 0, 8),  # G 8 decode, contexts 333-1500
]
INT8_VERIFY = (5, 6, 8, 1, 32, 16, 40, "int8", [2, 3, 4, 5, 5], [127, 62, 300, 520, 40])


def _int8_inputs(case, seed=0):
    """bf16 q and int8 pages (torch), the same values for JAX (q as f32),
    and the JAX call's case; long decode contexts for the G 8 case."""
    if case == INT8_VERIFY:
        q, entry, table, lens, q_lens = make_verify_case(case)
        jcase = case[:8] + (0, 8)
    else:
        B, W, H, KH, D, bs, MB, kv, window, ppt = case
        q, entry, table, lens, q_lens = make_case(B, W, H, KH, D, bs, MB, kv, seed=seed)
        if MB * bs >= 1024:
            lens = np.array([900, 700, 1500, 333][:B], np.int32)
            q_lens = np.ones(B, np.int32)
            table[:] = 1 + np.arange(B)[:, None] * MB + np.arange(MB)[None]
        jcase = case
    tq = torch.from_numpy(q).bfloat16()
    te = {k: torch.from_numpy(x) for k, x in entry.items()}
    tin = (tq, te, torch.from_numpy(table), torch.from_numpy(lens), torch.from_numpy(q_lens))
    return tin, (tq.float().numpy(), entry, table, lens, q_lens), jcase


@pytest.mark.parametrize("case", INT8_SPLIT_CASES + [INT8_VERIFY],
                         ids=["jax-int8", "jax-int8-swa", "G8-decode", "G8-verify"])
def test_int8_split_scheme_matches_jax(case):
    """int8 pages through the tensor-core scheme (their integer values as
    bf16, exact; S = (q . k) k_scale; P' = P v_scale split into bf16 hi +
    lo; l from the unscaled p), 64-key splits, within one bf16 step of the
    Pallas kernel (interpret mode, in-kernel dequantization in f32) and the
    JAX oracle on the same values.  Dead rows exactly 0."""
    tin, jin, jcase = _int8_inputs(case)
    got = paged_attention_split_ref(*tin, block_size=jcase[5], window=jcase[8], split=64)
    assert got.dtype == torch.bfloat16 and got.shape == tin[0].shape
    for name, want in _jax_wants(jcase, jin).items():
        assert _outside(got.float().numpy(), want) == 0.0, name
    dead = np.arange(jcase[1])[None] >= jin[4][:, None]
    assert not got.float().numpy()[dead].any()


@pytest.mark.parametrize("control", ["P' rounded once", "split dropped"])
def test_int8_split_controls_break_the_tolerance(control):
    """On the long G 8 int8 case: P' = P v_scale rounded once to bf16 (no
    hi + lo) and a slot's second 512-key split left out each put elements
    outside one bf16 step of the JAX oracle, so the kernel keeps the
    split."""
    case = INT8_SPLIT_CASES[2]
    tin, jin, jcase = _int8_inputs(case)
    kw = {"p_split": False} if control == "P' rounded once" else {"drop_split": 1}
    bad = paged_attention_split_ref(*tin, block_size=case[5], split=512, **kw)
    assert _outside(bad.float().numpy(), _jax_wants(jcase, jin)["jax oracle"]) > 0.0


class _Library:
    """Stands in for the kernel library: every C entry point counts its
    calls, keeps its arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.args, self.rc = Counter(), {}, rc

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] += 1
            self.args[name] = args
            return self.rc
        return entry


@pytest.mark.parametrize("q_dtype,kv_dtype,entry", [
    (torch.bfloat16, "bfloat16", "paged_attention_forward_mma"),
    (torch.bfloat16, "int8", "paged_attention_forward_mma"),
    (torch.float32, "int8", "paged_attention_forward"),
    (torch.float32, "bfloat16", "paged_attention_forward"),
    (torch.float32, "float32", "paged_attention_forward"),
])
def test_dtypes_select_the_kernel(q_dtype, kv_dtype, entry):
    """bf16 q with bf16 or int8 pages launches the tensor-core entry (with
    the int8 pages' scale pointers and page-dtype code), every other pair
    the CUDA-core one (f32 q with int8 pages too: f32's 2e-5 rules out q
    in bf16), once; the tensor-core entry gets a work list and split
    partials sized from the table width (2 splits of 512 keys for 64
    blocks of 16); a failed launch raises with the entry's name."""
    q, e, table, lens, q_lens = _torch_in(*make_case(2, 4, 4, 2, 32, 16, 64, kv_dtype),
                                          kv_dtype)
    q = q.to(q_dtype)
    lib = _Library()
    out = ops.launch(lib, q, e, table, lens, q_lens, block_size=16, window=0, rows_per_cta=0,
                     stream=None)
    assert lib.calls == Counter({entry: 1}) and ops.ENTRIES[q_dtype, e["k"].dtype] == entry
    assert out.shape == q.shape and out.dtype == q_dtype
    args = lib.args[entry]
    if entry == "paged_attention_forward_mma":
        *_, rows, split, n_splits, kv_code, _, _ = args
        assert (rows, split, n_splits) == (4, ops.SPLIT, 2)
        assert kv_code == {"bfloat16": 1, "int8": 2}[kv_dtype]
    scales = args[3:5]
    if kv_dtype == "int8":
        assert scales == (e["k_scale"].data_ptr(), e["v_scale"].data_ptr())
    else:
        assert scales == (None, None)
    with pytest.raises(RuntimeError, match=entry):
        ops.launch(_Library(rc=1), q, e, table, lens, q_lens, block_size=16, window=0,
                   rows_per_cta=0, stream=None)


# Verify-row shapes (speculative decoding): decode slots carry gamma + 1
# query rows at their current length.  (B, W, H, KH, D, bs, MB, kv_dtype,
# q_lens, lens): G 2 (qwen3-1.7b's) with q_len 2, 3, 5 and 8 beside a
# decode slot and a prefill chunk, the last verify row's causal edge on the
# first and on the last key of a 64-key split; G 8 (qwen3-moe-30b-a3b's)
# with q_len 2-5 on f32 and int8 pages.
VERIFY_CASES = [
    (6, 12, 4, 2, 32, 16, 72, kv, [2, 3, 5, 8, 1, 12], [510, 126, 60, 1017, 700, 300])
    for kv in ("float32", "bfloat16", "int8")
] + [
    (5, 6, 8, 1, 32, 16, 40, kv, [2, 3, 4, 5, 6], [127, 62, 300, 520, 40])
    for kv in ("float32", "int8")
]


def make_verify_case(case, seed=0):
    B, W, H, KH, D, bs, MB, kv, q_lens, lens = case
    q, entry, table, _, _ = make_case(B, W, H, KH, D, bs, MB, kv, seed=seed)
    table[:] = 1 + np.arange(B)[:, None] * MB + np.arange(MB)[None]
    return q, entry, table, np.array(lens, np.int32), np.array(q_lens, np.int32)


def _no_causal_edge(q, entry, table, lens, q_lens, bs):
    """A planted control: every live row of a slot sees all the slot's
    keys up to its last row, as a kernel that dropped the causal edge
    between verify rows would compute."""
    from repro_torch.kernels.paged_attention.ref import masked_attention, paged_mask
    from repro_torch.models.cache import paged_gather

    k, v = paged_gather(entry, table, bs)
    valid = paged_mask(lens, q_lens, q.shape[1], k.shape[1])
    last = (lens.long() + q_lens.long() - 1)[:, None, None]
    live = valid.any(dim=-1, keepdim=True)
    valid = live & (torch.arange(k.shape[1])[None, None] <= last)
    return masked_attention(q, k, v, valid)


@pytest.mark.parametrize("case", VERIFY_CASES, ids=lambda c: f"G{c[2] // c[3]}-{c[7]}")
def test_verify_rows_match_jax(case):
    """The plain version at verify-row shapes against the JAX oracle and
    the Pallas kernel (interpret mode), at the JAX test's tolerances; the
    causal edge between verify rows matters (its control fails)."""
    bs, kv = case[5], case[7]
    inputs = make_verify_case(case)
    jin, tin = _jax_in(*inputs, kv), _torch_in(*inputs, kv)
    mine = paged_attention_ref(*tin, block_size=bs).numpy()
    np.testing.assert_array_equal(ops.paged_attention(*tin, block_size=bs).numpy(), mine)
    want_ref = np.asarray(jax_ref(*jin, block_size=bs), np.float32)
    want_kernel = np.asarray(jax_kernel(*jin, block_size=bs, pages_per_tile=8), np.float32)
    np.testing.assert_allclose(mine, want_ref, rtol=2e-5, atol=2e-5)
    tol = 3e-2 if kv == "bfloat16" else 2e-5
    np.testing.assert_allclose(mine, want_kernel, rtol=tol, atol=tol)
    bad = _no_causal_edge(*tin, bs).numpy()
    assert not np.allclose(bad, want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("split", [64, 512])
def test_verify_rows_split_scheme_matches_jax(split):
    """The tensor-core kernel's arithmetic at G 2 verify rows: slots whose
    G x q_len rows fit one 16-row block (q_len 2-8) run as decode items cut
    at absolute multiples of ``split``, the prefill chunk (24 rows) as a
    row block; within one bf16 step of the JAX oracle and the Pallas kernel
    on the same bf16 values, dead rows 0, and the dropped causal edge
    rejected."""
    case = VERIFY_CASES[1]
    bs = case[5]
    q, entry, table, lens, q_lens = make_verify_case(case)
    tq = torch.from_numpy(q).bfloat16()
    te = {k: torch.from_numpy(x).bfloat16() for k, x in entry.items()}
    targs = (tq, te, torch.from_numpy(table), torch.from_numpy(lens), torch.from_numpy(q_lens))
    got = paged_attention_split_ref(*targs, block_size=bs, split=split)
    jin = (tq.float().numpy(), {k: x.float().numpy() for k, x in te.items()}, table, lens, q_lens)
    for name, want in _jax_wants(case[:8] + (0, 8), jin).items():
        assert _outside(got.float().numpy(), want) == 0.0, name
    dead = np.arange(case[1])[None] >= q_lens[:, None]
    assert not got.float().numpy()[dead].any()
    bad = _no_causal_edge(tq.float(), {k: x.float() for k, x in te.items()}, *targs[2:], bs)
    assert _outside(bad.numpy(), _jax_wants(case[:8] + (0, 8), jin)["jax oracle"]) > 0.0

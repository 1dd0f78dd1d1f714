"""One model, two paged serve steps, both packages: the port's ``forward``
+ ``logits_fn`` against the JAX ``forward`` on the same bridged weights and
the same slab (an idle slot, a prefilling slot, a decoding slot), on dense
and MoE archs (reduced mixtral-8x7b and qwen3-moe-30b-a3b), through
the fused path (JAX: the Pallas kernel in interpret mode; port on CPU: the
plain version) and the gather path.  f32: hidden states and logits within
1e-4; the pools hold the same pages after each step (every block but the
trash block, where dead rows collide and any writer may win).  The eager
path's other archs in a full pass (no cache), both paths: hidden states
and logits within 1e-4 of JAX's, vit-base's class logits included; and
the compute dtype of a model with no token embedding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import derive_serve_plan as jax_serve_plan
from repro.models.cache import init_paged_cache as jax_init_cache
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import logits_fn as jax_logits
from repro_torch.core.plan import derive_serve_plan
from repro_torch.models.cache import init_paged_cache
from repro_torch.models.transformer import forward, logits_fn
from torch_parity import MESH1, model_pair, t2n

TOL = 1e-4


def _pool_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pool_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _pool_leaves(v)
    elif tree is not None:
        yield tree


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch,kv_dtype,replace", [
    ("qwen3-1.7b", "fp32", {}), ("smollm-135m", "int8", {}),
    # MoE FFNs over the slab (dead rows route too): drop-free at the reduced
    # capacity factor, and at 1.25, where slab rows compete for capacity
    ("mixtral-8x7b", "fp32", {}), ("qwen3-moe-30b-a3b", "int8", {}),
    ("qwen3-moe-30b-a3b", "fp32", {"moe_capacity_factor": 1.25}),
])
def test_mixed_paged_steps_match_jax(arch, kv_dtype, replace, fused):
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch, **replace)
    kw = dict(max_seq_len=32, decode_batch=3, block_size=4, kv_dtype=kv_dtype,
              prefill_chunk=4)
    jserve, serve = jax_serve_plan(jcfg, MESH1, **kw), derive_serve_plan(tcfg, MESH1, **kw)
    jpools = jax_init_cache(jcfg, jplan, jserve)
    tpools = init_paged_cache(tcfg, tplan, serve, device="cpu")
    rng = np.random.default_rng(0)
    W, MB = serve.mixed_slab_width, serve.max_blocks_per_seq
    table = np.zeros((3, MB), np.int32)
    table[1, :3] = [1, 2, 3]
    table[2, :2] = [4, 5]
    # step 1: slot 1 prefills a full chunk, slot 2 its 3-token prompt;
    # step 2: slot 1 its next chunk, slot 2 decodes one token
    steps = [(np.array([0, 0, 0]), np.array([0, 4, 3])),
             (np.array([0, 4, 3]), np.array([0, 4, 1]))]
    for lens, kinds in steps:
        tokens = rng.integers(0, tcfg.vocab_size, (3, W)).astype(np.int32)
        lens, kinds = lens.astype(np.int32), kinds.astype(np.int32)
        jx, jnc, _ = jax_forward(
            jparams, {"tokens": jnp.asarray(tokens)}, cfg=jcfg, plan=jplan,
            cache={"layers": jpools["layers"], "t": jnp.asarray(lens)},
            page_state={"block_size": 4, "fused": fused, "pages_per_tile": 2,
                        "table": jnp.asarray(table), "q_lens": jnp.asarray(kinds)},
        )
        jpools = {"layers": jnc["layers"]}
        tx, tnc = forward(
            tparams, {"tokens": torch.from_numpy(tokens)}, cfg=tcfg, plan=tplan,
            cache={"layers": tpools["layers"], "t": torch.from_numpy(lens)},
            page_state={"block_size": 4, "fused": fused, "table": torch.from_numpy(table),
                        "q_lens": torch.from_numpy(kinds)},
        )
        assert tnc["layers"] is tpools["layers"]  # written in place
        np.testing.assert_allclose(t2n(tx), np.asarray(jx), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            t2n(logits_fn(tparams, tx, tcfg)), np.asarray(jax_logits(jparams, jx, jcfg)),
            rtol=TOL, atol=TOL,
        )
        mine, theirs = list(_pool_leaves(tpools)), list(_pool_leaves(jpools))
        assert len(mine) == len(theirs) > 0
        for t, j in zip(mine, theirs):
            got, want = t2n(t)[:, 1:], np.asarray(j, np.float32)[:, 1:]
            if t.dtype == torch.int8:
                # a quantization step may flip where the f32 inputs differ
                # in the last bits: at most one grid step, rarely
                diff = np.abs(got - want)
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bf16_compute_dtype_is_a_deliberate_divergence():
    """JAX ``_weight_dtype`` returns the dtype of the first >= 2-D leaf,
    which in a stacked tree is the f32 norm scale, so the JAX forward runs
    bf16 params in f32 activations; the port computes in the embedding's
    dtype (bf16), so that every projection stays a bf16 product."""
    from repro.models.transformer import _weight_dtype

    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair("qwen3-1.7b", dtype=jnp.bfloat16)
    assert _weight_dtype(jparams) == jnp.float32
    assert tparams["embed"].dtype == torch.bfloat16
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 6)).astype(np.int32)
    jx, _, _ = jax_forward(jparams, {"tokens": jnp.asarray(tokens)}, cfg=jcfg, plan=jplan)
    tx, _ = forward(tparams, {"tokens": torch.from_numpy(tokens)}, cfg=tcfg, plan=tplan)
    assert jx.dtype == jnp.float32 and tx.dtype == torch.bfloat16


def _frontend_batch(cfg, B, S, seed):
    """Tokens (none for vit-base: it has no token embedding) and the arch's
    prefix embeddings / encoder frames, from numpy."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.vocab_size > 1:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend != "none":
        b["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["enc_embeds"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "paligemma-3b", "whisper-small",
                                  "bert-base", "vit-base"])
def test_other_archs_forward_matches_jax(arch, fused):
    """A full pass: RG-LRU + local layers, a bidirectional prefix, the
    encoder and cross-attention, learned positions and bidirectional
    encoders, the classifier head ((B, n_classes) for vit-base)."""
    from repro.models.transformer import logits_fn as jax_logits_fn

    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch)
    b = _frontend_batch(tcfg, 2, 10, seed=5)
    jx, _, _ = jax_forward(jparams, {k: jnp.asarray(v) for k, v in b.items()}, cfg=jcfg,
                           plan=jplan)
    tx, none = forward(tparams, {k: torch.from_numpy(v) for k, v in b.items()}, cfg=tcfg,
                       plan=tplan, fused=fused)
    assert none is None
    np.testing.assert_allclose(t2n(tx), np.asarray(jx), rtol=TOL, atol=TOL)
    tl = logits_fn(tparams, tx, tcfg)
    if tcfg.n_classes:
        assert tl.shape == (2, tcfg.n_classes)
    np.testing.assert_allclose(t2n(tl), np.asarray(jax_logits_fn(jparams, jx, jcfg)), rtol=TOL,
                               atol=TOL)


def test_compute_dtype_without_token_embedding():
    """vit-base has no ``embed``: the port computes in its first layer's FFN
    weight dtype (bf16 here), beside the bf16 divergence above (JAX: f32)."""
    from repro.models.transformer import _weight_dtype

    # the reduced config has a 512-token vocabulary; vit-base itself has none
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair("vit-base", dtype=jnp.bfloat16,
                                                            vocab_size=1)
    assert "embed" not in tparams and _weight_dtype(jparams) == jnp.float32
    b = _frontend_batch(tcfg, 1, 0, seed=6)
    tx, _ = forward(tparams, {k: torch.from_numpy(v) for k, v in b.items()}, cfg=tcfg,
                    plan=tplan)
    assert tx.dtype == torch.bfloat16 and tx.shape == (1, tcfg.n_prefix_embeds, tcfg.d_model)

"""The port's eager path against the JAX package on bridged f32 weights:
``greedy_generate`` gives JAX ``greedy_generate``'s tokens exactly on
reduced rwkv6-1.6b, qwen3-1.7b, mixtral-8x7b and qwen3-moe-30b-a3b (f32
cache); prefill -> decode over the dense cache equals the full pass (rel
2e-3, as tests/test_decode.py; the reduced MoE archs are drop-free), the
SWA ring cache included past its window; ``cache_from_prefill`` builds the
JAX cache tree; the port's continuous engine gives the port's
``greedy_generate`` tokens request by request (as tests/test_serve_engine.py
holds the JAX engine to the JAX eager path); and the CLI falls back to the
eager engine for an arch the continuous engine refuses.  The eager path's
other archs, with their frontend inputs (prefix embeddings, encoder
frames): recurrentgemma-9b, paligemma-3b, whisper-small and bert-base give
JAX's tokens exactly, tied and untied; prefill -> decode equals the full
pass (rel 2e-3) for the decoders, recurrentgemma-9b's local ring past its
window included; their caches (RG-LRU states, cross K/V, the encoder
memory) are JAX's; and the CLI serves each of them eagerly, while vit-base,
a classifier, raises (JAX fails with an IndexError)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache_from_prefill as jax_cache_from_prefill
from repro.models.transformer import forward as jax_forward
from repro.serve import greedy_generate as jax_greedy_generate
from repro_torch.core.plan import derive_serve_plan
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.cache import cache_from_prefill, init_cache
from repro_torch.models.transformer import forward
from repro_torch.serve import Request, ServingEngine, greedy_generate
from torch_parity import MESH1, model_pair, t2n

ARCHS = ["rwkv6-1.6b", "qwen3-1.7b"]
MOE_ARCHS = ["mixtral-8x7b", "qwen3-moe-30b-a3b"]
# Reduced qwen3 ties its head to the embedding, and with random weights its
# greedy stream just repeats the last prompt token; an untied head (rwkv6
# has one) makes every token depend on the whole model.
UNTIED = {"rwkv6-1.6b": {}, "qwen3-1.7b": {"tie_embeddings": False},
          "mixtral-8x7b": {"tie_embeddings": False},
          "qwen3-moe-30b-a3b": {"tie_embeddings": False}}


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch,untie", [("rwkv6-1.6b", False), ("qwen3-1.7b", False),
                                        ("qwen3-1.7b", True), ("mixtral-8x7b", True),
                                        ("qwen3-moe-30b-a3b", False),
                                        ("qwen3-moe-30b-a3b", True)])
def test_greedy_generate_matches_jax(arch, untie):
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(
        arch, **(UNTIED[arch] if untie else {}))
    prompt = _tokens(tcfg, 2, 12)
    want = jax_greedy_generate(jparams, jcfg, jplan, {"tokens": jnp.asarray(prompt)},
                               n_steps=6, cache_len=20, cache_dtype=jnp.float32)
    got = greedy_generate(tparams, tcfg, tplan, {"tokens": torch.from_numpy(prompt)},
                          n_steps=6, cache_len=20, cache_dtype=torch.float32, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    if not tcfg.tie_embeddings:
        assert len(set(got[0].tolist())) > 1  # not a constant stream
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _decode_vs_full(tcfg, tplan, tparams, tokens, S0, cache_len):
    """Port hidden states of positions S0.. from prefill + one-token decode
    steps over the dense cache, and from the full pass."""
    T = torch.from_numpy(tokens)
    x_full, none = forward(tparams, {"tokens": T}, cfg=tcfg, plan=tplan)
    assert none is None
    _, pc = forward(tparams, {"tokens": T[:, :S0]}, cfg=tcfg, plan=tplan, collect_cache=True)
    cache = cache_from_prefill(tcfg, tplan, pc, cache_len=cache_len, dtype=torch.float32)
    outs = []
    for t in range(S0, tokens.shape[1]):
        x1, cache = forward(tparams, {"tokens": T[:, t:t + 1]}, cfg=tcfg, plan=tplan,
                            cache=cache)
        outs.append(t2n(x1[:, 0]))
    assert cache["t"] == tokens.shape[1]
    return np.stack(outs, axis=1), t2n(x_full[:, S0:]), x_full


def _rel(got, want):
    return np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-9)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_prefill_decode_matches_full(arch):
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch)
    tokens = _tokens(tcfg, 2, 11, seed=1)
    got, want, x_full = _decode_vs_full(tcfg, tplan, tparams, tokens, 8, cache_len=13)
    assert _rel(got, want) < 2e-3, f"{arch}: decode diverges from full pass"
    jx, _, _ = jax_forward(jparams, {"tokens": jnp.asarray(tokens)}, cfg=jcfg, plan=jplan)
    np.testing.assert_allclose(t2n(x_full), np.asarray(jx), rtol=1e-4, atol=1e-4)


def test_windowed_ring_cache_wraps():
    """Decode 16 tokens past an 8-slot window: the ring equals the full pass
    (the port's and the JAX one)."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(
        "qwen3-1.7b", layer_pattern=("swa",), sliding_window=8, n_layers=2)
    tokens = _tokens(tcfg, 1, 20, seed=2)
    got, want, x_full = _decode_vs_full(tcfg, tplan, tparams, tokens, 4,
                                        cache_len=tcfg.sliding_window)
    assert _rel(got, want) < 2e-3, f"ring cache wrap mismatch: {_rel(got, want):.1e}"
    jx, _, _ = jax_forward(jparams, {"tokens": jnp.asarray(tokens)}, cfg=jcfg, plan=jplan)
    np.testing.assert_allclose(t2n(x_full), np.asarray(jx), rtol=1e-4, atol=1e-4)


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_shapes(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, prefix + (i,)))
        return out
    return {prefix: tuple(np.shape(tree))}


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_cache_trees_match_jax(arch):
    """``cache_from_prefill`` and ``init_cache`` build the JAX tree (keys
    and shapes) with the same values; the stacked groups carry ``t``."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch, n_layers=3)
    tokens = _tokens(tcfg, 2, 6, seed=3)
    _, jpc, _ = jax_forward(jparams, {"tokens": jnp.asarray(tokens)}, cfg=jcfg, plan=jplan,
                            collect_cache=True)
    jc = jax_cache_from_prefill(jcfg, jplan, jpc, cache_len=9, dtype=jnp.float32)
    _, pc = forward(tparams, {"tokens": torch.from_numpy(tokens)}, cfg=tcfg, plan=tplan,
                    collect_cache=True)
    tc = cache_from_prefill(tcfg, tplan, pc, cache_len=9, dtype=torch.float32)
    js, ts = _shapes(jc["layers"]), _shapes(tc["layers"])
    assert js == ts
    assert int(jc["t"]) == tc["t"] == 6
    jl = dict(zip(js, jax.tree.leaves(jc["layers"])))
    for path, leaf in zip(ts, _leaves(tc["layers"])):
        np.testing.assert_allclose(t2n(leaf) if leaf.dtype != torch.int32 else leaf.numpy(),
                                   np.asarray(jl[path]), rtol=1e-4, atol=1e-4, err_msg=str(path))
    zero = init_cache(tcfg, tplan, 2, 9, dtype=torch.float32, device="cpu")
    assert _shapes(zero["layers"]) == ts and zero["t"] == 0


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_engine_matches_greedy_generate():
    """The port's continuous engine (paged cache, staggered arrivals) gives
    the port's eager tokens for every request, one request at a time."""
    _, _, _, tcfg, tplan, tparams = model_pair("qwen3-1.7b", **UNTIED["qwen3-1.7b"])
    serve = derive_serve_plan(tcfg, MESH1, max_seq_len=64, decode_batch=4, block_size=8,
                              kv_dtype="fp32", prefill_chunk=8, rolled_steps=1)
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(0, tcfg.vocab_size, n)) for n in (5, 12, 3, 9)]
    engine = ServingEngine(tparams, tcfg, tplan, serve, device="cpu")
    got = engine.run(Request(rid=f"r{i}", prompt=p, max_new_tokens=6, arrival=2 * i)
                     for i, p in enumerate(prompts))
    for i, p in enumerate(prompts):
        want = greedy_generate(tparams, tcfg, tplan, {"tokens": torch.tensor([p])}, n_steps=6,
                               cache_len=len(p) + 6, cache_dtype=torch.float32, device="cpu")
        assert got[f"r{i}"] == want[0].tolist(), f"request r{i}"


def test_cli_falls_back_to_eager(capsys):
    out = serve_main(["--arch", "rwkv6-1.6b-reduced", "--device", "cpu", "--dtype", "fp32",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    text = capsys.readouterr().out
    assert "falling back to --engine eager" in text
    assert out["tokens"].shape == (2, 3) and out["tok_per_s"] > 0


OTHER_ARCHS = ["recurrentgemma-9b", "paligemma-3b", "whisper-small", "bert-base"]


def _arch_batch(cfg, B, S, seed=0):
    """numpy batch: tokens and the arch's frontend inputs (prefix embeddings
    with a frontend, whisper's empty one included; encoder frames for an
    encoder-decoder), as the launchers build them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend != "none":
        b["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["enc_embeds"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch,untie", [(a, False) for a in OTHER_ARCHS]
                         + [(a, True) for a in ("recurrentgemma-9b", "paligemma-3b",
                                                "bert-base")])
def test_other_archs_greedy_generate_match_jax(arch, untie):
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(
        arch, **({"tie_embeddings": False} if untie else {}))
    b = _arch_batch(tcfg, 2, 12)
    P = tcfg.n_prefix_embeds
    want = jax_greedy_generate(jparams, jcfg, jplan, _jb(b), n_steps=6, cache_len=P + 20,
                               cache_dtype=jnp.float32)
    got = greedy_generate(tparams, tcfg, tplan, _tb(b), n_steps=6, cache_len=P + 20,
                          cache_dtype=torch.float32, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    if not tcfg.tie_embeddings:
        assert len(set(got[0].tolist())) > 1  # not a constant stream
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,S0,T,replace", [
    ("recurrentgemma-9b", 8, 11, {}),
    # decode 20 tokens past the 16-key local window: the ring wraps
    ("recurrentgemma-9b", 4, 24, {}),
    ("paligemma-3b", 8, 11, {}),
    ("whisper-small", 8, 11, {}),
])
def test_other_archs_prefill_decode_matches_full(arch, S0, T, replace):
    """As tests/test_decode.py (which leaves out the encoder-only archs):
    the port's prefill then one-token decode steps equal its full pass
    after the prefix (rel 2e-3), and the full pass equals JAX's (1e-4)."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch, **replace)
    b = _arch_batch(tcfg, 2, T, seed=1)
    P = tcfg.n_prefix_embeds
    tb = _tb(b)
    x_full, _ = forward(tparams, tb, cfg=tcfg, plan=tplan)
    _, pc = forward(tparams, {**tb, "tokens": tb["tokens"][:, :S0]}, cfg=tcfg, plan=tplan,
                    collect_cache=True)
    cache = cache_from_prefill(tcfg, tplan, pc, cache_len=P + T + 2, dtype=torch.float32)
    outs = []
    for t in range(S0, T):
        x1, cache = forward(tparams, {"tokens": tb["tokens"][:, t:t + 1]}, cfg=tcfg,
                            plan=tplan, cache=cache)
        outs.append(t2n(x1[:, 0]))
    assert cache["t"] == P + T
    got, want = np.stack(outs, axis=1), t2n(x_full[:, P + S0:])
    assert _rel(got, want) < 2e-3, f"{arch}: decode diverges from full pass"
    jx, _, _ = jax_forward(jparams, _jb(b), cfg=jcfg, plan=jplan)
    np.testing.assert_allclose(t2n(x_full), np.asarray(jx), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_archs_cache_trees_match_jax(arch):
    """``cache_from_prefill`` builds the JAX tree (keys, shapes, values):
    RG-LRU ``h``/``conv``, ``cross_kv`` and the encoder ``memory``;
    ``init_cache`` has the same keys and shapes."""
    from repro.models.cache import init_cache as jax_init_cache

    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch, n_layers=4)
    b = _arch_batch(tcfg, 2, 6, seed=3)
    P = tcfg.n_prefix_embeds
    _, jpc, _ = jax_forward(jparams, _jb(b), cfg=jcfg, plan=jplan, collect_cache=True)
    jc = jax_cache_from_prefill(jcfg, jplan, jpc, cache_len=P + 9, dtype=jnp.float32)
    _, pc = forward(tparams, _tb(b), cfg=tcfg, plan=tplan, collect_cache=True)
    tc = cache_from_prefill(tcfg, tplan, pc, cache_len=P + 9, dtype=torch.float32)
    assert set(jc) == set(tc) and int(jc["t"]) == tc["t"] == P + 6
    js, ts = _shapes(jc["layers"]), _shapes(tc["layers"])
    assert js == ts
    jl = dict(zip(js, jax.tree.leaves(jc["layers"])))
    for path, leaf in zip(ts, _leaves(tc["layers"])):
        np.testing.assert_allclose(t2n(leaf) if leaf.dtype != torch.int32 else leaf.numpy(),
                                   np.asarray(jl[path]), rtol=1e-4, atol=1e-4, err_msg=str(path))
    if tcfg.enc_dec:
        np.testing.assert_allclose(t2n(tc["memory"]), np.asarray(jc["memory"]), rtol=1e-4,
                                   atol=1e-4)
    jz = jax_init_cache(jcfg, jplan, 2, P + 9, dtype=jnp.float32)
    zero = init_cache(tcfg, tplan, 2, P + 9, dtype=torch.float32, device="cpu")
    assert _shapes(zero["layers"]) == _shapes(jz["layers"]) == ts
    assert set(zero) == set(jz)
    if tcfg.enc_dec:
        assert tuple(zero["memory"].shape) == tuple(jz["memory"].shape)


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_cli_eager_other_archs(arch, capsys):
    """The launcher sends each to the eager engine (the continuous engine
    refuses them) with random frontend inputs, and generates tokens."""
    out = serve_main(["--arch", f"{arch}-reduced", "--device", "cpu", "--dtype", "fp32",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert "falling back to --engine eager" in capsys.readouterr().out
    assert out["tokens"].shape == (2, 3) and out["tok_per_s"] > 0


def test_classifier_cannot_generate():
    """vit-base's logits are (B, n_classes): greedy_generate and the
    launcher's eager path raise a clear error (JAX's run_eager fails with an
    IndexError inside greedy_generate)."""
    _, _, _, tcfg, tplan, tparams = model_pair("vit-base")
    b = _tb(_arch_batch(tcfg, 2, 4))
    with pytest.raises(ValueError, match="classifier"):
        greedy_generate(tparams, tcfg, tplan, b, n_steps=3, cache_len=16, device="cpu")
    with pytest.raises(ValueError, match="classifier"):
        serve_main(["--arch", "vit-base-reduced", "--device", "cpu", "--dtype", "fp32",
                    "--batch", "2", "--prompt-len", "8", "--gen", "3"])

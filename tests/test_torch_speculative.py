"""The port's speculative decoding against the JAX package's.

``prompt_lookup`` / ``NGramDraft`` propose what JAX proposes.  On the same
bridged f32 weights and stream, the port's speculative engine emits the JAX
speculative engine's tokens and counters (draft rows, acceptances,
speculating slot-steps) and its own non-speculative engine's tokens, at
gamma 1, 2 and 4, for the n-gram drafter, the self-drafting ``ModelDraft``
(the target's params: acceptance 1) and a ``ModelDraft`` with independent
weights (JAX's, bridged).  Edge cases: full rejection (pure rollback),
int8 pages, the gather step (``fused=False``), mid-speculation eviction,
slot reuse, a slab too narrow to draft, and a drafter whose ids the target
cannot verify.  ``make_mixed_step``'s verify rows (``vtok``) and the
drafter's plans are held to JAX's."""
import numpy as np
import pytest
import torch

from repro.core.plan import derive_plan
from repro.serve import Request as JaxRequest
from repro.serve import ServingEngine as JaxEngine
from repro.serve.speculative import NGramDraft as JaxNGramDraft
from repro.serve.speculative import make_draft_source as jax_draft_source
from repro.serve.speculative import prompt_lookup as jax_prompt_lookup
from repro_torch.bridge import from_jax
from repro_torch.core.plan import derive_execution_plan
from repro_torch.serve import (
    ModelDraft,
    NGramDraft,
    Request,
    ServingEngine,
    make_draft_source,
    prompt_lookup,
)
from torch_parity import MESH1, model_pair, serve_pair, shared_stats, to_numpy

SPEC_SERVE = {"max_seq_len": 64, "decode_batch": 4}
_MEMO: dict = {}


def _world(arch="smollm-135m"):
    if arch not in _MEMO:
        _MEMO[arch] = model_pair(arch)
    return _MEMO[arch]


def _mixed_prompts(vocab, seed=0, lengths=(5, 8, 12, 12, 3, 9)):
    """Half random, half repetitive (so prompt lookup fires)."""
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]
    for i in range(1, len(prompts), 2):
        pat = prompts[i][:3]
        prompts[i] = (pat * len(prompts[i]))[: len(prompts[i])]
    return prompts


def _requests(R, prompts, gen, stagger=0, pre="r"):
    return [R(rid=f"{pre}{i}", prompt=p, max_new_tokens=gen, arrival=stagger * i)
            for i, p in enumerate(prompts)]


def _drafts(kind, jcfg, jserve, jparams, tcfg, serve, tparams):
    """(JAX draft source, the port's), the same proposals by construction."""
    if kind == "ngram":
        return JaxNGramDraft(), NGramDraft()
    base = tcfg.name[: -len("-reduced")]
    if kind == "self":
        return (jax_draft_source(base, jcfg, jserve, params=jparams, reduced=True),
                make_draft_source(base, tcfg, serve, params=tparams, reduced=True,
                                  device="cpu"))
    jd = jax_draft_source(base, jcfg, jserve, seed=123, reduced=True)
    return jd, make_draft_source(base, tcfg, serve, reduced=True, device="cpu",
                                 params=from_jax(to_numpy(jd.params), device="cpu"))


class _OffByOneDraft:
    """Proposes (last + 1 + i) mod V: random-weight targets repeat tokens,
    so every draft is rejected and the rollback path runs every step."""

    name = "off-by-one"

    def __init__(self, vocab):
        self.vocab = vocab

    def bind_obs(self, obs) -> None:
        pass

    def propose(self, asks):
        return {rid: [(seq[-1] + 1 + i) % self.vocab for i in range(n)]
                for rid, seq, n in asks}


def _plain(prompts, gen, stagger=0, **serve_kw):
    """The port's non-speculative tokens on the stream (computed once)."""
    key = (str(prompts), gen, stagger, str(sorted(serve_kw.items())))
    if key not in _MEMO:
        jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
        _, serve = serve_pair(jcfg, tcfg, **{**SPEC_SERVE, **serve_kw})
        engine = ServingEngine(tparams, tcfg, tplan, serve, device="cpu")
        _MEMO[key] = engine.run(_requests(Request, prompts, gen, stagger))
    return _MEMO[key]


# ---------------------------------------------------------------- drafters
def test_prompt_lookup_matches_jax():
    cases = [([1, 2, 3, 9, 1, 2, 3], 4, [9, 1, 2, 3]), ([5, 1, 2, 7, 1, 2, 8, 1, 2], 1, [8]),
             ([1, 2, 3, 4], 3, []), ([4, 4, 4], 2, [4, 4]), ([4, 4], 2, [4]),
             ([1, 2, 3, 1, 2, 3, 1, 2], 3, [3, 1, 2])]
    for seq, n, want in cases:
        assert prompt_lookup(seq, n) == jax_prompt_lookup(seq, n) == want
    rng = np.random.default_rng(0)
    asks = []
    for i in range(200):
        seq = [int(t) for t in rng.integers(0, 4, int(rng.integers(1, 30)))]
        n, mx = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        assert prompt_lookup(seq, n, max_ngram=mx) == jax_prompt_lookup(seq, n, max_ngram=mx)
        asks.append((f"a{i}", seq, n))
    assert NGramDraft().propose(asks) == JaxNGramDraft().propose(asks)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-1.7b", "qwen3-moe-30b-a3b"])
def test_draft_plans_match_jax(arch):
    """``make_draft_source`` plans with ``derive_execution_plan`` where JAX
    calls ``derive_plan``: the fields the draft step reads agree, reduced
    and at full size."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    for reduced in (True, False):
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        if reduced:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        jplan = derive_plan(jcfg, MESH1, batch=4, seq_len=64, training=False)
        tplan = derive_execution_plan(tcfg)
        assert (tplan.fuse_qkv, tplan.moe_dispatch) == (jplan.fuse_qkv, jplan.moe_dispatch)


def test_draft_serve_plan_matches_jax():
    """The drafter's serve plan has the JAX drafter's geometry."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    jserve, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, spec_len=2, draft="smollm-135m")
    jd = jax_draft_source("smollm-135m", jcfg, jserve, params=jparams, reduced=True)
    td = make_draft_source("smollm-135m", tcfg, serve, params=tparams, reduced=True,
                           device="cpu")
    for f in ("decode_batch", "block_size", "n_blocks", "max_blocks_per_seq", "kv_dtype",
              "prefill_chunk", "mixed_slab_width", "fused_attention", "max_seq_len"):
        assert getattr(td.serve, f) == getattr(jd.serve, f), f
    assert td.plan.fuse_qkv == jd.plan.fuse_qkv


def test_model_draft_weights_from_seed():
    """Draft weights are the port's ``init_params`` drawn from a generator
    seeded ``seed``: the same seed, the same weights; another, others."""
    jcfg, _, _, tcfg, _, _ = _world()
    _, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, spec_len=2)
    mk = lambda seed: make_draft_source("smollm-135m", tcfg, serve, seed=seed,  # noqa: E731
                                        reduced=True, device="cpu")
    a, b, c = mk(3), mk(3), mk(4)
    assert torch.equal(a.params["embed"], b.params["embed"])
    assert not torch.equal(a.params["embed"], c.params["embed"])
    assert make_draft_source("none", tcfg, serve) is None
    assert isinstance(make_draft_source("ngram", tcfg, serve), NGramDraft)


# ------------------------------------------------------------ spec parity
@pytest.mark.parametrize("kind", ["ngram", "self", "independent"])
@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_spec_parity(kind, gamma):
    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    jserve, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, spec_len=gamma,
                               draft="ngram" if kind == "ngram" else "smollm-135m")
    jdraft, draft = _drafts(kind, jcfg, jserve, jparams, tcfg, serve, tparams)
    prompts = _mixed_prompts(tcfg.vocab_size, seed=gamma)
    jeng = JaxEngine(jparams, jcfg, jplan, jserve, draft=jdraft)
    want = jeng.run(_requests(JaxRequest, prompts, 6, stagger=2))
    eng = ServingEngine(tparams, tcfg, tplan, serve, draft=draft, device="cpu")
    got = eng.run(_requests(Request, prompts, 6, stagger=2))
    assert got == want == _plain(prompts, 6, stagger=2)
    assert shared_stats(eng) == shared_stats(jeng)
    s = eng.summary()["spec"]
    assert s["enabled"] and s["spec_len"] == gamma and s["draft_rows"] > 0
    assert eng.iteration == jeng.iteration
    if kind == "self":
        assert s["acceptance_rate"] == 1.0 and s["tokens_per_spec_step"] > 1.0
        assert s["draft_dispatches"]["draft_step"] > 0
    assert eng.dispatch_counts == {"step": eng.stats["dispatches"]}  # rolled is off


@pytest.mark.parametrize("kind", ["ngram", "self"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-30b-a3b"])
def test_spec_parity_archs(arch, kind):
    """The dense and the MoE arch of the chip phases, reduced: gamma 2,
    tokens and counters as JAX's, tokens as the port's plain engine's."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = _world(arch)
    jserve, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, spec_len=2,
                               draft="ngram" if kind == "ngram" else arch)
    jdraft, draft = _drafts(kind, jcfg, jserve, jparams, tcfg, serve, tparams)
    prompts = _mixed_prompts(tcfg.vocab_size, seed=11, lengths=(5, 9, 12, 7))
    jeng = JaxEngine(jparams, jcfg, jplan, jserve, draft=jdraft)
    want = jeng.run(_requests(JaxRequest, prompts, 6, stagger=1))
    eng = ServingEngine(tparams, tcfg, tplan, serve, draft=draft, device="cpu")
    got = eng.run(_requests(Request, prompts, 6, stagger=1))
    _, plain_serve = serve_pair(jcfg, tcfg, **SPEC_SERVE)
    plain = ServingEngine(tparams, tcfg, tplan, plain_serve, device="cpu").run(
        _requests(Request, prompts, 6, stagger=1))
    assert got == want == plain
    assert shared_stats(eng) == shared_stats(jeng) and eng.stats["draft_rows"] > 0


def test_full_rejection_rollback():
    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    jserve, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, spec_len=3)
    prompts = _mixed_prompts(tcfg.vocab_size, seed=2, lengths=(6, 11, 4))
    jeng = JaxEngine(jparams, jcfg, jplan, jserve, draft=_OffByOneDraft(jcfg.vocab_size))
    want = jeng.run(_requests(JaxRequest, prompts, 6))
    eng = ServingEngine(tparams, tcfg, tplan, serve, draft=_OffByOneDraft(tcfg.vocab_size),
                        device="cpu")
    got = eng.run(_requests(Request, prompts, 6))
    assert got == want == _plain(prompts, 6)
    assert shared_stats(eng) == shared_stats(jeng)
    s = eng.summary()
    assert s["spec"]["draft_rows"] > 0 and s["spec"]["acceptance_rate"] == 0.0
    assert s["spec"]["tokens_per_spec_step"] == 1.0
    assert s["generated_tokens"] == 3 * 6 and s["prefill_tokens"] == sum(map(len, prompts))


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_spec_pages_match_spec_off(kv):
    """Draft rows quantize into int8 (or round into bf16) pages as the
    serial path would: speculation keeps the spec-off tokens, as in JAX."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    jserve, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, kv_dtype=kv, spec_len=2,
                               draft="smollm-135m")
    prompts = _mixed_prompts(tcfg.vocab_size, seed=3, lengths=(6, 9, 6))
    jdraft, draft = _drafts("self", jcfg, jserve, jparams, tcfg, serve, tparams)
    want = JaxEngine(jparams, jcfg, jplan, jserve, draft=jdraft).run(
        _requests(JaxRequest, prompts, 5))
    got = ServingEngine(tparams, tcfg, tplan, serve, draft=draft, device="cpu").run(
        _requests(Request, prompts, 5))
    assert got == want == _plain(prompts, 5, kv_dtype=kv)


def test_spec_gather_rung_matches_kernel_path():
    """The gather step (``fused=False``, the ladder's rung 2) verifies the
    same slab with the same tokens and counters."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    _, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, spec_len=2)
    prompts = _mixed_prompts(tcfg.vocab_size, seed=6, lengths=(9, 9, 9))
    runs = []
    for fused in (True, False):
        eng = ServingEngine(tparams, tcfg, tplan, serve, fused=fused, draft=NGramDraft(),
                            device="cpu")
        runs.append((eng.run(_requests(Request, prompts, 5)), shared_stats(eng)))
    assert runs[0] == runs[1] and runs[0][1]["draft_rows"] > 0


# ------------------------------------------------- scheduler edge cases
def test_eviction_mid_speculation_preserves_tokens():
    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    kw = dict(max_seq_len=16, decode_batch=2, block_size=2, prefill_chunk=4, n_blocks=1 + 8)
    jserve, serve = serve_pair(jcfg, tcfg, spec_len=2, draft="smollm-135m", **kw)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size, 4)] for _ in range(2)]
    jdraft, draft = _drafts("self", jcfg, jserve, jparams, tcfg, serve, tparams)
    jeng = JaxEngine(jparams, jcfg, jplan, jserve, draft=jdraft)
    want = jeng.run(_requests(JaxRequest, prompts, 9))
    eng = ServingEngine(tparams, tcfg, tplan, serve, draft=draft, device="cpu")
    got = eng.run(_requests(Request, prompts, 9))
    assert eng.sched.n_evictions == jeng.sched.n_evictions >= 1
    assert got == want and shared_stats(eng) == shared_stats(jeng)


def test_slot_reuse_after_full_rejection():
    jcfg, _, _, tcfg, tplan, tparams = _world()
    _, serve = serve_pair(jcfg, tcfg, max_seq_len=64, decode_batch=2, spec_len=2)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size, 7)] for _ in range(5)]
    eng = ServingEngine(tparams, tcfg, tplan, serve, draft=_OffByOneDraft(tcfg.vocab_size),
                        device="cpu")
    got = eng.run(_requests(Request, prompts, 4))
    assert len(got) == 5 and got == _plain(prompts, 4, decode_batch=2)


@pytest.mark.parametrize("width,gamma,want_gamma", [(1, 4, 0), (3, 8, 2)])
def test_slab_width_bounds_gamma(width, gamma, want_gamma):
    """A slab of width 1 has no room for draft rows (plain decode, no
    deadlock); a width-3 slab leaves gamma 2 of 8."""
    import dataclasses

    jcfg, _, _, tcfg, tplan, tparams = _world()
    _, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, prefill_chunk=width,
                          mixed_slab_width=width, spec_len=gamma)
    assert serve.spec_len == want_gamma  # the plan clamps gamma to the slab
    serve = dataclasses.replace(serve, spec_len=gamma)  # a hand-built hostile plan
    prompts = _mixed_prompts(tcfg.vocab_size, seed=4, lengths=(4, 6))
    eng = ServingEngine(tparams, tcfg, tplan, serve, draft=NGramDraft(), device="cpu")
    got = eng.run(_requests(Request, prompts, 6))
    assert eng.spec_len == want_gamma
    assert (eng.stats["draft_rows"] > 0) == (want_gamma > 0)
    assert got == _plain(prompts, 6, prefill_chunk=width, mixed_slab_width=width)


def test_model_draft_caps_proposals_to_target_vocab():
    jcfg, _, _, tcfg, _, tparams = _world()
    _, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE, spec_len=3)
    draft = make_draft_source("smollm-135m", tcfg, serve, seed=5, reduced=True, device="cpu")
    assert isinstance(draft, ModelDraft)
    draft.target_vocab = 1  # only token 0 is verifiable
    out = draft.propose([("x", [0, 0, 0], 3)])
    assert all(t < 1 for t in out["x"]) and len(out["x"]) <= 3
    draft.target_vocab = tcfg.vocab_size
    assert len(draft.propose([("y", [5, 6, 7], 3)])["y"]) == 3


# ------------------------------------------------------ the verify rows
@pytest.mark.parametrize("spec_width", [1, 3])
def test_mixed_step_vtok_matches_jax(spec_width):
    """One mixed step on the same pools and slab (a prefill chunk, a
    3-row verify chunk, a decode row, an idle slot; NaN poison on slot 2)
    in both packages: the same tok, vtok and finite flags, the same pool
    writes (2e-5), and each vtok row the argmax of logits that agree to
    2e-5."""
    import jax.numpy as jnp

    from repro.models.cache import init_paged_cache as jax_pools
    from repro.models.transformer import forward as jax_forward
    from repro.models.transformer import logits_fn as jax_logits
    from repro.serve.engine import make_mixed_step as jax_step
    from repro_torch.models.cache import init_paged_cache
    from repro_torch.models.transformer import forward, logits_fn
    from repro_torch.serve import make_mixed_step
    from repro_torch.serve.engine import _page_state, _upload

    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    jserve, serve = serve_pair(jcfg, tcfg, **SPEC_SERVE)
    B, W, MB = serve.decode_batch, serve.mixed_slab_width, serve.max_blocks_per_seq
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, tcfg.vocab_size, (B, W)).astype(np.int32)
    kinds = np.array([8, 3, 1, 0], np.int32)
    lens = np.array([0, 10, 21, 0], np.int32)
    tables = np.zeros((B, MB), np.int32)
    for b in range(3):
        tables[b, :4] = 1 + 4 * b + np.arange(4)
    poison = np.array([0, 0, np.nan, 0], np.float32)
    # pools holding the same random K/V in both packages (contexts to read)
    jp = jax_pools(jcfg, jplan, jserve)
    tp = init_paged_cache(tcfg, tplan, serve, "cpu")
    jkv, tkv = jp["layers"]["stack"][0]["paged"], tp["layers"]["stack"][0]["paged"]
    for name in ("k", "v"):
        x = rng.standard_normal(tuple(tkv[name].shape)).astype(np.float32)
        jkv[name] = jnp.asarray(x)
        tkv[name].copy_(torch.from_numpy(x))
    jtok, jvtok, jfin, jp = jax_step(jcfg, jplan, jserve, fused=True, spec_width=spec_width)(
        jparams, jp, jnp.asarray(tokens), jnp.asarray(tables), jnp.asarray(lens),
        jnp.asarray(kinds), jnp.asarray(poison))
    tok, vtok, fin = make_mixed_step(tcfg, tplan, serve, fused=True, spec_width=spec_width)(
        tparams, tp, tokens, tables, lens, kinds, poison)
    live = kinds > 0
    assert np.array_equal(np.asarray(jfin), fin.numpy())
    assert list(fin.numpy()[:3]) == [True, True, False]  # slot 2 poisoned
    keep = live & fin.numpy()
    assert np.array_equal(np.asarray(jtok)[keep], tok.numpy()[keep])
    assert np.array_equal(np.asarray(jvtok)[keep], vtok.numpy()[keep])
    assert vtok.shape == (B, spec_width)
    if spec_width == 1:
        assert torch.equal(vtok[:, 0], tok)
    # the pool writes, every block but the trash block
    jkv, tkv = jp["layers"]["stack"][0]["paged"], tp["layers"]["stack"][0]["paged"]
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy()[:, 1:], np.asarray(jkv[name])[:, 1:],
                                   rtol=2e-5, atol=2e-5)
    # the verify rows' logits: the second pass over the same slab, with the
    # pools the first pass wrote (both packages), agrees to 2e-5
    xj, _, _ = jax_forward(jparams, {"tokens": jnp.asarray(tokens)}, cfg=jcfg, plan=jplan,
                           cache={"layers": jp["layers"], "t": jnp.asarray(lens)},
                           page_state={"block_size": jserve.block_size, "fused": False,
                                       "pages_per_tile": jserve.pages_per_tile,
                                       "table": jnp.asarray(tables),
                                       "q_lens": jnp.asarray(kinds)})
    want = np.asarray(jax_logits(jparams, xj[:, :spec_width], jcfg))
    xt, _ = forward(tparams, {"tokens": _upload(tokens, "cpu")}, cfg=tcfg, plan=tplan,
                    cache={"layers": tp["layers"], "t": _upload(lens, "cpu")},
                    page_state={**_page_state(serve, False, tables, "cpu"),
                                "q_lens": _upload(kinds, "cpu")}, fused=False)
    got = logits_fn(tparams, xt[:, :spec_width], tcfg).numpy()
    for b in np.nonzero(live)[0]:
        rows = min(int(kinds[b]), spec_width)
        np.testing.assert_allclose(got[b, :rows], want[b, :rows], rtol=1e-5, atol=2e-5)

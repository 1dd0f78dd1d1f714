"""The port's ServingEngine (device="cpu") against the JAX ServingEngine on
the same bridged weights and the same Requests: greedy tokens identical for
staggered arrivals, slot reuse, eviction, int8 pages, a sliding window past
its width, the gather path and the rolled decode loop (K=4), mirroring
tests/test_serve_engine.py.  f32 weights; the JAX engine runs its fused
Pallas kernel in interpret mode, the port its plain version on CPU."""
import dataclasses

import numpy as np
import pytest

from repro.core.plan import derive_serve_plan as jax_serve_plan
from repro.serve import Request as JaxRequest
from repro.serve import ServingEngine as JaxEngine
from repro_torch.core.plan import derive_serve_plan
from repro_torch.serve import Request, ServingEngine
from torch_parity import MESH1, model_pair


def _serve_pair(jcfg, tcfg, **kw):
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("decode_batch", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("kv_dtype", "fp32")
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("rolled_steps", 1)
    return jax_serve_plan(jcfg, MESH1, **kw), derive_serve_plan(tcfg, MESH1, **kw)


def _both(arch, prompts, gen, *, stagger=0, n_blocks=None, fused=True, replace=None, **kw):
    """Run one stream through both engines; returns (jax tokens, port
    tokens, port engine)."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch, **(replace or {}))
    jserve, serve = _serve_pair(jcfg, tcfg, **kw)
    if n_blocks is not None:
        jserve = dataclasses.replace(jserve, n_blocks=n_blocks)
        serve = dataclasses.replace(serve, n_blocks=n_blocks)
    jax_engine = JaxEngine(jparams, jcfg, jplan, jserve, fused=fused)
    want = jax_engine.run(
        JaxRequest(rid=f"r{i}", prompt=p, max_new_tokens=gen, arrival=stagger * i)
        for i, p in enumerate(prompts)
    )
    engine = ServingEngine(tparams, tcfg, tplan, serve, fused=fused, device="cpu")
    got = engine.run(
        Request(rid=f"r{i}", prompt=p, max_new_tokens=gen, arrival=stagger * i)
        for i, p in enumerate(prompts)
    )
    assert engine.iteration == jax_engine.iteration
    assert engine.sched.n_evictions == jax_engine.sched.n_evictions
    return want, got, engine


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def test_staggered_mixed_lengths():
    want, got, engine = _both("smollm-135m", _prompts(0, [5, 8, 12, 12, 3, 9]), 6, stagger=2)
    assert got == want and len(got) == 6
    assert engine.summary()["mean_occupancy"] > 0.3


def test_slot_reuse():
    want, got, _ = _both("smollm-135m", _prompts(1, [7] * 5), 4, decode_batch=2)
    assert got == want and len(got) == 5


def test_eviction_preserves_tokens():
    want, got, engine = _both(
        "smollm-135m", _prompts(2, [4, 4]), 9, decode_batch=2, block_size=2,
        prefill_chunk=4, max_seq_len=16, n_blocks=1 + 8,
    )
    assert engine.sched.n_evictions >= 1
    assert got == want


def test_int8_pages():
    want, got, _ = _both("qwen3-1.7b", _prompts(3, [6, 11, 4]), 5, kv_dtype="int8")
    assert got == want


def test_sliding_window_past_its_width():
    """A dense config given SWA layers (window 16) with contexts past the
    window: the port must skip the same oldest keys as the JAX kernel."""
    want, got, _ = _both(
        "smollm-135m", _prompts(5, [20, 7, 25]), 8,
        replace={"layer_pattern": ("swa",), "sliding_window": 16},
    )
    assert got == want


def test_gather_path():
    want, got, _ = _both("qwen3-1.7b", _prompts(6, [9, 9, 9]), 5, fused=False)
    assert got == want


def test_rolled_loop_k4():
    """K=4 rolled spans give the JAX rolled engine's tokens and the port's
    own K=1 tokens, with genuine multi-iteration dispatches."""
    prompts = _prompts(8, [5, 9, 12])
    want, got, engine = _both("smollm-135m", prompts, 8, rolled_steps=4)
    assert got == want
    r = engine.summary()["rolled"]
    assert r["enabled"] and r["dispatches"] >= 1 and r["rolled_steps"] > r["dispatches"]
    _, k1, _ = _both("smollm-135m", prompts, 8, rolled_steps=1)
    assert k1 == got



def _calibration_trace(engine, requests, mixed_of):
    """Step ``engine`` through ``requests``; after each dispatch, (mixed
    dispatches so far, rolled dispatches so far, whether ``sched.step_ms``
    is set)."""
    for r in requests:
        engine.submit(r)
    trace, seen = [], (0, 0)
    while not engine.sched.idle:
        engine.step()
        now = (mixed_of(engine.stats), engine.stats["rolled_dispatches"])
        if now != seen:
            trace.append((*now, engine.sched.step_ms is not None))
            seen = now
    return trace


@pytest.mark.parametrize("rolled_steps", [1, 4])
def test_step_time_calibration_skips_first_dispatch(rolled_steps):
    """``sched.step_ms`` (the EMA behind SLO chunk sizing and retry_after)
    leaves out the first dispatch of each step function in both engines:
    it is None after the first mixed dispatch and set after the second;
    with K=4 the first rolled span leaves it None too when no second mixed
    dispatch came before it."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair("smollm-135m")
    # one 5-token prompt fits one 8-token prefill chunk: one mixed dispatch,
    # then decode (rolled spans with K=4)
    streams = {"single": [[7, 3, 9, 1, 4]], "two": _prompts(9, [12, 5])}
    for name, prompts in streams.items():
        jserve, serve = _serve_pair(jcfg, tcfg, rolled_steps=rolled_steps)
        reqs = [(f"r{i}", p) for i, p in enumerate(prompts)]
        want = _calibration_trace(
            JaxEngine(jparams, jcfg, jplan, jserve),
            [JaxRequest(rid=i, prompt=p, max_new_tokens=9) for i, p in reqs],
            lambda st: st["steps"] - st["rolled_steps"])
        got = _calibration_trace(
            ServingEngine(tparams, tcfg, tplan, serve, device="cpu"),
            [Request(rid=i, prompt=p, max_new_tokens=9) for i, p in reqs],
            lambda st: st["dispatches"] - st["rolled_dispatches"])
        assert got == want, name
        for mixed, rolled, calibrated in got:
            assert calibrated == (mixed >= 2 or rolled >= 2), (name, got)
        if rolled_steps == 1:
            assert got[:2] == [(1, 0, False), (2, 0, True)], (name, got)
        elif name == "single":
            assert got[:3] == [(1, 0, False), (1, 1, False), (1, 2, True)], got


# ------------------------------------------------------------------ MoE
# Reduced MoE configs tie the head; an untied one makes every greedy token
# depend on the whole model (with random weights a tied head repeats the
# last prompt token).
UNTIE = {"tie_embeddings": False}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_staggered_mixed_lengths(arch):
    want, got, _ = _both(arch, _prompts(10, [5, 8, 12, 3, 9]), 6, stagger=2, replace=UNTIE)
    assert got == want and len(got) == 5
    assert any(len(set(t)) > 1 for t in got.values())


@pytest.mark.parametrize("replace", [{}, UNTIE])
def test_moe_sliding_window_past_its_width(replace):
    """tests/test_serve_engine.py:68-82's stream (mixtral-8x7b reduced,
    window 16, contexts past it), tied as there and untied."""
    want, got, _ = _both("mixtral-8x7b", _prompts(5, [20, 7, 25]), 8, replace=replace)
    assert got == want and len(got) == 3


def test_moe_rolled_loop_k4():
    prompts = _prompts(11, [5, 9, 12])
    want, got, engine = _both("qwen3-moe-30b-a3b", prompts, 8, rolled_steps=4,
                              replace=UNTIE)
    assert got == want
    r = engine.summary()["rolled"]
    assert r["dispatches"] >= 1 and r["rolled_steps"] > r["dispatches"]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_capacity_125_slab_rows_compete(arch, monkeypatch):
    """``moe_capacity_factor=1.25`` in both configs: the slab's rows (dead
    ones included) compete for each group's expert slots and choices are
    dropped; the port drops as JAX does, so the tokens stay identical."""
    from repro_torch.models import moe

    dropped = []
    route = moe.gshard_route

    def counting(x, w_router, st):
        combine, aux = route(x, w_router, st)
        dropped.append(x.shape[0] * st.top_k - int((combine > 0).sum()))
        return combine, aux

    monkeypatch.setattr(moe, "gshard_route", counting)
    want, got, _ = _both(arch, _prompts(12, [14, 6, 11, 9]), 6, stagger=1,
                         replace={**UNTIE, "moe_capacity_factor": 1.25})
    assert got == want and len(got) == 4
    assert sum(dropped) > 0

"""Differential trace replay for the port: one seeded multi-tenant trace
through every engine configuration (prefix sharing x speculation gamma x
rolled cap K x KV page dtype, the 16 configurations of
``tests/test_serve_parity.py``), each request's tokens identical to the JAX
package's ``greedy_generate`` on the same weights (bridged, f32).  Half the
rows run with lifecycle tracing on: the exported Chrome trace validates and
the Prometheus text round-trips, and tracing changes no token.

The full matrix is marked ``slow``, as the JAX package's is; the four
configurations with sharing on and gamma 2 (K 1 and 4, int8 and bf16
pages) are not, so a run that deselects slow tests still crosses
speculation with prefix sharing, both K and both page dtypes."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve import greedy_generate as jax_greedy_generate
from repro.serve import make_trace as jax_make_trace
from repro_torch.core.plan import derive_serve_plan
from repro_torch.obs import Observability, prometheus_roundtrip_ok, validate_chrome_trace
from repro_torch.serve import NGramDraft, ServingEngine, make_trace
from torch_parity import MESH1, model_pair

MIX = {"chat": 2, "classify": 2}
MAX_SEQ = 96
TRACE = dict(tenants=2, system_prompt_len=16, stagger=1, seed=5, max_tokens=MAX_SEQ)

AXES = list(itertools.product(
    (False, True),      # prefix sharing
    (0, 2),             # speculation gamma
    (1, 4),             # rolled cap K
    ("int8", "bf16"),   # KV page dtype
))
TIER1 = {a for a in AXES if a[0] and a[1] == 2}
PARAMS = [pytest.param(*a, marks=() if a in TIER1 else pytest.mark.slow) for a in AXES]


@pytest.fixture(scope="module")
def world():
    """The bridged model and the JAX oracle of every trace request."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair("smollm-135m")
    oracle = {}
    for r in jax_make_trace(jcfg, MIX, **TRACE):
        out = jax_greedy_generate(
            jparams, jcfg, jplan, {"tokens": jnp.asarray(r.prompt)[None]},
            n_steps=r.max_new_tokens, cache_len=len(r.prompt) + r.max_new_tokens,
            cache_dtype=jnp.float32,
        )
        oracle[r.rid] = [int(t) for t in np.asarray(out)[0]]
    return tcfg, tplan, tparams, oracle


@pytest.mark.parametrize("sharing,gamma,rolled,kv", PARAMS, ids=lambda v: str(v).lower())
def test_differential_trace_replay(world, sharing, gamma, rolled, kv):
    cfg, plan, params, oracle = world
    serve = derive_serve_plan(
        cfg, MESH1, max_seq_len=MAX_SEQ, decode_batch=3, block_size=8, kv_dtype=kv,
        prefill_chunk=8, prefix_sharing=sharing, draft="ngram" if gamma else "none",
        spec_len=gamma, rolled_steps=rolled,
    )
    obs = Observability(tracing=True) if sharing else None
    engine = ServingEngine(params, cfg, plan, serve, draft=NGramDraft() if gamma else None,
                           obs=obs, device="cpu")
    got = engine.run(make_trace(cfg, MIX, **TRACE))
    for rid, want in oracle.items():
        assert got[rid] == want, (
            f"sharing={sharing} gamma={gamma} K={rolled} kv={kv}: {rid} diverged")
    # each mechanism must have engaged, or the row proves nothing
    if sharing:
        assert engine.sched.n_prefix_hits > 0
    if gamma:
        assert engine.spec_len == gamma and engine.stats["draft_rows"] > 0
        assert set(engine.dispatch_counts) == {"step"}  # the rolled loop is off
    if rolled > 1 and gamma == 0:
        assert engine.rolled_cap == rolled
        assert engine.stats["rolled_steps"] > engine.stats["rolled_dispatches"] >= 1
    if obs is not None:
        events = validate_chrome_trace(obs.tracer.chrome_trace())
        assert any(e["name"] == "request" and e["ph"] == "X" for e in events)
        assert prometheus_roundtrip_ok(obs.metrics)

"""The port's chaos harness and hardened engine against the JAX package's.

* ``FaultInjector``: the same numpy draws as ``repro.serve.faults`` for the
  same seed (transient bursts, NaN masks and rolled-span offsets, pool
  squeezes, spikes, the horizon), and the same knob validation.
* Chaos parity: the JAX engine and the port's (f32, bridged weights, the
  same trace and injector) finish the same requests with the same tokens,
  walk the same ladder rungs iteration by iteration and count the same
  retries, faults, quarantines and poisons, at rolled K 1 and 4; the
  finished tokens are also the port's fault-free run's.
* The ladder: rung 2 (the gather step, ``fused=False``) is reached only
  through the injector's ``TransientDeviceError`` and climbs back; a burst
  past every rung raises ``LadderExhausted`` before any dispatch; a
  failure inside the step function propagates and moves no rung.
* Lifecycle: ``StallError``, ``cancel``, deadlines, ``health()``'s shape
  and ``summary()``'s dispositions, as JAX.
* ``snapshot()`` / ``restore()`` in both directions between the packages:
  plain JSON, identical mid-stream, and either engine resumes the other's
  snapshot with the fault-free tokens."""
import json

import numpy as np
import pytest

from repro.serve import FaultInjector as JaxInjector
from repro.serve import Request as JaxRequest
from repro.serve import ServingEngine as JaxEngine
from repro.serve import make_trace as jax_make_trace
from repro.serve.scheduler import BlockAllocator as JaxAllocator
from repro_torch.serve import (
    LADDER,
    FaultInjector,
    LadderExhausted,
    Request,
    ServingEngine,
    StallError,
    TransientDeviceError,
    make_trace,
)
from repro_torch.serve.scheduler import BlockAllocator
from torch_parity import drive, model_pair, serve_pair, shared_stats

MIX = {"chat": 2, "classify": 2}
_MEMO: dict = {}


def _world():
    if "world" not in _MEMO:
        _MEMO["world"] = model_pair("smollm-135m")
    return _MEMO["world"]


def _traces(cfg_j, cfg_t, *, slo=True):
    """The shared trace in both packages.  Every class of MIX carries a TTFT
    target, so chunk sizing never depends on the measured step time; with
    speculation drafting does (no drafts while an SLO'd prefill is at risk
    at the measured step time), so ``slo=False`` drops the targets where
    the two engines' counters are compared under speculation."""
    kw = dict(tenants=2, system_prompt_len=16, stagger=1, seed=5, max_tokens=96)
    traces = jax_make_trace(cfg_j, MIX, **kw), make_trace(cfg_t, MIX, **kw)
    if not slo:
        for r in traces[0] + traces[1]:
            r.slo_ttft_ms = None
    return traces


def _engines(serve_kw=None, injector=None, *, jax=True):
    """(JAX engine or None, port engine) on the shared weights, each with
    its own copy of ``injector`` (a dict of FaultInjector arguments)."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    jserve, serve = serve_pair(jcfg, tcfg, **(serve_kw or {}))
    inj = injector or {}
    jeng = (JaxEngine(jparams, jcfg, jplan, jserve,
                      injector=JaxInjector(**inj) if inj else None) if jax else None)
    eng = ServingEngine(tparams, tcfg, tplan, serve,
                        injector=FaultInjector(**inj) if inj else None, device="cpu")
    return jeng, eng


def _clean():
    """The port's fault-free tokens on the shared trace."""
    if "clean" not in _MEMO:
        _, eng = _engines(jax=False)
        _MEMO["clean"] = drive(eng, _traces(*[_world()[i] for i in (0, 3)])[1])[0]
    return _MEMO["clean"]


# ------------------------------------------------------------ the injector
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_injector_draws_match_jax(seed):
    kw = dict(transient_rate=0.3, transient_burst=2, nan_rate=0.3, pressure_rate=0.4,
              pressure_frac=0.5, pressure_steps=3, spike_rate=0.2, spike_ms=1.0, horizon=30)
    a, b = FaultInjector(seed, **kw), JaxInjector(seed, **kw)
    alloc_a, alloc_b = BlockAllocator(33), JaxAllocator(33)
    for it in range(40):
        np.testing.assert_array_equal(a.nan_mask(it, 5), b.nan_mask(it, 5))
        np.testing.assert_array_equal(a.nan_in_span(it, 4, 5), b.nan_in_span(it, 4, 5))
        assert a.spike_s(it) == b.spike_s(it)
        for _ in range(3):  # a burst spans attempts
            raised = []
            for inj in (a, b):
                try:
                    inj.check_dispatch(it)
                    raised.append(False)
                except RuntimeError as e:
                    raised.append(type(e).__name__)
            assert raised[0] == raised[1]
        a.pressure(it, alloc_a)
        b.pressure(it, alloc_b)
        assert a.held == b.held and alloc_a.available == alloc_b.available
    assert a.counts == b.counts and a.to_record() == b.to_record()
    assert a.summary() == b.summary()
    assert any(v for v in a.counts.values())
    a.release(alloc_a)
    assert alloc_a.in_use == 0


@pytest.mark.parametrize("bad", [dict(transient_burst=0), dict(nan_rate=1.5),
                                 dict(pressure_rate=-0.1), dict(spike_rate=2.0)])
def test_injector_validates_knobs(bad):
    for Inj in (FaultInjector, JaxInjector):
        with pytest.raises(ValueError, match=next(iter(bad))):
            Inj(0, **bad)


# ---------------------------------------------------------- chaos parity
CHAOS_SPECS = {
    "transient": dict(transient_rate=0.3, transient_burst=2, horizon=20),
    "nan": dict(nan_rate=0.25, horizon=20),
    "pressure": dict(pressure_rate=0.4, pressure_frac=0.4, pressure_steps=3, horizon=20),
    "combined": dict(transient_rate=0.15, transient_burst=2, nan_rate=0.15, pressure_rate=0.25,
                     pressure_frac=0.3, pressure_steps=2, spike_rate=0.2, spike_ms=0.5,
                     horizon=24),
    # one burst past the retry limit: the ladder steps down (to the gather
    # rung from the mixed floor) and climbs back
    "ladder": dict(transient_rate=1.0, transient_burst=4, horizon=1),
}
ENGAGED = {
    "transient": lambda e, inj: e.stats["transient_faults"] >= 1 and e.stats["retries"] >= 1,
    "nan": lambda e, inj: e.stats["quarantines"] >= 1 and e.stats["injected_nans"] >= 1,
    "pressure": lambda e, inj: inj.counts["squeeze"] >= 1,
    "combined": lambda e, inj: sum(inj.counts.values()) >= 2,
    "ladder": lambda e, inj: e.stats["rung_escalations"] >= 1 and e.stats["rung_recoveries"] >= 1,
}


@pytest.mark.parametrize("rolled", (1, 4))
@pytest.mark.parametrize("spec", sorted(CHAOS_SPECS))
def test_chaos_parity_with_jax(spec, rolled):
    serve_kw = {"rolled_steps": rolled, "retry_limit": 2, "ladder_recovery": 3}
    jeng, eng = _engines(serve_kw, dict(seed=11, **CHAOS_SPECS[spec]))
    jtrace, trace = _traces(jeng.cfg, eng.cfg)
    want, want_rungs = drive(jeng, jtrace)
    got, rungs = drive(eng, trace)
    assert got == want
    assert rungs == want_rungs
    assert shared_stats(eng) == shared_stats(jeng)
    assert eng.injector.counts == jeng.injector.counts
    assert ENGAGED[spec](eng, eng.injector), (eng.stats, eng.injector.counts)
    clean = _clean()
    assert all(got[rid] == clean[rid] for rid in got)  # faults change no token
    if spec == "ladder":
        assert max(rungs) == (2 if rolled == 1 else 1)
        assert rungs[-1] == eng._rung_floor
        assert (eng.dispatch_counts.get("fallback_step", 0) >= 1) == (rolled == 1)
    eng.injector.release(eng.sched.alloc)
    assert eng.sched.alloc.in_use == 0, "chaos leaked blocks"
    assert eng.summary()["faults"]["injector"]["injected"] == eng.injector.counts


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-30b-a3b"])
def test_chaos_parity_archs(arch):
    """The combined chaos schedule on the dense and the MoE arch of the chip
    phases, reduced, K 1: the same tokens, rungs and counters as JAX."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair(arch)
    jserve, serve = serve_pair(jcfg, tcfg, rolled_steps=1, retry_limit=2, ladder_recovery=3)
    inj = dict(seed=11, **CHAOS_SPECS["combined"])
    jeng = JaxEngine(jparams, jcfg, jplan, jserve, injector=JaxInjector(**inj))
    eng = ServingEngine(tparams, tcfg, tplan, serve, injector=FaultInjector(**inj),
                        device="cpu")
    jtrace, trace = _traces(jcfg, tcfg)
    want, want_rungs = drive(jeng, jtrace)
    got, rungs = drive(eng, trace)
    assert got == want and rungs == want_rungs
    assert shared_stats(eng) == shared_stats(jeng)
    assert eng.injector.counts == jeng.injector.counts and sum(eng.injector.counts.values()) >= 2


def test_gather_rung_only_through_injected_faults(monkeypatch):
    """A failure inside the step function (what a failed kernel launch
    raises) propagates out of ``step()``: no retry, no rung change, and the
    gather step is never built."""
    _, eng = _engines({"rolled_steps": 1})
    eng.submit(Request(rid="k0", prompt=[1, 2, 3], max_new_tokens=4))

    def failing(*args, **kwargs):
        raise RuntimeError("paged_attention kernel launch failed (code 700)")

    monkeypatch.setattr(eng, "_step", failing)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        eng.step()
    assert eng.rung == 1 and eng._gather is None
    assert eng.stats["retries"] == eng.stats["transient_faults"] == 0
    assert "fallback_step" not in eng.dispatch_counts


def test_ladder_exhausted_raises_with_health():
    """A burst longer than every rung's retry budget raises before any
    device dispatch, in both packages."""
    inj = dict(seed=0, transient_rate=1.0, transient_burst=8, horizon=1)
    jeng, eng = _engines({"rolled_steps": 1, "retry_limit": 2}, inj)
    for e, R in ((jeng, JaxRequest), (eng, Request)):
        e.submit(R(rid="x0", prompt=[1, 2, 3], max_new_tokens=4, arrival=0))
        with pytest.raises(RuntimeError) as ei:
            e.run()
        assert type(ei.value).__name__ == "LadderExhausted"
        assert ei.value.health["rung_name"] == "gather"
        assert e.stats["rung_escalations"] == 1
    assert isinstance(ei.value, LadderExhausted)
    assert eng.dispatch_counts["step"] == 0 == jeng.trace_counts["step"]
    assert jeng.health() == eng.health()


# ------------------------------------------------------------- lifecycle
def test_stall_detector_raises_with_health():
    _, eng = _engines({"stall_limit": 6}, jax=False)
    eng.sched.admit = lambda iteration: None  # wedge admission
    eng.submit(Request(rid="s0", prompt=[1, 2, 3], max_new_tokens=4, arrival=0))
    with pytest.raises(StallError) as ei:
        eng.run()
    h = ei.value.health
    assert h["queue"]["arrived"] == 1 and h["slots"]["running"] == 0
    assert h["rung_name"] in LADDER and eng.iteration == 1 + 6  # first sight + 6 stalls


def test_idle_until_future_arrival_is_not_a_stall():
    _, eng = _engines({"stall_limit": 3, "deadline_ms": 0.0}, jax=False)
    eng.submit(Request(rid="f0", prompt=[1, 2], max_new_tokens=2, arrival=20))
    assert eng.run() == {}
    assert eng.stats["expired"] == 1 and eng.sched.alloc.in_use == 0


def test_submit_validation_names_the_field():
    _, eng = _engines(jax=False)
    vocab = eng.cfg.vocab_size
    for rid, prompt, gen, match in (("v0", [], 4, "prompt must not be empty"),
                                    ("v1", [1], 0, "max_new_tokens"),
                                    ("v2", [1] * 96, 4, "max_seq_len"),
                                    ("v3", [1, vocab], 4, "outside vocab")):
        with pytest.raises(ValueError, match=f"{rid}.*{match}"):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=gen))
    assert not eng.sched.waiting


def test_cancel_and_dispositions_match_jax():
    """cancel(), deadline expiry and admission-starved shedding, accounted
    per tenant in summary() exactly as the JAX engine accounts them."""
    kw = {"admission_patience": 2, "n_blocks": 1 + 2, "block_size": 4}
    jeng, eng = _engines(kw)
    for e, R in ((jeng, JaxRequest), (eng, Request)):
        e.submit(R(rid="x0", prompt=[1] * 9, max_new_tokens=2, arrival=0, tenant="t-shed"))
        e.submit(R(rid="x1", prompt=[1, 2], max_new_tokens=2, arrival=0, tenant="t-exp",
                   deadline_ms=0.0))
        e.submit(R(rid="x2", prompt=[1, 2], max_new_tokens=2, arrival=50, tenant="t-can"))
        assert e.cancel("x2") and not e.cancel("missing")
        assert e.run() == {}
    got, want = eng.summary(), jeng.summary()
    assert got["requests"] == want["requests"] == {
        "finished": 0, "shed": 1, "expired": 1, "cancelled": 1, "poisoned": 0}
    for t in ("t-shed", "t-exp", "t-can"):
        assert {k: got["tenants"][t][k] for k in ("finished", "shed", "expired", "cancelled")} \
            == {k: want["tenants"][t][k] for k in ("finished", "shed", "expired", "cancelled")}
    drop = ("injector",)
    assert {k: v for k, v in got["faults"].items() if k not in drop} == \
        {k: v for k, v in want["faults"].items() if k not in drop}
    assert next(r for r in eng.sched.shed if r.rid == "x0").retry_after_s > 0
    eng.reset_stats()
    assert eng.iteration == 0 and eng.stats["shed"] == 0 and not eng.sched.shed


def test_health_shape_matches_jax():
    jeng, eng = _engines({"rolled_steps": 4})
    for e, R in ((jeng, JaxRequest), (eng, Request)):
        e.submit(R(rid="h0", prompt=[3, 1, 4, 1, 5], max_new_tokens=3, arrival=0))
        e.submit(R(rid="h1", prompt=[2, 7], max_new_tokens=3, arrival=9))
        e.step()
    got, want = eng.health(), jeng.health()
    got_ms, want_ms = got.pop("step_ms"), want.pop("step_ms")
    assert got == want
    assert (got_ms is None) == (want_ms is None)
    assert got["pool"]["available"] + got["pool"]["in_use"] == eng.serve.n_blocks - 1
    assert got["rung_name"] == LADDER[got["rung"]] == "rolled"


# -------------------------------------------------------- snapshot/restore
def _strip(snap: dict, keys) -> dict:
    """A snapshot with only the counters ``keys`` (the JAX engine's), less
    the wall-clock one."""
    return {**snap, "stats": {k: v for k, v in snap["stats"].items()
                              if k in keys and k != "device_s"}}


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_snapshot_restore_across_packages(direction):
    """Both engines stop after the same iterations with identical JSON
    snapshots; a fresh engine of the *other* package restores it and
    finishes every request with the fault-free tokens."""
    jeng, eng = _engines()
    jtrace, trace = _traces(jeng.cfg, eng.cfg)
    for e, tr in ((jeng, jtrace), (eng, trace)):
        for r in tr:
            e.submit(r)
        while e.stats["generated_tokens"] < 5 and not e.sched.idle:
            e.step()
        assert not e.sched.idle, "interrupted too late to be interesting"
    snap_j = json.loads(json.dumps(jeng.snapshot()))
    snap_t = json.loads(json.dumps(eng.snapshot()))
    assert _strip(snap_t, snap_j["stats"]) == _strip(snap_j, snap_j["stats"])
    fresh_j, fresh_t = _engines()
    if direction == "jax->port":
        fresh_t.restore(snap_j)
        got, _ = drive(fresh_t)
    else:
        fresh_j.restore(snap_t)
        got, _ = drive(fresh_j)
    clean = _clean()
    assert set(got) == set(clean)
    assert all(got[rid] == clean[rid] for rid in clean), direction
    with pytest.raises(RuntimeError):  # a used engine refuses restore
        (fresh_t if direction == "jax->port" else fresh_j).restore(snap_j)
    with pytest.raises(ValueError, match="arch"):
        _engines(jax=False)[1].restore(dict(snap_j, arch="not-this-model"))


def test_draft_resyncs_after_quarantine():
    """Speculation under NaN chaos: the model drafter's prefix sync absorbs
    quarantine replays; tokens, counters and rungs match JAX's engine with
    the same (bridged) draft weights."""
    from repro.serve.speculative import make_draft_source as jax_draft_source
    from repro_torch.bridge import from_jax
    from repro_torch.serve import make_draft_source
    from torch_parity import to_numpy

    jcfg, jplan, jparams, tcfg, tplan, tparams = _world()
    jserve, serve = serve_pair(jcfg, tcfg, rolled_steps=1, draft="smollm-135m", spec_len=2)
    jdraft = jax_draft_source("smollm-135m", jcfg, jserve, seed=3, reduced=True)
    draft = make_draft_source("smollm-135m", tcfg, serve, reduced=True, device="cpu",
                              params=from_jax(to_numpy(jdraft.params), device="cpu"))
    inj = dict(seed=5, nan_rate=0.3, horizon=16)
    jeng = JaxEngine(jparams, jcfg, jplan, jserve, draft=jdraft, injector=JaxInjector(**inj))
    eng = ServingEngine(tparams, tcfg, tplan, serve, draft=draft, injector=FaultInjector(**inj),
                        device="cpu")
    jtrace, trace = _traces(jcfg, tcfg, slo=False)
    want, want_rungs = drive(jeng, jtrace)
    got, rungs = drive(eng, trace)
    assert got == want and rungs == want_rungs
    assert shared_stats(eng) == shared_stats(jeng)
    clean = _clean()
    assert all(got[rid] == clean[rid] for rid in got)
    assert eng.stats["quarantines"] >= 1 and eng.stats["draft_rows"] > 0


def test_transient_error_type_is_the_injectors():
    inj = FaultInjector(0, transient_rate=1.0, transient_burst=3, horizon=1)
    for _ in range(3):
        with pytest.raises(TransientDeviceError):
            inj.check_dispatch(0)
    inj.check_dispatch(0)  # the burst is spent
    assert inj.counts["transient"] == 3

"""The port's ``repro_torch.obs`` against ``repro.obs``: the metrics
registry, the tracer, the drift meter and ``step_time_model`` fed the same
event sequence give the same exposition, trace, report and prices (the
H100 constants in a JAX ``HardwareSpec``); a port engine run emits the
same counters and gauges as the JAX engine on the same stream and bridged
weights (f32), its metrics agree with its ``summary()``, its Chrome trace
validates with complete request lifecycles, tracing leaves its tokens
alone, and its fault events carry the injector's (seed, salt, iteration)
key exactly as the JAX engine's do.  The launcher's observability and
chaos flags map as ``ServeArgs`` maps them."""
import dataclasses
import json
import math

import pytest

from repro.core.hardware import HardwareSpec as JaxHardwareSpec
from repro.core.plan import derive_serve_plan as jax_serve_plan
from repro.obs import Observability as JaxObservability
from repro.obs.calibrate import DriftMeter as JaxDriftMeter
from repro.obs.calibrate import step_time_model as jax_step_time_model
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.obs.trace import Tracer as JaxTracer
from repro.serve import FaultInjector as JaxInjector
from repro.serve import ServingEngine as JaxEngine
from repro.serve.scheduler import random_stream as jax_stream
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.plan import derive_serve_plan
from repro_torch.obs import (
    PID_ENGINE,
    DriftMeter,
    MetricsRegistry,
    Observability,
    Tracer,
    parse_prometheus_text,
    prometheus_roundtrip_ok,
    step_time_model,
    validate_chrome_trace,
)
from repro_torch.serve import FaultInjector, ServingEngine, random_stream
from torch_parity import MESH1, model_pair

# the port's H100 entry spelled as the JAX package's HardwareSpec
JAX_H100 = JaxHardwareSpec(**{f.name: getattr(H100_SXM, f.name)
                              for f in dataclasses.fields(H100_SXM)})


# ---------------------------------------------------------------- metrics
def _fill_registry(reg):
    c = reg.counter("reqs_total", "requests", ("tenant",))
    c.inc(tenant="a")
    c.inc(2, tenant="b")
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.set(3)
    h = reg.histogram("lat_ms", "latency", ("tenant",))
    for v in (0.4, 12.0, 1e9, 0.5, 5000.0):  # edges, and past the last bucket
        h.observe(v, tenant="a")
    h.observe(3.25, tenant='a"b\nc\\d')  # escaped label values round-trip
    return reg


def test_metrics_registry_matches_jax():
    got, want = _fill_registry(MetricsRegistry()), _fill_registry(JaxRegistry())
    assert got.to_prometheus() == want.to_prometheus()
    assert got.snapshot() == want.snapshot()
    assert got.flat_samples() == want.flat_samples()
    assert prometheus_roundtrip_ok(got)
    parsed = parse_prometheus_text(got.to_prometheus())
    assert parsed[("reqs_total", (("tenant", "b"),))] == 2
    assert parsed[("lat_ms_count", (("tenant", "a"),))] == 5
    assert parsed[("lat_ms_bucket", (("le", "+Inf"), ("tenant", "a")))] == 5


@pytest.mark.parametrize("bad", ["type", "labels", "name", "negative"])
def test_metrics_registry_rejects_mismatches(bad):
    for reg in (MetricsRegistry(), JaxRegistry()):
        reg.counter("x_total", "x")
        assert reg.counter("x_total", "x") is reg.counter("x_total", "x")
        with pytest.raises(ValueError):
            {"type": lambda: reg.gauge("x_total", "x"),
             "labels": lambda: reg.counter("x_total", "x", ("tenant",)),
             "name": lambda: reg.counter("bad name", "x"),
             "negative": lambda: reg.counter("x_total").inc(-1)}[bad]()


# ---------------------------------------------------------------- tracer
def _fill_tracer(tr, base=100.0):
    tr._t0 = base  # both tracers on one clock origin
    for i in range(10):
        tr.instant(f"e{i}", PID_ENGINE, 0, base + i * 1e-3, {"i": i})
    tr.complete("step", PID_ENGINE, 0, base + 0.002, base + 0.004, {"rows": 3})
    tr.request_span("decode", "r1", base + 0.003, base + 0.005, {"pos": 9})
    tr.request_instant("finished", "r1", base + 0.006)
    tr.complete("backwards", PID_ENGINE, 0, base + 0.009, base + 0.008)  # dur clamps to 0
    return tr


@pytest.mark.parametrize("buffer", [4, 64])
def test_tracer_matches_jax(buffer):
    got = _fill_tracer(Tracer(buffer=buffer)).chrome_trace()
    want = _fill_tracer(JaxTracer(buffer=buffer)).chrome_trace()
    assert got == want
    events = validate_chrome_trace(got)
    assert len(events) == min(buffer, 14)
    assert got["otherData"]["dropped_events"] == max(0, 14 - buffer)


def test_tracer_disabled_is_noop():
    tr = Tracer(enabled=False)
    tr.instant("x", PID_ENGINE, 0, 1.0)
    tr.complete("y", PID_ENGINE, 0, 1.0, 2.0)
    tr.request_span("z", "r0", 1.0, 2.0)
    assert len(validate_chrome_trace(tr.chrome_trace())) == 0
    with pytest.raises(AssertionError):  # the validator rejects time going back
        validate_chrome_trace({"traceEvents": [
            {"name": "a", "ph": "i", "pid": 1, "tid": 0, "ts": 5.0},
            {"name": "b", "ph": "i", "pid": 1, "tid": 0, "ts": 4.0}]})


# ------------------------------------------------------------ drift meter
@pytest.mark.parametrize("keep", [3, 2048])
def test_drift_meter_matches_jax(keep):
    got, want = DriftMeter(ewma_alpha=0.25, keep=keep), JaxDriftMeter(ewma_alpha=0.25, keep=keep)
    assert got.report() == want.report() and got.empty
    for i in range(7):
        for dm in (got, want):
            dm.record("decode", predicted_s=1e-3 * (i + 1), measured_s=2e-3 + 1e-4 * i)
            if i % 3 == 0:
                dm.record("prefill", predicted_s=2e-3, measured_s=1e-3 * (i + 1))
    assert got.report() == want.report()
    rep = got.report()
    assert rep["phases"]["prefill"]["n"] == 3 and "roofline" in rep["note"]
    with pytest.raises(ValueError):
        DriftMeter(ewma_alpha=0.0)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-1.7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("fused", [True, False])
def test_step_time_model_matches_jax(arch, fused):
    """The full configs' roofline constants and prices, on the H100 entry."""
    from repro.configs import get_config as jax_get_config

    cfg, jcfg = get_config(arch), jax_get_config(arch)
    serve = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=2048)
    jserve = jax_serve_plan(jcfg, MESH1, JAX_H100, max_seq_len=2048)
    m = step_time_model(cfg, serve, H100_SXM, fused=fused)
    want = jax_step_time_model(jcfg, jserve, JAX_H100, fused=fused)
    assert dataclasses.asdict(m) == dataclasses.asdict(want)
    assert H100_SXM.ici_bandwidth == JAX_H100.ici_bandwidth == 0.0
    for rows, ctx, k in ((1, 64, 1), (256, 65536, 1), (40, 4096, 4), (65536, 500_000, 1)):
        assert m.predict_s(rows, ctx, k=k) == want.predict_s(rows, ctx, k=k)
    one = m.predict_s(1, 64)
    assert math.isfinite(one) and one > 0
    assert m.predict_s(1, 64, k=1) < m.predict_s(1, 64, k=4) < 4 * one  # one overhead a span


# ---------------------------------------------------- engine integration
def _serve_pair(jcfg, tcfg, **kw):
    kw = {"max_seq_len": 64, "decode_batch": 3, "block_size": 8, "prefill_chunk": 8,
          "mixed_slab_width": 8, "rolled_steps": 4, "kv_dtype": "fp32",
          "retry_backoff_s": 0.0, **kw}
    return jax_serve_plan(jcfg, MESH1, **kw), derive_serve_plan(tcfg, MESH1, **kw)


def _counters(snapshot: dict) -> dict:
    """Every counter and gauge sample (histograms hold wall times)."""
    return {(name, json.dumps(s["labels"], sort_keys=True)): s["value"]
            for name, m in snapshot.items() if m["type"] != "histogram"
            for s in m["samples"]}


@pytest.fixture(scope="module")
def obs_run():
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair("smollm-135m")
    jserve, serve = _serve_pair(jcfg, tcfg)
    jobs = JaxObservability(tracing=True)
    jax_engine = JaxEngine(jparams, jcfg, jplan, jserve, obs=jobs)
    want = jax_engine.run(jax_stream(jcfg, 5, 8, 10, stagger=1, seed=11))
    obs = Observability(tracing=True)
    engine = ServingEngine(tparams, tcfg, tplan, serve, obs=obs, device="cpu")
    out_on = engine.run(random_stream(tcfg, 5, 8, 10, stagger=1, seed=11))
    plain = ServingEngine(tparams, tcfg, tplan, serve, device="cpu")
    out_off = plain.run(random_stream(tcfg, 5, 8, 10, stagger=1, seed=11))
    return engine, plain, obs, out_on, out_off, want, jobs


def test_obs_parity_with_jax_engine(obs_run):
    engine, plain, obs, out_on, out_off, want, jobs = obs_run
    assert out_on == out_off == want, "observability changed the engine's tokens"
    assert engine.dispatch_counts == plain.dispatch_counts
    assert _counters(obs.metrics.snapshot()) == _counters(jobs.metrics.snapshot())
    # the same dispatches, by kind and phase, in the step-time histogram
    got = {(n, s["labels"]["phase"]): s["count"]
           for n, m in obs.metrics.snapshot().items() if n == "serve_step_ms"
           for s in m["samples"]}
    assert got == {(n, s["labels"]["phase"]): s["count"]
                   for n, m in jobs.metrics.snapshot().items() if n == "serve_step_ms"
                   for s in m["samples"]}
    # and the same trace events, but for wall times
    names = lambda o: sorted((e["name"], e["pid"]) for e in  # noqa: E731
                             validate_chrome_trace(o.tracer.chrome_trace()))
    assert names(obs) == names(jobs)


def test_golden_chrome_trace(obs_run, tmp_path):
    engine, _, obs, out_on, _, _, _ = obs_run
    path = tmp_path / "trace.json"
    n = obs.tracer.write(str(path))
    events = validate_chrome_trace(json.loads(path.read_text()))
    assert len(events) == n > 0
    names = {e["name"] for e in events}
    for required in ("queued", "admitted", "first-token", "finished", "request",
                     "prefill-chunk", "step", "rolled_step"):
        assert required in names, f"missing {required!r} in {sorted(names)}"
    reqs = [e for e in events if e.get("pid") == 2]
    assert reqs and all("rid" in e.get("args", {}) for e in reqs)
    steps = [e for e in events if e["name"] in ("step", "rolled_step") and e["ph"] == "X"]
    t_lo, t_hi = min(e["ts"] for e in steps), max(e["ts"] + e["dur"] for e in steps)
    fin = [e for e in events if e["name"] == "finished"]
    assert fin and all(t_lo <= e["ts"] <= t_hi + 1e6 for e in fin)


def test_metrics_agree_with_summary(obs_run):
    engine, _, obs, out_on, _, _, _ = obs_run
    s = engine.summary()
    m = obs.metrics.snapshot()

    def total(name, **labels):
        return sum(x["value"] for x in m[name]["samples"]
                   if all(x["labels"].get(k) == v for k, v in labels.items()))

    assert total("serve_requests_submitted_total") == len(out_on)
    assert total("serve_requests_finished_total", status="ok") == s["requests"]["finished"]
    assert total("serve_tokens_total", kind="generated") == s["generated_tokens"]
    assert total("serve_tokens_total", kind="prefill") == s["prefill_tokens"]
    # the steps counter counts dispatches (a rolled span is one)
    assert total("serve_steps_total") == s["dispatches"] == sum(s["dispatch_counts"].values())
    assert total("serve_steps_total", kind="rolled_step") == s["rolled"]["dispatches"] >= 1
    assert total("serve_admissions_total") == s["prefix"]["admissions"]
    assert total("serve_rung") == s["faults"]["rung"]
    assert total("serve_blocks_in_use") == 0 and total("serve_queue_depth") == 0
    assert prometheus_roundtrip_ok(obs.metrics)


def test_calibration_finite_for_both_phases(obs_run):
    engine, plain, _, _, _, _, _ = obs_run
    cal = engine.summary()["calibration"]
    for phase in ("prefill", "decode"):
        rep = cal["phases"].get(phase)
        assert rep is not None and rep["n"] >= 1, f"no {phase} dispatch calibrated"
        assert all(v is not None and math.isfinite(v) for v in rep.values()), (phase, rep)
    # each step function's first dispatch is left out of the drift meter
    assert sum(p["n"] for p in cal["phases"].values()) == engine.stats["dispatches"] - 2
    assert math.isfinite(cal["overall_ratio"]) and cal["overall_ratio"] > 0 and cal["note"]
    # the default bundle: metrics + drift on, tracer off and empty
    assert plain.obs.tracer.enabled is False and not plain.obs.drift.empty
    assert len(validate_chrome_trace(plain.obs.tracer.chrome_trace())) == 0


def test_fault_events_match_jax():
    """A chaos run traces the same fault instants, with the same
    determinism keys, in both packages."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair("smollm-135m")
    jserve, serve = _serve_pair(jcfg, tcfg, decode_batch=2, rolled_steps=1)
    runs = []
    for Engine, Obs, Inj, stream, params, cfg, plan, sp, dev in (
        (JaxEngine, JaxObservability, JaxInjector, jax_stream, jparams, jcfg, jplan, jserve, {}),
        (ServingEngine, Observability, FaultInjector, random_stream, tparams, tcfg, tplan, serve,
         {"device": "cpu"}),
    ):
        obs = Obs(tracing=True)
        inj = Inj(3, transient_rate=0.2, nan_rate=0.1, pressure_rate=0.1, horizon=30)
        engine = Engine(params, cfg, plan, sp, injector=inj, obs=obs, **dev)
        out = engine.run(stream(cfg, 3, 8, 8, stagger=1, seed=2))
        faults = [(e["name"], e["args"]) for e in validate_chrome_trace(obs.tracer.chrome_trace())
                  if e["name"].startswith("fault:")]
        runs.append((out, faults, dict(inj.counts)))
    assert runs[0] == runs[1]
    out, faults, counts = runs[1]
    assert {n for n, _ in faults} >= {"fault:transient", "fault:nan"}
    assert all(a["seed"] == 3 and a["salt"] in (1, 2, 3, 4) and a["iteration"] >= 0
               for _, a in faults)


# ------------------------------------------------------------- launcher
def test_launcher_flags_map_as_serve_args():
    """The observability, speculation and chaos flags reach the plan, the
    injector and the bundle as ``repro.launch.serve.ServeArgs`` sends them."""
    from repro.launch.serve import ServeArgs
    from repro.launch.serve import build_parser as jax_parser
    from repro_torch.launch.serve import build_parser, make_injector, plan_overrides

    argv = ["--arch", "qwen3-1.7b", "--draft", "ngram", "--spec-len", "3", "--retry-limit", "5",
            "--stall-limit", "40", "--chaos-seed", "7", "--chaos-transient", "0.1",
            "--chaos-burst", "4", "--chaos-nan", "0.02", "--chaos-pressure", "0.3",
            "--chaos-spike-ms", "2.5", "--chaos-horizon", "90", "--metrics-out", "m.prom",
            "--trace-out", "t.json", "--trace-buffer", "128"]
    a = build_parser().parse_args(argv)
    ja = ServeArgs.from_namespace(jax_parser().parse_args(argv))
    want = ja.plan_overrides()
    want.pop("pages_per_tile")  # the CUDA kernels have no page-tile schedule
    assert plan_overrides(a) == want
    assert make_injector(a).to_record() == ja.make_injector().to_record()
    assert (a.metrics_out, a.trace_out, a.trace_buffer) == ("m.prom", "t.json", 128)
    a0 = build_parser().parse_args(["--arch", "qwen3-1.7b"])
    assert make_injector(a0) is None and plan_overrides(a0)["draft"] == "none"


def test_launcher_writes_metrics_and_trace(tmp_path):
    """A CPU run of the launcher with chaos and n-gram speculation writes a
    Prometheus exposition that parses back and a Chrome trace that
    validates."""
    from repro_torch.launch.serve import main

    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    summary = main(["--arch", "smollm-135m-reduced", "--device", "cpu", "--dtype", "fp32",
                    "--requests", "3", "--prompt-len", "8", "--gen", "5", "--max-seq", "64",
                    "--fix-batch", "--batch", "2", "--prefill-chunk", "8", "--draft", "ngram",
                    "--spec-len", "2", "--chaos-seed", "1", "--chaos-nan", "0.05",
                    "--metrics-out", str(prom), "--trace-out", str(trace)])
    assert summary["requests"]["finished"] == 3 and summary["spec"]["enabled"]
    assert summary["faults"]["injector"]["spec"]["seed"] == 1
    parsed = parse_prometheus_text(prom.read_text())
    assert parsed[("serve_requests_finished_total",
                   (("status", "ok"), ("tenant", "default")))] == 3
    assert any(e["name"] == "request" for e in validate_chrome_trace(json.loads(trace.read_text())))

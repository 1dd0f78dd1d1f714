"""The port's multi-tenant trace workloads (``serve/workload.py``), the
engine's per-tenant summary and the launcher's trace and plan flags,
against the JAX package on the CPU: ``parse_mix``, ``make_trace`` (field for
field with JAX's ``Request``s) and ``per_class_report``; the trace replayed
on the port's engine (tokens identical with prefix sharing on and off and
to the JAX engine's, prefix hits, both tenants, every class); the flags
mapped onto ``derive_serve_plan`` as ``ServeArgs.plan_overrides`` maps
them; and the CLI replaying a trace on a reduced MoE arch."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.plan import derive_serve_plan as jax_serve_plan
from repro.launch.serve import ServeArgs
from repro.launch.serve import build_parser as jax_parser
from repro.serve import Request as JaxRequest
from repro.serve import ServingEngine as JaxEngine
from repro.serve import make_trace as jax_make_trace
from repro.serve import parse_mix as jax_parse_mix
from repro.serve import per_class_report as jax_report
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.plan import derive_serve_plan
from repro_torch.launch.serve import build_parser, main, plan_overrides, request_stream
from repro_torch.serve import (
    WORKLOADS,
    Request,
    ServingEngine,
    make_trace,
    parse_mix,
    per_class_report,
)
from torch_parity import MESH1, model_pair

REQUEST_FIELDS = ("rid", "prompt", "max_new_tokens", "arrival", "tenant", "priority",
                  "slo_ttft_ms", "tag", "deadline_ms")


def _record(r) -> tuple:
    return tuple((f, [int(t) for t in r.prompt] if f == "prompt" else getattr(r, f))
                 for f in REQUEST_FIELDS)


@pytest.mark.parametrize("spec", ["chat:4,summarize:2", "classify", "chat:1, chat:2,,",
                                  "classify:8,chat:4,summarize:2"])
def test_parse_mix_matches_jax(spec):
    assert parse_mix(spec) == jax_parse_mix(spec)


@pytest.mark.parametrize("spec", ["nosuch:3", "", " , "])
def test_parse_mix_rejects_as_jax(spec):
    with pytest.raises(ValueError):
        parse_mix(spec)
    with pytest.raises(ValueError):
        jax_parse_mix(spec)


def test_workload_classes_are_copies():
    from repro.serve import WORKLOADS as JAX_WORKLOADS

    assert {k: dataclasses.asdict(v) for k, v in WORKLOADS.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_WORKLOADS.items()}
    for name, wc in WORKLOADS.items():
        for m in (64, 512, 2048):
            assert dataclasses.asdict(wc.scaled(m)) == dataclasses.asdict(
                JAX_WORKLOADS[name].scaled(m))


@pytest.mark.parametrize("arch,mix,kw", [
    ("smollm-135m-reduced", {"chat": 3, "classify": 3},
     dict(tenants=2, system_prompt_len=16, stagger=2, seed=0, max_tokens=64)),
    ("qwen3-moe-30b-a3b", {"classify": 8, "chat": 4, "summarize": 2},
     dict(tenants=2, stagger=1, seed=1, max_tokens=512)),
    ("qwen3-1.7b", {"summarize": 2, "chat": 5}, dict(tenants=3, seed=7)),
])
def test_make_trace_matches_jax_field_for_field(arch, mix, kw):
    mine = make_trace(get_config(arch), mix, **kw)
    theirs = jax_make_trace(jax_get_config(arch), mix, **kw)
    assert [_record(r) for r in mine] == [_record(r) for r in theirs]
    assert all(isinstance(r, Request) for r in mine)
    assert {r.tenant for r in mine} == {f"tenant{t}" for t in range(kw["tenants"])}


def test_per_class_report_matches_jax():
    """The same finished requests (tags, outputs, admit/first/done times)
    give JAX's table, empty samples included."""
    rng = np.random.default_rng(0)
    mine, theirs = [], []
    for i, tag in enumerate(["chat", "chat", "classify", "", "summarize", "chat"]):
        t0 = float(rng.uniform(1, 2))
        times = dict(t_admit=t0, t_first=t0 + float(rng.uniform(0.01, 0.1)),
                     t_done=t0 + float(rng.uniform(0.2, 1.0)))
        if i == 4:
            times["t_first"] = None  # no TTFT sample
        out = [int(t) for t in rng.integers(0, 50, int(rng.integers(1, 6)))]
        for cls, lst in ((Request, mine), (JaxRequest, theirs)):
            r = cls(rid=f"r{i}", prompt=[1, 2], max_new_tokens=8, tag=tag)
            r.out = list(out)
            for k, v in times.items():
                setattr(r, k, v)
            lst.append(r)
    assert per_class_report(mine) == jax_report(theirs)
    assert set(per_class_report(mine)) == {"chat", "classify", "summarize", "untagged"}


def test_trace_replay_engine_parity_and_report():
    """tests/test_multitenant.py's end-to-end replay on the port's engine:
    tokens identical with prefix sharing on and off and to the JAX
    engine's, prefix hits from the shared system prompts, both tenants in
    the summary, every class in the report."""
    jcfg, jplan, jparams, tcfg, tplan, tparams = model_pair("smollm-135m")
    kw = dict(max_seq_len=64, decode_batch=4, block_size=8, kv_dtype="fp32", prefill_chunk=8)
    serve = derive_serve_plan(tcfg, MESH1, **kw)
    mix = {"chat": 3, "classify": 2}
    trace_kw = dict(tenants=2, system_prompt_len=24, stagger=1, seed=3, max_tokens=64)
    outs = {}
    for sharing in (True, False):
        eng = ServingEngine(tparams, tcfg, tplan,
                            dataclasses.replace(serve, prefix_sharing=sharing), device="cpu")
        outs[sharing] = eng.run(make_trace(tcfg, mix, **trace_kw))
        if sharing:
            summ = eng.summary()
            assert summ["prefix"]["hits"] > 0
            assert set(summ["tenants"]) == {"tenant0", "tenant1"}
            assert sum(t["finished"] for t in summ["tenants"].values()) == 5
            assert all(t["latency_s"]["n"] == t["finished"] and t["shed"] == 0
                       for t in summ["tenants"].values())
            report = per_class_report(eng.sched.finished)
            assert set(report) == set(mix)
            assert all(v["count"] == mix[k] for k, v in report.items())
    assert outs[True] == outs[False]
    jax_engine = JaxEngine(jparams, jcfg, jplan, jax_serve_plan(jcfg, MESH1, **kw))
    assert jax_engine.run(jax_make_trace(jcfg, mix, **trace_kw)) == outs[True]
    assert set(jax_engine.summary()["tenants"]) == set(summ["tenants"])


ARGV = ["--arch", "smollm-135m", "--fix-batch", "--batch", "4", "--max-seq", "128",
        "--slab-width", "16", "--no-fused", "--kv-dtype", "int8", "--no-prefix-sharing",
        "--slo-ttft-ms", "250", "--deadline-ms", "1500", "--rolled-steps", "2",
        "--prefill-chunk", "8"]


def test_flags_map_onto_the_plan_as_serve_args():
    """tests/test_multitenant.py's ServeArgs mapping, for the flags the port
    has: the same keywords with the same values, and the same plan."""
    mine = plan_overrides(build_parser().parse_args(ARGV))
    theirs = ServeArgs.from_namespace(jax_parser().parse_args(ARGV)).plan_overrides()
    assert mine == {k: theirs[k] for k in mine}
    assert set(theirs) - set(mine) == {"pages_per_tile"}
    sp = derive_serve_plan(get_config("smollm-135m"), MESH1, H100_SXM, **mine)
    assert sp.decode_batch == 4 and sp.kv_dtype == "int8"
    assert not sp.prefix_sharing and sp.slo_ttft_ms == 250.0
    assert sp.mixed_slab_width == 16 and not sp.fused_attention
    assert sp.deadline_ms == 1500.0 and sp.rolled_steps == 2
    defaults = plan_overrides(build_parser().parse_args(["--arch", "qwen3-1.7b"]))
    assert defaults["prefix_sharing"] and defaults["slo_ttft_ms"] is None


def test_request_stream_replays_the_trace_as_jax():
    argv = ["--arch", "smollm-135m", "--replay-trace", "chat:2,classify:1", "--tenant-mix",
            "3", "--stagger", "3", "--max-seq", "256"]
    a = build_parser().parse_args(argv)
    assert (a.replay_trace, a.tenant_mix) == ("chat:2,classify:1", 3)
    mine = request_stream(a, get_config("smollm-135m"))
    theirs = ServeArgs.from_namespace(jax_parser().parse_args(argv)).request_stream(
        jax_get_config("smollm-135m"))
    assert [_record(r) for r in mine] == [_record(r) for r in theirs]
    assert len(mine) == 3 and len({r.tenant for r in mine}) == 3
    plain = request_stream(build_parser().parse_args(["--arch", "smollm-135m"]),
                           get_config("smollm-135m"))
    assert len(plain) == 8 and {r.tenant for r in plain} == {"default"}


def test_cli_replays_a_trace_on_a_moe_arch(capsys):
    """``--replay-trace`` on reduced qwen3-moe-30b-a3b serves through the
    continuous engine (no eager fallback) and prints tenants and classes."""
    out = main(["--arch", "qwen3-moe-30b-a3b-reduced", "--device", "cpu", "--dtype", "fp32",
                "--replay-trace", "classify:2,chat:1", "--max-seq", "96", "--fix-batch",
                "--batch", "2", "--stagger", "1"])
    text = capsys.readouterr().out
    assert "falling back" not in text and '"classes"' in text
    assert out["requests"]["finished"] == 3
    assert set(out["tenants"]) == {"tenant0", "tenant1"}
    assert set(out["classes"]) == {"chat", "classify"}
    assert out["prefix"]["enabled"]

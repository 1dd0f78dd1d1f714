"""A whole run of each cell on the CPU at a small size, with the port in
float32: it comes out correct, and with the timed path broken underneath
it comes out not correct, once for each fault the cell can have.  Also
the data-driven layout and the import guard."""
import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from bench.portbench import guard, spec
from bench.portbench import run as R

SEED = 4_000_000_123
ROOT = spec.ROOT
# untied, and wide enough that the layers and not the input token's own
# embedding decide the logits (a tied toy decoder mostly repeats its input)
QWEN = dict(n_layers=2, d_model=256, n_heads=8, n_kv_heads=4, d_head=32, d_ff=768,
            vocab_size=1024, tie_embeddings=False)
RWKV = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, rnn_heads=2, d_ff=128,
            vocab_size=512)
SMALL_TRAFFIC = {
    "closed_loop": dict(clients=4, prefix_len=16, body_len={"dist": "loguniform", "lo": 8, "hi": 40},
                        output_len={"dist": "loguniform", "lo": 8, "hi": 24}, check_requests=4),
    "open_loop": dict(rate_per_s=40.0, preroll_s=0.5, prefix_len=16,
                      body_len={"dist": "loguniform", "lo": 8, "hi": 60},
                      output_len={"dist": "loguniform", "lo": 8, "hi": 24}, check_requests=6),
    "train_batches": dict(batch=2, seq_len=32),
}


def small(name: str):
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, dtype="fp32")
    cell.traffic = dict(cell.traffic, **SMALL_TRAFFIC[cell.traffic["kind"]])
    return cell


def run_small(name: str, fault=None):
    cell = small(name)
    dev = torch.device("cpu")
    if cell.kind == "serve":
        out = R.serve_cell(cell, SEED, 3.0, False, dev, arch_overrides=QWEN,
                           plan_overrides=dict(max_seq_len=128, decode_batch=4, rolled_steps=1),
                           fault=fault)
    else:
        arch = RWKV if cell.config["reference"] == "rwkv6" else QWEN
        out = R.train_cell(cell, SEED, 0.5, False, dev, arch_overrides=arch, fault=fault)
    from bench.portbench.check import judge
    return judge(out.numbers, cell.limits())[0], out


SERVE = ["qwen3-1.7b.decode", "qwen3-1.7b.code"]
TRAIN = ["rwkv6-1.6b.train", "qwen3-1.7b.train"]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_sound_run_is_correct(name):
    ok, out = run_small(name)
    assert ok, out.numbers
    assert out.attempted > 0 and out.failed == 0
    if name in SERVE:  # the pages the window's requests held, beside the whole pool
        assert 0 < out.device["kv_live_peak_bytes"] <= out.device["kv_pool_bytes"], out.device


def test_the_controls_are_judged_by_the_cells_limits():
    from bench.portbench.check import judge_controls

    limits = {"loss_gap": 1e-3, "grad_gap": 0.02}
    numbers = {"loss_gap": 1e-4, "grad_gap": 1e-3, "loss_gap.fp8": 5e-3, "grad_gap.fp8": 1e-3,
               "loss_gap.bf16_witness": 2e-4, "grad_gap.bf16_witness": 2e-3}
    assert judge_controls(numbers, limits) == {"fp8": False, "bf16_witness": True}
    assert judge_controls({"loss_gap": 1e-4}, limits) == {}


@pytest.mark.parametrize("name", TRAIN)
def test_the_float8_control_comes_out_not_correct(name):
    """The whole small run with ``--control``'s readings: the result line
    judges the float8 reference and the half batch by the cell's limits."""
    from bench.portbench import main

    cell = small(name)
    arch = RWKV if cell.config["reference"] == "rwkv6" else QWEN
    out = R.train_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                       control=("fp8", "half_batch"), arch_overrides=arch)
    res, _ = main.result_line(out, cell, False, torch.device("cpu"))
    assert res["correct"], res["compared"]
    assert res["controls_correct"]["fp8"] is False, res["readings"]
    assert res["controls_correct"]["half_batch"] is False, res["readings"]
    assert list(res)[-1] == "compared"


# ------------------------------------------------------------- serving faults
def _wrap_step(engine, change):
    inner = engine._step

    def step(*a, **k):
        tok, vtok, finite = inner(*a, **k)
        tok = change(tok)
        return tok, tok[:, None], finite

    engine._step = step


def altered_token(engine):
    """Every sampled token replaced by its neighbour id where it is produced."""
    _wrap_step(engine, lambda tok: (tok + 1) % engine.cfg.vocab_size)


def half_batch(engine):
    """The second half of the slots take the first slot's token."""
    def change(tok):
        tok = tok.clone()
        tok[tok.shape[0] // 2:] = tok[0]
        return tok
    _wrap_step(engine, change)


def unchanged_state(engine, monkeypatch=None):
    """The paged cache is never written: each step leaves the state it found."""
    from repro_torch.models import cache

    real = cache.paged_update
    engine._undo = real
    cache.paged_update = lambda entry, *a, **k: entry


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", [altered_token, half_batch, unchanged_state])
def test_a_broken_serving_path_is_not_correct(name, fault):
    from repro_torch.models import cache

    real = cache.paged_update
    try:
        ok, out = run_small(name, fault=fault)
    finally:
        cache.paged_update = real
    assert not ok, out.numbers


# ------------------------------------------------------------ training faults
def unchanged(step_fn):
    """A step that returns its state as it found it."""
    from bench.portbench.weights import leaves_with_path

    def step(state, batch):
        keep = [(x, x.clone()) for t in (state.params, state.m, state.v)
                for _, x in leaves_with_path(t)]
        new, met = step_fn(state, batch)
        for x, old in keep:
            x.copy_(old)
        return state, met
    return step


def half_rows(step_fn):
    """Half the batch left out, the mean taken over the rest."""
    def step(state, batch):
        return step_fn(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return step


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [unchanged, half_rows])
def test_a_broken_training_step_is_not_correct(name, fault):
    ok, out = run_small(name, fault=fault)
    assert not ok, out.numbers


# ------------------------------------------------------------ found by name
def _digest(d: Path) -> dict:
    return {p.relative_to(d): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in d.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_new_files_is_found(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(bench)
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a later change adds a mix, a cell and a metric, each a file of its own
    (bench / "traffic" / "chat_open.json").write_text(json.dumps(
        {"kind": "open_loop", "rate_per_s": 3.0, "preroll_s": 5.0,
         "tenants": 2, "prefix_len": 16, "body_len": {"dist": "fixed", "value": 20},
         "output_len": {"dist": "fixed", "value": 4}}))
    (bench / "cells" / "qwen3-1.7b.chat.json").write_text(json.dumps(
        {"config": "qwen3-1.7b", "traffic": "chat_open", "chips": 1,
         "limits": {"logit_gap": 1.0}}))
    (bench / "metrics" / "requests_due.chat.py").write_text(
        "def read(run):\n    return float(len(run.tracks))\n")
    benchmark["workloads"].append({"name": "qwen3-1.7b.chat", "config": "qwen3-1.7b",
                                   "traffic": "chat_open", "chips": 1, "why": "a test"})
    benchmark["per_layer"].append({"name": "requests_due.chat", "unit": "count",
                                   "better": "higher", "source": "program_counter",
                                   "layer": "scheduler serve/scheduler.py",
                                   "moves": "ttft_p95_ms", "workloads": ["qwen3-1.7b.chat"]})
    cell = spec.load_cell("qwen3-1.7b.chat", benchmark, bench_dir=bench)
    assert cell.kind == "serve" and cell.limits() == {"logit_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["requests_due.chat"]
    gen = spec.generator(cell.traffic["kind"], bench_dir=bench).make(cell.traffic, 100, 1, 5.0)
    assert len(gen.arrivals) > 0
    read = spec.metric_reader("requests_due.chat", bench_dir=bench)
    assert read(types.SimpleNamespace(tracks=[1, 2, 3])) == 3.0
    after = _digest(bench)
    assert all(after[p] == h for p, h in before.items())  # no file that was there changed


def test_every_listed_metric_and_cell_has_its_files():
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in benchmark["workloads"]:
        cell = spec.load_cell(w["name"], benchmark)
        assert cell.cell["config"] == w["config"] and cell.cell["traffic"] == w["traffic"]
        spec.generator(cell.traffic["kind"])
    for m in benchmark["end_to_end"] + benchmark["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


# ------------------------------------------------------------ the import guard
def test_guard_compares_whole_top_level_names():
    fake = {"jax.numpy": types.ModuleType("x"), "repro_torch.serve": types.ModuleType("y"),
            "repro": types.ModuleType("z"), "reprox": types.ModuleType("w")}
    assert guard.forbidden_modules(fake) == ["jax.numpy", "repro"]
    mod = types.ModuleType("b")
    mod.__file__ = str(ROOT / "benchmarks" / "anything.py")
    assert guard.forbidden_modules({"b": mod}) == ["b"]


def test_the_harness_and_the_port_load_nothing_forbidden():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import bench.portbench.main, bench.portbench.serving, bench.portbench.training\n"
            "import bench.reference.decoder, bench.reference.rwkv6, bench.reference.train\n"
            "import repro_torch.serve, repro_torch.train.train_step, repro_torch.launch.train\n"
            "from bench.portbench import guard; print(guard.forbidden_modules())"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for p in spec.BENCH_DIR.rglob("*.py"):
        text = p.read_text()
        for bad in ("import " + "jax", "from " + "jax", "import " + "repro\n",
                    "from " + "repro ", "from " + "repro.", "import " + "repro."):
            assert bad not in text, (p, bad)


def test_without_a_card_or_the_port_a_run_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    args = ["bench/run.py", "--workload", "qwen3-1.7b.decode", "--seed", str(SEED),
            "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # a directory holding only BENCHMARK.json and the benchmark's paths
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, *args], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""

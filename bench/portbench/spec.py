"""Finding a cell's files by name.

``BENCHMARK.json`` at the root lists the cells and the metrics; everything
that belongs to one cell, configuration, traffic mix or metric is a file of
its own under ``bench/``, found by the name ``BENCHMARK.json`` gives it:

* ``cells/<cell>.json``: ``config``, ``traffic``, ``chips`` and the limits of
  the comparison that decides ``correct``;
* ``configs/<config>.json``: the port's config name, the dtype, the
  published sizes it must run at, and the plan's inputs;
* ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  generator, ``traffic/<kind>.py``;
* ``metrics/<metric>.py``: one reader, ``read(run) -> float | None``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} does not exist")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """A Python file of the benchmark, loaded by path (metric names have
    dots, so they are not importable module names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    cell: dict
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.cell.get("chips", 1))

    @property
    def kind(self) -> str:
        """``serve`` or ``train``, from the traffic's generator."""
        return "train" if self.traffic["kind"] == "train_batches" else "serve"

    def limits(self) -> dict:
        return dict(self.cell["limits"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Optional[dict] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its configuration and traffic files, and the
    metrics ``BENCHMARK.json`` has it report."""
    if benchmark is None:
        benchmark = _json(bench_dir.parent / "BENCHMARK.json")
    names = [w["name"] for w in benchmark["workloads"]]
    if name not in names:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {names}")
    cell = _json(bench_dir / "cells" / f"{name}.json")
    config = _json(bench_dir / "configs" / f"{cell['config']}.json")
    traffic = _json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return Cell(
        name=name, cell=cell, config=config, traffic=traffic,
        end_to_end=[m for m in benchmark["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in benchmark["per_layer"] if _reports(m, name)],
    )


def generator(kind: str, bench_dir: Path = BENCH_DIR):
    """The traffic generator module of ``kind``."""
    return load_module(bench_dir / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader of metric ``name`` (``metrics/<name>.py``'s ``read``)."""
    mod = load_module(bench_dir / "metrics" / f"{name}.py",
                      "bench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read

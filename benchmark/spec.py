"""A cell's files, found by name: its entry in `BENCHMARK.json`, its
configuration (`benchmark/configs/<config>.json`), its traffic mix
(`benchmark/traffic/<traffic>.json`), the limits of its output check
(`benchmark/checks/<cell>.json`) and the per-layer metrics it reports (each
read by `benchmark/metrics/<metric>.py`)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]  # the checkout
BENCH = ROOT / "benchmark"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # compared number -> its limit
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files; raises
    KeyError for a cell the file does not name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json names no workload {name!r}; it has {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / "benchmark" / "configs" / f"{w['config']}.json"),
        traffic=load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(root / "benchmark" / "checks" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str, root: Path = ROOT):
    """`read` of benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

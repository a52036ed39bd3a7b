"""The harness on the CPU at a tiny size: every cell's files load by name, a
run's last line has exactly the contract's keys, the run loads neither JAX
nor the JAX package, and the command prints no result without a card or
without the program beside it. One test runs a real cell on the card and
skips without one."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import run, spec
from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def cells() -> list[str]:
    return [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", cells())
def test_cell_files_load_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == [w for w in spec.load_json(spec.ROOT / "BENCHMARK.json")[
        "workloads"] if w["name"] == name][0]["config"]
    assert {m["name"] for m in cell.end_to_end} == {"solves_per_s", "step_ms_p95", "setup_s"}
    assert set(cell.limits) == {"action_err", "state_err", "plan_err", "tighten_err",
                                "non_finite"}
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contract_keys(tmp_path, trace):
    root = tiny.make_checkout(tmp_path)
    out = run.run_cell(tiny.CELL, 2**31 + 999, 1.0, trace, "cpu", time.perf_counter(), root)
    keys = KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(out) == keys
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] % 8 == 0
    assert DEVICE_KEYS <= set(out["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"solves_per_s", "step_ms_p95", "setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["check"]) == set(spec.load_cell(tiny.CELL, root).limits)
    json.dumps(out)


def test_run_loads_no_jax(tmp_path):
    root = tiny.make_checkout(tmp_path)
    code = (f"import sys, time; sys.path.insert(0, {str(spec.ROOT)!r}); "
            "from benchmark import run; "
            f"run.run_cell({tiny.CELL!r}, 5, 0.5, False, 'cpu', time.perf_counter(), "
            f"__import__('pathlib').Path({str(root)!r})); print(run.forbidden_modules())")
    env = dict(os.environ, OMP_NUM_THREADS="4")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpmpc_tpu_torch.parallel", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpmpc_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["gpmpc_tpu", "jax"]


def test_command_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    done = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload",
                           cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""


def test_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/ runs no cell."""
    shutil.copytree(spec.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.path.insert(0, '.'); from benchmark import run; "
            f"run.run_cell({cells()[0]!r}, 1, 1.0, False, 'cpu', time.perf_counter())")
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode != 0 and "gpmpc_tpu_torch" in done.stderr


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload", cells()[0],
                           "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, timeout=1200, cwd=spec.ROOT)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert Path(spec.ROOT / "build").is_dir()

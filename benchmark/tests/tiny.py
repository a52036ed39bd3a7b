"""A checkout of the benchmark at a size the CPU runs in seconds: the cells'
configurations and traffic cut to a horizon of 5, 8 scenarios in one QP tile
of 8, 2 SQP and 4 interior-point iterations and 6-step episodes, with the
benchmark's own metric readers, GP data and limits, written under `root`."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.spec import BENCH, ROOT, load_json

CELL = "tiny.dr8"


def make_checkout(root: Path, config: str = "quadrotor-fig8", limits: dict | None = None) -> Path:
    bench = load_json(ROOT / "BENCHMARK.json")
    cfg = load_json(BENCH / "configs" / f"{config}.json")
    cfg.update(name="tiny", horizon=5)
    cfg["solver"].update(sqp_iters=2, qp_iters=4, tile=8)
    if cfg["gp"]["kind"] == "fitc":
        cfg["gp"].update(points=200, inducing=16, capacity=200)
    tr = load_json(BENCH / "traffic" / "dr1024.json")
    tr.update(name="dr8", scenarios=8, episode_steps=6, checks=3, trace_seconds=0.2)
    cell_limits = limits or load_json(BENCH / "checks" / "quad-fig8.dr1024.json")["limits"]
    bench["workloads"] = [dict(bench["workloads"][0], name=CELL, config="tiny", traffic="dr8")]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    for sub in ("configs", "traffic", "checks"):
        (root / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", root / "benchmark" / "metrics", dirs_exist_ok=True)
    shutil.copytree(BENCH / "data", root / "benchmark" / "data", dirs_exist_ok=True)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "traffic" / "dr8.json").write_text(json.dumps(tr))
    (root / "benchmark" / "checks" / f"{CELL}.json").write_text(
        json.dumps({"cell": CELL, "limits": cell_limits}))
    return root

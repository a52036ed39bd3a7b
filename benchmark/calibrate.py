"""The readings that the limits of `benchmark/checks/<cell>.json` are set
from, on the card, in one process: the compared numbers of sound runs of
the program over many seeds (the lower readings) and of the precision
control, the plain reference in TF32 in the program's place (the upper
readings), each a full run of the cell at its own load.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3 \
        [--seconds 20]

prints one JSON line a run: {"seed", "program": numbers, "control": numbers
or null, "correct", "failed", "attempted", "setup_s", "solves_per_s", and the
step times' 50th and 95th percentiles over all steps, over each episode's
first `--head` steps and over the rest}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import statistics  # noqa: E402

from benchmark import run  # noqa: E402


def percentiles(ms: list) -> list:
    if len(ms) < 2:
        return ms
    q = statistics.quantiles(ms, n=100)
    return [q[49], q[94]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--head", type=int, default=3)
    args = ap.parse_args(argv)
    controls = {int(x) for x in args.control_seeds.split(",") if x}
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        detail = {}
        out = run.run_cell(args.workload, seed, args.seconds, False, "cuda:0", t,
                           controls=("tf32",) if seed in controls else (), detail=detail)
        ms, L = detail["step_ms"], detail["episode_steps"]
        head = [v for i, v in enumerate(ms) if i % L < args.head]
        rest = [v for i, v in enumerate(ms) if i % L >= args.head]
        print(json.dumps({
            "seed": seed, "program": {k: v["value"] for k, v in out["check"].items()},
            "control": out.get("controls", {}).get("tf32"), "correct": out["correct"],
            "failed": out["failed"], "attempted": out["attempted"],
            "setup_s": out["metrics"]["setup_s"]["value"],
            "solves_per_s": out["metrics"]["solves_per_s"]["value"],
            "step_ms_p50_p95": {"all": percentiles(ms), "head": percentiles(head),
                                "rest": percentiles(rest)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

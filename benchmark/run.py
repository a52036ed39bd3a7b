"""The benchmark of `gpmpc_tpu_torch`, the PyTorch and CUDA port: one run of
one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (`benchmark/configs/`) under a traffic mix
(`benchmark/traffic/`), both named in `BENCHMARK.json`. The run builds the
controller, plant and GP through the package's API, captures one closed-loop
step in a CUDA graph (`parallel.fused.FusedWindow`), warms it, and then
replays it for `--seconds` (the measured window, `benchmark/window.py`).
With `--trace 1` it then traces a short window with torch.profiler
(`benchmark/trace.py`) and reports the cell's per-layer metrics, each read
by `benchmark/metrics/<metric>.py`, instead of its end-to-end ones. Once the
window has closed, the card's memory peak has been read and the program's
state freed, the plain reference steps again the checked steps of the window
(`benchmark/check.py`). The last line of standard output is the result:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"check"}; the numbers compared, each beside its limit, are also the last
lines of standard error. Without a CUDA card (or with fewer than the cell
asks for), or if JAX or the JAX package was loaded, the run prints no result
and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "gpmpc_tpu")  # top-level module names, compared whole
WARM_STEPS = 3  # the first captures the graph
NO_CARD, FORBIDDEN_LOADED = 5, 6  # exit codes


def say(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T_START:7.2f}s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    """nvidia-smi's power limit of the first card, in W (None without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: Path = ROOT, controls: tuple = (), detail: dict | None = None) -> dict:
    """One run of the cell `name` of the checkout `root` on `device`: the
    result's mapping. For `benchmark/calibrate.py`: with `controls`
    (precisions), also the numbers that each precision's reference gives in
    the program's place, under "controls"; `detail` gets each step's ms."""
    import torch

    from benchmark import check, gpdata, spec, system
    from benchmark import trace as tracing
    from benchmark import traffic as traffic_mod
    from benchmark.window import Driver
    from gpmpc_tpu_torch.parallel.fused import FusedWindow

    device = torch.device(device)
    cuda = device.type == "cuda"
    cell = spec.load_cell(name, root)
    cfg, tr = cell.config, cell.traffic
    B = int(tr["scenarios"])
    say("imports done")
    gp_arrays = gpdata.gp_arrays(cfg, seed, root, device)
    s = system.build(cfg, gp_arrays, B, device)
    eps = traffic_mod.draw_episodes(tr, cfg, seed, traffic_mod.episodes_for(seconds, tr), device)
    s.params.copy_(eps.params[0])
    say("system built")
    win = FusedWindow(system.step_fn(s), system.initial_carry(s, eps.x0[0]), 1)
    say("the window's first step ran")
    driver = Driver(win, s, eps, tr["episode_steps"], system.initial_carry)
    driver.warm(WARM_STEPS)
    checks = traffic_mod.check_steps(tr, seed)
    say(f"set-up done ({s.path}, B={B}, T={s.T}); the window starts")
    setup_s = time.perf_counter() - t_start
    res = driver.window(seconds, checks)
    fails = int(s.fails)
    step_s = res.wall_s / res.steps
    if detail is not None:
        detail.update(step_ms=res.step_ms, episode_steps=int(tr["episode_steps"]))
    say(f"window: {res.steps} steps in {res.wall_s:.3f} s, {len(res.snapshots)} checked")
    summary = None
    if trace:
        n = max(5, math.ceil(float(tr["trace_seconds"]) / step_s))
        summary = tracing.traced(lambda k: [driver.step() for _ in range(k)], n, device)
        say(f"traced window: {n} steps in {summary.span_s:.3f} s, busy {summary.busy_s:.3f} s")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    checked = [check.Checked(sn.step, sn.episode, sn.before, sn.after, sn.u, sn.plant_next,
                             sn.boxes) for sn in res.snapshots]
    graph_stats = list(win.stats.values())
    graph_s = sum(st.capture_s + st.instantiate_s for st in graph_stats)
    live = [int((m != 0).sum()) for m in s.gp.var_mask]
    del driver, win, s
    if cuda:
        torch.cuda.empty_cache()
    reading = check.compare(cfg, gp_arrays, eps, checked, fails, device)
    say(f"reference: {len(checked)} steps checked")

    if trace:
        # what a metric reader gets: the trace, the run's own readings and the cell's files
        ctx = dict(summary=summary, layers=tracing.layer_seconds(summary), step_s=step_s,
                   graph_s=graph_s, graph_stats=graph_stats, config=cfg, traffic=tr, B=B,
                   T=int(cfg["horizon"]), nx=int(cfg["n_states"]), nu=int(cfg["n_inputs"]),
                   D=gp_arrays["Zs"].shape[-1], live_points=live, tile=int(cfg["solver"]["tile"]),
                   mehrotra=bool(cfg["solver"]["qp_mehrotra"]),
                   qp_tile_iterations=reading.tile_iterations)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(solves_per_s=B * res.steps / res.wall_s,
                      step_ms_p95=statistics.quantiles(res.step_ms, n=100)[94], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if cuda else None}
    out = {"correct": check.verdict(reading.numbers, cell.limits), "attempted": B * res.steps,
           "failed": fails, "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.span_s)
        out["breakdown"] = tracing.breakdown(summary)
    if controls:
        out["controls"] = {p: check.compare(cfg, gp_arrays, eps, checked, 0, device, p).numbers
                           for p in controls}
    out["check"] = {k: {"value": reading.numbers[k], "limit": v} for k, v in cell.limits.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of a run inside the checkout, at fixed paths
    build = ROOT / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    import torch

    from benchmark import spec

    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return NO_CARD
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return FORBIDDEN_LOADED
    for k, v in out["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

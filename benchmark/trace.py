"""The traced window of a `--trace 1` run, and its reduction from the
profiler's events to what the per-layer metrics read.

`torch.profiler` records the card's kernels, copies and sets (CUPTI, under
graph replays too) and the host's operations and runtime calls. The host's
first launches under the profiler stall for milliseconds, so a spin kernel
holds the card first while the host enqueues the traced steps; these run
inside a host range (`MARK`), and only device operations that begin inside
it count (the spin kernel does not). They are reduced to: each device
operation's launches and seconds by its short name (the kernel's name
without its arguments); the seconds in which any device operation ran (the
union of their intervals, so kernels that overlap count once); the traced
window, the device's span from the first traced operation's start to the
last one's end, on the same timeline; and the gaps between device activity,
each with the host operation that was running when it began.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

MARK = "benchmark.traced_steps"  # the host range around the traced steps
SPIN_CYCLES = 100_000_000  # ~50 ms of the card's clock: longer than the host's stall

# The port's kernels by layer, matched against a kernel's short name: kernel 1
# (the register buckets, the tiled kernel and its reduction), kernel 2, kernel
# 3 and kernel 4 (the resident QP kernel, namespace gpmpc::ocp::resident).
LAYER_KERNELS = {
    "gp": ("gp_posterior", "gp_tiled_reduce"),
    "tighten": ("tighten_",),
    "linearize": ("linearize_kernel",),
    "qp": ("resident::kernel",),
}


class TraceSummary(NamedTuple):
    steps: int
    busy_s: float  # the union of device operations' intervals
    span_s: float  # the traced window: the first device operation's start to the last one's end
    ops: dict  # short name -> [launches, seconds]
    gaps: list  # (seconds, what the host was doing), longest first


def short_name(name: str) -> str:
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)", "anon")
    depth, out = 0, []
    for ch in name:  # drop the argument list and template arguments' spaces
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:160]


def layer_of(short: str) -> str:
    for layer, keys in LAYER_KERNELS.items():
        if any(k in short for k in keys):
            return layer
    return "other"


def traced(run_steps, n_steps: int, device) -> TraceSummary:
    """Runs `run_steps(n_steps)` inside the range `MARK`, behind a spin
    kernel, under torch.profiler, and reduces the traced steps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda._sleep(SPIN_CYCLES)
        with record_function(MARK):
            run_steps(n_steps)
            sync()
    return reduce(prof.profiler.kineto_results.events(), n_steps)


def reduce(events, n_steps: int) -> TraceSummary:
    """The traced steps' summary: device operations that begin inside the
    host range `MARK`."""
    dev, host = [], []
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        if end <= start:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() == MARK:
                continue  # the host range's shadow on the device's timeline, not work
            dev.append((start, end, short_name(e.name())))
        else:  # host operations and runtime calls
            host.append((start, end, e.name()))
    lo, hi = next((h[0], h[1]) for h in host if h[2] == MARK)
    dev = [d for d in dev if lo <= d[0] <= hi]
    ops: dict = {}
    for s, t, name in dev:
        rec = ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (t - s) * 1e-9
    dev.sort()
    busy_ns, gaps = 0, []
    cur_s = cur_e = None
    for s, t, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    span_ns = cur_e - dev[0][0] if dev else 0  # cur_e: the last operation's end
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    labelled = []
    for g0, g1 in gaps[:10]:
        # the innermost host operation running when the gap began
        running = [h for h in host if h[0] <= g0 < h[1]]
        label = min(running, key=lambda h: h[1] - h[0])[2] if running else "host outside torch"
        labelled.append(((g1 - g0) * 1e-9, label))
    return TraceSummary(n_steps, busy_ns * 1e-9, span_ns * 1e-9, ops, labelled)


def layer_seconds(summary: TraceSummary) -> dict:
    """Device seconds and launches of each layer's kernels in the window."""
    out = {layer: [0, 0.0] for layer in (*LAYER_KERNELS, "other")}
    for name, (n, sec) in summary.ops.items():
        rec = out[layer_of(name)]
        rec[0] += n
        rec[1] += sec
    return out


def breakdown(summary: TraceSummary) -> dict:
    top = sorted(summary.ops.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name, sec] for name, (_, sec) in top],
            "idle_gaps": [[label, sec] for sec, label in summary.gaps]}

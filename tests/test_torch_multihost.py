"""The port's multi-process path on the CPU: `init_distributed` (gloo over
127.0.0.1) and the sharded step in local processes through
`scripts/run_multihost_torch.py --virtual-hosts N --device cpu --parity`,
each rank's gathered actions and reduced tracking error against its own
unsharded run (both within 1e-4, the reference script's bars);
`parallel/dryrun.py::dryrun_multichip` on two CPU devices (the reference's
four bars, the weak-scaling table, the sharded sweep); and
`scripts/bench_scaling_torch.py` at its smallest settings. The 4-process
window and the 2-process sweep are `slow`, as in tests/test_multihost.py."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gpmpc_tpu_torch.parallel.dryrun import BARS, dryrun_multichip
from tests._torch_threads import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _run(*args, timeout=300):
    """The driver in processes of their own: one intra-op thread each, gloo
    on the loopback interface, a worker deadline below this timeout."""
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    r = subprocess.run([sys.executable, "scripts/run_multihost_torch.py", "--device", "cpu",
                        "--worker-timeout", str(timeout - 60), *args],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


def test_two_process_distributed_parity():
    """Two gloo processes, B = 8 on lanes at T = 5, one timed step: both ranks
    report parity and rank 0 the metric line with its collectives."""
    out = _run("--virtual-hosts", "2", "--scenarios", "8", "--steps", "1", "--horizon", "5",
               "--gp-points", "32", "--parity")
    for pid in (0, 1):
        assert f"PARITY pid={pid}" in out, out
    assert "ok=True" in out and "ok=False" not in out, out
    line = json.loads(next(x for x in out.splitlines() if x.startswith("{")))
    assert line["metric"] == "torch_solves_per_sec[multihost_2proc_2dev_B8_lanes]", line
    assert line["collectives"] == "gloo" and line["device"] == "cpu" and line["card"] is None
    assert line["value"] > 0


@pytest.mark.slow
def test_four_process_distributed_window():
    """Four processes, B = 256 on xla at T = 10, a 20-step timed window and
    4-way parity (tests/test_multihost.py's window)."""
    out = _run("--virtual-hosts", "4", "--scenarios", "256", "--steps", "20", "--backend", "xla",
               "--horizon", "10", "--gp-points", "32", "--parity", timeout=1500)
    for pid in range(4):
        assert f"PARITY pid={pid}" in out, out
    assert "ok=True" in out and "ok=False" not in out, out
    assert '"metric": "torch_solves_per_sec[multihost_4proc_4dev_B256_xla]"' in out, out


@pytest.mark.slow
def test_two_process_seed_sweep_parity():
    """The seed sweep sharded over two processes against each process's
    unsharded sweep (1e-3 relative), at the reference script's sizes."""
    out = _run("--virtual-hosts", "2", "--sweep", "4", "--steps", "20", "--horizon", "10",
               "--parity", timeout=1500)
    assert "SWEEP-PARITY pid=0" in out and "SWEEP-PARITY pid=1" in out, out
    assert "ok=True" in out and "ok=False" not in out, out
    assert '"metric": "torch_sweep[multihost_2proc_2dev_S4_lanes]"' in out, out


def test_dryrun_multichip_on_two_cpu_devices(capsys):
    """The reference's dry run on the port over two CPU devices: every delta
    within its bar (the function asserts them; 0 is expected, since every
    draw is made at the population's width and the xla path solves each
    scenario alone), a finite table at 1 and 2 devices."""
    r = dryrun_multichip(2, devices=["cpu", "cpu"])
    assert set(r["deltas"]) == set(BARS)
    assert all(r["deltas"][k] <= BARS[k] for k in BARS), r["deltas"]
    assert [(d, b) for d, b, _ in r["table"]] == [(1, 16), (2, 32)]
    assert all(v > 0 for _, _, v in r["table"])
    assert "dryrun_multichip(2) on [cpu, cpu]: ok" in capsys.readouterr().out


def test_bench_scaling_main_at_its_smallest_settings(capsys):
    """scripts/bench_scaling_torch.py's main on the CPU at one timed step:
    config 3 at B = 4 on lanes, the weak-scaling table over two CPU devices;
    every line is JSON with the device."""
    spec = importlib.util.spec_from_file_location("bench_scaling_torch",
                                                  REPO / "scripts" / "bench_scaling_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--steps", "1", "--batches", "4", "--backends", "lanes",
                     "--gp5k-batch", "0", "--devices", "cpu,cpu", "--per-device", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    names = [x["metric"] for x in lines]
    assert names == ["torch_solves_per_sec[T25_gp128_lanes_B4]", "torch_mesh_1dev",
                     "torch_mesh_2dev", "torch_mesh_weak_scaling"], names
    assert lines[0]["finite"] and lines[0]["device"] == "cpu" and lines[0]["value"] > 0
    assert set(lines[-1]["efficiency"]) == {"1", "2"}

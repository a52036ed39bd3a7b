"""Team sizes of the linearize kernel on the card.

    python3 scripts/bench_linearize_team_torch.py

Needs one CUDA card and `nvcc`. Each family trait of `csrc/linearize.cu`
holds its team (threads per (scenario, stage)) as a constant; this script
builds the source three more times, with `-DLINEARIZE_TEAM=1`, `2` and `4`
(every family at that team; one `nvcc` each, started together, into
`build/linearize_team/`), and loads each build with ctypes. It prints the
card's name and power limit, ptxas's registers and spills of each build's
three instantiations, then one JSON line per (family, horizon, team): the
kernel's device time (chip_smoke.py::device_ms, launches back to back) and
the median CUDA-event time of one call (chip_smoke.py::timed) on
chip_smoke.py's seeded random inputs of the path (chip_smoke.py::
random_inputs: the three families at T=25, B=1024, and the quadrotor at
T=360, B=256), and the largest difference from the plain version on the
same inputs (bars: 2e-5 on fnext, 2e-4 on A and B). A line with
`"team": "wrapper"` times the port's own wrapper (the library `_build`
builds, each family at its trait's team) on the same inputs. Team sizes
change only the order of the GP sums, so every team must meet the bars.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import TOL, Problem, device_ms, random_inputs, timed  # noqa: E402
from gpmpc_tpu_torch import _build  # noqa: E402
from gpmpc_tpu_torch.ops import cuda_linearize  # noqa: E402

TEAMS = (1, 2, 4)
CASES = (("quadrotor", 25), ("cartpole", 25), ("twolink", 25), ("quadrotor-soft-T360", 360))
OUT = ROOT / "build" / "linearize_team"


def build_teams() -> dict:
    """team -> (the linearize_launch entry of a build with every family at
    that team, ptxas's lines of its kernels)."""
    nvcc = _build._find_nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "linearize.cu"
    procs = {
        team: subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", f"-DLINEARIZE_TEAM={team}", "-I",
             str(_build.CSRC), "-o", str(OUT / f"linearize_team{team}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for team in TEAMS
    }
    out = {}
    for team, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc -DLINEARIZE_TEAM={team} failed:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"linearize_team{team}.so")).linearize_launch
        fn.argtypes = _build.SIGNATURES["linearize_launch"]
        fn.restype = ctypes.c_int
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        out[team] = (fn, lines)
    return out


def call_build(fn, params8, hyp, Zs, alpha, X, U, dt, use_gp, family):
    """The wrapper's CUDA route against another build's entry point."""
    fam = cuda_linearize.family_of(family)
    n, Tp1, _, L = X.shape
    T = Tp1 - 1
    fnext = torch.empty(n, T, fam.nx, L, dtype=torch.float32, device=X.device)
    A = torch.empty(n, T, fam.nx, fam.nx, L, dtype=torch.float32, device=X.device)
    B = torch.empty(n, T, fam.nx, fam.nu, L, dtype=torch.float32, device=X.device)
    p = _build.ptr
    err = fn(fam.kid, fam.nx, fam.nu, p(params8), p(hyp), p(X), p(U), p(Zs), p(alpha), n, T, L,
             Zs.shape[1], int(use_gp), float(dt), p(fnext), p(A), p(B),
             _build.stream_handle(X.device))
    if err != 0:
        raise RuntimeError(f"linearize_launch returned {err}")
    return fnext, A, B


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_linearize_team_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    builds = build_teams()
    for team, (_, lines) in builds.items():
        for line in lines:
            print(f"ptxas team {team}: {line}", flush=True)
    failed = False
    for path_name, T in CASES:
        prob = Problem(path_name, dev)
        a, k = random_inputs(prob, T)["linearize"]
        ref = cuda_linearize.linearize_ocp_lanes_plain(*a, **k)
        n, _, _, lanes = a[4].shape
        calls = {team: (lambda fn=fn: call_build(fn, *a, **k)) for team, (fn, _) in builds.items()}
        calls["wrapper"] = lambda: cuda_linearize.linearize_ocp_lanes(*a, **k)
        for team, call in calls.items():
            ms, runs, out = timed(call)
            on_device = device_ms(call)
            err_f = float((out[0] - ref[0]).abs().max())
            err_j = max(float((o - r).abs().max()) for o, r in zip(out[1:], ref[1:]))
            ok = err_f <= TOL["linearize_fnext"] and err_j <= TOL["linearize_jac"]
            failed |= not ok
            print(json.dumps(dict(
                family=prob.family, T=T, B=n * lanes, team=team, device_ms=on_device, ms=ms,
                runs=runs, max_err_fnext=err_f, max_err_jac=err_j, ok=ok, card=smi)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

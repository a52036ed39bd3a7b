"""Launch geometries of the resident QP kernel on the card.

    python3 scripts/bench_resident_geometry_torch.py

Needs one CUDA card and `nvcc` (the kernel library builds on first launch).
Prints the card's name and power limit, ptxas's registers and spills of the
resident kernel's six instantiations, then one JSON line per (width, bounds,
batch, geometry): the kernel's median time on seeded random QPs at T=25 with
the main path's solver settings (chip_smoke.py::random_qp_call) for
`scenarios_per_block` scenarios a block, so a cluster of 128 /
`scenarios_per_block` blocks a tile. Every geometry must give the solution of
the default one bit for bit: a team's arithmetic does not depend on how the
tile is split, and the exit vote is over the whole tile either way.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import LANES, random_qp_call, timed  # noqa: E402
from gpmpc_tpu_torch import _build  # noqa: E402
from gpmpc_tpu_torch.ops import cuda_ocp  # noqa: E402

# scenarios per block to try at each width; the first is the default
CANDIDATES = {(12, 4): (8, 16), (4, 1): (16, 8, 32), (4, 2): (16, 8, 32)}


def ptxas_report(log: str) -> list[str]:
    """ptxas's lines of the resident kernel's entries (entry, frame and
    spills, registers)."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            inside = "resident" in line
        if inside and ("Compiling entry" in line or "spill" in line or "registers" in line):
            out.append(line.strip())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_resident_geometry_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda:0")
    _build.load_library()
    for line in ptxas_report(_build.BuildInfo.log):
        print(f"ptxas: {line}", flush=True)
    default = dict(cuda_ocp.RESIDENT_SCENARIOS_PER_BLOCK)
    max_cluster = cuda_ocp.RESIDENT_MAX_CLUSTER
    fn = cuda_ocp.solve_ocp_qp_lanes
    try:
        cuda_ocp.RESIDENT_MAX_CLUSTER = 16
        for (nx, nu), spbs in CANDIDATES.items():
            for soft in (False, True):
                for n_tiles in ((8, 2) if nx == 12 else (8,)):
                    a, k = random_qp_call(dev, n_tiles, 25, nx, nu, soft)
                    ref = None
                    for spb in spbs:
                        cuda_ocp.RESIDENT_SCENARIOS_PER_BLOCK[(nx, nu)] = spb
                        g = cuda_ocp.resident_geometry(nx, nu, LANES)
                        try:
                            ms, runs, out = timed(lambda: fn(*a, **k))
                        except RuntimeError as e:  # e.g. a cluster the card cannot schedule
                            print(json.dumps(dict(width=f"{nx}x{nu}", soft=soft, B=n_tiles * LANES,
                                                  scenarios_per_block=spb, cluster=g.cluster,
                                                  error=str(e))), flush=True)
                            continue
                        if ref is None:
                            ref = out
                        same = all(torch.equal(x, y) for x, y in zip(out, ref))
                        print(json.dumps(dict(
                            width=f"{nx}x{nu}", soft=soft, B=n_tiles * LANES, team=g.team,
                            scenarios_per_block=spb, cluster=g.cluster, threads=g.threads,
                            shared_bytes=g.shared_bytes, blocks=n_tiles * g.cluster, ms=ms, runs=runs,
                            ip_iterations=fn.last_iterations.tolist(), same_as_default=same,
                            card=smi)), flush=True)
                        if not same:
                            raise RuntimeError(f"{nx}x{nu}: {spb} scenarios a block changed the solution")
                    cuda_ocp.RESIDENT_SCENARIOS_PER_BLOCK[(nx, nu)] = default[(nx, nu)]
    finally:
        cuda_ocp.RESIDENT_SCENARIOS_PER_BLOCK.update(default)
        cuda_ocp.RESIDENT_MAX_CLUSTER = max_cluster
    return 0


if __name__ == "__main__":
    sys.exit(main())

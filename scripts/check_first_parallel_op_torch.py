"""How often the first parallel elementwise op of a fresh torch process
differs from the same op repeated, on the CPU this runs on.

    python3 scripts/check_first_parallel_op_torch.py [--runs 400] [--jobs 8]

Starts `--runs` fresh Python processes for each mode, `--jobs` at a time. Each
computes the SE kernel row of tests/test_torch_gp.py's first case (70 queries
against 128 points in 3 dimensions, which torch splits over its intra-op
threads) twice and reports which elements of the first result differ from
the second. Mode "cold": these are the process's first parallel ops; mode
"warm": one unchecked exp over 2^20 elements runs first, so every intra-op
thread has done its first vector work before the checked ones. Prints one JSON
line per mode: the processes whose two results differed, the element ranges
that did (in units of the per-thread chunk), and the largest relative
difference. CPU only; needs no card and no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = r"""
import sys, torch
if sys.argv[1] == "warm":
    torch.exp(torch.zeros(1 << 20))
gen = torch.Generator().manual_seed(0)
z, Z = torch.randn(70, 3, generator=gen), torch.randn(128, 3, generator=gen)


def row():  # ops/cuda_gp.py::se_kernel's arithmetic, lengthscale 0.9, outputscale 1.3
    diff = z[:, None, :] - Z[None, :, :]
    return 1.3 * torch.exp(-0.5 * torch.sum(diff * diff * (1.0 / 0.81), dim=-1))


y1 = row()
y2 = row()
bad = torch.nonzero((y1 != y2).flatten()).flatten().tolist()
rel = float(((y1 - y2).abs() / y2).max())
print(len(bad), bad[0] if bad else -1, bad[-1] if bad else -1, rel, torch.get_num_threads())
"""


def one(mode: str) -> tuple:
    out = subprocess.run([sys.executable, "-c", CHILD, mode], capture_output=True, text=True,
                         check=True).stdout.split()
    return int(out[0]), int(out[1]), int(out[2]), float(out[3]), int(out[4])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--jobs", type=int, default=8)
    args = ap.parse_args()
    for mode in ("cold", "warm"):
        with ThreadPoolExecutor(args.jobs) as pool:
            res = list(pool.map(one, [mode] * args.runs))
        differed = [r for r in res if r[0]]
        print(json.dumps(dict(
            mode=mode, processes=len(res), differed=len(differed),
            ranges=sorted({(r[1], r[2]) for r in differed}),
            max_rel_diff=max((r[3] for r in differed), default=0.0), threads=res[0][4])),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

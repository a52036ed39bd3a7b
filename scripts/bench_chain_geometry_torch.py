"""Launch geometries of the lane chain kernels 7 and 8 on the card, beside an
earlier design of the same source.

    python3 scripts/bench_chain_geometry_torch.py [--parent PATH]

Needs one CUDA card and `nvcc`. `csrc/lanes_chain.cu` fixes the block width,
the launch bound's minimum of blocks an SM and the rows a round unrolls
together of its two `chain_kernel` instantiations as three constants
(`kChainSlots`, `kChainMinBlocks`, `kChainRows`). For each of `VARIANTS` this
script writes a copy of the source with those constants set into
`build/chain_geometry/`, builds it there (one `nvcc` each, all started
together) and loads it with ctypes; the launches take the geometry
`cuda_chain.chain_geometry` would give at that block width. `--parent PATH`
names an earlier `lanes_chain.cu` whose two launchers take `(x, out,
n_blocks, L, n_chain, stream)`; it is built beside them.

Prints the card's name and power limit, ptxas's registers, stack frame and
spills of both kernels in every build, the SASS opcodes of both kernels in
the first build (`cuobjdump -sass`; the arithmetic is that of the rows
unrolled together, `rows_in_code` of a round's 12, since the rest of the
kernel only loads and stores), then one JSON line per check and per timing:

- `check`: for each build and kernel, at tile widths 2, 40, 64, 128, 192 and
  256 lanes (two tiles of three stages of the reference's data) and on the
  probe's own input, after 0, 1, 4 and 200 rounds: whether the output is the
  earlier design's bit for bit (NaN where it has NaN), and after 4 rounds the
  largest error relative to max(1, |plain|) against the plain version (bars
  1e-5 in float32, 2 bf16 ulps). Any failed check makes the exit code 1.
- `time`: the device time of one call at the probe's size (x (10, 25, 12, 12,
  128) float32, (5, 25, 12, 12, 256) bf16; 200 rounds): CUDA events around 20
  calls back to back, the median of 5 such windows, taken twice in turns
  (earlier design, builds, the port's wrapper, then in the reverse order), so
  drift shows as a difference between a build's two readings.
- `clocks`: for the earlier design and the wrapper, the median SM clock and
  power draw that `nvidia-smi -lms 50` reads over the second half of 1.5 s of
  calls back to back.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import TOL, ptxas_entries  # noqa: E402
from gpmpc_tpu_torch import _build, roofline  # noqa: E402
from gpmpc_tpu_torch.ops import cuda_chain  # noqa: E402

# (slots a block, warps an SM, rows unrolled): the launch bound's minimum is
# warps * 32 / slots blocks, so ptxas caps a thread at 65,536 / (warps * 32)
# registers (255 at 8 warps, 168 at 12). The first is the library's default.
VARIANTS = ((64, 8, 4), (32, 8, 4), (128, 8, 4), (32, 12, 4), (64, 12, 4), (128, 12, 4),
            (64, 8, 1), (64, 8, 2), (64, 8, 3), (64, 8, 6), (64, 8, 12))
KINDS = {  # kind -> (entry, plain version, dtype, lanes of the probe's tile)
    "f32": ("lanes_chain", cuda_chain.lanes_chain_plain, torch.float32, roofline.LANES),
    "bf16": ("lanes_chain_bf16", cuda_chain.lanes_chain_bf16_plain, torch.bfloat16,
             2 * roofline.LANES),
}
WIDTHS = (2, 40, 64, 128, 192, 256)
ROUNDS = (0, 1, 4, roofline.N_CHAIN)
OUT = ROOT / "build" / "chain_geometry"
NEW_SIG = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
OLD_SIG = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def variant_name(slots: int, warps: int, rows: int) -> str:
    return f"slots{slots}_warps{warps}_rows{rows}"


def variant_source(slots: int, warps: int, rows: int) -> str:
    """csrc/lanes_chain.cu with chain_kernel's three constants set."""
    text = (_build.CSRC / "lanes_chain.cu").read_text()
    for name, value in (("kChainSlots", slots), ("kChainMinBlocks", warps * 32 // slots),
                        ("kChainRows", rows)):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise SystemExit(f"csrc/lanes_chain.cu: no single definition of {name}")
    return text


def geometry(kind: str, L: int, cap: int) -> tuple[int, int, int]:
    """cuda_chain.chain_geometry's rule with blocks of at most `cap` slots."""
    slots = L // 2 if kind == "bf16" else L
    slices = next(s for s in range(1, slots + 1) if slots % s == 0 and slots // s <= cap)
    per_block = slots // slices
    return per_block, slices, 4 * cuda_chain.N * cuda_chain.N * per_block


def build_all(parent: Path | None) -> dict:
    """name -> (path of the shared library, nvcc's output)."""
    nvcc = _build._find_nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for variant in VARIANTS:
        src = OUT / f"{variant_name(*variant)}.cu"
        src.write_text(variant_source(*variant))
        jobs[variant_name(*variant)] = src
    if parent is not None:
        jobs["parent"] = parent
    procs = {
        name: subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), "-o",
             str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in jobs.items()
    }
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc of {name} failed:\n{log}")
        built[name] = (OUT / f"{name}.so", log)
    return built


def entry(lib_path: Path, name: str, signature):
    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    fn.argtypes = signature
    fn.restype = ctypes.c_int
    return fn


def sass_opcodes(nvcc: str, lib_path: Path, match: str = "chain_kernel") -> dict:
    """Mangled kernel name -> Counter of SASS opcodes, for the kernels whose
    name holds `match`."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            current = m.group(1) if match in m.group(1) else None
            if current:
                counts[current] = Counter()
        elif current and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                                        line)):
            counts[current][m.group(1)] += 1
    return counts


def clocks_during(fn, seconds: float = 1.5) -> tuple[float, float]:
    """(median SM clock in MHz, median power draw in W) over the second half
    of the samples nvidia-smi takes while `fn` runs back to back."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate()[0]
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines() if line.strip()]
    rows = rows[len(rows) // 2:]
    return statistics.median(r[0] for r in rows), statistics.median(r[1] for r in rows)


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, every NaN made one pattern."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier lanes_chain.cu to check bit for bit and time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_chain_geometry_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda:0")
    built = build_all(args.parent)
    for name, (_, log) in built.items():
        for e in ptxas_entries("== lanes_chain.cu\n" + log):
            if "chain_kernel" in e["entry"]:  # kernels 7 and 8, not team_chain16_kernel
                print(json.dumps(dict(ptxas=name, **e)), flush=True)
    first = variant_name(*VARIANTS[0])
    for kernel, ops in sass_opcodes(_build._find_nvcc(), built[first][0]).items():
        print(json.dumps(dict(sass=first, entry=kernel, rows_in_code=VARIANTS[0][2],
                              total=sum(ops.values()), opcodes=dict(ops.most_common()))),
              flush=True)

    failed = False
    for kind in KINDS:  # the default variant's rule is the library's
        for w in (*WIDTHS, 2 * roofline.LANES):
            assert geometry(kind, w, cuda_chain.CHAIN_SLOTS) == cuda_chain.chain_geometry(kind, w)
    stream = lambda: _build.stream_handle(dev)  # noqa: E731
    timings = []
    for kind, (entry_name, plain, dtype, probe_lanes) in KINDS.items():
        calls = {}  # name -> x -> out
        for slots, warps, rows in VARIANTS:
            fn = entry(built[variant_name(slots, warps, rows)][0], entry_name + "_launch",
                       NEW_SIG)

            def call(x, n_chain, fn=fn, slots=slots, kind=kind):
                out = torch.empty_like(x)
                err = fn(x.data_ptr(), out.data_ptr(), x.shape[0] * x.shape[1], x.shape[-1],
                         n_chain, *geometry(kind, x.shape[-1], slots), stream())
                if err != 0:
                    raise RuntimeError(f"{entry_name} ({slots} slots) returned {err}")
                return out

            calls[variant_name(slots, warps, rows)] = call
        if "parent" in built:
            old = entry(built["parent"][0], entry_name + "_launch", OLD_SIG)

            def call_old(x, n_chain, fn=old):
                out = torch.empty_like(x)
                err = fn(x.data_ptr(), out.data_ptr(), x.shape[0] * x.shape[1], x.shape[-1],
                         n_chain, stream())
                if err != 0:
                    raise RuntimeError(f"the earlier {entry_name} returned {err}")
                return out

            calls["parent"] = call_old
        wrapper = getattr(cuda_chain, entry_name)
        calls["wrapper"] = lambda x, n_chain, w=wrapper: w(x, n_chain)

        mats = roofline.reference_mats()
        probe = roofline.to_lanes(torch.as_tensor(mats, device=dev), probe_lanes).to(dtype)
        inputs = {f"L{w}": roofline.to_lanes(
            torch.as_tensor(roofline.reference_mats(2 * w, 3), device=dev), w).to(dtype)
            for w in WIDTHS}
        inputs["probe"] = probe
        for label, x in inputs.items():
            for n_chain in ROUNDS:
                ref = calls["parent"](x, n_chain) if "parent" in calls else None
                p = plain(x, n_chain).float() if n_chain == 4 else None
                for name, call in calls.items():
                    if name == "parent":
                        continue
                    out = call(x, n_chain)
                    rec = dict(check=name, kind=kind, input=label, rounds=n_chain)
                    ok = True
                    if ref is not None:
                        rec["bits_equal_parent"] = bool(torch.equal(bits(out), bits(ref)))
                        ok &= rec["bits_equal_parent"]
                    if n_chain == 0:
                        rec["input_back"] = bool(torch.equal(out, x))
                        ok &= rec["input_back"]
                    if p is not None:
                        rel = float(((out.float() - p).abs() / p.abs().clamp_min(1.0)).max())
                        rec["rel_err_plain"] = rel
                        ok &= rel <= TOL["chain_bf16" if kind == "bf16" else "chain"]
                    rec["ok"] = ok
                    failed |= not ok
                    print(json.dumps(rec), flush=True)

        order = (["parent"] if "parent" in calls else []) + [
            variant_name(*v) for v in VARIANTS] + ["wrapper"]
        readings = {name: [] for name in order}
        for turn in (order, order[::-1]):
            for name in turn:
                fn = lambda c=calls[name]: c(probe, roofline.N_CHAIN)  # noqa: E731
                fn()
                torch.cuda.synchronize()
                windows = []
                for _ in range(5):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(20):
                        fn()
                    end.record()
                    end.synchronize()
                    windows.append(start.elapsed_time(end) / 20)
                readings[name].append(statistics.median(windows))
        for name in order:
            timings.append(dict(time=name, kind=kind, shape=list(probe.shape),
                                rounds=roofline.N_CHAIN, device_ms=readings[name],
                                mean_ms=statistics.fmean(readings[name]), card=smi))
        for name in ("parent", "wrapper"):
            if name in calls:
                mhz, watts = clocks_during(lambda c=calls[name]: c(probe, roofline.N_CHAIN))
                timings.append(dict(clocks=name, kind=kind, sm_mhz=mhz, power_w=watts, card=smi))
    for rec in timings:
        print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

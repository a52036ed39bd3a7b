"""Builds and loads the port's CUDA kernels.

Each `.cu` source in `csrc/` compiles with its own `nvcc` for `sm_90a`, all
started together, and the objects link into one shared library with a plain C
interface, which is loaded with `ctypes`. The library
goes to `build/gpmpc_tpu_torch/` at the repository root (git-ignored), named by
a hash of the sources and flags, so an edited source rebuilds. The build runs
on the first kernel launch, never at import. A missing `nvcc` or a failed
build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "gpmpc_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
UNSUPPORTED = -1  # a launcher's code for a shape or family it has no instantiation for

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes. Every one returns cudaGetLastError() as int.
SIGNATURES = {
    # z, Zt, alpha, W, mask, hyp, G, n, m, d, include_noise, mean, var, stream
    "gp_posterior_launch": [_P] * 6 + [_I] * 5 + [_P] * 3,
    # covdn, A, B, K, Bd, ppf, B, T, nd, nx, nu, wsq, tx, tu, stream
    "tighten_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # family, nx, nu, par8, hyp, X, U, Zs, alpha, n_tiles, T, L, Ms, use_gp, dt, fnext, A, B, stream
    "linearize_launch": [_I, _I, _I] + [_P] * 6 + [_I, _I, _I, _I, _I, _F, _P, _P, _P, _P],
}
# The lane-wise matmul chains of the roofline probe (csrc/lanes_chain.cu).
for _name in ("lanes_chain", "lanes_chain_bf16", "lanes_chain_16"):
    # x, out, n_blocks, L, n_chain, stream
    SIGNATURES[_name + "_launch"] = [_P, _P, _I, _I, _I, _P]
# The interior-point kernels: resident and tier-2 (csrc/ocp_ip_resident.cuh),
# tier-1 streamed (csrc/ocp_ip.cuh), each with hard and with L1-soft state
# bounds, one source and its entry points each.
OCP_IP_KERNELS = (
    "ocp_ip", "ocp_ip_soft", "ocp_ip_streamed", "ocp_ip_streamed_soft",
    "ocp_ip_streamed2", "ocp_ip_streamed2_soft",
)
# csrc/ocp_ip_resident.cuh: team and cluster
OCP_IP_RESIDENT = ("ocp_ip", "ocp_ip_soft", "ocp_ip_streamed2", "ocp_ip_streamed2_soft")
for _name in OCP_IP_KERNELS:
    # A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu, dx, du, gap, n_iters, ws, n_tiles, T, L,
    # nx, nu, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho, [team, cluster,] stream
    _geometry = [_I, _I] if _name in OCP_IP_RESIDENT else []
    SIGNATURES[_name + "_launch"] = [_P] * 16 + [_I] * 6 + [_F] * 4 + [_I, _F] + _geometry + [_P]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
            "kernels of gpmpc_tpu_torch cannot be built on this machine"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgpmpc_kernels_{h.hexdigest()[:16]}.so"


class BuildInfo:
    """What the last build did: wall seconds of the whole build, seconds from
    the build's start to each source's nvcc exit (they run in parallel), and
    the compiler's report."""

    seconds: float = 0.0
    per_source: dict = {}
    log: str = ""
    cached: bool = False


def _compile_all(nvcc: str, units: list[Path], workdir: Path, out: str) -> None:
    """One nvcc per source, all started together, then one link into `out`."""
    t0 = time.perf_counter()
    procs = {}
    for src in units:
        obj, log = workdir / (src.stem + ".o"), workdir / (src.stem + ".log")
        with open(log, "w") as f:  # the child keeps its own handle
            procs[src] = (obj, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
                stdout=f, stderr=subprocess.STDOUT,
            ))
    try:
        while any(src.name not in BuildInfo.per_source for src in procs):
            for src, (_, _, proc) in procs.items():
                if src.name not in BuildInfo.per_source and proc.poll() is not None:
                    BuildInfo.per_source[src.name] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:  # an interrupted build leaves no compiler running
        for _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs, failed = [], []
    for src, (_, log, proc) in procs.items():
        logs.append(f"== {src.name}\n{log.read_text()}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode})")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", out, *(str(obj) for obj, _, _ in procs.values())],
            capture_output=True, text=True,
        )
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link (exit {link.returncode})")
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "\n".join(logs)
    if failed:
        raise KernelBuildError(f"nvcc failed: {', '.join(failed)}\n{BuildInfo.log}")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if the hashed library is missing) and load the kernel library."""
    out = library_path()
    if out.exists():
        BuildInfo.cached = True
    else:
        nvcc = _find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        units = [p for p in _sources() if p.suffix == ".cu"]
        # Build into a temporary name and rename: concurrent first launches
        # (several test processes) never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            with tempfile.TemporaryDirectory(dir=out.parent) as objdir:
                _compile_all(nvcc, units, Path(objdir), tmp)
        except BaseException:
            os.unlink(tmp)
            raise
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cudaGetErrorString_wrapper.argtypes = [ctypes.c_int]
    lib.cudaGetErrorString_wrapper.restype = ctypes.c_char_p
    for name in OCP_IP_KERNELS:  # (T, nx, nu) -> floats of workspace per scenario
        fn = getattr(lib, name + "_workspace_floats")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_long
    for name in OCP_IP_RESIDENT:  # (nx, nu, scenarios per block) -> shared bytes of a block
        fn = getattr(lib, name + "_shared_bytes")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_long
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point `name`; raise if it reports a CUDA error or has no
    instantiation for the arguments."""
    lib = load_library()
    err = getattr(lib, name)(*args)
    if err == UNSUPPORTED:
        raise ValueError(f"{name}: no kernel instantiation for these widths or family")
    if err != 0:
        msg = lib.cudaGetErrorString_wrapper(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return t.data_ptr()

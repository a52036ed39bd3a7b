"""Builds and loads the port's CUDA kernels.

All sources in `csrc/` compile with `nvcc` for `sm_90a` into one shared
library with a plain C interface, which is loaded with `ctypes`. The library
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes. Every one returns cudaGetLastError() as int.
SIGNATURES = {
    # z, Zt, alpha, W, mask, hyp, n, m, d, mean, var, stream
    "gp_posterior_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # covdn, A, B, K, Bd, ppf, n_tiles, T, nd, L, tx, tu, stream
    "tighten_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # par8, hyp, X, U, Zs, alpha, n_tiles, T, L, Ms, use_gp, dt, fnext, A, B, stream
    "linearize_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P],
    # A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu, dx, du, gap, ws,
    # n_tiles, T, L, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, stream
    "ocp_ip_launch": [_P] * 15 + [_I, _I, _I, _I, _F, _F, _F, _F, _I, _P],
}


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
    """What the last build did: seconds spent and the compiler's report."""

    seconds: float = 0.0
    log: str = ""
    cached: bool = False


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if the hashed library is missing) and load the kernel library."""
    out = library_path()
    if out.exists():
        BuildInfo.cached = True
    else:
        nvcc = _find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        units = [str(p) for p in _sources() if p.suffix == ".cu"]
        # Build into a temporary name and rename: concurrent first launches
        # (several test processes) never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *units],
            capture_output=True, text=True,
        )
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}):\n{BuildInfo.log}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cudaGetErrorString_wrapper.argtypes = [ctypes.c_int]
    lib.cudaGetErrorString_wrapper.restype = ctypes.c_char_p
    lib.ocp_ip_workspace_floats.argtypes = [ctypes.c_int]
    lib.ocp_ip_workspace_floats.restype = ctypes.c_long
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point `name`; raise if it reports a CUDA error."""
    lib = load_library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.cudaGetErrorString_wrapper(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return t.data_ptr()

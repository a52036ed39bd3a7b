"""Importing the PyTorch port must not import JAX (or Triton).

The port runs where JAX is not installed, and it must never reach into the
JAX package (`gpmpc_tpu/__init__.py` imports jax). The check runs in a fresh
interpreter so that this test process's own imports do not mask a leak.
"""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import pkgutil, sys
sys.path.insert(0, {repo!r})
import gpmpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gpmpc_tpu_torch.__path__, "gpmpc_tpu_torch.")]
for name in names:
    __import__(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "triton", "gpmpc_tpu"))
print("MODULES", len(names))
print("LEAKED", leaked)
"""


def test_port_imports_no_jax_and_no_triton():
    r = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 24, r.stdout  # every module of the port was imported, device.py too
    assert "LEAKED []" in r.stdout, r.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port only: importing it pulls in no JAX."""
    probe = (
        f"import sys; sys.path.insert(0, {str(REPO)!r}); import chip_smoke; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'gpmpc_tpu')))"
    )
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("[]"), r.stdout


def test_port_sources_name_no_jax_and_no_reference_import():
    """Every Python file of the port and chip_smoke.py, read as text: no
    import of jax or of the JAX package, also inside functions."""
    files = sorted((REPO / "gpmpc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert REPO / "gpmpc_tpu_torch" / "device.py" in files
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|gpmpc_tpu)(\.|\s|$)", re.M)
    leaks = [str(f.relative_to(REPO)) for f in files if pat.search(f.read_text())]
    assert leaks == []


def test_every_ip_kernel_variant_has_its_source():
    """The build compiles csrc/*.cu: each interior-point entry point the build
    binds has a source of its name that defines it through the shared header."""
    from gpmpc_tpu_torch import _build

    csrc = REPO / "gpmpc_tpu_torch" / "csrc"
    for name in _build.OCP_IP_KERNELS:
        text = (csrc / f"{name}.cu").read_text()
        assert f"GPMPC_OCP_IP_ENTRY_POINTS({name}," in text and '#include "ocp_ip.cuh"' in text
        assert name + "_launch" in _build.SIGNATURES
    assert (csrc / "ocp_ip.cuh").exists()

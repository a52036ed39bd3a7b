"""Importing the PyTorch port must not import JAX (or Triton, PyYAML or matplotlib).

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
import pkgutil, runpy, sys
sys.path.insert(0, {repo!r})
import gpmpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gpmpc_tpu_torch.__path__, "gpmpc_tpu_torch.")]
for name in names:
    __import__(name)
for script in ("run_gp_mpc_torch", "eval_seeds_torch", "bench_gp_fit_torch",
               "run_multihost_torch", "bench_scaling_torch", "bench_step_breakdown_torch"):
    runpy.run_path(f"scripts/{{script}}.py", run_name="probe")
runpy.run_path("bench_torch.py", run_name="probe")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "triton", "gpmpc_tpu", "yaml",
                                       "matplotlib"))
print("MODULES", len(names), " ".join(names))
print("LEAKED", leaked)
"""


def test_port_imports_no_jax_and_no_triton():
    """Every module of the port and the experiment scripts' module tops
    (scripts/run_gp_mpc_torch.py, eval_seeds_torch.py, bench_gp_fit_torch.py,
    run_multihost_torch.py, bench_scaling_torch.py,
    bench_step_breakdown_torch.py and bench_torch.py; their mains import only
    modules of the port): no JAX, no Triton, nothing
    of the JAX package, and neither PyYAML nor matplotlib, which the card's
    machine does not have (matplotlib is imported only to draw)."""
    r = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 45, r.stdout  # every module of the port was imported, device.py too
    for name in ("roofline", "ops.cuda_chain", "models.jacobians", "gp.kernels", "gp.exact_gp",
                 "gp.sparse", "gp.compat", "runtime.online", "utils.benchkit", "parallel.sweep",
                 "runtime.server", "runtime.native", "utils.checkpoint", "envs._stateful",
                 "config", "utils.observations", "utils.profiling", "utils.plotting",
                 "parallel.mesh", "parallel.dryrun", "ops.riccati_parallel"):
        assert f"gpmpc_tpu_torch.{name}" in r.stdout, name
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
    """Every Python file of the port, chip_smoke.py and bench_torch.py, read
    as text: no import of jax or of the JAX package, also inside functions."""
    files = sorted((REPO / "gpmpc_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "bench_torch.py"] + sorted(
        (REPO / "scripts").glob("*_torch.py"))
    assert REPO / "gpmpc_tpu_torch" / "device.py" in files
    for name in ("run_gp_mpc_torch", "eval_seeds_torch", "bench_gp_fit_torch",
                 "serve_bench_torch", "bench_roofline_torch", "run_multihost_torch",
                 "bench_scaling_torch", "bench_step_breakdown_torch"):
        assert REPO / "scripts" / f"{name}.py" in files, name
    assert REPO / "gpmpc_tpu_torch" / "roofline.py" in files
    for sub in ("gp", "runtime", "utils"):  # the subpackages of GP training and learning
        assert any(f.parent == REPO / "gpmpc_tpu_torch" / sub for f in files), sub
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|gpmpc_tpu)(\.|\s|$)", re.M)
    leaks = [str(f.relative_to(REPO)) for f in files if pat.search(f.read_text())]
    assert leaks == []


def test_roofline_script_imports_no_jax():
    """scripts/bench_roofline_torch.py is the port's: importing it pulls in no
    JAX, no Triton and nothing of the JAX package."""
    probe = (
        "import runpy, sys; runpy.run_path('scripts/bench_roofline_torch.py', run_name='probe'); "
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'gpmpc_tpu')))"
    )
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("[]"), r.stdout


def test_serve_bench_script_imports_no_jax():
    """scripts/serve_bench_torch.py measures the port's server: it and every
    module its `main` imports pull in no JAX, no Triton and nothing of the
    JAX package."""
    probe = (
        "import runpy, sys; g = runpy.run_path('scripts/serve_bench_torch.py', run_name='probe'); "
        "import gpmpc_tpu_torch.runtime.server, gpmpc_tpu_torch.utils.benchkit, "
        "gpmpc_tpu_torch.envs.drone, gpmpc_tpu_torch.parallel.batch; "
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'gpmpc_tpu')))"
    )
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("[]"), r.stdout


def test_chain_kernels_have_their_source_and_entry_points():
    """The three chain kernels are hand-written CUDA in csrc/lanes_chain.cu
    (two `__global__` templates: one thread per 32-bit slot with the whole
    matrix in registers for kernels 7 and 8, a team of threads per scenario
    synchronized with `__syncwarp` for kernel 9; one instantiation behind each
    entry point), bound by the build, and call no library."""
    from gpmpc_tpu_torch import _build

    text = (REPO / "gpmpc_tpu_torch" / "csrc" / "lanes_chain.cu").read_text()
    for name, inst in (("lanes_chain", "launch_chain<F32>("),
                       ("lanes_chain_bf16", "launch_chain<Bf16x2>("),
                       ("lanes_chain_16", "launch_team_chain16(")):
        entry = text.split(f'extern "C" int {name}_launch(')[1].split('extern "C"')[0]
        assert inst in entry
        assert name + "_launch" in _build.SIGNATURES
    assert text.count("__global__ void") == 2 and "__syncwarp(team)" in text
    for library in ("cublas", "cutlass", "cudnn"):
        assert library not in text.lower()


def test_every_ip_kernel_variant_has_its_source():
    """The build compiles csrc/*.cu: each interior-point entry point the build
    binds has a source of its name that instantiates the resident kernel
    (ocp_ip_resident.cuh: a team of threads per scenario, a cluster per tile)
    under its own names, for all three QP tiers. ocp_ip.cuh keeps the element
    algebra they share and no kernel: the one-thread-per-scenario tiers are
    gone."""
    from gpmpc_tpu_torch import _build

    csrc = REPO / "gpmpc_tpu_torch" / "csrc"
    for name in _build.OCP_IP_KERNELS:
        text = (csrc / f"{name}.cu").read_text()
        assert f"GPMPC_OCP_IP_RESIDENT_ENTRY_POINTS({name}," in text
        assert '#include "ocp_ip_resident.cuh"' in text
        assert name + "_launch" in _build.SIGNATURES
    algebra = (csrc / "ocp_ip.cuh").read_text()
    for gone in ("RESIDENT", "__global__", "GPMPC_OCP_IP_ENTRY_POINTS"):
        assert gone not in algebra
    resident = (csrc / "ocp_ip_resident.cuh").read_text()
    for feature in ("cudaLaunchAttributeClusterDimension", "map_shared_rank", "cp.async",
                    "__shfl_xor_sync"):
        assert feature in resident


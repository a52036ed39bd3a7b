"""The port's packages export the reference's names: each `__all__` of
`gpmpc_tpu_torch` equals the JAX package's counterpart, in its order, less
the names not ported yet (`UNPORTED`, each with its ROADMAP.md item), and
every exported name resolves. The reference's `__all__` is read from its
source with `ast`, so that no JAX import enters this check."""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

PACKAGES = ["", "models", "ops", "control", "envs", "parallel", "gp", "runtime", "utils"]

# Names of the reference's __all__ that the port does not have yet, by subpackage: none.
UNPORTED: dict[str, set] = {}


def reference_all(sub: str) -> list[str]:
    """The `__all__` list of gpmpc_tpu[.sub]/__init__.py, read as a literal."""
    path = REPO / "gpmpc_tpu" / sub / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


@pytest.mark.parametrize("sub", PACKAGES, ids=[s or "top" for s in PACKAGES])
def test_port_all_is_the_references_less_the_unported(sub):
    port = importlib.import_module("gpmpc_tpu_torch" + (f".{sub}" if sub else ""))
    want = reference_all(sub)
    unported = UNPORTED.get(sub, set())
    assert unported <= set(want), "a listed name is no longer in the reference"
    exported = list(getattr(port, "__all__", []))
    assert exported == [n for n in want if n not in unported]
    for name in exported:
        assert getattr(port, name, None) is not None, name
    for name in unported:  # the list stays honest: a ported name leaves it
        assert not hasattr(port, name), name


def test_issue_imports_work():
    """The imports a user of the reference writes, on the port, the names
    that left UNPORTED (items 8c, 10 and 12) among them: they resolve to the
    port's own modules, and `make_batched_controller_step` takes a mesh of
    `make_mesh` and returns its step."""
    from gpmpc_tpu_torch.control import GPMPC, MPC
    from gpmpc_tpu_torch.envs import DroneFigureEightEnv
    from gpmpc_tpu_torch.ops import sqp_solve
    from gpmpc_tpu_torch.parallel import batched_gpmpc_step, make_batched_controller_step
    from gpmpc_tpu_torch.runtime import NativeOcpSolver, build_native_library
    from gpmpc_tpu_torch.runtime.server import ControlServer

    assert callable(sqp_solve) and callable(batched_gpmpc_step)
    assert GPMPC.__module__ == "gpmpc_tpu_torch.control.gpmpc"
    assert MPC.__module__ == "gpmpc_tpu_torch.control.mpc"
    assert DroneFigureEightEnv.__module__ == "gpmpc_tpu_torch.envs.drone"
    assert NativeOcpSolver.__module__ == build_native_library.__module__ == "gpmpc_tpu_torch.runtime.native"
    assert ControlServer.__module__ == "gpmpc_tpu_torch.runtime.server"
    step = make_batched_controller_step("model", "cfg")
    assert step.func is batched_gpmpc_step and step.args == ("model", "cfg")
    from gpmpc_tpu_torch.parallel import init_distributed, make_mesh, shard_leading_axis

    assert make_mesh.__module__ == init_distributed.__module__ == shard_leading_axis.__module__ \
        == "gpmpc_tpu_torch.parallel.mesh"
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    assert mesh.devices.shape == (2,) and mesh.axis_names == ("data",)
    assert callable(make_batched_controller_step("model", "cfg", mesh=mesh))

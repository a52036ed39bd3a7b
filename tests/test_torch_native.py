"""The port's loader of the C++ oracle (`runtime/native.py`) against the JAX
package's loader of the same unchanged `native/ocp_solver.cpp`, and the
oracle against the port's `ops/boxqp.py::solve_ocp_qp`.

Both loaders call the same C code on the same inputs, so every entry point
(the QP, the nominal MPC, the tightening and the GP-MPC solve of the
quadrotor and of the generic families) must agree bit for bit. The oracle
against the port's box QP: 5e-4 absolute on dx and du
(tests/test_native.py:41's bar against the reference's). The port builds its
library under build/native/ and never writes the reference's build product
in native/."""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.gp.exact_gp import softplus
from gpmpc_tpu_torch.ops.boxqp import OcpQpData, solve_ocp_qp
from gpmpc_tpu_torch.runtime import native as t_native
from gpmpc_tpu_torch.runtime import NativeOcpSolver, build_native_library

T, NX, NU = 8, 12, 4
REPO = t_native._REPO


@pytest.fixture(scope="module")
def solvers():
    """(the port's loader, the reference's loader), the reference's bindings
    on the library the port built: its own build would write native/ (not
    atomically, while tests/test_native.py may build it in another worker)."""
    from gpmpc_tpu.runtime import native as j_native

    port = NativeOcpSolver()
    build = j_native.build_native_library
    j_native.build_native_library = lambda force=False: build_native_library()
    try:
        ref = j_native.NativeOcpSolver()
    finally:
        j_native.build_native_library = build
    return port, ref


def make_qp(seed=0):
    """tests/test_native.py's random QP."""
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(NX, dtype=np.float32), (T, 1, 1)) + 0.08 * rng.normal(
        size=(T, NX, NX)).astype(np.float32)
    B = (rng.normal(size=(T, NX, NU)) * 0.4).astype(np.float32)
    r = (rng.normal(size=(T, NX)) * 0.05).astype(np.float32)
    qdiag = rng.uniform(0.5, 2.0, (T + 1, NX)).astype(np.float32)
    qx = (rng.normal(size=(T + 1, NX)) * 0.4).astype(np.float32)
    rdiag = rng.uniform(0.5, 2.0, (T, NU)).astype(np.float32)
    ru = (rng.normal(size=(T, NU)) * 0.4).astype(np.float32)
    lx = np.full((T + 1, NX), -1.2, np.float32)
    ux = np.full((T + 1, NX), 1.2, np.float32)
    lu = np.full((T, NU), -0.25, np.float32)
    uu = np.full((T, NU), 0.25, np.float32)
    lx[0] = -1e8
    ux[0] = 1e8
    return dict(A=A, B=B, r=r, qdiag=qdiag, qx=qx, rdiag=rdiag, ru=ru, lx=lx, ux=ux, lu=lu, uu=uu)


def test_port_builds_under_build_and_never_writes_native(monkeypatch):
    """g++ compiles the unchanged native/ocp_solver.cpp into build/native/
    (a temporary name there, renamed to one with the source's hash), never
    into native/, where the reference puts its build product."""
    commands = []
    run = t_native.subprocess.run

    def record(cmd, **kw):
        commands.append(cmd)
        return run(cmd, **kw)

    monkeypatch.setattr(t_native.subprocess, "run", record)
    lib = build_native_library(force=True)
    assert lib.parent == REPO / "build" / "native" and lib.name.startswith("libgpmpc_native_")
    assert lib.exists()
    (cmd,) = commands
    out = cmd[cmd.index("-o") + 1]
    assert out.startswith(str(REPO / "build" / "native")) and "native/libgpmpc_native.so" not in out
    assert cmd[-1] == str(REPO / "native" / "ocp_solver.cpp")
    assert build_native_library() == lib and len(commands) == 1  # cached


@pytest.mark.parametrize("seed", [0, 3])
def test_qp_matches_the_reference_loader_and_the_port_boxqp(solvers, seed):
    port, ref = solvers
    d = make_qp(seed)
    dx, du = port.solve(**d, n_ip=15)
    dx_r, du_r = ref.solve(**d, n_ip=15)
    assert isinstance(dx, np.ndarray)
    np.testing.assert_array_equal(dx, dx_r)
    np.testing.assert_array_equal(du, du_r)
    dx_t, du_t = port.solve(**{k: torch.as_tensor(v) for k, v in d.items()}, n_ip=15)
    assert isinstance(dx_t, torch.Tensor) and torch.equal(dx_t, torch.as_tensor(dx))
    t = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    qp = OcpQpData(A=t(d["A"]), B=t(d["B"]), r=t(d["r"]),
                   Qxx=t(np.stack([np.diag(q) for q in d["qdiag"]])), qx=t(d["qx"]),
                   Ruu=t(np.stack([np.diag(q) for q in d["rdiag"]])), ru=t(d["ru"]),
                   lx=t(d["lx"]), ux=t(d["ux"]), lu=t(d["lu"]), uu=t(d["uu"]))
    sol = solve_ocp_qp(qp, n_iter=15)
    np.testing.assert_allclose(du, sol.du[0].numpy(), atol=5e-4)
    np.testing.assert_allclose(dx, sol.dx[0].numpy(), atol=5e-4)


def test_quadrotor_entry_points_match_the_reference_loader(solvers):
    """mpc_solve, tighten and gpmpc_solve on the benchmark GP, a few
    iterations from a hover warm start."""
    port, ref = solvers
    rng = np.random.default_rng(1)
    H = 6
    params8 = np.asarray([12.1432, 1.8118, -72.08, -7.5755, 39.8653, -72.08, -7.5755, 39.8653],
                         np.float32)
    x0 = (rng.normal(0, 0.05, 12)).astype(np.float32)
    xref = (rng.normal(0, 0.1, (H + 1, 12))).astype(np.float32)
    uref = np.tile(np.asarray([0.3234, 0, 0, 0], np.float32), (H, 1))
    q, r = np.ones(12, np.float32), np.ones(4, np.float32)
    lx, ux = np.full(12, -5.0, np.float32), np.full(12, 5.0, np.float32)
    lu, uu = np.asarray([0.1, -1, -1, -1], np.float32), np.asarray([0.6, 1, 1, 1], np.float32)
    X0, U0 = np.tile(x0, (H + 1, 1)), uref.copy()
    args = (params8, 0.02, x0, xref, uref, q, r, q, lx, ux, lu, uu, X0, U0)
    for a, b in zip(port.mpc_solve(*args, sqp_iters=3, qp_iters=8),
                    ref.mpc_solve(*args, sqp_iters=3, qp_iters=8)):
        np.testing.assert_array_equal(a, b)

    gp = convert.load_bench_gp("cpu")
    ell = softplus(gp.hypers.raw_lengthscale).double().numpy()
    inv_ell2 = np.broadcast_to((1.0 / ell**2).reshape(3, -1), (3, 3)).copy()
    sf2 = softplus(gp.hypers.raw_outputscale).double().numpy()
    noise = softplus(gp.hypers.raw_noise).double().numpy() + 1e-6
    Ad = np.eye(12) + 0.02 * np.eye(12, k=1)
    Bd = 0.02 * np.eye(12, 4)
    K = 0.1 * np.ones((4, 12))
    targs = (X0 + 0.01, U0, gp.var_Z, gp.var_mat, gp.var_mask, inv_ell2, sf2, noise, Ad, Bd, K,
             2.0, 0.02)
    t_port, t_ref = port.tighten(*targs), ref.tighten(*[np.asarray(a) for a in targs])
    for a, b in zip(t_port, t_ref):
        assert isinstance(a, torch.Tensor)  # the GP leaves came in as tensors
        np.testing.assert_array_equal(a.numpy(), b)
    assert float(t_port[0].max()) > 0
    lx_s, ux_s = np.tile(lx, (H + 1, 1)), np.tile(ux, (H + 1, 1))
    lu_s, uu_s = np.tile(lu, (H, 1)), np.tile(uu, (H, 1))
    gargs = (params8, 0.02, gp.Zs.numpy(), gp.alpha_s.numpy(), inv_ell2, sf2, x0, xref, uref, q, r,
             q, lx_s, ux_s, lu_s, uu_s, X0, U0)
    for a, b in zip(port.gpmpc_solve(*gargs, sqp_iters=3, qp_iters=8),
                    ref.gpmpc_solve(*gargs, sqp_iters=3, qp_iters=8)):
        np.testing.assert_array_equal(a, b)


def test_family_entry_points_match_the_reference_loader(solvers):
    """family_tighten and family_gpmpc_solve for the two-link arm on its
    benchmark GP (G = 2, D = 6)."""
    port, ref = solvers
    rng = np.random.default_rng(2)
    H, nx, nu = 5, 4, 2
    gp = convert.load_bench_gp("cpu", "twolink")
    ell = softplus(gp.hypers.raw_lengthscale).double().numpy()
    inv_ell2 = np.broadcast_to((1.0 / ell**2).reshape(2, -1), (2, 6)).copy()
    sf2 = softplus(gp.hypers.raw_outputscale).double().numpy()
    noise = softplus(gp.hypers.raw_noise).double().numpy() + 1e-6
    x0 = np.asarray([-1.57, 0.1, 0.0, 0.0], np.float32)
    X0 = (np.tile(x0, (H + 1, 1)) + rng.normal(0, 0.02, (H + 1, nx))).astype(np.float32)
    U0 = rng.normal(0, 0.5, (H, nu)).astype(np.float32)
    Ad, Bd, K = np.eye(nx) + 0.02 * np.eye(nx, k=2), 0.02 * np.eye(nx, nu, k=-2), 0.2 * np.ones((nu, nx))
    targs = ("twolink", X0, U0, gp.var_Z.numpy(), gp.var_mat.numpy(), gp.var_mask.numpy(), inv_ell2,
             sf2, noise, Ad, Bd, K, 2.0, 0.02)
    t_port, t_ref = port.family_tighten(*targs), ref.family_tighten(*targs)
    for a, b in zip(t_port, t_ref):
        np.testing.assert_array_equal(a, b)
    xref = np.tile(x0, (H + 1, 1)).astype(np.float32)
    q, r = np.ones(nx, np.float32), 0.1 * np.ones(nu, np.float32)
    lx_s, ux_s = np.full((H + 1, nx), -10.0, np.float32), np.full((H + 1, nx), 10.0, np.float32)
    lu_s, uu_s = np.full((H, nu), -20.0, np.float32), np.full((H, nu), 20.0, np.float32)
    gargs = ("twolink", np.asarray([1.0, 1.0, 1.0, 1.0]), 0.02, gp.Zs.numpy(), gp.alpha_s.numpy(),
             inv_ell2, sf2, x0, xref, U0, q, r, q, lx_s, ux_s, lu_s, uu_s, X0, U0)
    for a, b in zip(port.family_gpmpc_solve(*gargs, sqp_iters=3, qp_iters=8),
                    ref.family_gpmpc_solve(*gargs, sqp_iters=3, qp_iters=8)):
        np.testing.assert_array_equal(a, b)
        assert np.all(np.isfinite(a))


def test_device_tensors_are_refused(solvers):
    """The oracle runs on the host: a tensor on any other device raises."""
    d = make_qp(0)
    d["A"] = torch.empty(T, NX, NX, device="meta")
    with pytest.raises(ValueError, match="host"):
        solvers[0].solve(**d)

"""ctypes loader of the C++ OCP oracle (`native/ocp_solver.cpp`). Port of
`gpmpc_tpu/runtime/native.py`: `build_native_library`, `NativeOcpSolver`,
with its own copy of the bindings.

The oracle is a hand-written, model-independent interior-point/Riccati
solver in double precision, compiled once with g++: an independent host
reference for the port's solvers. It runs on no card: it takes numpy arrays
or CPU tensors and returns numpy arrays, or CPU tensors when it was given
tensors. The library is built from the unchanged source into `build/native/`
(named by a hash of the source); the reference's own build product,
`native/libgpmpc_native.so`, is never written here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "ocp_solver.cpp"
_BUILD_DIR = _REPO / "build" / "native"


def build_native_library(force: bool = False) -> Path:
    """Compile native/ocp_solver.cpp into build/native/ (cached by a hash of
    the source; written under a temporary name and renamed, so concurrent
    builds do not see a half-written library)."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libgpmpc_native_{digest}.so"
    if lib.exists() and not force:
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    r = subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SOURCE}:\n{r.stderr}")
    os.replace(tmp, lib)
    return lib


# Family ids of the generic oracle entry points (native/ocp_solver.cpp).
NATIVE_FAMILIES = {"cartpole": 1, "twolink": 2}

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)


def _host(a, dtype) -> np.ndarray:
    """A C-contiguous host array of `dtype` from a numpy array or CPU tensor."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"the native OCP solver runs on the host; got a tensor on {a.device}")
        a = a.detach().numpy()
    return np.ascontiguousarray(a, dtype=dtype)


def _outputs(inputs, *arrays):
    """The results as CPU tensors if any input was a tensor, else as arrays."""
    if any(isinstance(a, torch.Tensor) for a in inputs):
        return tuple(torch.from_numpy(a) for a in arrays)
    return arrays


def _f32(arrays):
    return [_host(a, np.float32) for a in arrays]


def _f64(arrays):
    return [_host(a, np.float64) for a in arrays]


def _p32(arrays):
    return [a.ctypes.data_as(_F32P) for a in arrays]


def _p64(arrays):
    return [a.ctypes.data_as(_F64P) for a in arrays]


class NativeOcpSolver:
    """Host-side box-constrained OCP-QP solver (double precision inside)."""

    def __init__(self):
        self._lib = ctypes.CDLL(str(build_native_library()))
        i, f, d = ctypes.c_int, ctypes.c_float, ctypes.c_double
        signatures = {
            "gpmpc_native_solve_ocp_qp": (ctypes.c_int, [i] * 3 + [_F32P] * 11 + [i, f, f, f]
                                          + [_F32P] * 2),
            "gpmpc_native_mpc_solve": (ctypes.c_int, [_F32P, f, i] + [_F32P] * 10 + [i, i, f]
                                       + [_F32P] * 2),
            "gpmpc_native_tighten": (None, [i, i] + [_F64P] * 11 + [d, d] + [_F64P] * 2),
            "gpmpc_native_gpmpc_solve": (ctypes.c_int, [_F32P, f, i, i] + [_F64P] * 4
                                         + [_F32P] * 10 + [i, i, f] + [_F32P] * 2),
            "gpmpc_native_family_tighten": (None, [i] * 3 + [_F64P] * 11 + [d, d] + [_F64P] * 2),
            "gpmpc_native_family_gpmpc_solve": (ctypes.c_int, [i, _F32P, f, i, i] + [_F64P] * 4
                                                + [_F32P] * 10 + [i, i, f] + [_F32P] * 2),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(self._lib, name)
            fn.restype, fn.argtypes = restype, argtypes

    def mpc_solve(
        self,
        params8,  # (8,) quadrotor params [a..l]
        dt: float,
        x0,  # (12,)
        xref,  # (T+1, 12)
        uref,  # (T, 4)
        qdiag,  # (12,)
        rdiag,  # (4,)
        qediag,  # (12,)
        lx, ux,  # (12,)
        lu, uu,  # (4,)
        X_warm,  # (T+1, 12)
        U_warm,  # (T, 4)
        sqp_iters: int = 25,
        qp_iters: int = 20,
        step_tol: float = 1e-6,
    ):
        """Full nominal-MPC solve on the host, the independent full-stack
        oracle (dynamics, finite-difference Jacobians, SQP and IP in double
        precision). Returns (X (T+1, 12), U (T, 4))."""
        inputs = (params8, x0, xref, uref, qdiag, rdiag, qediag, lx, ux, lu, uu, X_warm, U_warm)
        T = uref.shape[0]
        X, U = _f32([X_warm, U_warm])
        X, U = X.copy(), U.copy()
        args = _f32(inputs[:11])
        status = self._lib.gpmpc_native_mpc_solve(
            args[0].ctypes.data_as(_F32P), dt, T, *_p32(args[1:]),
            sqp_iters, qp_iters, step_tol, *_p32([X, U]),
        )
        if status != 0:
            raise RuntimeError(f"native MPC solver failed with status {status}")
        return _outputs(inputs, X, U)

    def tighten(
        self,
        X_prev,  # (T+1, 12) previous solution
        U_prev,  # (T, 4)
        var_Z,  # (3, Ms, 3)
        var_mat,  # (3, Ms, Ms)
        var_mask,  # (3, Ms)
        inv_ell2,  # (3, 3)
        sf2,  # (3,)
        noise,  # (3,)
        Ad,  # (12, 12)
        Bd_in,  # (12, 4)
        lqr_gain,  # (4, 12)
        ppf: float,
        dt: float,
    ):
        """Chance-constraint tightenings (t_x (T+1, 12), t_u (T, 4)) from the
        GP predictive variance along the previous solution: the double
        precision oracle of `control/gpmpc.py::propagate_constraint_limits`."""
        inputs = (X_prev, U_prev, var_Z, var_mat, var_mask, inv_ell2, sf2, noise, Ad, Bd_in,
                  lqr_gain)
        T, ms = U_prev.shape[0], var_Z.shape[1]
        t_x = np.zeros((T + 1, 12), np.float64)
        t_u = np.zeros((T, 4), np.float64)
        self._lib.gpmpc_native_tighten(T, ms, *_p64(_f64(inputs)), float(ppf), float(dt),
                                       *_p64([t_x, t_u]))
        return _outputs(inputs, t_x, t_u)

    def gpmpc_solve(
        self,
        params8,
        dt: float,
        gp_Zs,  # (3, Ms, 3) mean-inducing inputs
        gp_alpha,  # (3, Ms)
        gp_inv_ell2,  # (3, 3)
        gp_sf2,  # (3,)
        x0,
        xref,  # (T+1, 12)
        uref,  # (T, 4)
        qdiag,
        rdiag,
        qediag,
        lx_stage, ux_stage,  # (T+1, 12) tightened boxes
        lu_stage, uu_stage,  # (T, 4)
        X_warm,
        U_warm,
        sqp_iters: int = 25,
        qp_iters: int = 20,
        step_tol: float = 1e-6,
    ):
        """Full GP-MPC solve (GP-augmented dynamics, per-stage tightened
        bounds): the external oracle of `GPMPC.select_action`'s solve."""
        gp_in = (gp_Zs, gp_alpha, gp_inv_ell2, gp_sf2)
        rest = (params8, x0, xref, uref, qdiag, rdiag, qediag, lx_stage, ux_stage, lu_stage,
                uu_stage)
        inputs = gp_in + rest + (X_warm, U_warm)
        T, ms = uref.shape[0], gp_Zs.shape[1]
        X, U = (a.copy() for a in _f32([X_warm, U_warm]))
        args = _f32(rest)
        status = self._lib.gpmpc_native_gpmpc_solve(
            args[0].ctypes.data_as(_F32P), dt, T, ms, *_p64(_f64(gp_in)), *_p32(args[1:]),
            sqp_iters, qp_iters, step_tol, *_p32([X, U]),
        )
        if status != 0:
            raise RuntimeError(f"native GP-MPC solver failed with status {status}")
        return _outputs(inputs, X, U)

    # -- family-generic oracle (cartpole, two-link arm) -------------------------
    # The quadrotor keeps its own entry points (rotated mean and variance
    # injection); these families share identity var_factors and direct row
    # injection, so one generic C++ path covers both.

    def family_tighten(
        self,
        family: str,
        X_prev,  # (T+1, nx)
        U_prev,  # (T, nu)
        var_Z,  # (G, Ms, D)
        var_mat,  # (G, Ms, Ms)
        var_mask,  # (G, Ms)
        inv_ell2,  # (G, D)
        sf2,  # (G,)
        noise,  # (G,)
        Ad, Bd_in, lqr_gain,
        ppf: float, dt: float,
    ):
        inputs = (X_prev, U_prev, var_Z, var_mat, var_mask, inv_ell2, sf2, noise, Ad, Bd_in,
                  lqr_gain)
        T, nu = U_prev.shape
        nx, ms = X_prev.shape[1], var_Z.shape[1]
        t_x = np.zeros((T + 1, nx), np.float64)
        t_u = np.zeros((T, nu), np.float64)
        self._lib.gpmpc_native_family_tighten(
            NATIVE_FAMILIES[family], T, ms, *_p64(_f64(inputs)), float(ppf), float(dt),
            *_p64([t_x, t_u]))
        return _outputs(inputs, t_x, t_u)

    def family_gpmpc_solve(
        self,
        family: str,
        params,  # the family's plant params (padded to 8)
        dt: float,
        gp_Zs,  # (G, Ms, D)
        gp_alpha,  # (G, Ms)
        gp_inv_ell2,  # (G, D)
        gp_sf2,  # (G,)
        x0,
        xref,  # (T+1, nx)
        uref,  # (T, nu)
        qdiag, rdiag, qediag,
        lx_stage, ux_stage,  # (T+1, nx)
        lu_stage, uu_stage,  # (T, nu)
        X_warm, U_warm,
        sqp_iters: int = 25, qp_iters: int = 20, step_tol: float = 1e-6,
    ):
        """Full GP-MPC solve for a non-quadrotor family (pass a (G, 0, D) Zs
        for the nominal controller)."""
        gp_in = (gp_Zs, gp_alpha, gp_inv_ell2, gp_sf2)
        rest = (x0, xref, uref, qdiag, rdiag, qediag, lx_stage, ux_stage, lu_stage, uu_stage)
        inputs = (params,) + gp_in + rest + (X_warm, U_warm)
        T, ms = uref.shape[0], gp_Zs.shape[1]
        p8 = np.zeros(8, np.float32)
        params = _host(params, np.float32)
        p8[: len(params)] = params
        X, U = (a.copy() for a in _f32([X_warm, U_warm]))
        status = self._lib.gpmpc_native_family_gpmpc_solve(
            NATIVE_FAMILIES[family], p8.ctypes.data_as(_F32P), dt, T, ms, *_p64(_f64(gp_in)),
            *_p32(_f32(rest)), sqp_iters, qp_iters, step_tol, *_p32([X, U]),
        )
        if status != 0:
            raise RuntimeError(f"native family GP-MPC solve failed: {status}")
        return _outputs(inputs, X, U)

    def solve(
        self,
        A,  # (T, nx, nx)
        B,  # (T, nx, nu)
        r,  # (T, nx)
        qdiag,  # (T+1, nx)
        qx,  # (T+1, nx)
        rdiag,  # (T, nu)
        ru,  # (T, nu)
        lx,
        ux,
        lu,
        uu,
        n_ip: int = 15,
        mu0: float = 1e-1,
        sigma: float = 0.2,
        tau: float = 0.995,
    ):
        """One box-constrained OCP QP: (dx (T+1, nx), du (T, nu))."""
        inputs = (A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu)
        T, nx, nu = A.shape[0], A.shape[1], B.shape[2]
        dx = np.zeros((T + 1, nx), np.float32)
        du = np.zeros((T, nu), np.float32)
        status = self._lib.gpmpc_native_solve_ocp_qp(
            T, nx, nu, *_p32(_f32(inputs)), n_ip, mu0, sigma, tau, *_p32([dx, du]),
        )
        if status != 0:
            raise RuntimeError(f"native OCP solver failed with status {status}")
        return _outputs(inputs, dx, du)

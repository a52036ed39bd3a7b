"""Setup-time dense linear algebra in float64 numpy: exact discretization and
the discrete LQR gain. Copy of `gpmpc_tpu/ops/linalg.py`, which cannot be
imported without JAX."""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm


def discretize_linear_system(
    A: np.ndarray, B: np.ndarray, dt: float, exact: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Exact (expm of [[A, B], [0, 0]] * dt) or Euler discretization of (A, B)."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    nx, nu = A.shape[1], B.shape[1]
    if exact:
        M = np.zeros((nx + nu, nx + nu))
        M[:nx, :nx] = A
        M[:nx, nx:] = B
        Md = expm(M * dt)
        return Md[:nx, :nx], Md[:nx, nx:]
    return np.eye(nx) + A * dt, B * dt


def solve_discrete_are(
    A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray, iters: int = 60
) -> np.ndarray:
    """Discrete algebraic Riccati equation by the structure-preserving doubling
    algorithm (the same iteration as the reference, so both give the same P)."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    n = A.shape[0]
    G = B @ np.linalg.solve(R, B.T)
    Ak, Gk, Hk = A.copy(), G.copy(), Q.copy()
    eye = np.eye(n)
    for _ in range(iters):
        W = eye + Gk @ Hk
        W_inv_A = np.linalg.solve(W, Ak)
        W_inv_G = np.linalg.solve(W, Gk)
        A_next = Ak @ W_inv_A
        G_next = Gk + Ak @ W_inv_G @ Ak.T
        H_next = Hk + W_inv_A.T @ Hk @ Ak
        if np.linalg.norm(H_next - Hk, ord="fro") <= 1e-14 * max(
            1.0, np.linalg.norm(Hk, ord="fro")
        ):
            Hk = H_next
            break
        Ak, Gk, Hk = A_next, G_next, H_next
    return 0.5 * (Hk + Hk.T)


def lqr_gain_discrete(
    A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """K = -(R + B'PB)^-1 B'PA and the DARE solution P."""
    P = solve_discrete_are(A, B, Q, R)
    btp = B.T @ P
    K = -np.linalg.solve(R + btp @ B, btp @ A)
    return K, P

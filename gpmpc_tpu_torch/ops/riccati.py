"""Riccati recursion for affine LQ optimal-control subproblems, batch-first.

Port of `gpmpc_tpu/ops/riccati.py`: every interior-point iteration of the
OCP-QP (`ops/boxqp.py`) reduces to one equality-constrained affine LQR
solve, a backward sweep over the stages followed by a forward rollout. Every
leaf carries a leading scenario axis B; the sweeps are Python loops over the
T stages, each stage a few batched products over all B scenarios.

Solves, for each scenario:
    min_{dx, du}  sum_k 1/2 dx_k'Qxx_k dx_k + qx_k'dx_k
                        + 1/2 du_k'Ruu_k du_k + ru_k'du_k
    s.t.          dx_{k+1} = A_k dx_k + B_k du_k + r_k,   dx_0 = dx0.

The backward sweep is split in two: `riccati_factor`, the matrix recursion
(P, the Cholesky factor of Guu, the gains K), which depends only on the
dynamics and the Hessians, and `riccati_apply`, the vector recursion and the
rollout for given linear terms. The reference computes both in every solve;
the interior point's two Newton solves of a Mehrotra iteration share the
matrices, so `ops/boxqp.py` factors once and applies twice, with the same
arithmetic as two full solves. The products of a stage are taken on [A | B]
at once (A'PA, A'PB and B'PB are blocks of [A | B]' P [A | B]).

The solves through Guu's Cholesky factor L go through L's inverse, formed
once a stage by one batched triangular solve against the identity
(`tril_inverse`: cuBLAS's batched `trsm` on the card, LAPACK on the CPU):
Guu^-1 b = L^-T (L^-1 b), two small products. The same code runs on the CPU
and the card, and it is capturable in a CUDA graph, where
`torch.cholesky_solve` is not (PyTorch sends a batch to MAGMA, whose
`magma_spotrs_batched` a capturing stream refuses).

A scenario whose Guu is not positive definite at some stage gets NaN in its
whole solution, as JAX's Cholesky gives it, while the other scenarios of the
batch are solved as usual (`torch.linalg.cholesky` would raise for the batch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LqProblem(NamedTuple):
    """Stage-wise affine LQ data for B scenarios, T stages, state nx, input nu.

    A:   (B, T, nx, nx)   B: (B, T, nx, nu)   r: (B, T, nx)
    Qxx: (B, T+1, nx, nx) qx: (B, T+1, nx)
    Ruu: (B, T, nu, nu)   ru: (B, T, nu)
    """

    A: torch.Tensor
    B: torch.Tensor
    r: torch.Tensor
    Qxx: torch.Tensor
    qx: torch.Tensor
    Ruu: torch.Tensor
    ru: torch.Tensor


class LqSolution(NamedTuple):
    dx: torch.Tensor  # (B, T+1, nx)
    du: torch.Tensor  # (B, T, nu)
    K: torch.Tensor  # (B, T, nu, nx) feedback gains
    kff: torch.Tensor  # (B, T, nu) feedforward terms


class RiccatiFactor(NamedTuple):
    """The matrix half of the backward sweep, per stage k (lists of T):
    P_{k+1}, the inverse of Guu_k's Cholesky factor, Gxu_k and the gain K_k."""

    AB: torch.Tensor  # (B, T, nx, nx + nu), [A | B]
    P_next: list
    Linv: list
    Gxu: list
    K: list


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., a, b) @ (..., b) -> (..., a)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def cholesky_or_nan(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of (..., n, n), NaN in every matrix that is not
    positive definite (JAX's per-matrix failure) instead of a raise for all."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, torch.nan), L)


def tril_inverse(L: torch.Tensor) -> torch.Tensor:
    """The inverse of each lower-triangular (..., n, n) L: one batched
    triangular solve against the identity (for n <= 512 PyTorch takes
    cuBLAS's batched `trsm` on the card, not MAGMA). NaN in L gives NaN."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def cholesky_inverse_or_nan(G: torch.Tensor) -> torch.Tensor:
    """L^-1 for the lower Cholesky factor L of each (..., n, n) G, NaN in
    every matrix that is not positive definite (`cholesky_or_nan`)."""
    return tril_inverse(cholesky_or_nan(G))


def cho_apply(Linv: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """G^-1 rhs for G = L L' from Linv = L^-1 (`cholesky_inverse_or_nan`):
    L^-T (L^-1 rhs), what `torch.cholesky_solve(rhs, L)` computes."""
    return Linv.transpose(-1, -2) @ (Linv @ rhs)


def stack_dynamics(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[A | B], (B, T, nx, nx + nu): formed once per QP."""
    return torch.cat([A, B], dim=-1)


def riccati_factor(AB: torch.Tensor, Qxx: torch.Tensor, Ruu: torch.Tensor) -> RiccatiFactor:
    """The backward matrix recursion for dynamics [A | B] (`stack_dynamics`)
    and Hessians Qxx (B, T+1, nx, nx), Ruu (B, T, nu, nu)."""
    T, nx = AB.shape[1], AB.shape[2]
    ABt = AB.transpose(-1, -2)
    P = Qxx[:, T]
    P_next, Linv, Gxu, K = [None] * T, [None] * T, [None] * T, [None] * T
    for k in range(T - 1, -1, -1):
        P_next[k] = P
        H = (ABt[:, k] @ P) @ AB[:, k]  # [A'PA, A'PB; B'PA, B'PB]
        Gxx = Qxx[:, k] + H[:, :nx, :nx]
        Guu = Ruu[:, k] + H[:, nx:, nx:]
        Gxu[k] = H[:, :nx, nx:]
        # du* = K dx + kff through the Cholesky factor of Guu
        Linv[k] = cholesky_inverse_or_nan(Guu)
        K[k] = -cho_apply(Linv[k], Gxu[k].transpose(-1, -2))
        P = Gxx + Gxu[k] @ K[k]
        P = 0.5 * (P + P.transpose(-1, -2))
    return RiccatiFactor(AB=AB, P_next=P_next, Linv=Linv, Gxu=Gxu, K=K)


def riccati_apply(
    f: RiccatiFactor, r: torch.Tensor, qx: torch.Tensor, ru: torch.Tensor, dx0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward vector recursion and the forward rollout for the linear
    terms r (B, T, nx), qx (B, T+1, nx), ru (B, T, nu) and dx0 (B, nx):
    (dx (B, T+1, nx), du (B, T, nu), kff (B, T, nu))."""
    T, nx = f.AB.shape[1], f.AB.shape[2]
    ABt = f.AB.transpose(-1, -2)
    g_lin = torch.cat([qx[:, :T], ru], dim=-1)  # [qx_k; ru_k]
    p = qx[:, T]
    kff = [None] * T
    for k in range(T - 1, -1, -1):
        Fr_p = _mv(f.P_next[k], r[:, k]) + p
        g = g_lin[:, k] + _mv(ABt[:, k], Fr_p)  # [gx; gu]
        kff[k] = -cho_apply(f.Linv[k], g[:, nx:, None]).squeeze(-1)
        p = g[:, :nx] + _mv(f.Gxu[k], kff[k])
    dx, du = [dx0], []
    for k in range(T):
        du.append(_mv(f.K[k], dx[k]) + kff[k])
        dx.append(_mv(f.AB[:, k], torch.cat([dx[k], du[k]], dim=-1)) + r[:, k])
    return torch.stack(dx, dim=1), torch.stack(du, dim=1), torch.stack(kff, dim=1)


def riccati_solve(lq: LqProblem, dx0: torch.Tensor) -> LqSolution:
    """Backward Riccati sweep and forward rollout; dx0 (B, nx)."""
    f = riccati_factor(stack_dynamics(lq.A, lq.B), lq.Qxx, lq.Ruu)
    dx, du, kff = riccati_apply(f, lq.r, lq.qx, lq.ru, dx0)
    return LqSolution(dx=dx, du=du, K=torch.stack(f.K, dim=1), kff=kff)

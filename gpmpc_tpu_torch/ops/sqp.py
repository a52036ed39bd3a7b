"""SQP types and KKT residuals. Port of the type half of
`gpmpc_tpu/ops/sqp.py` and of its `kkt_residuals`, batch-first; the generic
(non-lanes) SQP solver is not ported yet (ROADMAP.md Queue 1)."""

from __future__ import annotations

from typing import NamedTuple

import torch

BOUND_INF = 1e8  # inactive-bound magnitude (gpmpc_tpu/ops/boxqp.py)


class SqpConfig(NamedTuple):
    """Same fields and defaults as the reference's SqpConfig (see its comments)."""

    sqp_iters: int = 25
    qp_iters: int = 15
    step_tol: float = 1e-6
    parallel_scan: bool = False
    early_exit: bool = True
    qp_tol: float | None = None
    analytic_jac: bool = False
    qp_mehrotra: bool = False
    kernel_linearize: bool = False
    soft_x_penalty: float | None = None
    lm_reg: float = 0.0
    warm_shift: bool = False
    kkt_tol: float | None = None


class OcpCost(NamedTuple):
    xref: torch.Tensor  # (B, T+1, nx)
    uref: torch.Tensor  # (T, nu)
    Q: torch.Tensor  # (nx, nx)
    R: torch.Tensor  # (nu, nu)
    Qe: torch.Tensor  # (nx, nx)
    scale: torch.Tensor  # (T+1,)


class OcpBounds(NamedTuple):
    lx: torch.Tensor  # (B, T+1, nx)
    ux: torch.Tensor
    lu: torch.Tensor  # (B, T, nu)
    uu: torch.Tensor


class SqpSolution(NamedTuple):
    X: torch.Tensor  # (B, T+1, nx)
    U: torch.Tensor  # (B, T, nu)
    step_norm: torch.Tensor  # (B,)
    qp_gap: torch.Tensor
    n_iters: torch.Tensor
    eq_res: torch.Tensor
    stat_res: torch.Tensor
    converged: torch.Tensor


def kkt_residuals(
    A: torch.Tensor,  # (B, T, nx, nx) discrete dynamics Jacobians at the iterate
    Bm: torch.Tensor,  # (B, T, nx, nu)
    defect: torch.Tensor,  # (B, T, nx) fd(x_k, u_k) - x_{k+1}
    qx: torch.Tensor,  # (B, T+1, nx) cost gradient in x (terminal stage included)
    ru: torch.Tensor,  # (B, T, nu) cost gradient in u
    U: torch.Tensor,  # (B, T, nu) current inputs
    lu: torch.Tensor,  # (B, T, nu) input bounds
    uu: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(eq_res (B,), stat_res (B,)) at the current SQP iterate of each scenario.

    eq_res = max |fd(x_k, u_k) - x_{k+1}|, the dynamics feasibility. For
    stat_res the costates come from the state-stationarity recursion
    lam_k = qx_k + A_k' lam_{k+1} (active state bounds' multipliers are
    absorbed into lam), and input stationarity is the projected-gradient norm
    max |u - P_[lu,uu](u - (ru + B' lam))|, zero iff u satisfies its
    first-order conditions under the box."""
    eq = torch.amax(torch.abs(defect), dim=(1, 2))
    T = A.shape[1]
    lam = qx[:, T]
    gu = [None] * T
    for k in range(T - 1, -1, -1):
        gu[k] = ru[:, k] + torch.sum(Bm[:, k] * lam[:, :, None], dim=1)
        lam = qx[:, k] + torch.sum(A[:, k] * lam[:, :, None], dim=1)
    gu = torch.stack(gu, dim=1)
    proj = torch.minimum(torch.maximum(U - gu, lu), uu)
    return eq, torch.amax(torch.abs(U - proj), dim=(1, 2))

"""SQP for the nonlinear tracking OCP, batch-first. Port of
`gpmpc_tpu/ops/sqp.py`: its types, `kkt_residuals` and `sqp_solve`
(Gauss-Newton, full steps, each iteration one box QP of `ops/boxqp.py`),
plus `jacfwd_linearize`, the forward-mode linearization that both this
solver and the lanes solvers (`ops/sqp_lanes.py`) use.

Every leaf carries a leading scenario axis B, and each scenario has its own
convergence mask, as under `jax.vmap` of the reference: a converged
scenario's iterate, residuals and iteration count stay frozen while the
others go on. Stage costs are scaled by dt and the terminal cost by 1
(acados' default cost scaling, `OcpCost.scale`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gpmpc_tpu_torch.ops.boxqp import BOUND_INF, OcpQpData, solve_ocp_qp


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


def jacfwd_linearize(fd, X: torch.Tensor, U: torch.Tensor):
    """(fnext (..., nx), A (..., nx, nx), B (..., nx, nu)) of fd at every point
    of X (..., nx), U (..., nu) by forward-mode differentiation: what
    `vmap(jacfwd(fd, argnums=(0, 1)))` computes, with each of the nx + nu
    tangents pushed through fd on the whole batch (`vmap` over the basis of
    `torch.func.jvp`). `fd` must take leading batch axes, as every model
    function of the port does. `jacfwd` of a per-point fd is not used: there a
    state component is a 0-dim tensor, and forward-mode products of 0-dim
    tensors with Python scalars come out in float64."""
    nx, nu = X.shape[-1], U.shape[-1]
    basis = torch.eye(nx + nu, dtype=X.dtype, device=X.device)

    def push(t):
        return torch.func.jvp(fd, (X, U), (t[:nx].expand_as(X), t[nx:].expand_as(U)))[1]

    J = torch.func.vmap(push)(basis).movedim(0, -1)  # (..., nx, nx + nu)
    return fd(X, U), J[..., :nx], J[..., nx:]


def sqp_solve(
    fd: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None,
    cost: OcpCost,  # xref (B, T+1, nx); uref (T, nu), Q/R/Qe/scale shared
    bounds: OcpBounds,  # leaves (B, ...)
    x0: torch.Tensor,  # (B, nx)
    X_init: torch.Tensor,  # (B, T+1, nx)
    U_init: torch.Tensor,  # (B, T, nu)
    cfg: SqpConfig,
    linearize_fn=None,
) -> SqpSolution:
    """Solve the tracking OCP of each of B scenarios by Gauss-Newton SQP with
    full steps: per iteration, the dynamics linearized at the iterate, the
    KKT residuals of the iterate, and one box QP (`solve_ocp_qp`, cfg.qp_iters
    fixed IP iterations, cfg.qp_mehrotra, soft state bounds under
    cfg.soft_x_penalty) in delta form, x0 pinned through +-BOUND_INF on stage
    0. cfg.lm_reg damps the Hessian only. A scenario converges once its step
    is below cfg.step_tol (and, with cfg.kkt_tol, both residuals below it).

    fd: (X (..., nx), U (..., nu)) -> next states, linearized by
    `jacfwd_linearize`; linearize_fn: (X (B, T, nx), U (B, T, nu)) ->
    (fnext, A, B), for dynamics that differ per scenario, replaces it.

    cfg.early_exit stops once every scenario has converged (one host read an
    iteration); without it the loop runs cfg.sqp_iters times. A converged
    scenario is frozen either way, so both give the same X, U and n_iters.
    The lanes options (qp_tol, analytic_jac, kernel_linearize) do not apply:
    this is the reference's fixed-count path."""
    B, Tp1, nx = X_init.shape
    T, nu = Tp1 - 1, U_init.shape[2]
    dev, dtype = X_init.device, X_init.dtype
    linearize = linearize_fn if linearize_fn is not None else (
        lambda X_, U_: jacfwd_linearize(fd, X_, U_))

    Qxx = torch.cat([cost.scale[:-1, None, None] * cost.Q[None],
                     (cost.scale[-1] * cost.Qe)[None]]).expand(B, T + 1, nx, nx)
    Ruu = (cost.scale[:-1, None, None] * cost.R[None]).expand(B, T, nu, nu)
    # LM damping enters the QP Hessian only: gradients and the KKT residuals
    # stay those of the true cost, so lm_reg changes the step, not the solution
    if cfg.lm_reg:
        Qxx_h = Qxx + cfg.lm_reg * torch.eye(nx, dtype=dtype, device=dev)
        Ruu_h = Ruu + cfg.lm_reg * torch.eye(nu, dtype=dtype, device=dev)
    else:
        Qxx_h, Ruu_h = Qxx, Ruu

    X, U = X_init, U_init
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    inf = lambda: torch.full((B,), torch.inf, dtype=dtype, device=dev)  # noqa: E731
    step_norm, qp_gap, eq_res, stat_res = inf(), inf(), inf(), inf()
    n_iters = torch.zeros(B, dtype=torch.int32, device=dev)

    for _ in range(cfg.sqp_iters):
        if cfg.early_exit and bool(converged.all()):
            break
        X = X.clone()
        X[:, 0] = x0
        fnext, A, Bm = linearize(X[:, :-1], U)
        defect = fnext - X[:, 1:]
        qx = torch.matmul(Qxx, (X - cost.xref)[..., None])[..., 0]
        ru = torch.matmul(Ruu, (U - cost.uref)[..., None])[..., 0]
        # the KKT residuals of the current iterate: the returned solution when
        # the step below is tiny
        new_eq, new_stat = kkt_residuals(A, Bm, defect, qx, ru, U, bounds.lu, bounds.uu)
        lx = bounds.lx - X
        lx[:, 0] = -BOUND_INF
        ux = bounds.ux - X
        ux[:, 0] = BOUND_INF
        sol = solve_ocp_qp(
            OcpQpData(A=A, B=Bm, r=defect, Qxx=Qxx_h, qx=qx, Ruu=Ruu_h, ru=ru, lx=lx, ux=ux,
                      lu=bounds.lu - U, uu=bounds.uu - U),
            n_iter=cfg.qp_iters, parallel_scan=cfg.parallel_scan, mehrotra=cfg.qp_mehrotra,
            soft_x=cfg.soft_x_penalty,
        )
        new_step = torch.maximum(torch.amax(torch.abs(sol.dx), dim=(1, 2)),
                                 torch.amax(torch.abs(sol.du), dim=(1, 2)))
        # full steps, frozen once a scenario's mask triggered
        active = ~converged
        X = torch.where(active[:, None, None], X + sol.dx, X)
        U = torch.where(active[:, None, None], U + sol.du, U)
        step_norm = torch.where(active, new_step, step_norm)
        qp_gap = torch.where(active, sol.gap, qp_gap)
        eq_res = torch.where(active, new_eq, eq_res)
        stat_res = torch.where(active, new_stat, stat_res)
        n_iters = n_iters + active.to(torch.int32)
        step_ok = new_step < cfg.step_tol
        if cfg.kkt_tol is not None:
            step_ok = step_ok & (new_eq < cfg.kkt_tol) & (new_stat < cfg.kkt_tol)
        converged = converged | step_ok

    X = X.clone()
    X[:, 0] = x0
    return SqpSolution(X=X, U=U, step_norm=step_norm, qp_gap=qp_gap, n_iters=n_iters,
                       eq_res=eq_res, stat_res=stat_res, converged=converged)

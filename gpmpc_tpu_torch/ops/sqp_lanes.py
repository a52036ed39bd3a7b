"""The two lanes SQP solvers: the fused path (the linearize kernel and the
lanes IP kernels, X and U kept in lanes layout across SQP iterations) and the
path that linearizes in plain torch and repacks into lane tiles for the QP
kernels each iteration.

Port of `gpmpc_tpu/ops/sqp_lanes.py`: `sqp_solve_batch_lanes_fused`,
`sqp_solve_batch_lanes` with its three linearizers, `_solve_qp_lanes` with its
three tiers (resident, tier-1 and tier-2 streamed kernel, hard or L1-soft
state bounds), `_kkt_residuals_lanes` (plain torch, as it is XLA code in the
reference) and the lane-tile packing.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch

from gpmpc_tpu_torch.ops.cuda_linearize import linearize_ocp_lanes
from gpmpc_tpu_torch.ops.cuda_ocp import (
    LanesQp,
    solve_ocp_qp_lanes,
    solve_ocp_qp_lanes_streamed,
    solve_ocp_qp_lanes_streamed2,
)
from gpmpc_tpu_torch.ops.sqp import (
    BOUND_INF,
    OcpBounds,
    OcpCost,
    SqpConfig,
    SqpSolution,
    kkt_residuals,
)

LANES = 128  # default scenario tile width
# Horizon caps of the three QP kernels. They are the reference's numbers, kept
# so that both packages send a horizon to the same tier and refuse the same
# ones; on this card they are a dispatch table, not memory limits (the tier-2
# wrapper checks its workspace against the card's free memory).
MAX_LANES_HORIZON = 50  # resident kernel
MAX_LANES_HORIZON_MEHROTRA = 50
MAX_STREAM_HORIZON = 400  # tier-1 streamed kernel
MAX_STREAM_HORIZON_SOFT = 320
MAX_STREAM2_HORIZON = 1024  # tier-2 streamed kernel
MAX_STREAM2_HORIZON_SOFT = 768
MAX_FUSED_HORIZON = MAX_STREAM_HORIZON  # the fused path's own cap


def _lane_width(T: int, lanes: int = LANES) -> int:
    """The lane-tile width for horizon T: `lanes`, or a ValueError past the
    last QP kernel's horizon."""
    if T > MAX_STREAM2_HORIZON:
        raise ValueError(
            f"lanes backend supports horizons up to {MAX_STREAM2_HORIZON} (got {T}); "
            "use the xla backend for longer horizons"
        )
    return lanes


def lanes_resident_cap(cfg: SqpConfig) -> int:
    """Largest horizon the resident kernel serves for this config."""
    return MAX_LANES_HORIZON_MEHROTRA if cfg.qp_mehrotra else MAX_LANES_HORIZON


def lanes_horizon_cap(cfg: SqpConfig) -> int:
    """Largest horizon the lanes backend serves for this config (soft state
    bounds lower the caps)."""
    return MAX_STREAM2_HORIZON_SOFT if cfg.soft_x_penalty is not None else MAX_STREAM2_HORIZON


def lanes_serves(cfg: SqpConfig, T: int) -> bool:
    return T <= lanes_horizon_cap(cfg)


def _solve_qp_lanes(qp: LanesQp, cfg: SqpConfig):
    """Send the tiles to the resident, the tier-1 or the tier-2 streamed IP
    kernel by horizon; past the last cap raise."""
    T = qp.A.shape[1]
    kw = dict(
        n_ip=cfg.qp_iters, adaptive_tol=cfg.qp_tol, mehrotra=cfg.qp_mehrotra,
        soft_rho=cfg.soft_x_penalty,
    )
    if T <= lanes_resident_cap(cfg):
        return solve_ocp_qp_lanes(qp, **kw)
    soft = cfg.soft_x_penalty is not None
    if T <= (MAX_STREAM_HORIZON_SOFT if soft else MAX_STREAM_HORIZON):
        return solve_ocp_qp_lanes_streamed(qp, **kw)
    if T > lanes_horizon_cap(cfg):
        raise ValueError(
            f"lanes backend serves horizons up to T={lanes_horizon_cap(cfg)} "
            f"{'with soft state bounds ' if soft else ''}(got {T}); use the xla backend"
        )
    return solve_ocp_qp_lanes_streamed2(qp, **kw)


def _to_lane_tiles(x: torch.Tensor, n_tiles: int, lanes: int) -> torch.Tensor:
    """(B_pad, ...) -> (n_tiles, ..., lanes), contiguous."""
    x = x.reshape((n_tiles, lanes) + tuple(x.shape[1:]))
    return x.movedim(1, -1).contiguous()


def _from_lane_tiles(x: torch.Tensor, B: int) -> torch.Tensor:
    """(n_tiles, ..., lanes) -> (B, ...)."""
    x = x.movedim(-1, 1)
    return x.reshape((-1,) + tuple(x.shape[2:]))[:B]


def _kkt_residuals_lanes(A, Bm, defect, qx, ru, U, lu, uu):
    """Per-scenario dynamics defect and projected-gradient stationarity.

    A (n,T,nx,nx,L), Bm (n,T,nx,nu,L), defect (n,T,nx,L), qx (n,T+1,nx,L),
    ru/U/lu/uu (n,T,nu,L) -> (eq (n,L), stat (n,L))."""
    eq = torch.amax(torch.abs(defect), dim=(1, 2))
    T = A.shape[1]
    lam = qx[:, T]
    gu = [None] * T
    for k in range(T - 1, -1, -1):
        gu[k] = ru[:, k] + torch.sum(Bm[:, k] * lam[:, :, None, :], dim=1)
        lam = qx[:, k] + torch.sum(A[:, k] * lam[:, :, None, :], dim=1)
    gu = torch.stack(gu, dim=1)
    proj = torch.minimum(torch.maximum(U - gu, lu), uu)
    stat = torch.amax(torch.abs(U - proj), dim=(1, 2))
    return eq, stat


def _cost_diagonals(cost: OcpCost) -> tuple[torch.Tensor, torch.Tensor]:
    """(qdiag (T+1, nx), rdiag (T, nu)): the stage-scaled diagonals of Q, Qe, R."""
    scale = cost.scale
    qdiag = torch.cat(
        [scale[:-1, None] * torch.diagonal(cost.Q)[None], (scale[-1] * torch.diagonal(cost.Qe))[None]]
    )
    return qdiag, scale[:-1, None] * torch.diagonal(cost.R)[None]


class LanesLinearizer(NamedTuple):
    """Inputs of the linearize kernel: the family's plant coefficients and
    the GP mean data in kernel-ready form."""

    params8: torch.Tensor  # (8,) ResidualSpec.kernel_params packing
    hyp: torch.Tensor  # (G, 1+D) per GP [sf2, 1/ell^2 per dim]
    Zs: torch.Tensor  # (G, Ms, D)
    alpha: torch.Tensor  # (G, Ms)
    use_gp: bool
    family: str = "quadrotor"  # key into ops/cuda_linearize.py::FAMILIES


def sqp_solve_batch_lanes_fused(
    lin: LanesLinearizer,
    dt: float,
    cost: OcpCost,  # xref (B, T+1, nx); uref (T, nu), Q/R/Qe/scale shared
    bounds: OcpBounds,  # leaves (B, ...)
    x0: torch.Tensor,  # (B, nx)
    X_init: torch.Tensor,  # (B, T+1, nx)
    U_init: torch.Tensor,  # (B, T, nu)
    cfg: SqpConfig,
    lanes: int = LANES,
) -> SqpSolution:
    """Gauss-Newton SQP for B scenarios in lane tiles of width `lanes`, with
    per-scenario convergence masks and (cfg.early_exit) an exit once every
    scenario converged or the first hits cfg.sqp_iters."""
    B, Tp1, nx = X_init.shape
    T = Tp1 - 1
    nu = U_init.shape[2]
    dev, dtype = X_init.device, X_init.dtype
    lanes = _lane_width(T, lanes)
    B_pad = B + (-B) % lanes
    n_tiles = B_pad // lanes
    qdiag, rdiag = _cost_diagonals(cost)

    def pack(x):  # zero-padded scenarios, as in the reference
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, B_pad - B))
        return _to_lane_tiles(x, n_tiles, lanes)

    X = pack(X_init)  # (n, T+1, nx, L)
    U = pack(U_init)
    x0_l = pack(x0)  # (n, nx, L)
    xref_l = pack(cost.xref)
    lx_l, ux_l = pack(bounds.lx), pack(bounds.ux)
    lu_l, uu_l = pack(bounds.lu), pack(bounds.uu)
    qdiag_l = qdiag[None, :, :, None].expand(n_tiles, T + 1, nx, lanes)
    rdiag_l = rdiag[None, :, :, None].expand(n_tiles, T, nu, lanes)
    uref_l = cost.uref[None, :, :, None].expand(n_tiles, T, nu, lanes)
    qdiag_h = (qdiag_l + cfg.lm_reg if cfg.lm_reg else qdiag_l).contiguous()
    rdiag_h = (rdiag_l + cfg.lm_reg if cfg.lm_reg else rdiag_l).contiguous()
    big = BOUND_INF

    converged = torch.zeros(n_tiles, lanes, dtype=torch.bool, device=dev)
    inf = lambda: torch.full((n_tiles, lanes), torch.inf, dtype=dtype, device=dev)  # noqa: E731
    step_norm, qp_gap, eq_res, stat_res = inf(), inf(), inf(), inf()
    n_iters = torch.zeros(n_tiles, lanes, dtype=torch.int32, device=dev)

    for _ in range(cfg.sqp_iters):
        if cfg.early_exit and bool(converged.all()):
            break
        Xi = X.clone()
        Xi[:, 0] = x0_l
        fnext, A, Bm = linearize_ocp_lanes(
            lin.params8, lin.hyp, lin.Zs, lin.alpha, Xi, U, dt=dt, use_gp=lin.use_gp,
            family=lin.family,
        )
        defect = fnext - Xi[:, 1:]
        qx = qdiag_l * (Xi - xref_l)
        ru = rdiag_l * (U - uref_l)
        new_eq, new_stat = _kkt_residuals_lanes(A, Bm, defect, qx, ru, U, lu_l, uu_l)
        lx_d = lx_l - Xi
        lx_d[:, 0] = -big
        ux_d = ux_l - Xi
        ux_d[:, 0] = big
        qp = LanesQp(
            A=A, B=Bm, r=defect.contiguous(), qdiag=qdiag_h, qx=qx.contiguous(),
            rdiag=rdiag_h, ru=ru.contiguous(), lx=lx_d, ux=ux_d,
            lu=(lu_l - U).contiguous(), uu=(uu_l - U).contiguous(),
        )
        dx, du, gap = _solve_qp_lanes(qp, cfg)

        new_step = torch.maximum(
            torch.amax(torch.abs(dx), dim=(1, 2)), torch.amax(torch.abs(du), dim=(1, 2))
        )  # (n, L)
        active = ~converged
        act_b = active[:, None, None, :]
        X = torch.where(act_b, X + dx, X)
        U = torch.where(act_b, U + du, U)
        step_norm = torch.where(active, new_step, step_norm)
        qp_gap = torch.where(active, gap, qp_gap)
        eq_res = torch.where(active, new_eq, eq_res)
        stat_res = torch.where(active, new_stat, stat_res)
        n_iters = n_iters + active.to(torch.int32)
        step_ok = new_step < cfg.step_tol
        if cfg.kkt_tol is not None:
            step_ok = step_ok & (new_eq < cfg.kkt_tol) & (new_stat < cfg.kkt_tol)
        converged = converged | step_ok

    X = X.clone()
    X[:, 0] = x0_l
    lane_scalar = lambda v: _from_lane_tiles(v, B)  # noqa: E731
    return SqpSolution(
        X=_from_lane_tiles(X, B), U=_from_lane_tiles(U, B),
        step_norm=lane_scalar(step_norm), qp_gap=lane_scalar(qp_gap),
        n_iters=lane_scalar(n_iters), eq_res=lane_scalar(eq_res),
        stat_res=lane_scalar(stat_res), converged=lane_scalar(converged),
    )


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


def sqp_solve_batch_lanes(
    fd: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None,
    cost: OcpCost,  # xref (B, T+1, nx); uref (T, nu), Q/R/Qe/scale shared
    bounds: OcpBounds,  # leaves (B, ...)
    x0: torch.Tensor,  # (B, nx)
    X_init: torch.Tensor,  # (B, T+1, nx)
    U_init: torch.Tensor,  # (B, T, nu)
    cfg: SqpConfig,
    fd_jac3=None,
    linearize_fn=None,
    lanes: int = LANES,
) -> SqpSolution:
    """Gauss-Newton SQP for B scenarios with the dynamics linearized in plain
    torch and the QPs solved by the lanes IP kernels; X and U stay
    batch-first, and the QP data is repacked into lane tiles every iteration.

    fd: (X (..., nx), U (..., nu)) -> next states, differentiated in forward
    mode (`jacfwd_linearize`) unless one of the others is given. fd_jac3:
    (X (B, T, nx), U (B, T, nu)) -> (fnext, A, B) on the whole batch
    (analytic Jacobians, models/jacobians.py). linearize_fn: the same
    signature, for dynamics that differ per scenario (a GP population);
    overrides fd and fd_jac3."""
    B, Tp1, nx = X_init.shape
    T = Tp1 - 1
    dev, dtype = X_init.device, X_init.dtype
    lanes = _lane_width(T, lanes)
    B_pad = B + (-B) % lanes
    n_tiles = B_pad // lanes
    qdiag, rdiag = _cost_diagonals(cost)

    if linearize_fn is not None:
        linearize = linearize_fn
    elif fd_jac3 is not None:
        linearize = fd_jac3
    else:
        linearize = partial(jacfwd_linearize, fd)

    def pack(x):  # zero-padded scenarios, as in the reference
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, B_pad - B))
        return _to_lane_tiles(x, n_tiles, lanes)

    # LM damping: Hessian diagonals only; gradient and KKT residuals stay undamped
    qdiag_t = pack((qdiag + cfg.lm_reg)[None].expand(B, T + 1, nx))
    rdiag_t = pack((rdiag + cfg.lm_reg)[None].expand((B,) + tuple(rdiag.shape)))
    big = BOUND_INF

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
        fnext, A, Bm = linearize(X[:, :-1], U)  # (B,T,nx), (B,T,nx,nx), (B,T,nx,nu)
        defect = fnext - X[:, 1:]
        qx = qdiag[None] * (X - cost.xref)
        ru = rdiag[None] * (U - cost.uref)
        new_eq, new_stat = kkt_residuals(A, Bm, defect, qx, ru, U, bounds.lu, bounds.uu)
        lx = bounds.lx - X
        lx[:, 0] = -big
        ux = bounds.ux - X
        ux[:, 0] = big
        tiles = LanesQp(
            A=pack(A), B=pack(Bm), r=pack(defect), qdiag=qdiag_t, qx=pack(qx), rdiag=rdiag_t,
            ru=pack(ru), lx=pack(lx), ux=pack(ux), lu=pack(bounds.lu - U), uu=pack(bounds.uu - U),
        )
        dx_t, du_t, gap_t = _solve_qp_lanes(tiles, cfg)
        dx, du = _from_lane_tiles(dx_t, B), _from_lane_tiles(du_t, B)
        gap = gap_t.reshape(-1)[:B]

        new_step = torch.maximum(
            torch.amax(torch.abs(dx), dim=(1, 2)), torch.amax(torch.abs(du), dim=(1, 2))
        )  # (B,)
        active = ~converged
        X = torch.where(active[:, None, None], X + dx, X)
        U = torch.where(active[:, None, None], U + du, U)
        step_norm = torch.where(active, new_step, step_norm)
        qp_gap = torch.where(active, gap, qp_gap)
        eq_res = torch.where(active, new_eq, eq_res)
        stat_res = torch.where(active, new_stat, stat_res)
        n_iters = n_iters + active.to(torch.int32)
        step_ok = new_step < cfg.step_tol
        if cfg.kkt_tol is not None:
            step_ok = step_ok & (new_eq < cfg.kkt_tol) & (new_stat < cfg.kkt_tol)
        converged = converged | step_ok

    X = X.clone()
    X[:, 0] = x0
    return SqpSolution(
        X=X, U=U, step_norm=step_norm, qp_gap=qp_gap, n_iters=n_iters,
        eq_res=eq_res, stat_res=stat_res, converged=converged,
    )

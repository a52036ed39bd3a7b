"""Whole-SQP lanes path: the fused linearize kernel and the lanes IP kernel,
with X and U kept in lanes layout across SQP iterations.

Port of `gpmpc_tpu/ops/sqp_lanes.py`: `sqp_solve_batch_lanes_fused`, the
resident branch of `_solve_qp_lanes`, `_kkt_residuals_lanes` (plain torch, as
it is XLA code in the reference) and the lane-tile packing. The streamed QP
tiers and the jacfwd-linearized `sqp_solve_batch_lanes` are not ported yet
(ROADMAP.md Queues 1 and 2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch.ops.cuda_linearize import linearize_ocp_lanes
from gpmpc_tpu_torch.ops.cuda_ocp import LanesQp, solve_ocp_qp_lanes
from gpmpc_tpu_torch.ops.sqp import BOUND_INF, OcpBounds, OcpCost, SqpConfig, SqpSolution

LANES = 128  # default scenario tile width
MAX_LANES_HORIZON = 50  # resident-kernel cap, as in the reference
MAX_FUSED_HORIZON = 400  # fused-path cap of the reference (its tier-1 streamed cap)
MAX_STREAM2_HORIZON = 1024
MAX_STREAM2_HORIZON_SOFT = 768


def lanes_horizon_cap(cfg: SqpConfig) -> int:
    """Largest horizon the reference's lanes backend serves for this config."""
    return MAX_STREAM2_HORIZON_SOFT if cfg.soft_x_penalty is not None else MAX_STREAM2_HORIZON


def lanes_serves(cfg: SqpConfig, T: int) -> bool:
    return T <= lanes_horizon_cap(cfg)


def _solve_qp_lanes(qp: LanesQp, cfg: SqpConfig):
    """The resident IP kernel; the reference's streamed tiers and soft state
    bounds are not ported."""
    T = qp.A.shape[1]
    if cfg.soft_x_penalty is not None:
        raise NotImplementedError(
            "soft state bounds (SqpConfig.soft_x_penalty) are not ported to the lanes "
            "QP yet: see ROADMAP.md Queue 1 item 5"
        )
    if T > MAX_LANES_HORIZON:
        raise NotImplementedError(
            f"horizon T={T} needs the streamed QP kernels (resident cap "
            f"MAX_LANES_HORIZON={MAX_LANES_HORIZON}), not ported yet: see ROADMAP.md "
            "Queue 1 item 5 and Queue 2"
        )
    return solve_ocp_qp_lanes(
        qp, n_ip=cfg.qp_iters, adaptive_tol=cfg.qp_tol, mehrotra=cfg.qp_mehrotra
    )


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


class LanesLinearizer(NamedTuple):
    """Inputs of the linearize kernel: the quadrotor's plant coefficients and
    the GP mean data in kernel-ready form."""

    params8: torch.Tensor  # (8,)
    hyp: torch.Tensor  # (G, 1+D) per GP [sf2, 1/ell^2 per dim]
    Zs: torch.Tensor  # (G, Ms, D)
    alpha: torch.Tensor  # (G, Ms)
    use_gp: bool


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
    B_pad = B + (-B) % lanes
    n_tiles = B_pad // lanes

    scale = cost.scale
    qdiag = torch.cat(
        [scale[:-1, None] * torch.diagonal(cost.Q)[None], (scale[-1] * torch.diagonal(cost.Qe))[None]]
    )  # (T+1, nx)
    rdiag = scale[:-1, None] * torch.diagonal(cost.R)[None]  # (T, nu)

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
            lin.params8, lin.hyp, lin.Zs, lin.alpha, Xi, U, dt=dt, use_gp=lin.use_gp
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

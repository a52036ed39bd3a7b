"""SQP types. Port of the type half of `gpmpc_tpu/ops/sqp.py`; the generic
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

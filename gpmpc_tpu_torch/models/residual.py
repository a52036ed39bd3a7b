"""Residual-GP structure of each model family. Port of
`gpmpc_tpu/models/residual.py`: `QUADROTOR_SPEC`, `CARTPOLE_SPEC` and
`TWOLINK_SPEC`. The specs' `mean_rows` and `make_targets` wait for the GP
layer (ROADMAP.md Queue 1)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from gpmpc_tpu_torch.models import cartpole, quadrotor


@dataclass(frozen=True)
class ResidualSpec:
    """Which features feed the GPs, which state rows they act on, and how the
    GP variances map onto those rows."""

    name: str
    z_dim: int
    gp_idx: tuple[tuple[int, ...], ...]
    uncertain_dim: tuple[int, ...]
    # (x (..., nx), u (..., nu)) -> z (..., z_dim)
    gp_input: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = field(repr=False)
    # z (..., z_dim) -> F (..., n_unc, num_gps)
    var_factors: Callable[[torch.Tensor], torch.Tensor] = field(repr=False)
    supports_kernel_linearize: bool = False
    # model params -> (8,) float32 row read by the linearize kernel
    kernel_params: Callable[..., torch.Tensor] | None = field(default=None, repr=False)

    @property
    def num_gps(self) -> int:
        return len(self.gp_idx)

    @property
    def n_unc(self) -> int:
        return len(self.uncertain_dim)

    @property
    def gp_input_dim(self) -> int:
        return max(len(idx) for idx in self.gp_idx)


def _quad_gp_input(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """z = [thrust, phi, dphi, phi_cmd, theta, dtheta, theta_cmd]."""
    return torch.stack(
        [
            u[..., 0],
            x[..., quadrotor.IDX_PHI], x[..., quadrotor.IDX_DPHI], u[..., 1],
            x[..., quadrotor.IDX_THETA], x[..., quadrotor.IDX_DTHETA], u[..., 2],
        ],
        dim=-1,
    )


def _quad_var_factors(z: torch.Tensor) -> torch.Tensor:
    """F (..., 5, 3): squared thrust-rotation factors on rows x/y/z, identity
    on the two rate rows."""
    phi, theta = z[..., 1], z[..., 4]
    f_ax = (torch.cos(phi) * torch.sin(theta)) ** 2
    f_ay = torch.sin(phi) ** 2
    f_az = (torch.cos(phi) * torch.cos(theta)) ** 2
    zero = torch.zeros_like(f_ax)
    one = torch.ones_like(f_ax)
    rows = [
        torch.stack([f_ax, zero, zero], dim=-1),
        torch.stack([f_ay, zero, zero], dim=-1),
        torch.stack([f_az, zero, zero], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _quad_kernel_params(p) -> torch.Tensor:
    """[a, b, c, d, e, f, h, l]."""
    return torch.tensor([p.a, p.b, p.c, p.d, p.e, p.f, p.h, p.l], dtype=torch.float32)


QUADROTOR_SPEC = ResidualSpec(
    name="quadrotor",
    z_dim=7,
    gp_idx=((0,), (1, 2, 3), (4, 5, 6)),
    uncertain_dim=(1, 3, 5, 9, 10),
    gp_input=_quad_gp_input,
    var_factors=_quad_var_factors,
    supports_kernel_linearize=True,
    kernel_params=_quad_kernel_params,
)


def _identity_var_factors(z: torch.Tensor) -> torch.Tensor:
    """F (..., 2, 2): GP k's variance lands on uncertain row k."""
    return torch.eye(2, dtype=z.dtype, device=z.device).expand(z.shape[:-1] + (2, 2))


def _cart_gp_input(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """z = [x_dot, theta, theta_dot, force]."""
    return torch.stack(
        [x[..., cartpole.IDX_DX], x[..., cartpole.IDX_THETA], x[..., cartpole.IDX_DTHETA],
         u[..., 0]],
        dim=-1,
    )


def _cart_kernel_params(p) -> torch.Tensor:
    """[m_cart, m_pole, length, 0, 0, 0, 0, 0]."""
    return torch.tensor([p.m_cart, p.m_pole, p.length, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=torch.float32)


CARTPOLE_SPEC = ResidualSpec(
    name="cartpole",
    z_dim=4,
    # GP0 (cart acceleration) sees (x_dot, theta_dot, force); GP1 (pole
    # acceleration) sees (theta, theta_dot, force)
    gp_idx=((0, 2, 3), (1, 2, 3)),
    uncertain_dim=(cartpole.IDX_DX, cartpole.IDX_DTHETA),
    gp_input=_cart_gp_input,
    var_factors=_identity_var_factors,
    supports_kernel_linearize=True,
    kernel_params=_cart_kernel_params,
)


# Torques enter the two-link GPs scaled into the O(1) range of the angles and
# rates (the input box is +-20 Nm), as in the reference.
_TWOLINK_TAU_SCALE = 0.1


def _twolink_gp_input(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """z = [q1, q2, dq1, dq2, tau1/10, tau2/10]."""
    return torch.cat([x[..., :4], _TWOLINK_TAU_SCALE * u[..., :2]], dim=-1)


def _twolink_kernel_params(p) -> torch.Tensor:
    """[m1, m2, l1, l2, 0, 0, 0, 0]."""
    return torch.tensor([p.m1, p.m2, p.l1, p.l2, 0.0, 0.0, 0.0, 0.0], dtype=torch.float32)


TWOLINK_SPEC = ResidualSpec(
    name="twolink",
    z_dim=6,
    # both GPs see the full feature vector (M(q)^-1 couples every row to both
    # torques and both rates)
    gp_idx=((0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5)),
    uncertain_dim=(2, 3),
    gp_input=_twolink_gp_input,
    var_factors=_identity_var_factors,
    supports_kernel_linearize=True,
    kernel_params=_twolink_kernel_params,
)

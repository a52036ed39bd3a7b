"""Residual-GP structure of the quadrotor. Port of the `QUADROTOR_SPEC` part of
`gpmpc_tpu/models/residual.py`; the other families are not ported yet
(ROADMAP.md Queue 1)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from gpmpc_tpu_torch.models import quadrotor


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

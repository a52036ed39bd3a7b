"""Quadrotor attitude-interface dynamics, batched over leading axes.

Port of `gpmpc_tpu/models/quadrotor.py`. State order
[x, dx, y, dy, z, dz, phi, theta, psi, dphi, dtheta, dpsi], input order
[thrust, phi_cmd, theta_cmd, psi_cmd]. Every function here takes tensors with
any number of leading batch axes and the state/input on the last axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GRAVITY = 9.81

U_EQ = np.array([0.3234, 0.0, 0.0, 0.0], dtype=np.float32)

STATE_LABELS = [
    "x", "d_x", "y", "d_y", "z", "d_z",
    "phi", "theta", "psi", "d_phi", "d_theta", "d_psi",
]

NX = 12
NU = 4

IDX_X, IDX_DX, IDX_Y, IDX_DY, IDX_Z, IDX_DZ = 0, 1, 2, 3, 4, 5
IDX_PHI, IDX_THETA, IDX_PSI, IDX_DPHI, IDX_DTHETA, IDX_DPSI = 6, 7, 8, 9, 10, 11


class QuadrotorParams(NamedTuple):
    """acc = a*thrust + b; dd_phi = c*phi + d*dphi + e*phi_cmd;
    dd_theta = f*theta + h*dtheta + l*theta_cmd."""

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float
    h: float
    l: float  # noqa: E741 - name fixed by the reference config schema

    @classmethod
    def from_dict(cls, d: dict) -> "QuadrotorParams":
        return cls(**{k: float(d[k]) for k in ("a", "b", "c", "d", "e", "f", "h", "l")})


PRIOR_PARAMS = QuadrotorParams(
    a=12.1432, b=1.8118, c=-72.08, d=-7.5755, e=39.8653, f=-72.08, h=-7.5755, l=39.8653
)
TRUE_PARAMS = QuadrotorParams(
    a=20.91, b=3.65, c=-130.3, d=-16.33, e=119.51, f=-99.94, h=-13.3, l=84.73
)


def thrust_acc(thrust_cmd: torch.Tensor, params: QuadrotorParams) -> torch.Tensor:
    """Collective-thrust command -> specific-thrust magnitude [m/s^2]."""
    return params.a * thrust_cmd + params.b


def continuous_dynamics(x: torch.Tensor, u: torch.Tensor, params: QuadrotorParams) -> torch.Tensor:
    """f(x, u) for (..., 12) states and (..., 4) inputs."""
    phi, theta, psi = x[..., IDX_PHI], x[..., IDX_THETA], x[..., IDX_PSI]
    d_phi, d_theta, d_psi = x[..., IDX_DPHI], x[..., IDX_DTHETA], x[..., IDX_DPSI]
    thrust_cmd, phi_cmd, theta_cmd = u[..., 0], u[..., 1], u[..., 2]

    acc = thrust_acc(thrust_cmd, params)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)

    dd_x = acc * (cphi * sth * cpsi + sphi * spsi)
    dd_y = acc * (cphi * sth * spsi - sphi * cpsi)
    dd_z = acc * cphi * cth - GRAVITY
    dd_phi = params.c * phi + params.d * d_phi + params.e * phi_cmd
    dd_theta = params.f * theta + params.h * d_theta + params.l * theta_cmd
    dd_psi = torch.zeros_like(psi)
    return torch.stack(
        [x[..., IDX_DX], dd_x, x[..., IDX_DY], dd_y, x[..., IDX_DZ], dd_z,
         d_phi, d_theta, d_psi, dd_phi, dd_theta, dd_psi],
        dim=-1,
    )


def rk4(f, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """Classic RK4 step of dx/dt = f(x, u)."""
    k1 = f(x, u)
    k2 = f(x + dt / 2 * k1, u)
    k3 = f(x + dt / 2 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def state_bounds() -> tuple[np.ndarray, np.ndarray]:
    low = np.array([-2, -15, -2, -15, -0.05, -15, -1.5, -1.5, -10, -8.5, -8.5, -10], np.float32)
    high = np.array([2, 15, 2, 15, 2, 15, 1.5, 1.5, 10, 8.5, 8.5, 10], np.float32)
    return low, high


def input_bounds() -> tuple[np.ndarray, np.ndarray]:
    low = np.array([0.12, -0.43, -0.43, -0.43], np.float32)
    high = np.array([0.59, 0.43, 0.43, 0.43], np.float32)
    return low, high

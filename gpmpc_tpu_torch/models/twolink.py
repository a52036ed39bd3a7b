"""Two-link planar arm model family, batched over leading axes.

Port of `gpmpc_tpu/models/twolink.py`: the uniform-rod 2R manipulator,
M(q) ddq + C(q, dq) dq + g(q) = tau solved in closed form. State
[q1, q2, dq1, dq2] (q1 from the +x axis, -pi/2 hanging; q2 the elbow),
input [tau1, tau2].
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.models.quadrotor import rk4  # noqa: F401  (model-agnostic RK4)

NX = 4
NU = 2
GRAVITY = 9.81

IDX_Q1, IDX_Q2, IDX_DQ1, IDX_DQ2 = 0, 1, 2, 3


class TwoLinkParams(NamedTuple):
    m1: float = 1.0  # kg, link-1 mass (uniform rod)
    m2: float = 1.0  # kg, link-2 mass
    l1: float = 1.0  # m
    l2: float = 1.0  # m


def _mass_gravity(p: TwoLinkParams, q1, q2):
    """M(q) entries, gravity torques and the Coriolis coefficient h."""
    lc1, lc2 = 0.5 * p.l1, 0.5 * p.l2
    i1, i2 = p.m1 * p.l1**2 / 12.0, p.m2 * p.l2**2 / 12.0
    c2 = torch.cos(q2)
    m11 = i1 + i2 + p.m1 * lc1**2 + p.m2 * (p.l1**2 + lc2**2 + 2.0 * p.l1 * lc2 * c2)
    m12 = i2 + p.m2 * (lc2**2 + p.l1 * lc2 * c2)
    m22 = i2 + p.m2 * lc2**2
    g1 = (p.m1 * lc1 + p.m2 * p.l1) * GRAVITY * torch.cos(q1) + p.m2 * lc2 * GRAVITY * torch.cos(q1 + q2)
    g2 = p.m2 * lc2 * GRAVITY * torch.cos(q1 + q2)
    h = p.m2 * p.l1 * lc2 * torch.sin(q2)
    return m11, m12, m22, g1, g2, h


def solve_mass(m11, m12, m22, r1, r2):
    """ddq = M^-1 r by the closed-form 2x2 inverse."""
    det = m11 * m22 - m12 * m12
    return (m22 * r1 - m12 * r2) / det, (m11 * r2 - m12 * r1) / det


def continuous_dynamics(
    x: torch.Tensor, u: torch.Tensor, params: TwoLinkParams = TwoLinkParams()
) -> torch.Tensor:
    """f(x, u) for (..., 4) states and (..., 2) inputs."""
    q1, q2, dq1, dq2 = x.unbind(-1)
    m11, m12, m22, g1, g2, h = _mass_gravity(params, q1, q2)
    r1 = u[..., 0] + h * dq2 * (2.0 * dq1 + dq2) - g1
    r2 = u[..., 1] - h * dq1 * dq1 - g2
    ddq1, ddq2 = solve_mass(m11, m12, m22, r1, r2)
    return torch.stack([dq1, dq2, ddq1, ddq2], dim=-1)


def gravity_torques(q1, q2, params: TwoLinkParams = TwoLinkParams()) -> torch.Tensor:
    """tau holding the arm statically at (q1, q2): the input trim."""
    _, _, _, g1, g2, _ = _mass_gravity(params, torch.as_tensor(q1), torch.as_tensor(q2))
    return torch.stack([g1, g2], dim=-1)


def state_bounds() -> tuple[np.ndarray, np.ndarray]:
    lo = np.array([-2.9, -0.6, -6.0, -6.0], np.float32)
    hi = np.array([0.3, 2.2, 6.0, 6.0], np.float32)
    return lo, hi


def input_bounds() -> tuple[np.ndarray, np.ndarray]:
    hi = np.array([20.0, 20.0], np.float32)
    return -hi, hi


def symbolic_twolink(dt: float = 0.02, params: TwoLinkParams | None = None):
    """The two-link arm as a `SymbolicModel`, with TWOLINK_SPEC and the trim
    pair at the trajectory's mean posture q = (-pi/2, 0.7): gravity
    compensation there, zero rates."""
    from gpmpc_tpu_torch.models.residual import TWOLINK_SPEC  # avoid an import cycle
    from gpmpc_tpu_torch.models.symbolic import SymbolicModel

    p = params or TwoLinkParams()
    q = torch.tensor([-math.pi / 2, 0.7], dtype=torch.float64)
    u_eq = gravity_torques(q[0], q[1], p).numpy().astype(np.float32)
    x_eq = np.array([-np.pi / 2, 0.7, 0.0, 0.0], np.float32)
    return SymbolicModel(
        nx=NX, nu=NU, dt=float(dt), params=p,
        fc_func=partial(continuous_dynamics, params=p), u_eq=u_eq, x_eq=x_eq,
        residual_spec=TWOLINK_SPEC,
    )

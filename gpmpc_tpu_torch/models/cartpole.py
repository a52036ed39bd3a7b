"""Cartpole model family, batched over leading axes.

Port of `gpmpc_tpu/models/cartpole.py`: the pole-on-cart with state
[x, x_dot, theta, theta_dot] (theta = 0 upright) and input [force]. Every
function takes tensors with any number of leading batch axes and the
state/input on the last axis.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.models.quadrotor import rk4  # noqa: F401  (model-agnostic RK4)

NX = 4
NU = 1
GRAVITY = 9.81

IDX_X, IDX_DX, IDX_THETA, IDX_DTHETA = 0, 1, 2, 3


class CartpoleParams(NamedTuple):
    m_cart: float = 1.0  # kg
    m_pole: float = 0.1  # kg
    length: float = 0.5  # m, pivot -> pole center of mass


def continuous_dynamics(
    x: torch.Tensor, u: torch.Tensor, params: CartpoleParams = CartpoleParams()
) -> torch.Tensor:
    """f(x, u) for (..., 4) states and (..., 1) inputs."""
    mc, mp, ell = params.m_cart, params.m_pole, params.length
    theta, dtheta = x[..., IDX_THETA], x[..., IDX_DTHETA]
    force = u[..., 0]
    total = mc + mp
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    tmp = (force + mp * ell * dtheta**2 * sin_t) / total
    dd_theta = (GRAVITY * sin_t - cos_t * tmp) / (ell * (4.0 / 3.0 - mp * cos_t**2 / total))
    dd_x = tmp - mp * ell * dd_theta * cos_t / total
    return torch.stack([x[..., IDX_DX], dd_x, dtheta, dd_theta], dim=-1)


def state_bounds() -> tuple[np.ndarray, np.ndarray]:
    hi = np.array([2.4, 10.0, 0.8, 10.0], np.float32)
    return -hi, hi


def input_bounds() -> tuple[np.ndarray, np.ndarray]:
    hi = np.array([12.0], np.float32)
    return -hi, hi


def symbolic_cartpole(dt: float = 0.02, params: CartpoleParams | None = None):
    """The cartpole as a `SymbolicModel`, with CARTPOLE_SPEC."""
    from gpmpc_tpu_torch.models.residual import CARTPOLE_SPEC  # avoid an import cycle
    from gpmpc_tpu_torch.models.symbolic import SymbolicModel

    p = params or CartpoleParams()
    return SymbolicModel(
        nx=NX, nu=NU, dt=float(dt), params=p,
        fc_func=partial(continuous_dynamics, params=p), residual_spec=CARTPOLE_SPEC,
    )

"""The model object the controller is written against. Port of
`gpmpc_tpu/models/symbolic.py`; `df_func` uses `torch.func.jacfwd` in float64
(it only runs once, at controller setup). `fd_func` (RK4 of `fc_func`) and
`dfd_func` (its forward-mode Jacobians) take tensors with any leading batch
axes and stay on their device; the nominal MPC (`control/mpc.py`) solves
through `fd_func`. `symbolic_attitude` builds the quadrotor;
`models/cartpole.py::symbolic_cartpole` and `models/twolink.py::symbolic_twolink`
build the other two families with the same dataclass."""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.models import quadrotor
from gpmpc_tpu_torch.models.quadrotor import QuadrotorParams
from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC, ResidualSpec
from gpmpc_tpu_torch.ops.sqp import jacfwd_linearize


@dataclass(frozen=True)
class SymbolicModel:
    nx: int
    nu: int
    dt: float
    params: NamedTuple  # the family's parameters (QuadrotorParams, CartpoleParams, ...)
    fc_func: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = field(repr=False)
    u_eq: np.ndarray | None = field(default=None, repr=False)
    x_eq: np.ndarray | None = field(default=None, repr=False)
    residual_spec: ResidualSpec | None = field(default=None, repr=False)

    def df_func(self, x, u) -> tuple[np.ndarray, np.ndarray]:
        """Continuous Jacobians (dfdx, dfdu) at one point, in float64 numpy."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
        u = torch.as_tensor(np.asarray(u), dtype=torch.float64)
        dfdx, dfdu = torch.func.jacfwd(self.fc_func, argnums=(0, 1))(x, u)
        return dfdx.numpy(), dfdu.numpy()

    def fd_func(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One RK4 step of fc_func: x (..., nx), u (..., nu) -> (..., nx)."""
        return quadrotor.rk4(self.fc_func, x, u, self.dt)

    def dfd_func(self, x: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Jacobians of fd_func, (dfdx (..., nx, nx), dfdu (..., nx, nu)), by
        forward mode (`ops/sqp.py::jacfwd_linearize`), in the inputs' dtype."""
        _, dfdx, dfdu = jacfwd_linearize(self.fd_func, x, u)
        return dfdx, dfdu


def symbolic_attitude(dt: float = 0.02, params: dict | QuadrotorParams | None = None) -> SymbolicModel:
    if params is None:
        p = quadrotor.PRIOR_PARAMS
    elif isinstance(params, QuadrotorParams):
        p = params
    else:
        p = QuadrotorParams.from_dict(dict(params))
    return SymbolicModel(
        nx=quadrotor.NX, nu=quadrotor.NU, dt=float(dt), params=p,
        fc_func=partial(quadrotor.continuous_dynamics, params=p),
        u_eq=quadrotor.U_EQ, residual_spec=QUADROTOR_SPEC,
    )

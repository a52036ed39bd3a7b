"""The model object the controller is written against. Port of the quadrotor
part of `gpmpc_tpu/models/symbolic.py`; `df_func` uses `torch.func.jacfwd`
in float64 (it only runs once, at controller setup)."""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import numpy as np
import torch

from gpmpc_tpu_torch.models import quadrotor
from gpmpc_tpu_torch.models.quadrotor import QuadrotorParams
from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC, ResidualSpec


@dataclass(frozen=True)
class SymbolicModel:
    nx: int
    nu: int
    dt: float
    params: QuadrotorParams
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

from gpmpc_tpu_torch.models.quadrotor import (
    GRAVITY,
    U_EQ,
    QuadrotorParams,
    STATE_LABELS,
    continuous_dynamics,
    input_bounds,
    rk4,
    state_bounds,
    thrust_acc,
)
from gpmpc_tpu_torch.models.symbolic import SymbolicModel, symbolic_attitude
from gpmpc_tpu_torch.models.trajectory import figure_eight_trajectory

__all__ = [
    "GRAVITY",
    "U_EQ",
    "QuadrotorParams",
    "STATE_LABELS",
    "continuous_dynamics",
    "input_bounds",
    "rk4",
    "state_bounds",
    "thrust_acc",
    "SymbolicModel",
    "symbolic_attitude",
    "figure_eight_trajectory",
]

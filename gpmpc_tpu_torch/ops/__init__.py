from gpmpc_tpu_torch.ops.linalg import (
    discretize_linear_system,
    lqr_gain_discrete,
    solve_discrete_are,
)
from gpmpc_tpu_torch.ops.riccati import riccati_solve
from gpmpc_tpu_torch.ops.boxqp import OcpQpData, solve_ocp_qp
from gpmpc_tpu_torch.ops.sqp import SqpConfig, sqp_solve

__all__ = [
    "discretize_linear_system",
    "lqr_gain_discrete",
    "solve_discrete_are",
    "riccati_solve",
    "OcpQpData",
    "solve_ocp_qp",
    "SqpConfig",
    "sqp_solve",
]

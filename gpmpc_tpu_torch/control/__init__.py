from gpmpc_tpu_torch.control.mpc import MPC, MpcConsts, MpcState
from gpmpc_tpu_torch.control.gpmpc import GPMPC

__all__ = ["MPC", "MpcConsts", "MpcState", "GPMPC"]

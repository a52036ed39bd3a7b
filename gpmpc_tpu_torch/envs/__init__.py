from gpmpc_tpu_torch.envs.drone import (
    DroneFigureEightEnv,
    EnvParams,
    EnvState,
    env_reset,
    env_step,
)

__all__ = ["DroneFigureEightEnv", "EnvParams", "EnvState", "env_reset", "env_step"]

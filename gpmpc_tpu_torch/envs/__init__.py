# DroneFigureEightEnv, the stateful plant, is not ported yet (ROADMAP.md Queue 1 item 8c).
from gpmpc_tpu_torch.envs.drone import EnvParams, EnvState, env_reset, env_step

__all__ = ["EnvParams", "EnvState", "env_reset", "env_step"]

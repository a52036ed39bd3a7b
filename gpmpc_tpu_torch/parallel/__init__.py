from gpmpc_tpu_torch.parallel.mesh import init_distributed, make_mesh, shard_leading_axis
from gpmpc_tpu_torch.parallel.batch import (
    batched_episode,
    batched_episode_randomized,
    batched_gpmpc_step,
    make_batched_controller_step,
)

__all__ = [
    "make_mesh",
    "shard_leading_axis",
    "init_distributed",
    "batched_gpmpc_step",
    "batched_episode",
    "batched_episode_randomized",
    "make_batched_controller_step",
]

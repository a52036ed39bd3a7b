# Not ported yet: make_mesh, shard_leading_axis and init_distributed (ROADMAP.md
# Queue 1 item 12).
from gpmpc_tpu_torch.parallel.batch import (
    batched_episode,
    batched_episode_randomized,
    batched_gpmpc_step,
    make_batched_controller_step,
)

__all__ = [
    "batched_gpmpc_step",
    "batched_episode",
    "batched_episode_randomized",
    "make_batched_controller_step",
]

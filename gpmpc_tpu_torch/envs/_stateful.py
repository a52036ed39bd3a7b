"""What the three plants share beyond their dynamics: the process noise of
`env_step` and the stateful single-scenario wrapper (the reference's
`DroneFigureEightEnv`, `CartpoleTrackEnv` and `TwoLinkTrackEnv`)."""

from __future__ import annotations

import math

import torch

from gpmpc_tpu_torch.device import ShardDraw, device_constant, draw_rows, resolve


def add_process_noise(p, x: torch.Tensor, rows: list[int],
                      generator: torch.Generator | ShardDraw | None) -> torch.Tensor:
    """x (B, nx) plus, for `p.noise_std > 0`, `noise_std * sqrt(dt) * N(0, 1)`
    on the velocity `rows` of every scenario, one (B, len(rows)) draw from
    `generator` (the reference's white acceleration noise; its draws come
    from JAX keys and cannot be reproduced). Without a generator the noise
    raises: it never comes from torch's global generator. A `ShardDraw`
    draws for its population and keeps its rows (x holds those rows)."""
    if p.noise_std <= 0.0:
        return x
    if generator is None:
        raise ValueError(f"process noise (noise_std={p.noise_std}) needs a torch.Generator on "
                         "the plant's device: pass generator=")
    noise = draw_rows("randn", generator, (x.shape[0], len(rows)), x.dtype, x.device)
    index = device_constant(("noise_rows", tuple(rows)), x.device,
                            lambda device: torch.tensor(rows, device=device))
    return x.index_add(1, index, p.noise_std * math.sqrt(p.dt) * noise)


class StatefulEnv:
    """One scenario of a batched plant behind the reference's gymnasium-like
    calls: `reset(seed)` -> (obs (nx,), {}), `step(action)` -> (obs,
    reward (), terminated, truncated, {}), `trajectory`, `dt`, `close()`.
    `reset(seed)` seeds a torch.Generator on the env's device, which draws
    the initial perturbation and every step's process noise. A subclass
    names its module's `EnvParams`, `env_reset`, `env_step` and
    `make_trajectory`."""

    _params_cls = None
    _reset_fn = None
    _step_fn = None
    _trajectory_fn = None

    def __init__(self, params=None, device=None):
        self.p = params or type(self)._params_cls.default()
        self.device = resolve(device)
        self._state = None
        self._generator = None

    @property
    def trajectory(self) -> torch.Tensor:
        return type(self)._trajectory_fn(self.p, self.device)

    @property
    def dt(self) -> float:
        return self.p.dt

    def reset(self, seed: int = 0):
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state, obs = type(self)._reset_fn(self.p, 1, self._generator, self.device)
        return obs[0], {}

    def step(self, action):
        action = torch.as_tensor(action, dtype=torch.float32, device=self.device).reshape(1, -1)
        self._state, obs, reward, terminated, truncated = type(self)._step_fn(
            self.p, self._state, action, generator=self._generator)
        return obs[0], reward[0], bool(terminated[0]), bool(truncated[0]), {}

    def close(self):
        self._state = None

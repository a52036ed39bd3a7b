"""Cartpole tracking plant, batched over B scenarios. Port of
`gpmpc_tpu/envs/cartpole_env.py`: the true plant (heavier, longer pole) with
viscous cart and pivot friction, an actuation gain error and a constant force
bias, tracking a sinusoidal cart position with the pole upright, with the
rigid coefficients fixed (`env_step`) or per scenario (`env_step_dynamic`,
`params_to_array`, `randomize_params`), with process noise (`noise_std > 0`,
from an explicit generator) and the stateful single-scenario
`CartpoleTrackEnv`."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.device import resolve
from gpmpc_tpu_torch.envs._stateful import StatefulEnv, add_process_noise
from gpmpc_tpu_torch.models import cartpole
from gpmpc_tpu_torch.models.cartpole import CartpoleParams

F32 = torch.float32
_NOISE_ROWS = [cartpole.IDX_DX, cartpole.IDX_DTHETA]

TRUE_PARAMS = CartpoleParams(m_cart=1.0, m_pole=0.14, length=0.62)


class EnvParams(NamedTuple):
    """Plant and episode parameters (same fields and defaults as the reference)."""

    params: CartpoleParams
    dt: float = 0.02
    n_steps: int = 300
    sim_substeps: int = 2
    init_noise: float = 0.03
    traj_amplitude: float = 0.7
    traj_period_steps: int | None = None
    friction_cart: float = 0.25
    friction_pole: float = 0.004
    gain: float = 0.9
    force_bias: float = 1.2
    noise_std: float = 0.0

    @classmethod
    def default(cls) -> "EnvParams":
        return cls(params=TRUE_PARAMS)

    @classmethod
    def ideal(cls, **overrides) -> "EnvParams":
        """The prior's own model class: prior rigid parameters, no mismatch."""
        kw = dict(friction_cart=0.0, friction_pole=0.0, gain=1.0, force_bias=0.0, noise_std=0.0)
        kw.update(overrides)
        return cls(params=CartpoleParams(), **kw)


class EnvState(NamedTuple):
    """Batched plant state; every leaf leads with B."""

    x: torch.Tensor  # (B, 4)
    t: torch.Tensor  # (B,) int32


def make_trajectory(p: EnvParams, device=None) -> torch.Tensor:
    """(n_steps, 4): sinusoidal cart position with its velocity, pole upright."""
    device = resolve(device)
    period = p.traj_period_steps if p.traj_period_steps is not None else p.n_steps
    t = torch.arange(p.n_steps, dtype=F32, device=device) * p.dt
    omega = 2.0 * math.pi / (period * p.dt)
    zero = torch.zeros_like(t)
    return torch.stack(
        [p.traj_amplitude * torch.sin(omega * t), p.traj_amplitude * omega * torch.cos(omega * t),
         zero, zero],
        dim=1,
    )


def env_reset(
    p: EnvParams, batch: int, generator: torch.Generator, device=None
) -> tuple[EnvState, torch.Tensor]:
    """B resets at the trajectory start plus `init_noise` Gaussian perturbations
    drawn from `generator` (which must live on `device`)."""
    device = resolve(device)
    traj0 = make_trajectory(p, device)[0]
    noise = torch.randn(batch, cartpole.NX, generator=generator, dtype=F32, device=device)
    x0 = traj0[None] + p.init_noise * noise
    return EnvState(x=x0, t=torch.zeros(batch, dtype=torch.int32, device=device)), x0


def params_to_array(p: CartpoleParams, device=None) -> torch.Tensor:
    """CartpoleParams -> (3,) float32 [m_cart, m_pole, length]."""
    return torch.tensor([p.m_cart, p.m_pole, p.length], dtype=F32, device=resolve(device))


def randomize_params(
    generator: torch.Generator, base: CartpoleParams, scale: float = 0.1, batch: int = 1
) -> torch.Tensor:
    """Per-scenario domain randomization, (batch, 3): each coefficient times
    1 + scale * a standard normal truncated to [-2, 2], drawn from
    `generator` on its device."""
    dev = generator.device
    factors = torch.nn.init.trunc_normal_(torch.empty(batch, 3, dtype=F32, device=dev),
                                          0.0, 1.0, -2.0, 2.0, generator=generator)
    return params_to_array(base, dev) * (1.0 + scale * factors)


def _true_dynamics(p: EnvParams, dyn, x: torch.Tensor, u_cmd: torch.Tensor) -> torch.Tensor:
    """The rigid cartpole `dyn`: the gain error and force bias modify the
    applied force; friction acts on the two velocity rows."""
    f = cartpole.continuous_dynamics(x, p.gain * u_cmd + p.force_bias, params=dyn)
    if p.friction_cart > 0.0 or p.friction_pole > 0.0:
        drag = torch.zeros_like(f)
        drag[..., cartpole.IDX_DX] = -p.friction_cart * x[..., cartpole.IDX_DX] / (dyn.m_cart + dyn.m_pole)
        drag[..., cartpole.IDX_DTHETA] = (
            -p.friction_pole * x[..., cartpole.IDX_DTHETA] / (dyn.m_pole * dyn.length**2)
        )
        f = f + drag
    return f


def env_step(
    p: EnvParams, state: EnvState, action: torch.Tensor, generator: torch.Generator | None = None
) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One control step for all B scenarios: (state, obs, reward, terminated,
    truncated), each leading with B. With `p.noise_std > 0` the process
    noise is drawn from `generator`, which is then required."""
    return _step(p, p.params, state, action, generator)


def env_step_dynamic(
    p: EnvParams, params_arr: torch.Tensor, state: EnvState, action: torch.Tensor,
    generator: torch.Generator | None = None,
) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`env_step` with the rigid coefficients per scenario, params_arr
    (B, 3) (or (3,) for all): `p.params` is ignored in their favour."""
    return _step(p, CartpoleParams(*params_arr.unbind(-1)), state, action, generator)


def _step(p: EnvParams, dyn, state: EnvState, action: torch.Tensor, generator):
    sub_dt = p.dt / p.sim_substeps
    x = state.x
    for _ in range(p.sim_substeps):
        x = cartpole.rk4(lambda x_, u_: _true_dynamics(p, dyn, x_, u_), x, action, sub_dt)
    x = add_process_noise(p, x, _NOISE_ROWS, generator)  # the two velocity rows
    t = state.t + 1

    ref = make_trajectory(p, x.device)[torch.remainder(t.long(), p.n_steps)]
    err_pos = x[:, cartpole.IDX_X] - ref[:, cartpole.IDX_X]
    reward = -(err_pos**2 + x[:, cartpole.IDX_THETA] ** 2)

    s_low, s_high = (torch.as_tensor(b, device=x.device) for b in cartpole.state_bounds())
    terminated = torch.logical_or((x < 2 * s_low).any(-1), (x > 2 * s_high).any(-1))
    truncated = t >= p.n_steps
    return EnvState(x=x, t=t), x, reward, terminated, truncated


class CartpoleTrackEnv(StatefulEnv):
    """The cartpole plant for one scenario, with the reference's calls
    (`gpmpc_tpu/envs/cartpole_env.py:177`): `reset(seed)`, `step(action)`,
    `trajectory`, `dt`, `close()`; `device=None` is the card."""

    _params_cls = EnvParams
    _reset_fn = staticmethod(env_reset)
    _step_fn = staticmethod(env_step)
    _trajectory_fn = staticmethod(make_trajectory)

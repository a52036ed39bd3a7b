"""Quadrotor figure-eight plant, batched over B scenarios. Port of
`gpmpc_tpu/envs/drone.py:35-217`: true-parameter dynamics with rotor and
attitude lag, aero drag and actuation delay, with the rigid coefficients
fixed (`env_step`) or per scenario (`env_step_dynamic`, `params_to_array`,
`randomize_params`), process noise (`noise_std > 0`, from an explicit
generator; the default plant has none) and the stateful single-scenario
`DroneFigureEightEnv`."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.device import device_constant, resolve
from gpmpc_tpu_torch.envs._stateful import StatefulEnv, add_process_noise
from gpmpc_tpu_torch.models import quadrotor
from gpmpc_tpu_torch.models.quadrotor import QuadrotorParams
from gpmpc_tpu_torch.models.trajectory import figure_eight_trajectory

F32 = torch.float32
_VEL_ROWS = [quadrotor.IDX_DX, quadrotor.IDX_DY, quadrotor.IDX_DZ]
# the rows the process noise enters: the three velocities and the two attitude rates
_NOISE_ROWS = _VEL_ROWS + [quadrotor.IDX_DPHI, quadrotor.IDX_DTHETA]
# the velocity and position rows as slices (every other row from 1 and from 0): indexing by a
# slice reads a view, where a list of rows would copy its index to the card on every call
_VEL = slice(quadrotor.IDX_DX, quadrotor.IDX_DZ + 1, 2)
_POS = slice(quadrotor.IDX_X, quadrotor.IDX_Z + 1, 2)


class EnvParams(NamedTuple):
    """Plant and episode parameters (same fields and defaults as the reference)."""

    params: QuadrotorParams
    dt: float = 0.02
    n_steps: int = 300
    sim_substeps: int = 2
    init_noise: float = 0.02
    traj_amplitude: float = 0.8
    traj_height: float = 1.0
    rotor_tau: float = 0.06
    att_tau: float = 0.03
    drag_lin: float = 0.10
    drag_quad: float = 0.06
    delay_steps: int = 1
    noise_std: float = 0.0

    @classmethod
    def default(cls) -> "EnvParams":
        return cls(params=quadrotor.TRUE_PARAMS)


class EnvState(NamedTuple):
    """Batched plant state; every leaf leads with B."""

    x: torch.Tensor  # (B, 12)
    t: torch.Tensor  # (B,) int32
    u_act: torch.Tensor  # (B, 4) actuator outputs after the lag
    u_queue: torch.Tensor  # (B, delay_steps, 4) in-flight delayed commands


def make_trajectory(p: EnvParams, device=None) -> torch.Tensor:
    return figure_eight_trajectory(
        n_steps=p.n_steps, dt=p.dt, amplitude=p.traj_amplitude, height=p.traj_height,
        device=device,
    )


def hover_input(params: QuadrotorParams, device=None) -> torch.Tensor:
    device = resolve(device)
    t_hover = (quadrotor.GRAVITY - params.b) / params.a
    return torch.tensor([t_hover, 0.0, 0.0, 0.0], dtype=F32, device=device)


def env_reset(
    p: EnvParams, batch: int, generator: torch.Generator, device=None
) -> tuple[EnvState, torch.Tensor]:
    """B resets at the trajectory start plus `init_noise` Gaussian perturbations
    drawn from `generator` (which must live on `device`)."""
    device = resolve(device)
    traj0 = make_trajectory(p, device)[0]
    noise = torch.randn(batch, traj0.shape[0], generator=generator, dtype=F32, device=device)
    x0 = traj0[None] + p.init_noise * noise
    u_hover = hover_input(p.params, device)
    state = EnvState(
        x=x0,
        t=torch.zeros(batch, dtype=torch.int32, device=device),
        u_act=u_hover.expand(batch, 4).clone(),
        u_queue=u_hover.expand(batch, p.delay_steps, 4).clone(),
    )
    return state, x0


def params_to_array(p: QuadrotorParams, device=None) -> torch.Tensor:
    """QuadrotorParams -> (8,) float32 [a, b, c, d, e, f, h, l]."""
    return torch.tensor([p.a, p.b, p.c, p.d, p.e, p.f, p.h, p.l], dtype=F32, device=resolve(device))


def randomize_params(
    generator: torch.Generator, base: QuadrotorParams, scale: float = 0.1, batch: int = 1
) -> torch.Tensor:
    """Per-scenario domain randomization, (batch, 8): every coefficient times
    1 + scale * a standard normal truncated to [-2, 2], drawn from
    `generator` on its device (JAX's draw cannot be reproduced)."""
    dev = generator.device
    factors = torch.nn.init.trunc_normal_(torch.empty(batch, 8, dtype=F32, device=dev),
                                          0.0, 1.0, -2.0, 2.0, generator=generator)
    return params_to_array(base, dev) * (1.0 + scale * factors)


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
    (B, 8) (or (8,) for all): `p.params` is ignored in their favour."""
    return _step(p, QuadrotorParams(*params_arr.unbind(-1)), state, action, generator)


def _step_constants(p: EnvParams, device):
    """(alpha (4,), the reference trajectory (n_steps, 12), the state box (12,) x 2) of the
    plant `p` on `device`, built once (`device_constant`)."""
    def build(device):
        sub_dt = p.dt / p.sim_substeps
        alpha = torch.tensor(
            [1.0 - math.exp(-sub_dt / tau) if tau > 0.0 else 1.0
             for tau in (p.rotor_tau, p.att_tau, p.att_tau, p.att_tau)],
            dtype=F32, device=device,
        )
        s_low, s_high = (torch.as_tensor(b, device=device) for b in quadrotor.state_bounds())
        return alpha, make_trajectory(p, device), s_low, s_high

    return device_constant(("drone.step", p), device, build)


def _step(p: EnvParams, dyn, state: EnvState, action: torch.Tensor, generator):
    def fc(x_, u_):
        f = quadrotor.continuous_dynamics(x_, u_, params=dyn)
        if p.drag_lin > 0.0 or p.drag_quad > 0.0:
            v = x_[..., _VEL].contiguous()
            drag = -(p.drag_lin + p.drag_quad * torch.linalg.vector_norm(v, dim=-1, keepdim=True)) * v
            f = f.clone()
            f[..., _VEL] += drag
        return f

    if p.delay_steps > 0:
        u_cmd = state.u_queue[:, 0]
        u_queue = torch.cat([state.u_queue[:, 1:], action[:, None]], dim=1)
    else:
        u_cmd = action
        u_queue = state.u_queue

    sub_dt = p.dt / p.sim_substeps
    alpha, traj, s_low, s_high = _step_constants(p, action.device)
    x = state.x
    u_act = state.u_act
    for _ in range(p.sim_substeps):
        u_act = u_act + alpha * (u_cmd - u_act)
        x = quadrotor.rk4(fc, x, u_act, sub_dt)
    x = add_process_noise(p, x, _NOISE_ROWS, generator)
    t = state.t + 1

    ref = traj[torch.remainder(t.long(), p.n_steps)]
    pos_err = x[:, _POS] - ref[:, _POS]
    reward = -torch.sum(pos_err**2, dim=-1)

    terminated = torch.logical_or((x < 2 * s_low).any(-1), (x > 2 * s_high).any(-1))
    truncated = t >= p.n_steps
    return EnvState(x=x, t=t, u_act=u_act, u_queue=u_queue), x, reward, terminated, truncated


class DroneFigureEightEnv(StatefulEnv):
    """The quadrotor plant for one scenario, with the reference's calls
    (`gpmpc_tpu/envs/drone.py:220`): `reset(seed)`, `step(action)`,
    `trajectory`, `dt`, `close()`; `device=None` is the card."""

    _params_cls = EnvParams
    _reset_fn = staticmethod(env_reset)
    _step_fn = staticmethod(env_step)
    _trajectory_fn = staticmethod(make_trajectory)

"""Two-link-arm tracking plant, batched over B scenarios. Port of
`gpmpc_tpu/envs/twolink_env.py`: the true arm (slightly heavier, longer
links) with a point-mass payload at the link-2 tip, viscous joint friction
and a torque gain error plus bias, tracking joint-space sinusoids around the
hanging posture, with the rigid coefficients fixed (`env_step`) or per
scenario (`env_step_dynamic`, `params_to_array`, `randomize_params`).
Process noise (`noise_std > 0`) is not ported yet (ROADMAP.md Queue 1 item 8c)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.device import UnsupportedPathError, resolve
from gpmpc_tpu_torch.models import twolink
from gpmpc_tpu_torch.models.twolink import GRAVITY, TwoLinkParams

F32 = torch.float32

TRUE_PARAMS = TwoLinkParams(m1=1.05, m2=1.1, l1=1.0, l2=1.05)


class EnvParams(NamedTuple):
    """Plant and episode parameters (same fields and defaults as the reference)."""

    params: TwoLinkParams
    dt: float = 0.02
    n_steps: int = 300
    sim_substeps: int = 2
    init_noise: float = 0.02
    amp1: float = 0.45
    amp2: float = 0.45
    phase2: float = 1.2
    q1_center: float = -math.pi / 2
    q2_center: float = 0.7
    traj_period_steps: int | None = None
    payload_m: float = 0.05
    friction1: float = 0.35
    friction2: float = 0.25
    gain: float = 0.92
    bias1: float = -2.5
    bias2: float = -1.5
    noise_std: float = 0.0

    @classmethod
    def default(cls) -> "EnvParams":
        return cls(params=TRUE_PARAMS)

    @classmethod
    def ideal(cls, **overrides) -> "EnvParams":
        """The prior's own model class: prior rigid parameters, no mismatch."""
        kw = dict(payload_m=0.0, friction1=0.0, friction2=0.0, gain=1.0, bias1=0.0, bias2=0.0,
                  noise_std=0.0)
        kw.update(overrides)
        return cls(params=TwoLinkParams(), **kw)


class EnvState(NamedTuple):
    """Batched plant state; every leaf leads with B."""

    x: torch.Tensor  # (B, 4)
    t: torch.Tensor  # (B,) int32


def make_trajectory(p: EnvParams, device=None) -> torch.Tensor:
    """(n_steps, 4): joint-space sinusoids with their rates."""
    device = resolve(device)
    period = p.traj_period_steps if p.traj_period_steps is not None else p.n_steps
    t = torch.arange(p.n_steps, dtype=F32, device=device) * p.dt
    omega = 2.0 * math.pi / (period * p.dt)
    return torch.stack(
        [p.q1_center + p.amp1 * torch.sin(omega * t),
         p.q2_center + p.amp2 * torch.sin(omega * t + p.phase2),
         p.amp1 * omega * torch.cos(omega * t),
         p.amp2 * omega * torch.cos(omega * t + p.phase2)],
        dim=1,
    )


def env_reset(
    p: EnvParams, batch: int, generator: torch.Generator, device=None
) -> tuple[EnvState, torch.Tensor]:
    """B resets at the trajectory start plus `init_noise` Gaussian perturbations
    drawn from `generator` (which must live on `device`)."""
    device = resolve(device)
    traj0 = make_trajectory(p, device)[0]
    noise = torch.randn(batch, twolink.NX, generator=generator, dtype=F32, device=device)
    x0 = traj0[None] + p.init_noise * noise
    return EnvState(x=x0, t=torch.zeros(batch, dtype=torch.int32, device=device)), x0


def params_to_array(p: TwoLinkParams, device=None) -> torch.Tensor:
    """TwoLinkParams -> (4,) float32 [m1, m2, l1, l2]."""
    return torch.tensor([p.m1, p.m2, p.l1, p.l2], dtype=F32, device=resolve(device))


def randomize_params(
    generator: torch.Generator, base: TwoLinkParams, scale: float = 0.1, batch: int = 1
) -> torch.Tensor:
    """Per-scenario domain randomization, (batch, 4): each coefficient times
    1 + scale * a standard normal truncated to [-2, 2], drawn from
    `generator` on its device."""
    dev = generator.device
    factors = torch.nn.init.trunc_normal_(torch.empty(batch, 4, dtype=F32, device=dev),
                                          0.0, 1.0, -2.0, 2.0, generator=generator)
    return params_to_array(base, dev) * (1.0 + scale * factors)


def _true_dynamics(p: EnvParams, dyn, x: torch.Tensor, u_cmd: torch.Tensor) -> torch.Tensor:
    """Rigid arm `dyn` plus the tip payload, joint friction and the torque
    gain and bias."""
    q1, q2, dq1, dq2 = x.unbind(-1)
    m11, m12, m22, g1, g2, h = twolink._mass_gravity(dyn, q1, q2)
    mp = p.payload_m
    if mp > 0.0:  # point mass at distance l2 along link 2
        c2 = torch.cos(q2)
        m11 = m11 + mp * (dyn.l1**2 + dyn.l2**2 + 2.0 * dyn.l1 * dyn.l2 * c2)
        m12 = m12 + mp * (dyn.l2**2 + dyn.l1 * dyn.l2 * c2)
        m22 = m22 + mp * dyn.l2**2
        h = h + mp * dyn.l1 * dyn.l2 * torch.sin(q2)
        g1 = g1 + mp * GRAVITY * (dyn.l1 * torch.cos(q1) + dyn.l2 * torch.cos(q1 + q2))
        g2 = g2 + mp * GRAVITY * dyn.l2 * torch.cos(q1 + q2)
    tau1 = p.gain * u_cmd[..., 0] + p.bias1 - p.friction1 * dq1
    tau2 = p.gain * u_cmd[..., 1] + p.bias2 - p.friction2 * dq2
    r1 = tau1 + h * dq2 * (2.0 * dq1 + dq2) - g1
    r2 = tau2 - h * dq1 * dq1 - g2
    ddq1, ddq2 = twolink.solve_mass(m11, m12, m22, r1, r2)
    return torch.stack([dq1, dq2, ddq1, ddq2], dim=-1)


def env_step(
    p: EnvParams, state: EnvState, action: torch.Tensor
) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One control step for all B scenarios: (state, obs, reward, terminated,
    truncated), each leading with B."""
    return _step(p, p.params, state, action)


def env_step_dynamic(
    p: EnvParams, params_arr: torch.Tensor, state: EnvState, action: torch.Tensor
) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`env_step` with the rigid coefficients per scenario, params_arr
    (B, 4) (or (4,) for all): `p.params` is ignored in their favour."""
    return _step(p, TwoLinkParams(*params_arr.unbind(-1)), state, action)


def _step(p: EnvParams, dyn, state: EnvState, action: torch.Tensor):
    if p.noise_std > 0.0:
        raise UnsupportedPathError(
            "two-link plant process noise is not ported yet (ROADMAP.md Queue 1 item 8c); use noise_std=0"
        )
    sub_dt = p.dt / p.sim_substeps
    x = state.x
    for _ in range(p.sim_substeps):
        x = twolink.rk4(lambda x_, u_: _true_dynamics(p, dyn, x_, u_), x, action, sub_dt)
    t = state.t + 1

    ref = make_trajectory(p, x.device)[torch.remainder(t.long(), p.n_steps)]
    reward = -torch.sum((x[:, :2] - ref[:, :2]) ** 2, dim=-1)

    s_low, s_high = (torch.as_tensor(b, device=x.device) for b in twolink.state_bounds())
    terminated = torch.logical_or((x < 2 * s_low).any(-1), (x > 2 * s_high).any(-1))
    truncated = t >= p.n_steps
    return EnvState(x=x, t=t), x, reward, terminated, truncated

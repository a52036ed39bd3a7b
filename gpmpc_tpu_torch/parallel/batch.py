"""Scenario-batched GP-MPC steps and episodes. Port of
`gpmpc_tpu/parallel/batch.py`'s `dispatch_decision`, its one-time
degradation warnings, `batched_gpmpc_step` for the `lanes-fused` and `lanes`
paths, and the episodes on the lanes backend (`batched_episode`,
`_batched_episode_lanes`, `cfg_horizon`) with a shared GP or a population;
the `xla` path (the vmapped `select_action`) raises `UnsupportedPathError`
instead of falling back. Sharding and the domain-randomized wrapper are not
ported yet (ROADMAP.md Queue 1)."""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.control import gpmpc as gpmpc_mod
from gpmpc_tpu_torch.control.gpmpc import GpModel, GpMpcConsts, UnsupportedPathError
from gpmpc_tpu_torch.control import mpc as mpc_mod
from gpmpc_tpu_torch.control.mpc import MpcState
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.ops.sqp import SqpConfig
from gpmpc_tpu_torch.ops.sqp_lanes import LANES, MAX_FUSED_HORIZON, lanes_horizon_cap, lanes_serves


class DispatchDecision(NamedTuple):
    """Outcome of `dispatch_decision`. `degraded` is True iff the path is below
    what was requested for a reason the user did not configure (horizon caps,
    a family without a kernel linearizer, a GP population): the cases the
    one-time warnings exist for."""

    path: str
    reason: str
    degraded: bool = False


def dispatch_decision(
    cfg: SqpConfig, spec, T: int, gp_batched: bool = False, backend: str = "lanes"
) -> DispatchDecision:
    """(path, reason, degraded) for this configuration: the reference's
    decision table with the reference's reason texts, so a user of either
    package reads the same words. Paths:

      "lanes-fused"  kernel linearization + lanes QP, X and U kept in lanes layout
      "lanes"        lanes QP with the dynamics linearized in plain torch
      "xla"          the reference's fully-XLA path (not ported: raises)
    """
    if backend != "lanes":
        return DispatchDecision("xla", "requested explicitly")
    if not lanes_serves(cfg, T):
        soft = " with soft state bounds" if cfg.soft_x_penalty is not None else ""
        return DispatchDecision("xla", (
            f"horizon T={T} exceeds the lanes cap ({lanes_horizon_cap(cfg)}{soft}); "
            "the XLA path serves any horizon (orders of magnitude slower per "
            "solve — measured 200x at T=200 — see README dispatch matrix)"
        ), degraded=True)
    if gp_batched:
        return DispatchDecision("lanes", (
            "per-scenario GP population: linearization runs vmapped under XLA "
            "(each scenario has its own Gram); QP + tightening stay in lanes"
        ), degraded=True)
    if not cfg.kernel_linearize:
        return DispatchDecision(
            "lanes", "kernel_linearize disabled; jacfwd linearization + lanes QP"
        )
    if not spec.supports_kernel_linearize:
        return DispatchDecision("lanes", (
            f"model family '{spec.name}' has no in-kernel linearizer closure "
            "(ops/pallas_linearize.py registry); jacfwd linearization + lanes QP"
        ), degraded=True)
    if T > MAX_FUSED_HORIZON:
        return DispatchDecision("lanes", (
            f"horizon T={T} exceeds the fused-path cap ({MAX_FUSED_HORIZON}); "
            "jacfwd linearization + lanes QP"
        ), degraded=True)
    return DispatchDecision(
        "lanes-fused", "in-kernel linearizer + lanes QP (the flagship path)"
    )


# Reasons already warned about: each distinct degradation warns once per process.
_DISPATCH_WARNED: set[str] = set()


def _warn_dispatch(decision: DispatchDecision) -> None:
    """Warn once per distinct reason iff the decision is degraded; explicit
    user choices (backend="xla", kernel_linearize=False) stay silent."""
    if not decision.degraded or decision.reason in _DISPATCH_WARNED:
        return
    _DISPATCH_WARNED.add(decision.reason)
    warnings.warn(
        f"gpmpc dispatch: lanes backend requested but taking the "
        f"'{decision.path}' path — {decision.reason}",
        stacklevel=3,
    )


def batched_gpmpc_step(
    model,
    cfg: SqpConfig,
    consts: GpMpcConsts,
    gp: GpModel,
    states: MpcState,  # leaves with leading batch axis B
    obs: torch.Tensor,  # (B, nx)
    backend: str = "lanes",
    lanes: int = LANES,
):
    """One GP-MPC solve for B scenarios: (u (B, nu), next states, MpcInfo).
    Executes `dispatch_decision`: `lanes-fused` and `lanes` run, each
    degradation warning once with its reason; `xla` raises."""
    T = consts.mpc.uref.shape[0]
    decision = dispatch_decision(
        cfg, gpmpc_mod.model_spec(model), T, gpmpc_mod.gp_is_batched(gp), backend
    )
    if decision.path == "xla":
        raise UnsupportedPathError(
            f"dispatch path 'xla' ({decision.reason}) is not ported; 'lanes-fused' and "
            "'lanes' are (ROADMAP.md Queue 1)"
        )
    _warn_dispatch(decision)
    return gpmpc_mod.batched_select_action_lanes(model, cfg, consts, gp, states, obs, lanes=lanes)


class EpisodeResult(NamedTuple):
    obs: torch.Tensor  # (B, n_steps+1, nx)
    actions: torch.Tensor  # (B, n_steps, nu)
    rewards: torch.Tensor  # (B, n_steps)


def cfg_horizon(consts: GpMpcConsts) -> int:
    return consts.mpc.uref.shape[0]


def batched_episode(
    model,
    cfg: SqpConfig,
    env_params,
    consts: GpMpcConsts,
    gp: GpModel,
    generator: torch.Generator,
    n_steps: int,
    batch: int,
    use_gp: bool = True,
    param_scale: float | None = None,
    backend: str = "lanes",
    gp_batched: bool = False,
    env_mod=drone,
) -> EpisodeResult:
    """Closed-loop episodes of `batch` scenarios on the lanes backend: a
    host loop of `batched_select_action_lanes` and the plant, on the
    device of `consts` (the reference's scan has nothing to hoist here).

    `env_mod` is any module with `envs/drone.py`'s surface (`env_reset`,
    `env_step_dynamic`, `params_to_array`, `randomize_params`); the initial
    states, and with `param_scale` every scenario's own plant coefficients
    (the reference's domain randomization), are drawn from `generator`,
    which must live on that device (JAX's keys cannot be reproduced). With
    `gp_batched`, every `gp` leaf leads with `batch` and each scenario runs
    its own GP. The QP tiles are LANES scenarios wide on the card and the
    whole batch wide on the CPU, as `GPMPC.select_action` picks its width
    from the device. The reference's `xla` backend and `use_gp=False` (its
    nominal MPC) are not ported and raise `UnsupportedPathError`."""
    if backend != "lanes":
        raise UnsupportedPathError(
            f"batched_episode(backend={backend!r}) needs the reference's vmapped select_action, "
            "which is not ported; backend='lanes' is (ROADMAP.md Queue 1)"
        )
    if not use_gp:
        raise UnsupportedPathError(
            "batched_episode(use_gp=False) needs the reference's nominal MPC, which is not "
            "ported; the untrained GP (empty_gp_model) gives the prior controller (ROADMAP.md "
            "Queue 1)"
        )
    if gp_batched != gpmpc_mod.gp_is_batched(gp):
        raise ValueError(f"gp_batched={gp_batched} but the GpModel's leaves "
                         f"{'do' if gpmpc_mod.gp_is_batched(gp) else 'do not'} lead with a scenario axis")
    return _batched_episode_lanes(model, cfg, env_params, consts, gp, generator, n_steps, batch,
                                  param_scale, env_mod)


def _batched_episode_lanes(model, cfg, env_params, consts, gp, generator, n_steps, batch,
                           param_scale, env_mod) -> EpisodeResult:
    dev = consts.Ad.device
    lanes = LANES if dev.type == "cuda" else batch
    env_states, obs0 = env_mod.env_reset(env_params, batch, generator, dev)
    if param_scale is None:
        plant = env_mod.params_to_array(env_params.params, dev).expand(batch, -1)
    else:
        plant = env_mod.randomize_params(generator, env_params.params, param_scale, batch)
    ctrl = mpc_mod.init_state(batch, cfg_horizon(consts), model.nx, model.nu, device=dev)
    obs, obs_path, actions, rewards = obs0, [obs0], [], []
    for _ in range(n_steps):
        u, ctrl, _ = gpmpc_mod.batched_select_action_lanes(model, cfg, consts, gp, ctrl, obs,
                                                           lanes=lanes)
        env_states, obs, reward, _, _ = env_mod.env_step_dynamic(env_params, plant, env_states, u)
        obs_path.append(obs)
        actions.append(u)
        rewards.append(reward)
    return EpisodeResult(obs=torch.stack(obs_path, dim=1), actions=torch.stack(actions, dim=1),
                         rewards=torch.stack(rewards, dim=1))

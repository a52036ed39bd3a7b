"""Scenario-batched GP-MPC steps and episodes. Port of
`gpmpc_tpu/parallel/batch.py`: `dispatch_decision`, its one-time degradation
warnings, `batched_gpmpc_step` on all three paths (`lanes-fused`, `lanes`
and `xla`, the reference's vmapped `select_action`, its default), and the
episodes (`batched_episode` on either backend, GP-MPC or the nominal MPC,
with a shared GP or a population; `batched_episode_randomized`;
`cfg_horizon`) and `make_batched_controller_step`, whose mesh form runs
the step on each shard of the scenario axis (`parallel/mesh.py`). An
episode can run rows [lo, hi) of a population: every random draw is made at
the population's width and cut to the rows, so shards reproduce the whole
run's rows."""

from __future__ import annotations

import contextlib
import warnings
from functools import partial
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.control import gpmpc as gpmpc_mod
from gpmpc_tpu_torch.control.gpmpc import GpModel, GpMpcConsts
from gpmpc_tpu_torch.control import mpc as mpc_mod
from gpmpc_tpu_torch.control.mpc import MpcState
from gpmpc_tpu_torch.device import ShardDraw
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.parallel.mesh import Sharded, shard_leading_axis, tree_map
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
      "xla"          the reference's fully-XLA path: `control/gpmpc.py::select_action`
                     on the nominal solver stack, in plain torch
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
    backend: str = "xla",
    var_backend: str = "auto",
    var_bf16: bool = False,
    lanes: int = LANES,
    tighten_backend: str = "auto",
):
    """One GP-MPC solve for B scenarios: (u (B, nu), next states, MpcInfo).
    Executes `dispatch_decision`, each degradation warning once with its
    reason: `backend="lanes"` takes `lanes-fused` or `lanes` where the lanes
    caps serve the horizon, else `xla`, which serves any horizon; the default
    is the reference's, `xla`. `lanes` is the scenario tile of the lanes QP.
    `var_backend` and `var_bf16` select the tightening variances
    (`control/gpmpc.py::batched_variances`) and `tighten_backend` the
    recursion (`batched_prepare_step`; the reference takes it there only) on
    the lanes paths; the `xla` path ignores all three, as the reference's
    vmapped `select_action` does."""
    T = consts.mpc.uref.shape[0]
    decision = dispatch_decision(
        cfg, gpmpc_mod.model_spec(model), T, gpmpc_mod.gp_is_batched(gp), backend
    )
    _warn_dispatch(decision)
    if decision.path == "xla":
        return gpmpc_mod.select_action(model, cfg, consts, gp, states, obs)
    return gpmpc_mod.batched_select_action_lanes(
        model, cfg, consts, gp, states, obs, lanes=lanes, var_backend=var_backend,
        var_bf16=var_bf16, tighten_backend=tighten_backend)


def make_batched_controller_step(model, cfg: SqpConfig, mesh=None):
    """`batched_gpmpc_step` with `model` and `cfg` bound: a callable of
    (consts, gp, states, obs, backend=..., ...). Nothing is compiled (the
    reference jits here). With a `mesh` (`parallel/mesh.py`) the scenario
    axis is sharded over its first axis: consts and GP are replicated, states
    and observations are sharded (`Sharded` from `shard_leading_axis`, or
    whole trees, which the callable shards), the step runs on each local
    shard on that shard's device, and it returns (u, states, info), each a
    `Sharded` (the reference's `out_shardings`). A scenario's solution does
    not depend on the rest of its shard, except through the QP kernel's
    tile-wide exit: shards of whole tiles of 128 give the unsharded step's
    numbers bit for bit."""
    if mesh is None:
        return partial(batched_gpmpc_step, model, cfg)
    axis = mesh.axis_names[0]

    def step(consts, gp, states, obs, **kw):
        states = states if isinstance(states, Sharded) else shard_leading_axis(states, mesh, axis)
        obs = obs if isinstance(obs, Sharded) else shard_leading_axis(obs, mesh, axis)
        if states.index != obs.index:
            raise ValueError(f"states shards {states.index} and observation shards {obs.index}")
        outs = []
        for dev, st, ob in zip(states.devices, states.shards, obs.shards):
            c, g = (tree_map(lambda t, d=dev: t.to(d), x) for x in (consts, gp))
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                outs.append(batched_gpmpc_step(model, cfg, c, g, st, ob, **kw))
        return tuple(Sharded([o[i] for o in outs], states.index, states.count, states.devices)
                     for i in range(3))

    return step


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
    backend: str = "xla",
    gp_batched: bool = False,
    env_mod=drone,
    rows: tuple[int, int] | None = None,
) -> EpisodeResult:
    """Closed-loop episodes of `batch` scenarios: a host loop of the
    controller step and the plant, on the device of `consts` (the
    reference's scan has nothing to hoist here).

    backend="xla" (the reference's default) steps `control/gpmpc.py::
    select_action`, or with `use_gp=False` the nominal MPC
    (`control/mpc.py::select_action` on `consts.mpc`); backend="lanes" steps
    `batched_select_action_lanes` (GP-MPC only, as in the reference), its QP
    tiles LANES scenarios wide on the card and the whole batch wide on the
    CPU. `env_mod` is any module with `envs/drone.py`'s surface
    (`env_reset`, `env_step_dynamic`, `params_to_array`, `randomize_params`);
    the initial states, with `param_scale` every scenario's own plant
    coefficients (the reference's domain randomization), and with the
    plant's `noise_std > 0` its process noise, are drawn from `generator`, which must live on that device (JAX's keys cannot be
    reproduced). With `gp_batched`, every `gp` leaf leads with the
    scenarios run and each scenario runs its own GP. With `rows` = (lo, hi)
    only scenarios [lo, hi) of the `batch` run (a shard of the population):
    every draw (initial states, plant coefficients, each step's process
    noise) is made at the full `batch` width from `generator` and cut to the
    rows, so the shard's numbers are the whole run's rows; the draws are a
    few numbers a scenario a step."""
    if backend == "lanes" and not use_gp:
        raise ValueError("backend='lanes' requires use_gp=True (GP-MPC step)")
    if gp_batched != gpmpc_mod.gp_is_batched(gp):
        raise ValueError(f"gp_batched={gp_batched} but the GpModel's leaves "
                         f"{'do' if gpmpc_mod.gp_is_batched(gp) else 'do not'} lead with a scenario axis")
    dev = consts.Ad.device
    lo, hi = (0, batch) if rows is None else rows
    if not 0 <= lo < hi <= batch:
        raise ValueError(f"rows [{lo}, {hi}) of a batch of {batch}")
    n = hi - lo
    if not use_gp:
        step = lambda ctrl, obs: mpc_mod.select_action(model, cfg, consts.mpc, ctrl, obs)  # noqa: E731
    elif backend != "lanes":
        step = lambda ctrl, obs: gpmpc_mod.select_action(model, cfg, consts, gp, ctrl, obs)  # noqa: E731
    else:
        lanes = LANES if dev.type == "cuda" else n
        step = lambda ctrl, obs: gpmpc_mod.batched_select_action_lanes(  # noqa: E731
            model, cfg, consts, gp, ctrl, obs, lanes=lanes)
    env_states, obs0 = env_mod.env_reset(env_params, batch, generator, dev)
    env_states, obs0 = tree_map(lambda t: t[lo:hi], (env_states, obs0))
    if param_scale is None:
        plant = env_mod.params_to_array(env_params.params, dev).expand(n, -1)
    else:
        plant = env_mod.randomize_params(generator, env_params.params, param_scale, batch)[lo:hi]
    noise = generator if rows is None else ShardDraw(generator, batch, lo, hi)
    ctrl = mpc_mod.init_state(n, cfg_horizon(consts), model.nx, model.nu, device=dev)
    obs, obs_path, actions, rewards = obs0, [obs0], [], []
    for _ in range(n_steps):
        u, ctrl, _ = step(ctrl, obs)
        env_states, obs, reward, _, _ = env_mod.env_step_dynamic(env_params, plant, env_states, u,
                                                                 generator=noise)
        obs_path.append(obs)
        actions.append(u)
        rewards.append(reward)
    return EpisodeResult(obs=torch.stack(obs_path, dim=1), actions=torch.stack(actions, dim=1),
                         rewards=torch.stack(rewards, dim=1))


def batched_episode_randomized(
    model,
    cfg: SqpConfig,
    env_params,
    consts: GpMpcConsts,
    gp: GpModel,
    generator: torch.Generator,
    n_steps: int,
    batch: int,
    param_scale: float = 0.1,
    use_gp: bool = True,
) -> EpisodeResult:
    """Domain-randomized episodes: `batched_episode` with `param_scale`, on
    its default backend, as the reference's wrapper."""
    return batched_episode(model, cfg, env_params, consts, gp, generator, n_steps, batch,
                           use_gp=use_gp, param_scale=param_scale)

"""Scenario-batched GP-MPC step. Port of `gpmpc_tpu/parallel/batch.py`'s
`dispatch_decision`, its one-time degradation warnings and
`batched_gpmpc_step` for the `lanes-fused` and `lanes` paths; the `xla` path
(the vmapped `select_action`) raises `UnsupportedPathError` instead of
falling back. Episodes, sharding and sweeps are not ported yet (ROADMAP.md
Queue 1)."""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.control import gpmpc as gpmpc_mod
from gpmpc_tpu_torch.control.gpmpc import GpModel, GpMpcConsts, UnsupportedPathError
from gpmpc_tpu_torch.control.mpc import MpcState
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

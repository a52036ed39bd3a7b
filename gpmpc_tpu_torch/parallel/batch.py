"""Scenario-batched GP-MPC step. Port of `gpmpc_tpu/parallel/batch.py`'s
`dispatch_decision` and `batched_gpmpc_step` for the `lanes-fused` path only:
every other path of the reference raises `UnsupportedPathError` instead of
falling back. Episodes, sharding and sweeps are not ported yet (ROADMAP.md
Queue 1)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch.control import gpmpc as gpmpc_mod
from gpmpc_tpu_torch.control.gpmpc import GpModel, GpMpcConsts, UnsupportedPathError
from gpmpc_tpu_torch.control.mpc import MpcState
from gpmpc_tpu_torch.ops.sqp import SqpConfig
from gpmpc_tpu_torch.ops.sqp_lanes import LANES, MAX_FUSED_HORIZON, lanes_horizon_cap, lanes_serves


class DispatchDecision(NamedTuple):
    path: str
    reason: str
    degraded: bool = False


def dispatch_decision(
    cfg: SqpConfig, spec, T: int, gp_batched: bool = False, backend: str = "lanes"
) -> DispatchDecision:
    """The path the reference's dispatcher takes for this configuration (the
    same decision table, so the port refuses exactly what it has not ported)."""
    if backend != "lanes":
        return DispatchDecision("xla", "requested explicitly")
    if not lanes_serves(cfg, T):
        soft = " with soft state bounds" if cfg.soft_x_penalty is not None else ""
        return DispatchDecision(
            "xla", f"horizon T={T} exceeds the lanes cap ({lanes_horizon_cap(cfg)}{soft})", True
        )
    if gp_batched:
        return DispatchDecision("lanes", "per-scenario GP population", True)
    if not cfg.kernel_linearize:
        return DispatchDecision("lanes", "kernel_linearize disabled; jacfwd linearization")
    if not spec.supports_kernel_linearize:
        return DispatchDecision("lanes", f"model family '{spec.name}' has no kernel linearizer", True)
    if T > MAX_FUSED_HORIZON:
        return DispatchDecision("lanes", f"horizon T={T} exceeds the fused-path cap", True)
    return DispatchDecision("lanes-fused", "in-kernel linearizer + lanes QP")


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
    Serves the `lanes-fused` path; any other decision raises."""
    T = consts.mpc.uref.shape[0]
    decision = dispatch_decision(cfg, gpmpc_mod.model_spec(model), T, gp.Zs.dim() == 4, backend)
    if decision.path != "lanes-fused":
        raise UnsupportedPathError(
            f"dispatch path '{decision.path}' ({decision.reason}) is not ported; only "
            "'lanes-fused' is (ROADMAP.md Queue 1)"
        )
    return gpmpc_mod.batched_select_action_lanes(model, cfg, consts, gp, states, obs, lanes=lanes)

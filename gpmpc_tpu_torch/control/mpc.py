"""MPC constants, controller state and reference windowing. Port of
`gpmpc_tpu/control/mpc.py:34-147`; the nominal `MPC` controller is not ported
yet (ROADMAP.md Queue 1)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.models import quadrotor

F32 = torch.float32


class MpcConsts(NamedTuple):
    traj: torch.Tensor  # (N, nx) periodic reference
    Q: torch.Tensor  # (nx, nx)
    R: torch.Tensor  # (nu, nu)
    uref: torch.Tensor  # (T, nu)
    scale: torch.Tensor  # (T+1,) [dt, ..., dt, 1]
    lx: torch.Tensor  # (nx,)
    ux: torch.Tensor
    lu: torch.Tensor  # (nu,)
    uu: torch.Tensor


class MpcState(NamedTuple):
    """Controller state; every leaf carries a leading batch axis B."""

    traj_step: torch.Tensor  # (B,) int32
    X_warm: torch.Tensor  # (B, T+1, nx)
    U_warm: torch.Tensor  # (B, T, nu)


class MpcInfo(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    step_norm: torch.Tensor
    qp_gap: torch.Tensor
    n_iters: torch.Tensor
    clamp_frac: torch.Tensor
    soft_viol: torch.Tensor
    eq_res: torch.Tensor
    stat_res: torch.Tensor
    converged: torch.Tensor


def make_consts(model, traj, q_mpc, r_mpc, horizon: int, device="cpu") -> MpcConsts:
    """The quadrotor's constants: hover-trim input reference and its boxes."""
    assert len(q_mpc) == model.nx and len(r_mpc) == model.nu
    (lx, ux), (lu, uu) = quadrotor.state_bounds(), quadrotor.input_bounds()
    u_eq = model.u_eq if model.u_eq is not None else np.zeros(model.nu, np.float32)
    scale = np.full(horizon + 1, model.dt)
    scale[-1] = 1.0
    t = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"), device=device)  # noqa: E731
    return MpcConsts(
        traj=torch.as_tensor(traj, dtype=F32).to(device),
        Q=torch.diag(t(q_mpc)),
        R=torch.diag(t(r_mpc)),
        uref=t(np.tile(np.asarray(u_eq, np.float32)[None], (horizon, 1))),
        scale=t(scale),
        lx=t(lx), ux=t(ux), lu=t(lu), uu=t(uu),
    )


def init_state(batch: int, horizon: int, nx: int = 12, nu: int = 4, device="cpu") -> MpcState:
    """B fresh controller states: step 0, zero state guess, hover-trim inputs."""
    u_eq = torch.as_tensor(quadrotor.U_EQ, device=device) if nu == quadrotor.NU else (
        torch.zeros(nu, dtype=F32, device=device)
    )
    return MpcState(
        traj_step=torch.zeros(batch, dtype=torch.int32, device=device),
        X_warm=torch.zeros(batch, horizon + 1, nx, dtype=F32, device=device),
        U_warm=u_eq.expand(batch, horizon, nu).clone(),
    )


def reference_window(traj: torch.Tensor, traj_step: torch.Tensor, horizon: int) -> torch.Tensor:
    """Periodic reference windows: traj_step (B,) -> (B, T+1, nx)."""
    idx = torch.remainder(
        traj_step[:, None].long() + torch.arange(horizon + 1, device=traj.device), traj.shape[0]
    )
    return traj[idx]

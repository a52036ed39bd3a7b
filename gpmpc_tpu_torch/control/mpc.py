"""Nominal nonlinear MPC (the prior model, no GP), batch-first. Port of
`gpmpc_tpu/control/mpc.py`: the constants, the controller state, reference
windowing, the pure `select_action` (an SQP of `ops/sqp.py` on the model's
RK4 dynamics `fd_func`, every leaf with a leading scenario axis B, as the
reference's under `jax.vmap`), `state_bound_violation` and the stateful
`MPC`, which runs `select_action` as a batch of one."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.device import UnsupportedPathError, resolve, strict_float32
from gpmpc_tpu_torch.models import quadrotor
from gpmpc_tpu_torch.ops.sqp import OcpBounds, OcpCost, SqpConfig, sqp_solve

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


def make_consts(
    model, traj, q_mpc, r_mpc, horizon: int, device=None, bounds=None, u_eq=None
) -> MpcConsts:
    """The MPC constants. Defaults keep the reference's quadrotor contract (the
    quadrotor's boxes); other families pass `bounds=((lx, ux), (lu, uu))`. The
    input reference is `u_eq`, else the model's own trim, else zero."""
    device = resolve(device)
    if len(q_mpc) != model.nx or len(r_mpc) != model.nu:
        raise ValueError(f"q_mpc/r_mpc need {model.nx}/{model.nu} entries, got {len(q_mpc)}/{len(r_mpc)}")
    if bounds is None:
        (lx, ux), (lu, uu) = quadrotor.state_bounds(), quadrotor.input_bounds()
    else:
        (lx, ux), (lu, uu) = bounds
    if u_eq is None:
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


def default_u_eq(nu: int, device=None) -> torch.Tensor:
    """The reference's warm-start input when none is given: the quadrotor's
    hover trim for nu = 4, zeros otherwise (the first step replaces it with
    the consts' input reference)."""
    device = resolve(device)
    if nu == quadrotor.NU:
        return torch.as_tensor(quadrotor.U_EQ, device=device)
    return torch.zeros(nu, dtype=F32, device=device)


def init_state(
    batch: int, horizon: int, nx: int = 12, nu: int = 4, device=None, u_eq=None
) -> MpcState:
    """B fresh controller states: step 0, zero state guess, `u_eq` (default
    `default_u_eq(nu)`) as the input guess."""
    device = resolve(device)
    u_eq = default_u_eq(nu, device) if u_eq is None else torch.as_tensor(u_eq, dtype=F32, device=device)
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


def state_bound_violation(X: torch.Tensor, bounds: OcpBounds) -> torch.Tensor:
    """(B,) largest excess of X over its box on stages 1..T (stage 0 is the
    pinned observation): 0 under hard bounds, the soft-bound telemetry
    `MpcInfo.soft_viol` under soft ones."""
    lo = torch.amax(bounds.lx[:, 1:] - X[:, 1:], dim=(1, 2))
    hi = torch.amax(X[:, 1:] - bounds.ux[:, 1:], dim=(1, 2))
    return torch.clamp_min(torch.maximum(lo, hi), 0.0)


def select_action(
    model,
    cfg: SqpConfig,
    consts: MpcConsts,
    states: MpcState,
    obs: torch.Tensor,  # (B, nx)
    bounds_override: OcpBounds | None = None,
) -> tuple[torch.Tensor, MpcState, MpcInfo]:
    """One nominal MPC step for B scenarios: (u (B, nu), next states, info).
    A scenario's first solve starts from its observation repeated over the
    horizon and the input reference; later ones from its previous solution.
    The boxes are the consts' on every stage unless `bounds_override` (leaves
    (B, ...)) is given."""
    with strict_float32():
        T = consts.uref.shape[0]
        B = obs.shape[0]
        xref = reference_window(consts.traj, states.traj_step, T)
        first = (states.traj_step == 0)[:, None, None]
        X_init = torch.where(first, obs[:, None, :].expand(-1, T + 1, -1), states.X_warm)
        U_init = torch.where(first, consts.uref[None], states.U_warm)
        if bounds_override is None:
            bounds = OcpBounds(
                lx=consts.lx.expand(B, T + 1, -1), ux=consts.ux.expand(B, T + 1, -1),
                lu=consts.lu.expand(B, T, -1), uu=consts.uu.expand(B, T, -1),
            )
        else:
            bounds = bounds_override
        cost = OcpCost(xref=xref, uref=consts.uref, Q=consts.Q, R=consts.R, Qe=consts.Q,
                       scale=consts.scale)
        sol = sqp_solve(model.fd_func, cost, bounds, obs, X_init, U_init, cfg)
        new_states = MpcState(traj_step=states.traj_step + 1, X_warm=sol.X, U_warm=sol.U)
        info = MpcInfo(
            X=sol.X, U=sol.U, step_norm=sol.step_norm, qp_gap=sol.qp_gap, n_iters=sol.n_iters,
            clamp_frac=torch.zeros(B, dtype=F32, device=obs.device),
            soft_viol=state_bound_violation(sol.X, bounds),
            eq_res=sol.eq_res, stat_res=sol.stat_res, converged=sol.converged,
        )
        return sol.U[:, 0], new_states, info


class MPC:
    """The reference's stateful nominal controller: its parameters in its
    order and with its defaults, then `device` (None resolves to the card).
    `select_action(obs)` solves one observation as a batch of one and raises
    RuntimeError on a non-finite action (the reference's failed-solver
    status); `reset` and `reference_trajectory` as in the reference.
    `parallel_scan=True` is not ported and raises."""

    U_EQ = np.array([0.3234, 0.0, 0.0, 0.0])

    def __init__(
        self,
        symbolic_model,
        traj,
        q_mpc,
        r_mpc,
        output_dir=None,
        horizon: int = 5,
        sqp_iters: int = 25,
        qp_iters: int = 15,
        parallel_scan: bool = False,
        bounds: tuple | None = None,
        lm_reg: float = 0.0,
        device: torch.device | str | None = None,
    ):
        if parallel_scan:
            raise UnsupportedPathError(
                "MPC(parallel_scan=True) needs ops/riccati_parallel.py, which is not ported "
                "(ROADMAP.md Queue 1 item 13)")
        self.model = symbolic_model
        self.T = horizon
        self.device = device = resolve(device)
        traj = torch.as_tensor(np.array(traj, np.float32))
        if traj.shape[0] < traj.shape[1]:  # (nx, N) as the reference accepts it
            traj = traj.T
        self.traj = traj
        self.output_dir = output_dir
        self.consts = make_consts(symbolic_model, traj, q_mpc, r_mpc, horizon, device=device,
                                  bounds=bounds)
        self.cfg = SqpConfig(sqp_iters=sqp_iters, qp_iters=qp_iters, parallel_scan=parallel_scan,
                             lm_reg=lm_reg)
        self.reset()
        self._last_info = None

    def reset(self):
        """A fresh controller state (step 0, no warm start)."""
        self.state = init_state(1, self.T, self.model.nx, self.model.nu, device=self.device)

    def reference_trajectory(self) -> np.ndarray:
        """Reference window at the current step, (nx, T+1)."""
        window = reference_window(self.consts.traj, self.state.traj_step, self.T)
        return window[0].cpu().numpy().T

    def select_action(self, obs) -> np.ndarray:
        obs = torch.as_tensor(np.array(obs, np.float32), device=self.device).reshape(1, -1)
        u, self.state, info = select_action(self.model, self.cfg, self.consts, self.state, obs)
        self._last_info = MpcInfo(*[v[0] for v in info])
        u = u[0].cpu().numpy()
        if not np.all(np.isfinite(u)):
            raise RuntimeError(f"MPC solve produced non-finite action {u} "
                               f"(step_norm={float(self._last_info.step_norm)})")
        return u

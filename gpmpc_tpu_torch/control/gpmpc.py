"""GP-MPC: setup, the GP-augmented dynamics, step preparation (GP variances
and chance-constraint tightening) and the lanes step.

Port of the `lanes-fused` and `lanes` slices of `gpmpc_tpu/control/gpmpc.py`:
`GpModel`, `GpMpcConsts`, the setup half of `GPMPC.__init__`, `gp_residual`,
`augmented_fd`, `gp_variances`, both branches of `batched_variances` (the
kernel for a shared GP, per-scenario quadratic forms for a population),
`_gp_disturbance_batch` (which is also the reference's per-scenario
`disturbance_diagonals`, batched), `_bounds_from_tightening`,
`batched_prepare_step` and the three branches of
`batched_select_action_lanes` (fused kernel linearization; jacfwd or analytic
Jacobians; a per-scenario GP population), with hard or L1-soft state bounds.
GP training, the vmapped `select_action` of the `xla` path and the stateful
controller API are not ported yet (ROADMAP.md Queue 1). All state carries a
leading scenario axis B; a GP population carries it on every GpModel leaf.
"""

from __future__ import annotations

import statistics
import warnings
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.control import mpc as mpc_mod
from gpmpc_tpu_torch.control.mpc import MpcConsts, MpcInfo, MpcState
from gpmpc_tpu_torch.device import resolve, strict_float32
from gpmpc_tpu_torch.models import quadrotor
from gpmpc_tpu_torch.models.jacobians import make_augmented_fd_jac
from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC, ResidualSpec
from gpmpc_tpu_torch.ops.cuda_gp import gp_mean_var, se_kernel
from gpmpc_tpu_torch.ops.cuda_tighten import tighten_lanes
from gpmpc_tpu_torch.ops.linalg import discretize_linear_system, lqr_gain_discrete
from gpmpc_tpu_torch.ops.sqp import OcpBounds, OcpCost, SqpConfig
from gpmpc_tpu_torch.ops.sqp_lanes import (
    LANES,
    MAX_FUSED_HORIZON,
    LanesLinearizer,
    jacfwd_linearize,
    lanes_horizon_cap,
    sqp_solve_batch_lanes,
    sqp_solve_batch_lanes_fused,
)

F32 = torch.float32


class GPHypers(NamedTuple):
    """Raw (pre-softplus) hyperparameters, leaves shaped (G,) (lengthscale
    (G, D) for ARD)."""

    raw_lengthscale: torch.Tensor
    raw_outputscale: torch.Tensor
    raw_noise: torch.Tensor


class GpModel(NamedTuple):
    """Padded GP ensemble (see the reference's GpModel for each leaf)."""

    Z: torch.Tensor  # (G, M, D)
    y: torch.Tensor  # (G, M)
    mask: torch.Tensor  # (G, M)
    hypers: GPHypers
    Zs: torch.Tensor  # (G, Ms, D) mean inducing inputs
    alpha_s: torch.Tensor  # (G, Ms)
    var_Z: torch.Tensor  # (G, Mv, D) variance-form inputs
    var_mat: torch.Tensor  # (G, Mv, Mv) variance quadratic form
    var_mask: torch.Tensor  # (G, Mv)
    trained: torch.Tensor  # () bool


class GpMpcConsts(NamedTuple):
    mpc: MpcConsts
    Ad: torch.Tensor  # (nx, nx) exact discretization at equilibrium
    Bd_in: torch.Tensor  # (nx, nu)
    lqr_gain: torch.Tensor  # (nu, nx)
    Bd: torch.Tensor  # (nx, n_unc) uncertainty injection
    inverse_cdf: torch.Tensor  # ()
    dt: torch.Tensor  # ()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without torch's linear cutoff (matches jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def model_spec(model) -> ResidualSpec:
    return model.residual_spec if model.residual_spec is not None else QUADROTOR_SPEC


def slice_gp_inputs(xz: torch.Tensor, spec: ResidualSpec = QUADROTOR_SPEC) -> torch.Tensor:
    """(..., z_dim) GP inputs -> (G, ..., gp_input_dim) zero-padded per-GP slices."""
    pads = []
    for idx in spec.gp_idx:
        cols = [xz[..., i] for i in idx]
        while len(cols) < spec.gp_input_dim:
            cols.append(torch.zeros_like(xz[..., 0]))
        pads.append(torch.stack(cols, dim=-1))
    return torch.stack(pads, dim=0)


class UnsupportedPathError(NotImplementedError):
    """The configuration needs a path of the reference that is not ported."""


def gp_is_batched(gp: GpModel) -> bool:
    """True if every GpModel leaf carries a leading scenario axis (a GP
    population, one model per scenario)."""
    return gp.Zs.dim() == 4


def gp_residual(
    gp: GpModel, x: torch.Tensor, u: torch.Tensor, spec: ResidualSpec = QUADROTOR_SPEC
) -> torch.Tensor:
    """Residual dynamics term (..., nx): the GP posterior means injected into
    the model's uncertain rows through the spec's mean map. Built with
    `torch.stack`, not an indexed write, so that `torch.func.jvp` under
    `vmap` can differentiate it."""
    z = spec.gp_input(x, u)  # (..., z_dim)
    zs = slice_gp_inputs(z, spec)  # (G, ..., D)
    ell = softplus(gp.hypers.raw_lengthscale)
    sf2 = softplus(gp.hypers.raw_outputscale)
    preds = []
    for i in range(spec.num_gps):
        k = se_kernel(zs[i][..., None, :], gp.Zs[i], ell[i], sf2[i])[..., 0, :]  # (..., Ms)
        preds.append(torch.sum(k * gp.alpha_s[i], dim=-1))
    rows = spec.mean_rows(torch.stack(preds, dim=-1), z)  # (..., n_unc)
    zero = torch.zeros_like(x[..., 0])
    row_of = {d: j for j, d in enumerate(spec.uncertain_dim)}
    return torch.stack(
        [rows[..., row_of[d]] if d in row_of else zero for d in range(x.shape[-1])], dim=-1
    )


def augmented_fd(model, gp: GpModel, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RK4 discretization of prior + GP residual."""
    spec = model_spec(model)
    f = lambda x_, u_: model.fc_func(x_, u_) + gp_residual(gp, x_, u_, spec)  # noqa: E731
    return quadrotor.rk4(f, x, u, model.dt)


def gp_variances(gp: GpModel, z_slices: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Predictive variance (G, ...) at per-GP query slices (G, ..., D) through
    the var_mat quadratic form, in float32. The reference's `bf16` mode (the
    quadratic form's product in bfloat16) is not ported."""
    if bf16:
        raise UnsupportedPathError("gp_variances(bf16=True) is not ported (ROADMAP.md Queue 1)")
    G, D = z_slices.shape[0], z_slices.shape[-1]
    batch_shape = z_slices.shape[1:-1]
    z_flat = z_slices.reshape(G, -1, D)
    ell = softplus(gp.hypers.raw_lengthscale)
    sf2 = softplus(gp.hypers.raw_outputscale)
    covs = []
    for i in range(G):
        k = se_kernel(z_flat[i], gp.var_Z[i], ell[i], sf2[i]) * gp.var_mask[i][None, :]  # (N, Mv)
        covs.append(torch.clamp_min(sf2[i] - torch.sum((k @ gp.var_mat[i]) * k, dim=-1), 1e-12))
    return torch.stack(covs, dim=0).reshape((G,) + tuple(batch_shape))


def batched_variances(gp: GpModel, z_slices: torch.Tensor) -> torch.Tensor:
    """Tightening variances (G, B, T) for z_slices (G, B, T, D). Shared GP:
    one `gp_mean_var` launch per GP over all B*T queries, with the variance
    form padded to a multiple of 128 (padded entries are masked out). GP
    population: each scenario's own quadratic form in plain torch, as in the
    reference (there is no shared Gram to stage once)."""
    if gp_is_batched(gp):
        per_scenario = torch.func.vmap(gp_variances)(gp, z_slices.movedim(1, 0))  # (B, G, T)
        return per_scenario.movedim(0, 1)
    G, B, T, D = z_slices.shape
    Mv = gp.var_Z.shape[1]
    pad = (-Mv) % 128
    var_Z = torch.nn.functional.pad(gp.var_Z, (0, 0, 0, pad))
    var_mat = torch.nn.functional.pad(gp.var_mat, (0, pad, 0, pad))
    var_mask = torch.nn.functional.pad(gp.var_mask, (0, pad))
    alpha = torch.nn.functional.pad(gp.alpha_s, (0, pad))
    ell = softplus(gp.hypers.raw_lengthscale)
    sf2 = softplus(gp.hypers.raw_outputscale)
    noise = softplus(gp.hypers.raw_noise) + 1e-6
    covs = []
    for i in range(G):
        _, var = gp_mean_var(
            z_slices[i].reshape(B * T, D), var_Z[i], alpha[i], var_mat[i],
            ell[i], sf2[i], noise[i], var_mask[i], include_noise=False,
        )
        covs.append(var.reshape(B, T))
    return torch.stack(covs, dim=0)


def _gp_disturbance_batch(
    consts: GpMpcConsts,
    gp: GpModel,
    zq: torch.Tensor,  # (B, T, z_dim)
    covs: torch.Tensor,  # (G, B, T)
    spec: ResidualSpec = QUADROTOR_SPEC,
) -> torch.Tensor:
    """(B, T, n_unc) disturbance-covariance diagonals: the GP variances and
    observation noise mapped onto the uncertain rows, times dt^2 (the
    reference's per-scenario `disturbance_diagonals`, batched; a population
    brings each scenario's own noise)."""
    noise = softplus(gp.hypers.raw_noise) + 1e-6  # (G,), (B, G) for a population
    if gp_is_batched(gp):
        noise = noise[:, None, None, :]
    F = spec.var_factors(zq)  # (B, T, n_unc, G)
    cov_d = torch.sum(F * covs.permute(1, 2, 0)[:, :, None, :], dim=-1)
    cov_n = torch.sum(F * noise, dim=-1)
    return (cov_d + cov_n) * consts.dt**2


def _bounds_from_tightening(
    consts: GpMpcConsts,
    gp: GpModel,
    states: MpcState,
    obs: torch.Tensor,  # (B, nx)
    t_x: torch.Tensor,  # (B, T+1, nx)
    t_u: torch.Tensor,  # (B, T, nu)
    soft: bool = False,
):
    """Gate and clamp the tightening, build the tightened boxes, the
    reference windows and the warm starts. (xref, bounds, X_init, U_init,
    clamp_frac (B,)). With `soft` state bounds the state tightening is kept in
    full (even crossed boxes are well-posed for the L1-penalized QP, and the
    degradation shows in MpcInfo.soft_viol); input bounds are actuator limits
    and are always clamped."""
    c = consts.mpc
    T = c.uref.shape[0]
    # no previous rollout, or an untrained GP -> no tightening (gp.trained is
    # () for a shared GP and (B,) for a population)
    use = ((states.traj_step > 0) & gp.trained)[:, None, None]
    t_x = torch.where(use, t_x, torch.zeros_like(t_x))
    t_u = torch.where(use, t_u, torch.zeros_like(t_u))
    # never consume more than 45% of a box from each side; count every clamp
    cap_x = 0.45 * (c.ux - c.lx)
    cap_u = 0.45 * (c.uu - c.lu)
    n_clamped = (t_u > cap_u).sum(dim=(1, 2))
    if not soft:
        n_clamped = n_clamped + (t_x > cap_x).sum(dim=(1, 2))
        t_x = torch.minimum(t_x, cap_x)
    clamp_frac = n_clamped.to(F32) / float(t_x[0].numel() + t_u[0].numel())
    t_u = torch.minimum(t_u, cap_u)
    bounds = OcpBounds(lx=c.lx + t_x, ux=c.ux - t_x, lu=c.lu + t_u, uu=c.uu - t_u)

    xref = mpc_mod.reference_window(c.traj, states.traj_step, T)
    first = (states.traj_step == 0)[:, None, None]
    X_init = torch.where(first, obs[:, None, :].expand(-1, T + 1, -1), states.X_warm)
    U_init = torch.where(first, c.uref[None], states.U_warm)
    return xref, bounds, X_init, U_init, clamp_frac


def batched_prepare_step(
    model, consts: GpMpcConsts, gp: GpModel, states: MpcState, obs: torch.Tensor,
    soft: bool = False,
):
    """GP variances along the previous solutions (kernel 1), disturbance
    diagonals, the covariance recursion (kernel 2), then the tightened boxes
    and warm starts for all B scenarios."""
    spec = model_spec(model)
    zq = spec.gp_input(states.X_warm[:, :-1], states.U_warm)  # (B, T, z)
    covs = batched_variances(gp, slice_gp_inputs(zq, spec))
    cov_dn = _gp_disturbance_batch(consts, gp, zq, covs, spec)
    t_x, t_u = tighten_lanes(
        cov_dn.contiguous(), consts.Ad, consts.Bd_in, consts.lqr_gain, consts.Bd,
        consts.inverse_cdf,
    )
    return _bounds_from_tightening(consts, gp, states, obs, t_x, t_u, soft=soft)


def state_bound_violation(X: torch.Tensor, bounds: OcpBounds) -> torch.Tensor:
    """(B,) largest excess of X over its box on stages 1..T (0 under hard bounds)."""
    lo = torch.amax(bounds.lx[:, 1:] - X[:, 1:], dim=(1, 2))
    hi = torch.amax(X[:, 1:] - bounds.ux[:, 1:], dim=(1, 2))
    return torch.clamp_min(torch.maximum(lo, hi), 0.0)


def batched_select_action_lanes(
    model,
    cfg: SqpConfig,
    consts: GpMpcConsts,
    gp: GpModel,
    states: MpcState,
    obs: torch.Tensor,  # (B, nx)
    lanes: int = LANES,
) -> tuple[torch.Tensor, MpcState, MpcInfo]:
    """One GP-MPC step for B scenarios with the lanes QP kernels: (u (B, nu),
    next states, info). The fused path (kernel linearization, X and U kept in
    lanes layout) serves a shared GP on a family with a kernel linearizer up to
    `MAX_FUSED_HORIZON`; otherwise the dynamics are linearized in plain torch
    (forward-mode `torch.func`, or the quadrotor's analytic Jacobians under
    `cfg.analytic_jac`) and only the QP rides the kernels. `gp` may be a
    population (a leading scenario axis on every leaf): each scenario is then
    linearized against its own GP."""
    with strict_float32():
        return _select_action_lanes(model, cfg, consts, gp, states, obs, lanes)


def _select_action_lanes(model, cfg, consts, gp, states, obs, lanes):
    spec = model_spec(model)
    gp_batched = gp_is_batched(gp)
    T = consts.mpc.uref.shape[0]
    # Soft state bounds live in all three QP kernels up to the soft cap; past
    # it, hard bounds with the feasibility clamp, and a warning.
    if cfg.soft_x_penalty is not None and T > lanes_horizon_cap(cfg):
        warnings.warn(
            f"soft_constraints requested but T={T} exceeds the lanes soft horizon cap "
            f"({lanes_horizon_cap(cfg)}); falling back to hard bounds with the 45% "
            "feasibility clamp for this controller",
            stacklevel=3,
        )
        cfg = cfg._replace(soft_x_penalty=None)
    xref, bounds, X_init, U_init, clamp_frac = batched_prepare_step(
        model, consts, gp, states, obs, soft=cfg.soft_x_penalty is not None
    )
    if cfg.warm_shift:
        X_init = torch.cat([X_init[:, 1:], X_init[:, -1:]], dim=1)
        U_init = torch.cat([U_init[:, 1:], U_init[:, -1:]], dim=1)
    c = consts.mpc
    cost = OcpCost(xref=xref, uref=c.uref, Q=c.Q, R=c.R, Qe=c.Q, scale=c.scale)

    if (cfg.kernel_linearize and spec.supports_kernel_linearize and not gp_batched
            and T <= MAX_FUSED_HORIZON):
        ell = softplus(gp.hypers.raw_lengthscale)
        sf2 = softplus(gp.hypers.raw_outputscale)
        G, _, D = gp.Zs.shape
        inv_ell2 = (1.0 / (ell * ell)).reshape(G, -1).expand(G, D)
        lin = LanesLinearizer(
            params8=spec.kernel_params(model.params).to(obs.device),
            hyp=torch.cat([sf2[:, None], inv_ell2], dim=1).contiguous(),
            Zs=gp.Zs, alpha=gp.alpha_s, use_gp=True, family=spec.name,
        )
        sol = sqp_solve_batch_lanes_fused(
            lin, model.dt, cost, bounds, obs, X_init, U_init, cfg, lanes=lanes
        )
    elif gp_batched:
        def linearize(X, U):  # X (B, T, nx), U (B, T, nu): each scenario against its own GP
            return torch.func.vmap(
                lambda g, Xb, Ub: jacfwd_linearize(partial(augmented_fd, model, g), Xb, Ub)
            )(gp, X, U)

        sol = sqp_solve_batch_lanes(
            None, cost, bounds, obs, X_init, U_init, cfg, linearize_fn=linearize, lanes=lanes
        )
    else:
        fd_jac3 = None
        if cfg.analytic_jac and spec.name == "quadrotor":
            # closed forms exist for the quadrotor; other families use jacfwd
            fd_jac3 = make_augmented_fd_jac(model, gp)
        sol = sqp_solve_batch_lanes(
            partial(augmented_fd, model, gp), cost, bounds, obs, X_init, U_init, cfg,
            fd_jac3=fd_jac3, lanes=lanes,
        )
    new_states = MpcState(traj_step=states.traj_step + 1, X_warm=sol.X, U_warm=sol.U)
    info = MpcInfo(
        X=sol.X, U=sol.U, step_norm=sol.step_norm, qp_gap=sol.qp_gap,
        n_iters=sol.n_iters, clamp_frac=clamp_frac,
        soft_viol=state_bound_violation(sol.X, bounds),
        eq_res=sol.eq_res, stat_res=sol.stat_res, converged=sol.converged,
    )
    return sol.U[:, 0], new_states, info


class GPMPC:
    """Controller setup (the setup half of the reference's `GPMPC.__init__`):
    `consts` (GpMpcConsts on `device`) and `cfg` (SqpConfig). `bounds`
    (((lx, ux), (lu, uu)), default the quadrotor's boxes) and `lm_reg` are the
    reference's, as is `soft_constraints`: the L1 penalty weight that makes
    the chance-tightened state bounds soft (None keeps them hard). The
    stateful select_action / train_gp API is not ported yet."""

    def __init__(
        self,
        model,
        traj,
        prior_params: dict,
        horizon: int,
        q_mpc,
        r_mpc,
        prob: float = 0.955,
        sqp_iters: int = 25,
        qp_iters: int = 15,
        device: torch.device | str | None = None,
        bounds: tuple | None = None,
        lm_reg: float = 0.0,
        soft_constraints: float | None = None,
    ):
        device = resolve(device)
        self.spec = model_spec(model)
        # only the quadrotor's thrust map consumes the prior's a and b
        if self.spec.name == "quadrotor" and (
            prior_params is None or any(k not in prior_params for k in ("a", "b"))
        ):
            raise ValueError("GPMPC requires prior_params to be defined and contain 'a' and 'b'.")
        self.model = model
        self.T = horizon
        nx, nu = model.nx, model.nu
        traj = torch.as_tensor(np.array(traj, np.float32))
        if traj.shape[0] < traj.shape[1]:
            traj = traj.T

        inverse_cdf = float(statistics.NormalDist().inv_cdf(1 - (1 / nx - (prob + 1) / (2 * nx))))
        x_eq = np.zeros(nx, np.float32) if model.x_eq is None else np.asarray(model.x_eq, np.float32)
        u_eq = np.zeros(nu, np.float32) if model.u_eq is None else np.asarray(model.u_eq, np.float32)
        dfdx, dfdu = model.df_func(x_eq, u_eq)
        Ad, Bd_in = discretize_linear_system(dfdx, dfdu, model.dt, exact=True)
        Q = np.diag(np.asarray(q_mpc, np.float64))
        R = np.diag(np.asarray(r_mpc, np.float64))
        lqr_K, _ = lqr_gain_discrete(Ad, Bd_in, Q, R)
        Bd_mat = np.eye(nx)[:, list(self.spec.uncertain_dim)]
        t = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"), device=device)  # noqa: E731
        self.consts = GpMpcConsts(
            mpc=mpc_mod.make_consts(model, traj, q_mpc, r_mpc, horizon, device=device, bounds=bounds),
            Ad=t(Ad), Bd_in=t(Bd_in), lqr_gain=t(lqr_K), Bd=t(Bd_mat),
            inverse_cdf=t(inverse_cdf), dt=t(model.dt),
        )
        self.cfg = SqpConfig(
            sqp_iters=sqp_iters, qp_iters=qp_iters, soft_x_penalty=soft_constraints, lm_reg=lm_reg
        )

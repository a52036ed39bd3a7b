"""GP-MPC: setup, GP training, the GP-augmented dynamics, step preparation
(GP variances and chance-constraint tightening), the two steps (`lanes` and
`xla`) and the stateful controller.

Port of `gpmpc_tpu/control/gpmpc.py`: `GpModel`, `GpMpcConsts`,
`empty_gp_model`, the training data's packing (`pack_training_data`,
`pack_training_buffers`, `preprocess_data_jnp`, named as in the reference so
a reader finds the counterpart), `train_gp_models` (sparse FITC or exact, ARD
or isotropic, batched over any leading axes), `gp_residual`, `augmented_fd`,
`gp_variances` (float32 or the reference's bf16 mode), `batched_variances`
with the reference's backends (the kernel or the plain quadratic form for a
shared GP, per-scenario quadratic forms for a population),
`disturbance_diagonals`, `_bounds_from_tightening`; the `lanes` step
(`batched_prepare_step`: the GP kernel or the plain variances, the
tightening kernel or the plain recursion; the three branches of
`batched_select_action_lanes`: fused kernel linearization, jacfwd or
analytic Jacobians, a per-scenario GP population); the `xla` step, the
reference's vmapped `select_action` (`propagate_constraint_limits` through
the plain `gp_variances`, `tightening_from_variances` and its covariance
recursion `_tightening_scan`, `prepare_step`, `select_action` on the
nominal solver stack `ops/sqp.py::sqp_solve`), which launches no kernel;
both with hard or L1-soft state bounds; and the stateful `GPMPC` with its
nominal `prior_ctrl`. All state carries a leading scenario axis B; a GP
population carries it on every GpModel leaf.
"""

from __future__ import annotations

import statistics
import warnings
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.control import mpc as mpc_mod
from gpmpc_tpu_torch.control.mpc import MPC, MpcConsts, MpcInfo, MpcState, state_bound_violation
from gpmpc_tpu_torch.device import UnsupportedPathError, device_constant, resolve, strict_float32
from gpmpc_tpu_torch.gp.exact_gp import (
    GPData,
    GPHypers,
    _cho_solve,
    fit_gp,
    init_hypers,
    posterior,
    softplus,
)
from gpmpc_tpu_torch.gp.kernels import se_kernel
from gpmpc_tpu_torch.gp.sparse import fitc_posterior, select_inducing
from gpmpc_tpu_torch.models import quadrotor
from gpmpc_tpu_torch.models.jacobians import make_augmented_fd_jac
from gpmpc_tpu_torch.models.quadrotor import GRAVITY
from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC, ResidualSpec
from gpmpc_tpu_torch.ops.cuda_gp import GpForm, gp_mean_var_multi, pack_form
from gpmpc_tpu_torch.ops.cuda_tighten import tighten_lanes
from gpmpc_tpu_torch.ops.linalg import discretize_linear_system, lqr_gain_discrete
from gpmpc_tpu_torch.ops.sqp import OcpBounds, OcpCost, SqpConfig, sqp_solve
from gpmpc_tpu_torch.ops.sqp_lanes import (
    LANES,
    MAX_FUSED_HORIZON,
    LanesLinearizer,
    jacfwd_linearize,
    lanes_horizon_cap,
    lanes_serves,
    sqp_solve_batch_lanes,
    sqp_solve_batch_lanes_fused,
)

F32 = torch.float32


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


def gp_is_batched(gp: GpModel) -> bool:
    """True if every GpModel leaf carries a leading scenario axis (a GP
    population, one model per scenario)."""
    return gp.Zs.dim() == 4


def empty_gp_model(
    max_points: int,
    max_inducing: int,
    dtype=torch.float32,
    ard: bool = False,
    spec: ResidualSpec = QUADROTOR_SPEC,
    device=None,
) -> GpModel:
    """An untrained ensemble: zero data, zero mean weights (the residual
    vanishes, so the controller is the prior's) and `trained` False (no
    tightening). `max_inducing` sizes both the mean inducing set and the
    variance form (max_inducing == max_points for the exact mode). The
    lengthscale leaf has the shape training gives it, (G, D) for ARD."""
    device = resolve(device)
    M, Ms = max_points, max_inducing
    G, D = spec.num_gps, spec.gp_input_dim
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    return GpModel(
        Z=z(G, M, D), y=z(G, M), mask=z(G, M),
        hypers=GPHypers(z(G, D) if ard else z(G), z(G), z(G)),
        Zs=z(G, Ms, D), alpha_s=z(G, Ms), var_Z=z(G, Ms, D), var_mat=z(G, Ms, Ms),
        var_mask=z(G, Ms), trained=torch.tensor(False, device=device),
    )


def gp_input_from_xu(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(x, u) -> the quadrotor's 7-dim GP input [T, phi, dphi, phi_cmd,
    theta, dtheta, theta_cmd]; other families use `model_spec(model).gp_input`."""
    return QUADROTOR_SPEC.gp_input(x, u)


def pack_training_data(
    xz: torch.Tensor, yg: torch.Tensor, max_points: int, spec: ResidualSpec = QUADROTOR_SPEC
) -> GPData:
    """(N, z_dim) inputs and (N, G) targets -> padded per-GP GPData (leaves
    lead with the GP axis), every one of the N rows active."""
    n = xz.shape[0]
    pad = max_points - n
    z = slice_gp_inputs(xz, spec)  # (G, N, D)
    return GPData(
        x=torch.nn.functional.pad(z, (0, 0, 0, pad)),
        y=torch.nn.functional.pad(yg.T, (0, pad)),
        mask=torch.nn.functional.pad(
            torch.ones(spec.num_gps, n, dtype=xz.dtype, device=xz.device), (0, pad)),
    )


def pack_training_buffers(
    bufx: torch.Tensor, bufy: torch.Tensor, count, spec: ResidualSpec = QUADROTOR_SPEC
) -> GPData:
    """Padded (..., cap, z_dim) and (..., cap, G) buffers and the count of
    active rows (an int, or a tensor of the leading shape) -> masked GPData
    with leaves (..., G, cap, ...): rows >= count stay in the buffers but
    are masked out, so a growing dataset never changes shapes."""
    cap = bufx.shape[-2]
    count = torch.as_tensor(count, device=bufx.device)
    mask = (torch.arange(cap, device=bufx.device) < count[..., None]).to(bufx.dtype)
    mask = mask.expand(bufx.shape[:-2] + (cap,))
    z = slice_gp_inputs(bufx, spec).movedim(0, -3)  # (..., G, cap, D)
    return GPData(x=z, y=bufy.transpose(-1, -2),
                  mask=mask[..., None, :].expand(bufx.shape[:-2] + (spec.num_gps, cap)))


def train_gp_models(
    data: GPData,  # leaves (..., G, M, ...)
    generator: torch.Generator,
    sparse: bool,
    max_inducing: int,
    n_train: int,
    lr: float,
    ard: bool = False,
    return_info: bool = False,
):
    """Fit the hyperparameters, factorize the posteriors and build the
    mean-inducing set and the variance form: a new GpModel, every leaf a new
    tensor (nothing of an earlier model is written). Batched over the data's
    leading axes: G GPs, or S seeds x G GPs in one fit (a GpModel whose
    leaves lead with S). Sparse: one uniform inducing draw of up to
    `max_inducing` active rows per leading entry (shared by its G GPs) from
    `generator`, and the FITC mean and variance form; exact: the whole
    training set, alpha = K^-1 y and W = K^-1. With `return_info`,
    (GpModel, the fit's FitInfo)."""
    with strict_float32():
        batch = tuple(data.y.shape[:-1])  # (..., G)
        D = data.x.shape[-1]
        h0 = init_hypers(data.x.dtype, D if ard else None, data.x.device, batch)
        hypers, _, info = fit_gp(data, hypers=h0, n_train=n_train, lr=lr, return_info=True)
        if sparse:
            idx, s_mask = select_inducing(generator, data.mask[..., 0, :], max_inducing)
            Zs, alpha_s, W = fitc_posterior(hypers, data, idx[..., None, :], s_mask[..., None, :])
            var_Z, var_mask = Zs, s_mask[..., None, :].expand(batch + (max_inducing,))
        else:
            post = posterior(hypers, data)
            M = data.x.shape[-2]
            eye = torch.eye(M, dtype=data.x.dtype, device=data.x.device)
            with torch.no_grad():
                W = _cho_solve(post.chol, eye.expand(batch + (M, M)))
            Zs, alpha_s = data.x, post.alpha
            var_Z, var_mask = data.x, data.mask
    c = lambda t: t.detach().clone().contiguous()  # noqa: E731
    model = GpModel(
        Z=c(data.x), y=c(data.y), mask=c(data.mask), hypers=GPHypers(*[c(h) for h in hypers]),
        Zs=c(Zs), alpha_s=c(alpha_s), var_Z=c(var_Z), var_mat=c(W), var_mask=c(var_mask),
        trained=torch.ones(batch[:-1], dtype=torch.bool, device=data.x.device),
    )
    return (model, info) if return_info else model


def preprocess_data_jnp(model, acc_a: float, acc_b: float, x: torch.Tensor, u: torch.Tensor,
                        x_next: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The quadrotor's transition preprocessing, (N, 7) GP inputs and (N, 3)
    targets: finite-difference state derivatives minus the prior's, the
    thrust-magnitude residual |v_dot + g e_z| - (a T + b) for the
    acceleration GP and the phi and theta rate residuals; dt is the model's.
    Named as in the reference (whose version is its jnp one)."""
    thrust_cmd = u[:, 0]
    x_dot = (x_next - x) / model.dt
    acc = torch.sqrt(x_dot[:, 1] ** 2 + x_dot[:, 3] ** 2 + (x_dot[:, 5] + GRAVITY) ** 2)
    acc_target = acc - (acc_a * thrust_cmd + acc_b)
    f_prior = model.fc_func(x, u)
    phi_target = x_dot[:, 6] - f_prior[:, 6]
    theta_target = x_dot[:, 7] - f_prior[:, 7]
    train_input = torch.stack(
        [thrust_cmd, x[:, 6], x[:, 9], u[:, 1], x[:, 7], x[:, 10], u[:, 2]], dim=1)
    return train_input, torch.stack((acc_target, phi_target, theta_target), dim=1)


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
    the var_mat quadratic form, in float32. With `bf16`, the reference's fast
    mode: k and W are rounded to bfloat16 and multiplied with float32
    products and sums (the reference's `preferred_element_type=float32`).
    Each product of two bfloat16 values is exact in float32, so the operands
    are rounded, cast back and multiplied in float32 with TF32 off; a bfloat16
    matmul would round its output (and on the card may reduce) in bfloat16.
    The quadratic form's second factor is k in float32, as in the reference."""
    G, D = z_slices.shape[0], z_slices.shape[-1]
    batch_shape = z_slices.shape[1:-1]
    z_flat = z_slices.reshape(G, -1, D)
    ell = softplus(gp.hypers.raw_lengthscale)
    sf2 = softplus(gp.hypers.raw_outputscale)
    bf16_round = lambda t: t.to(torch.bfloat16).to(F32)  # noqa: E731
    covs = []
    with strict_float32():
        for i in range(G):
            k = se_kernel(z_flat[i], gp.var_Z[i], ell[i], sf2[i]) * gp.var_mask[i][None, :]  # (N, Mv)
            t = bf16_round(k) @ bf16_round(gp.var_mat[i]) if bf16 else k @ gp.var_mat[i]
            covs.append(torch.clamp_min(sf2[i] - torch.sum(t * k, dim=-1), 1e-12))
    return torch.stack(covs, dim=0).reshape((G,) + tuple(batch_shape))


# The packed variance forms of the last few shared GPs (`variance_form`):
# (the GpModel's leaves the form was built from, their versions, the form).
_FORMS: list = []
_FORMS_KEPT = 8


def variance_form(gp: GpModel) -> GpForm:
    """The shared GP's variance form packed for the GP kernel (live points
    only, softplus hyperparameters, the kernel's layout), built once per
    GpModel: a later call with the same leaf tensors, unmodified in place,
    returns the same form. A form is never reused for other leaves, or for
    leaves written in place since (their version counters differ). A tensor
    made under `torch.inference_mode` has no version counter and is matched
    by identity alone, so such a leaf must not be written in place."""
    leaves = (gp.var_Z, gp.alpha_s, gp.var_mat, gp.var_mask, *gp.hypers)
    versions = tuple(None if t.is_inference() else t._version for t in leaves)
    for i, (kept, kept_versions, form) in enumerate(_FORMS):
        if versions == kept_versions and all(a is b for a, b in zip(leaves, kept)):
            _FORMS.insert(0, _FORMS.pop(i))
            return form
    form = pack_form(
        gp.var_Z, gp.alpha_s, gp.var_mat, softplus(gp.hypers.raw_lengthscale),
        softplus(gp.hypers.raw_outputscale), softplus(gp.hypers.raw_noise) + 1e-6, gp.var_mask,
    )
    _FORMS.insert(0, (leaves, versions, form))
    del _FORMS[_FORMS_KEPT:]
    return form


def cached_forms() -> list:
    """Every variance form `variance_form` keeps now: a CUDA graph that read
    them holds them, so that none is freed under it."""
    return [form for _, _, form in _FORMS]


def _population_variances(gp: GpModel, z_slices: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """(G, B, T) variances of a GP population (every leaf leading with B) at
    z_slices (G, B, T, D): each scenario's own quadratic form."""
    return torch.func.vmap(partial(gp_variances, bf16=bf16))(
        gp, z_slices.movedim(1, 0)).movedim(0, 1)


VAR_BACKENDS = ("auto", "pallas", "xla")


def batched_variances(
    gp: GpModel, z_slices: torch.Tensor, backend: str = "auto", bf16: bool = False
) -> torch.Tensor:
    """Tightening variances (G, B, T) for z_slices (G, B, T, D), with the
    reference's backends. "pallas": one `gp_mean_var_multi` launch for all
    G GPs over all B*T queries, on the GpModel's packed variance form
    (`variance_form`; CPU tensors take the wrapper's plain version); "xla":
    the plain quadratic form `gp_variances`; "auto": "pallas" on the card
    (at any number of points: the tiled instantiation serves every M) and
    "xla" on the CPU. `bf16` acts on the plain form and on a GP population
    only, as in the reference, whose Pallas branch ignores it; there is no
    bf16 kernel. A GP population takes each scenario's own quadratic form
    in plain torch whatever the backend (there is no shared Gram to stage
    once)."""
    if backend not in VAR_BACKENDS:
        raise ValueError(f"var_backend must be one of {VAR_BACKENDS}, got {backend!r}")
    if gp_is_batched(gp):
        return _population_variances(gp, z_slices, bf16)
    if backend == "auto":
        backend = "pallas" if z_slices.device.type == "cuda" else "xla"
    if backend == "xla":
        return gp_variances(gp, z_slices, bf16=bf16)
    G, B, T, D = z_slices.shape
    _, var = gp_mean_var_multi(z_slices.reshape(G, B * T, D).contiguous(), variance_form(gp))
    return var.reshape(G, B, T)


def disturbance_diagonals(
    consts: GpMpcConsts,
    gp: GpModel,
    zq: torch.Tensor,  # (B, T, z_dim) GP inputs along the previous solutions
    covs: torch.Tensor,  # (G, B, T) predictive variances
    spec: ResidualSpec = QUADROTOR_SPEC,
) -> torch.Tensor:
    """(B, T, n_unc) disturbance-covariance diagonals: the GP variances and
    observation noise mapped onto the uncertain rows through the spec's
    factor map, times dt^2. Shared by both steps (a population brings each
    scenario's own noise)."""
    noise = softplus(gp.hypers.raw_noise) + 1e-6  # (G,), (B, G) for a population
    if gp_is_batched(gp):
        noise = noise[:, None, None, :]
    F = spec.var_factors(zq)  # (B, T, n_unc, G)
    cov_d = torch.sum(F * covs.permute(1, 2, 0)[:, :, None, :], dim=-1)
    cov_n = torch.sum(F * noise, dim=-1)
    return (cov_d + cov_n) * consts.dt**2


def tightening_from_variances(
    consts: GpMpcConsts,
    gp: GpModel,
    zq: torch.Tensor,  # (B, T, z_dim)
    covs: torch.Tensor,  # (G, B, T)
    spec: ResidualSpec = QUADROTOR_SPEC,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-stage tightenings (t_x (B, T+1, nx), t_u (B, T, nu)), both >= 0,
    from precomputed variances: the disturbance diagonals and the `xla`
    step's covariance recursion (`_tightening_scan`)."""
    cov_dn = disturbance_diagonals(consts, gp, zq, covs, spec)
    return _tightening_scan(consts, cov_dn, zq.dtype, consts.Ad.shape[0])


def _tightening_scan(consts: GpMpcConsts, cov_dn: torch.Tensor, dtype, nx: int):
    """The reference's covariance recursion over the horizon in float32,
    with its products in its order: cov_x under the LQR feedback K, t_x =
    ppf sqrt(diag cov_x) and t_u = ppf sqrt(diag K cov_x K'). This is not
    the tightening kernel's direct form (`ops/cuda_tighten.py`)."""
    K, A, Bi, Bd = consts.lqr_gain, consts.Ad, consts.Bd_in, consts.Bd
    Kt, At, Bt, Bdt = K.T, A.T, Bi.T, Bd.T
    ppf = consts.inverse_cdf
    B, T = cov_dn.shape[:2]
    sd = lambda c: ppf * torch.sqrt(torch.clamp_min(torch.diagonal(c, dim1=-2, dim2=-1), 0.0))  # noqa: E731
    cov_x = torch.zeros(B, nx, nx, dtype=dtype, device=cov_dn.device)
    t_x, t_u = [], []
    for k in range(T):
        cov_xu = cov_x @ Kt
        cov_u = K @ cov_x @ Kt
        t_x.append(sd(cov_x))
        t_u.append(sd(cov_u))
        cov_x = (A @ cov_x @ At + A @ cov_xu @ Bt + Bi @ cov_xu.transpose(-1, -2) @ At
                 + Bi @ cov_u @ Bt + Bd @ torch.diag_embed(cov_dn[:, k]) @ Bdt)
    t_x.append(sd(cov_x))
    return torch.stack(t_x, dim=1), torch.stack(t_u, dim=1)


def propagate_constraint_limits(
    consts: GpMpcConsts,
    gp: GpModel,
    x_prev: torch.Tensor,  # (B, T+1, nx) previous solutions
    u_prev: torch.Tensor,  # (B, T, nu)
    spec: ResidualSpec = QUADROTOR_SPEC,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-stage tightenings (t_x (B, T+1, nx), t_u (B, T, nu)) of the `xla`
    step: the plain `gp_variances` along the previous solutions (each
    scenario's own for a population), then `tightening_from_variances`. The
    magnitude ppf sqrt(diag cov) applies to both sides of each box."""
    zq = spec.gp_input(x_prev[:, :-1], u_prev)  # (B, T, z_dim)
    z = slice_gp_inputs(zq, spec)
    covs = _population_variances(gp, z) if gp_is_batched(gp) else gp_variances(gp, z)
    return tightening_from_variances(consts, gp, zq, covs, spec)


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


TIGHTEN_BACKENDS = ("auto", "pallas", "xla")


def batched_prepare_step(
    model, consts: GpMpcConsts, gp: GpModel, states: MpcState, obs: torch.Tensor,
    var_backend: str = "auto", var_bf16: bool = False, soft: bool = False,
    tighten_backend: str = "auto",
):
    """GP variances along the previous solutions (`batched_variances` with
    `var_backend` and `var_bf16`), disturbance diagonals, the covariance
    recursion, then the tightened boxes and warm starts for all B scenarios.
    `tighten_backend`: "pallas" and "auto" take the tightening kernel's
    wrapper (`ops/cuda_tighten.py::tighten_lanes`, its plain version on CPU
    tensors); "xla" the per-scenario recursion of the `xla` step
    (`tightening_from_variances`), each scenario's own noise for a GP
    population."""
    if tighten_backend not in TIGHTEN_BACKENDS:
        raise ValueError(f"tighten_backend must be one of {TIGHTEN_BACKENDS}, got "
                         f"{tighten_backend!r}")
    spec = model_spec(model)
    zq = spec.gp_input(states.X_warm[:, :-1], states.U_warm)  # (B, T, z)
    covs = batched_variances(gp, slice_gp_inputs(zq, spec), var_backend, var_bf16)
    if tighten_backend == "xla":
        t_x, t_u = tightening_from_variances(consts, gp, zq, covs, spec)
    else:
        cov_dn = disturbance_diagonals(consts, gp, zq, covs, spec)
        t_x, t_u = tighten_lanes(
            cov_dn.contiguous(), consts.Ad, consts.Bd_in, consts.lqr_gain, consts.Bd,
            consts.inverse_cdf,
        )
    return _bounds_from_tightening(consts, gp, states, obs, t_x, t_u, soft=soft)


def _population_linearize(model, gp: GpModel):
    """(X (B, T, nx), U (B, T, nu)) -> (fnext, A, B), each scenario
    linearized in forward mode against its own GP of the population."""
    def linearize(X, U):
        return torch.func.vmap(
            lambda g, Xb, Ub: jacfwd_linearize(partial(augmented_fd, model, g), Xb, Ub)
        )(gp, X, U)

    return linearize


def prepare_step(model, consts: GpMpcConsts, gp: GpModel, states: MpcState, obs: torch.Tensor,
                 soft: bool = False):
    """The `xla` step's preparation for B scenarios: tightenings by
    `propagate_constraint_limits`, then the tightened boxes, reference
    windows and warm starts. (xref, bounds, X_init, U_init, clamp_frac)."""
    t_x, t_u = propagate_constraint_limits(consts, gp, states.X_warm, states.U_warm,
                                           model_spec(model))
    return _bounds_from_tightening(consts, gp, states, obs, t_x, t_u, soft=soft)


def select_action(
    model,
    cfg: SqpConfig,
    consts: GpMpcConsts,
    gp: GpModel,
    states: MpcState,
    obs: torch.Tensor,  # (B, nx)
) -> tuple[torch.Tensor, MpcState, MpcInfo]:
    """One GP-MPC step for B scenarios on the `xla` path, the reference's
    `select_action` under `jax.vmap`: (u (B, nu), next states, info).
    `prepare_step`, the optional warm-start shift, then `sqp_solve` on the
    GP-augmented RK4 dynamics (each scenario against its own GP for a
    population), in full float32 (TF32 off, the reference's "highest"). The
    lanes options of cfg (qp_tol, kernel_linearize, analytic_jac) do not
    apply, and soft state bounds serve any horizon. No kernel launches."""
    with strict_float32():
        c = consts.mpc
        xref, bounds, X_init, U_init, clamp_frac = prepare_step(
            model, consts, gp, states, obs, soft=cfg.soft_x_penalty is not None
        )
        if cfg.warm_shift:
            X_init = torch.cat([X_init[:, 1:], X_init[:, -1:]], dim=1)
            U_init = torch.cat([U_init[:, 1:], U_init[:, -1:]], dim=1)
        cost = OcpCost(xref=xref, uref=c.uref, Q=c.Q, R=c.R, Qe=c.Q, scale=c.scale)
        if gp_is_batched(gp):
            sol = sqp_solve(None, cost, bounds, obs, X_init, U_init, cfg,
                            linearize_fn=_population_linearize(model, gp))
        else:
            sol = sqp_solve(partial(augmented_fd, model, gp), cost, bounds, obs, X_init, U_init,
                            cfg)
        new_states = MpcState(traj_step=states.traj_step + 1, X_warm=sol.X, U_warm=sol.U)
        info = MpcInfo(
            X=sol.X, U=sol.U, step_norm=sol.step_norm, qp_gap=sol.qp_gap,
            n_iters=sol.n_iters, clamp_frac=clamp_frac,
            soft_viol=state_bound_violation(sol.X, bounds),
            eq_res=sol.eq_res, stat_res=sol.stat_res, converged=sol.converged,
        )
        return sol.U[:, 0], new_states, info


def batched_select_action_lanes(
    model,
    cfg: SqpConfig,
    consts: GpMpcConsts,
    gp: GpModel,
    states: MpcState,
    obs: torch.Tensor,  # (B, nx)
    lanes: int = LANES,
    var_backend: str = "auto",
    var_bf16: bool = False,
    tighten_backend: str = "auto",
) -> tuple[torch.Tensor, MpcState, MpcInfo]:
    """One GP-MPC step for B scenarios with the lanes QP kernels: (u (B, nu),
    next states, info). The fused path (kernel linearization, X and U kept in
    lanes layout) serves a shared GP on a family with a kernel linearizer up to
    `MAX_FUSED_HORIZON`; otherwise the dynamics are linearized in plain torch
    (forward-mode `torch.func`, or the quadrotor's analytic Jacobians under
    `cfg.analytic_jac`) and only the QP rides the kernels. `gp` may be a
    population (a leading scenario axis on every leaf): each scenario is then
    linearized against its own GP. `var_backend`, `var_bf16` and
    `tighten_backend` go to `batched_prepare_step`; the reference takes
    `tighten_backend` there only, and "auto" is its choice on its
    accelerator, the kernel."""
    with strict_float32():
        return _select_action_lanes(model, cfg, consts, gp, states, obs, lanes, var_backend,
                                    var_bf16, tighten_backend)


def _kernel_params(spec: ResidualSpec, params, device) -> torch.Tensor:
    """The family's (8,) plant coefficients for the linearize kernel on `device`, formed once
    per (family, parameters, device) (`device_constant`): no host-to-device copy a step."""
    return device_constant(("kernel_params", spec.name, tuple(params)), device,
                           lambda device: spec.kernel_params(params).to(device))


def _select_action_lanes(model, cfg, consts, gp, states, obs, lanes, var_backend, var_bf16,
                         tighten_backend):
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
        model, consts, gp, states, obs, var_backend, var_bf16,
        soft=cfg.soft_x_penalty is not None, tighten_backend=tighten_backend,
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
            params8=_kernel_params(spec, model.params, obs.device),
            hyp=torch.cat([sf2[:, None], inv_ell2], dim=1).contiguous(),
            Zs=gp.Zs, alpha=gp.alpha_s, use_gp=True, family=spec.name,
        )
        sol = sqp_solve_batch_lanes_fused(
            lin, model.dt, cost, bounds, obs, X_init, U_init, cfg, lanes=lanes
        )
    elif gp_batched:
        sol = sqp_solve_batch_lanes(
            None, cost, bounds, obs, X_init, U_init, cfg,
            linearize_fn=_population_linearize(model, gp), lanes=lanes,
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
    """The reference's stateful controller: setup (`consts`, `cfg`, the
    empty `gp_model`), `preprocess_data`, `train_gp`, `reset`,
    `reference_trajectory`, `select_action` and the reference-surface
    properties. The parameter list is the reference's, in its order and
    with its defaults, except `device` (None resolves to the card). `bounds`
    (((lx, ux), (lu, uu)), default the quadrotor's boxes), `lm_reg` and
    `soft_constraints` (the L1 penalty weight that makes the chance-tightened
    state bounds soft; None keeps them hard) act as in the reference.

    `step_backend`: "lanes" runs each `select_action` as a B = 1 batch of
    `batched_select_action_lanes` (a ValueError past the lanes horizon cap);
    "xla" as a B = 1 batch of `select_action` (the reference's xla path);
    "auto" resolves as in the reference: "lanes" on the card where the lanes
    caps serve the horizon, else "xla". `prior_ctrl` is the nominal `MPC`
    built with the controller's arguments. `parallel_scan` takes the
    associative-scan Riccati on the `xla` path (the lanes QP kernels do not
    read it, as in the reference)."""

    U_EQ = np.array([0.3234, 0.0, 0.0, 0.0])

    def __init__(
        self,
        model,
        traj,
        prior_params: dict | None,
        horizon: int,
        q_mpc,
        r_mpc,
        sparse_gp: bool = False,
        prob: float = 0.955,
        max_gp_samples: int = 30,
        seed: int = 1337,
        device: torch.device | str | None = None,
        output_dir=None,
        max_gp_points: int = 128,
        sqp_iters: int = 25,
        qp_iters: int = 15,
        parallel_scan: bool = False,
        ard_gp: bool = False,
        soft_constraints: float | None = None,
        bounds: tuple | None = None,
        lm_reg: float = 0.0,
        step_backend: str = "auto",
    ):
        if step_backend not in ("auto", "lanes", "xla"):
            raise ValueError(f"step_backend must be 'auto', 'lanes' or 'xla', got {step_backend!r}")
        self.sparse, self.ard_gp, self.step_backend = sparse_gp, ard_gp, step_backend
        self.max_gp_samples, self.max_gp_points = max_gp_samples, max(max_gp_points, max_gp_samples)
        self.seed, self.output_dir = seed, output_dir
        self.device = device = resolve(device)
        self.spec = model_spec(model)
        # only the quadrotor's thrust map consumes the prior's a and b
        if self.spec.name == "quadrotor":
            if prior_params is None or any(k not in prior_params for k in ("a", "b")):
                raise ValueError("GPMPC requires prior_params to be defined and contain 'a' and 'b'.")
            self._acc_a, self._acc_b = float(prior_params["a"]), float(prior_params["b"])
        self.model = model
        self.dt = model.dt
        self.T = horizon
        self.np_random = np.random.default_rng(seed)
        # the inducing draws (JAX's PRNG key chain cannot be reproduced)
        self._gp_generator = torch.Generator(device=device).manual_seed(seed)
        nx, nu = model.nx, model.nu
        traj = torch.as_tensor(np.array(traj, np.float32))
        if traj.shape[0] < traj.shape[1]:
            traj = traj.T
        # the nominal prior controller
        self.prior_ctrl = MPC(
            model, traj, q_mpc=q_mpc, r_mpc=r_mpc, output_dir=output_dir, horizon=horizon,
            sqp_iters=sqp_iters, qp_iters=qp_iters, parallel_scan=parallel_scan, bounds=bounds,
            lm_reg=lm_reg, device=device,
        )
        self.traj = traj

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
            mpc=self.prior_ctrl.consts,
            Ad=t(Ad), Bd_in=t(Bd_in), lqr_gain=t(lqr_K), Bd=t(Bd_mat),
            inverse_cdf=t(inverse_cdf), dt=t(model.dt),
        )
        self.cfg = SqpConfig(
            sqp_iters=sqp_iters, qp_iters=qp_iters, parallel_scan=parallel_scan,
            soft_x_penalty=soft_constraints, lm_reg=lm_reg,
        )
        self.gp_model = empty_gp_model(
            self.max_gp_points, self.max_gp_samples if sparse_gp else self.max_gp_points,
            ard=ard_gp, spec=self.spec, device=device,
        )
        self.state = mpc_mod.init_state(1, horizon, nx, nu, device=device)
        self._requires_recompile = False  # the reference's API: nothing is ever recompiled here
        self._last_info = None
        self.last_fit_info = None

    def _resolve_step_backend(self) -> str:
        """The step backend this controller runs: "lanes" or "xla"."""
        backend = self.step_backend
        if backend == "auto":
            backend = ("lanes" if self.device.type == "cuda" and lanes_serves(self.cfg, self.T)
                       else "xla")
        elif backend == "lanes" and not lanes_serves(self.cfg, self.T):
            raise ValueError(
                f"step_backend='lanes' forced but horizon T={self.T} exceeds the lanes cap "
                f"({lanes_horizon_cap(self.cfg)}"
                f"{' with soft state bounds' if self.cfg.soft_x_penalty is not None else ''}); "
                "use step_backend='xla' or 'auto'"
            )
        return backend

    # -- the reference's attribute surface ------------------------------------

    @property
    def gaussian_process(self):
        """The trained GP ensemble (one padded GpModel), None before train_gp."""
        return self.gp_model if bool(self.gp_model.trained) else None

    @property
    def gp_idx(self):
        """Per-GP input-slice indices."""
        return [list(i) for i in self.spec.gp_idx]

    @property
    def traj_step(self) -> int:
        return int(self.state.traj_step[0])

    @property
    def x_prev(self):
        """Previous solution, (nx, T+1) as in the reference; None before the
        first solve."""
        if self.traj_step == 0:
            return None
        return self.state.X_warm[0].cpu().numpy().T

    @property
    def u_prev(self):
        if self.traj_step == 0:
            return None
        return self.state.U_warm[0].cpu().numpy().T

    @property
    def ref_action(self):
        """(nu, T) input reference."""
        return self.consts.mpc.uref.cpu().numpy().T

    @property
    def lqr_gain(self):
        return self.consts.lqr_gain.cpu().numpy()

    @property
    def inverse_cdf(self) -> float:
        return float(self.consts.inverse_cdf)

    # -- training data ---------------------------------------------------------

    def preprocess_data(self, x, u, x_next):
        """Rollout transitions -> GP inputs (N, z_dim) and residual targets
        (N, G) as numpy arrays, through the family's ResidualSpec; the
        quadrotor's thrust map comes from the `prior_params` given at
        construction. dt is the model's."""
        t = lambda a: torch.as_tensor(np.array(a, np.float32), device=self.device)  # noqa: E731
        x, u, x_next = t(x), t(u), t(x_next)
        if self.spec.name == "quadrotor":
            xi, ti = preprocess_data_jnp(self.model, self._acc_a, self._acc_b, x, u, x_next)
        else:
            xi, ti = self.spec.make_targets(self.model, x, u, x_next)
        return xi.cpu().numpy(), ti.cpu().numpy()

    def train_gp(self, x, y, lr: float, iterations: int):
        """Fit the G GPs to (N, z_dim) inputs and (N, G) targets on this
        controller's device: a new GpModel (never written into the old one,
        so a cached variance form of the old model is never reused). The
        fit's per-GP freeze steps stay in `last_fit_info`."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        n = x.shape[0]
        M = self.max_gp_points
        if n > M:
            raise ValueError(f"GP dataset ({n}) exceeds capacity ({M}); raise max_gp_points")
        G, D = self.spec.num_gps, self.spec.gp_input_dim
        Z = np.zeros((G, M, D), np.float32)
        Y = np.zeros((G, M), np.float32)
        mask = np.zeros((G, M), np.float32)
        for i, idx in enumerate(self.spec.gp_idx):
            Z[i, :n, : len(idx)] = x[:, list(idx)]
            Y[i, :n] = y[:, i]
            mask[i, :n] = 1.0
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.gp_model, self.last_fit_info = train_gp_models(
            GPData(x=t(Z), y=t(Y), mask=t(mask)), self._gp_generator, sparse=self.sparse,
            max_inducing=self.max_gp_samples if self.sparse else M, n_train=int(iterations),
            lr=float(lr), ard=self.ard_gp, return_info=True,
        )
        self._requires_recompile = False

    # -- control -----------------------------------------------------------------

    def reset(self):
        """A fresh controller state (step 0, no warm start)."""
        self.state = mpc_mod.init_state(1, self.T, self.model.nx, self.model.nu, device=self.device)

    def reference_trajectory(self) -> np.ndarray:
        """Reference window at the current step, (nx, T+1)."""
        window = mpc_mod.reference_window(self.consts.mpc.traj, self.state.traj_step, self.T)
        return window[0].cpu().numpy().T

    def select_action(self, obs) -> np.ndarray:
        """One GP-MPC step for one observation (nx,), as a B = 1 batch of
        `batched_select_action_lanes` (one lane tile) or of `select_action`;
        raises on a non-finite action."""
        backend = self._resolve_step_backend()
        obs = torch.as_tensor(np.array(obs, np.float32), device=self.device).reshape(1, -1)
        if backend == "lanes":
            u, self.state, info = batched_select_action_lanes(
                self.model, self.cfg, self.consts, self.gp_model, self.state, obs,
                lanes=LANES if self.device.type == "cuda" else 1,
            )
        else:
            u, self.state, info = select_action(
                self.model, self.cfg, self.consts, self.gp_model, self.state, obs)
        self._last_info = MpcInfo(*[v[0] if v.dim() > 0 else v for v in info])
        u = u[0].cpu().numpy()
        if not np.all(np.isfinite(u)):
            raise RuntimeError(
                f"GP-MPC solve produced non-finite action {u} "
                f"(step_norm={float(self._last_info.step_norm)})"
            )
        return u

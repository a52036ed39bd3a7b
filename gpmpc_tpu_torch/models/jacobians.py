"""Analytic Jacobians of the (GP-augmented) quadrotor dynamics, batched over
leading axes.

Port of `gpmpc_tpu/models/jacobians.py`. `torch.func.jacfwd` through the RK4
step pushes 16 tangents through every elementwise operation, the GP kernel's
exponentials included. The attitude dynamics and the SE-kernel posterior mean
both have closed-form Jacobians; this module evaluates them and chains them
through RK4:

    dk1/dx = Jx(x1)                      dk1/du = Ju(x1)
    dk2/dx = Jx(x2) (I + dt/2 dk1/dx)    dk2/du = Jx(x2) dt/2 dk1/du + Ju(x2)
    ...
    A = I + dt/6 (dk1 + 2 dk2 + 2 dk3 + dk4)/dx,   B likewise.

Every function takes states (..., 12) and inputs (..., 4) with any leading
axes and returns matrices with the same leading axes; the chain's products
are batched `torch.matmul` calls. `SqpConfig.analytic_jac` selects this
evaluator on the `lanes` path (default off, quadrotor only).
"""

from __future__ import annotations

from functools import partial

import torch

from gpmpc_tpu_torch.models import quadrotor
from gpmpc_tpu_torch.models.quadrotor import QuadrotorParams

NX, NU = quadrotor.NX, quadrotor.NU


def prior_jacobians(p: QuadrotorParams, x: torch.Tensor, u: torch.Tensor):
    """Continuous-time Jacobians (dfdx (..., 12, 12), dfdu (..., 12, 4)) of the
    attitude dynamics: the closed form of `quadrotor.continuous_dynamics`."""
    phi, theta, psi = x[..., 6], x[..., 7], x[..., 8]
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    acc = p.a * u[..., 0] + p.b

    A = x.new_zeros(x.shape[:-1] + (NX, NX))
    # kinematic rows: d(pos)/d(vel) and d(angle)/d(rate)
    for i, j in ((0, 1), (2, 3), (4, 5), (6, 9), (7, 10), (8, 11)):
        A[..., i, j] = 1.0
    # dd_x = acc (cphi sth cpsi + sphi spsi)
    A[..., 1, 6] = acc * (-sphi * sth * cpsi + cphi * spsi)
    A[..., 1, 7] = acc * (cphi * cth * cpsi)
    A[..., 1, 8] = acc * (-cphi * sth * spsi + sphi * cpsi)
    # dd_y = acc (cphi sth spsi - sphi cpsi)
    A[..., 3, 6] = acc * (-sphi * sth * spsi - cphi * cpsi)
    A[..., 3, 7] = acc * (cphi * cth * spsi)
    A[..., 3, 8] = acc * (cphi * sth * cpsi + sphi * spsi)
    # dd_z = acc cphi cth - g
    A[..., 5, 6] = -acc * sphi * cth
    A[..., 5, 7] = -acc * cphi * sth
    # attitude response rows
    A[..., 9, 6] = p.c
    A[..., 9, 9] = p.d
    A[..., 10, 7] = p.f
    A[..., 10, 10] = p.h

    B = x.new_zeros(x.shape[:-1] + (NX, NU))
    B[..., 1, 0] = p.a * (cphi * sth * cpsi + sphi * spsi)
    B[..., 3, 0] = p.a * (cphi * sth * spsi - sphi * cpsi)
    B[..., 5, 0] = p.a * cphi * cth
    B[..., 9, 1] = p.e
    B[..., 10, 2] = p.l
    return A, B


def _gp_mean_and_grad(Zs_i, alpha_i, ell_i, sf2_i, z_i):
    """SE posterior mean (...,) and its gradient (..., D) with respect to the
    query points z_i (..., D):

    mean = sum_m k_m alpha_m,  dmean/dz_d = sum_m k_m alpha_m (Z_{m,d} - z_d) / ell_d^2.
    ell_i is a scalar (isotropic) or a (D,) ARD vector."""
    diff = Zs_i - z_i[..., None, :]  # (..., Ms, D)
    inv_ell2 = 1.0 / (ell_i * ell_i)
    ka = sf2_i * torch.exp(-0.5 * torch.sum(diff * diff * inv_ell2, dim=-1)) * alpha_i
    return torch.sum(ka, dim=-1), torch.sum(ka[..., None] * diff, dim=-2) * inv_ell2


def augmented_jacobians(model, gp, x: torch.Tensor, u: torch.Tensor):
    """Continuous Jacobians of prior + GP residual dynamics
    (`control/gpmpc.py::gp_residual`): analytic kernel-mean gradients instead
    of 16 jacfwd tangents. Isotropic and ARD lengthscales; a shared GP."""
    from gpmpc_tpu_torch.control.gpmpc import softplus

    A, B = prior_jacobians(model.params, x, u)
    phi, theta = x[..., 6], x[..., 7]
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    ell = softplus(gp.hypers.raw_lengthscale)
    sf2 = softplus(gp.hypers.raw_outputscale)

    zero = torch.zeros_like(u[..., 0])
    zT = torch.stack([u[..., 0], zero, zero], dim=-1)
    zR = torch.stack([x[..., 6], x[..., 9], u[..., 1]], dim=-1)
    zP = torch.stack([x[..., 7], x[..., 10], u[..., 2]], dim=-1)
    Tp, dT = _gp_mean_and_grad(gp.Zs[0], gp.alpha_s[0], ell[0], sf2[0], zT)
    _, dR = _gp_mean_and_grad(gp.Zs[1], gp.alpha_s[1], ell[1], sf2[1], zR)
    _, dP = _gp_mean_and_grad(gp.Zs[2], gp.alpha_s[2], ell[2], sf2[2], zP)
    dT0 = dT[..., 0]  # only the thrust component of zT is live

    # res row 1: Tp cphi sth ; row 3: -Tp sphi ; row 5: Tp cphi cth
    A[..., 1, 6] += -Tp * sphi * sth
    A[..., 1, 7] += Tp * cphi * cth
    A[..., 3, 6] += -Tp * cphi
    A[..., 5, 6] += -Tp * sphi * cth
    A[..., 5, 7] += -Tp * cphi * sth
    B[..., 1, 0] += dT0 * cphi * sth
    B[..., 3, 0] += -dT0 * sphi
    B[..., 5, 0] += dT0 * cphi * cth
    # res row 9: Rp(phi, dphi, u1) ; row 10: Pp(theta, dtheta, u2)
    A[..., 9, 6] += dR[..., 0]
    A[..., 9, 9] += dR[..., 1]
    B[..., 9, 1] += dR[..., 2]
    A[..., 10, 7] += dP[..., 0]
    A[..., 10, 10] += dP[..., 1]
    B[..., 10, 2] += dP[..., 2]
    return A, B


def rk4_discrete_jacobians(fc, fc_jac, x: torch.Tensor, u: torch.Tensor, dt: float):
    """(fnext, A_d, B_d) of the RK4 step, chaining analytic continuous Jacobians.

    fc(x, u) -> dx/dt;  fc_jac(x, u) -> (Jx (..., 12, 12), Ju (..., 12, 4))."""
    eye = torch.eye(NX, dtype=x.dtype, device=x.device)

    k1 = fc(x, u)
    J1x, J1u = fc_jac(x, u)
    x2 = x + 0.5 * dt * k1
    k2 = fc(x2, u)
    J2x_c, J2u_c = fc_jac(x2, u)
    dk2x = J2x_c @ (eye + 0.5 * dt * J1x)
    dk2u = J2x_c @ (0.5 * dt * J1u) + J2u_c
    x3 = x + 0.5 * dt * k2
    k3 = fc(x3, u)
    J3x_c, J3u_c = fc_jac(x3, u)
    dk3x = J3x_c @ (eye + 0.5 * dt * dk2x)
    dk3u = J3x_c @ (0.5 * dt * dk2u) + J3u_c
    x4 = x + dt * k3
    k4 = fc(x4, u)
    J4x_c, J4u_c = fc_jac(x4, u)
    dk4x = J4x_c @ (eye + dt * dk3x)
    dk4u = J4x_c @ (dt * dk3u) + J4u_c

    fnext = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    A_d = eye + dt / 6.0 * (J1x + 2 * dk2x + 2 * dk3x + dk4x)
    B_d = dt / 6.0 * (J1u + 2 * dk2u + 2 * dk3u + dk4u)
    return fnext, A_d, B_d


def make_augmented_fd_jac(model, gp):
    """(x (..., 12), u (..., 4)) -> (fnext, A_d, B_d) for the GP-augmented
    discrete dynamics, on whole batches at once."""
    from gpmpc_tpu_torch.control.gpmpc import gp_residual

    def fc(x, u):
        return model.fc_func(x, u) + gp_residual(gp, x, u)

    def fc_jac(x, u):
        return augmented_jacobians(model, gp, x, u)

    return partial(rk4_discrete_jacobians, fc, fc_jac, dt=model.dt)

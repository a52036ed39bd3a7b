"""Dynamics linearization in lanes layout: kernel 3 of the port.

Port of `gpmpc_tpu/ops/pallas_linearize.py::linearize_ocp_lanes` with its
family closures (`_FAMILY_FC_JAC`: the quadrotor, the cartpole and the
two-link arm). The CUDA kernel is `csrc/linearize.cu`, a template on a family
trait with the stages in the grid and a team of threads per (scenario,
stage), the team a constant of the trait; `linearize_ocp_lanes_plain`
computes the same RK4 step and Jacobian chain in plain PyTorch, with the
closures below, which the wrapper runs for CPU tensors. `FAMILIES` is the
registry both read: a family's widths, its GP count and input width, and the
id the C launcher dispatches on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, route

GRAVITY = 9.81


def _gp_mean_grad(Zs, alpha, inv_ell2, sf2, z):
    """SE posterior mean (N,) and its gradient (N, D) at queries z (N, D)."""
    diff = Zs[None, :, :] - z[:, None, :]  # (N, Ms, D)
    d2 = torch.sum(diff * diff * inv_ell2, dim=-1)
    ka = sf2 * torch.exp(-0.5 * d2) * alpha[None, :]
    return ka.sum(-1), torch.sum(ka[..., None] * diff, dim=1) * inv_ell2


def _gp(hyp, Zs, alpha, use_gp, g, z):
    """Mean (N,) and gradient (N, D) of GP g at z, or zeros without the GP."""
    if not use_gp:
        return z.new_zeros(z.shape[0]), torch.zeros_like(z)
    return _gp_mean_grad(Zs[g], alpha[g], hyp[g, 1:], hyp[g, 0], z)


def _quad_fc_and_jac(par, hyp, Zs, alpha, use_gp, x, u):
    """f (N, 12), Jx (N, 12, 12), Ju (N, 12, 4) of the GP-augmented quadrotor."""
    pa, pb, pc, pd, pe, pf, ph, pl = (par[i] for i in range(8))
    phi, theta, psi = x[:, 6], x[:, 7], x[:, 8]
    dphi, dtheta, dpsi = x[:, 9], x[:, 10], x[:, 11]
    u0, u1, u2 = u[:, 0], u[:, 1], u[:, 2]
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    acc = pa * u0 + pb
    zero = torch.zeros_like(phi)

    Tp, dT = _gp(hyp, Zs, alpha, use_gp, 0, torch.stack([u0, zero, zero], dim=-1))
    Rp, dR = _gp(hyp, Zs, alpha, use_gp, 1, torch.stack([phi, dphi, u1], dim=-1))
    Pp, dP = _gp(hyp, Zs, alpha, use_gp, 2, torch.stack([theta, dtheta, u2], dim=-1))
    dT0 = dT[:, 0]

    f = torch.stack(
        [
            x[:, 1], acc * (cphi * sth * cpsi + sphi * spsi) + Tp * cphi * sth,
            x[:, 3], acc * (cphi * sth * spsi - sphi * cpsi) + Tp * (-sphi),
            x[:, 5], acc * cphi * cth - GRAVITY + Tp * cphi * cth,
            dphi, dtheta, dpsi,
            pc * phi + pd * dphi + pe * u1 + Rp,
            pf * theta + ph * dtheta + pl * u2 + Pp,
            zero,
        ],
        dim=-1,
    )
    Jx = x.new_zeros(x.shape[0], 12, 12)
    for i, j in ((0, 1), (2, 3), (4, 5), (6, 9), (7, 10), (8, 11)):
        Jx[:, i, j] = 1.0
    Jx[:, 1, 6] = acc * (-sphi * sth * cpsi + cphi * spsi) - Tp * sphi * sth
    Jx[:, 1, 7] = acc * (cphi * cth * cpsi) + Tp * cphi * cth
    Jx[:, 1, 8] = acc * (-cphi * sth * spsi + sphi * cpsi)
    Jx[:, 3, 6] = acc * (-sphi * sth * spsi - cphi * cpsi) - Tp * cphi
    Jx[:, 3, 7] = acc * (cphi * cth * spsi)
    Jx[:, 3, 8] = acc * (cphi * sth * cpsi + sphi * spsi)
    Jx[:, 5, 6] = -(acc + Tp) * sphi * cth
    Jx[:, 5, 7] = -(acc + Tp) * cphi * sth
    Jx[:, 9, 6] = pc + dR[:, 0]
    Jx[:, 9, 9] = pd + dR[:, 1]
    Jx[:, 10, 7] = pf + dP[:, 0]
    Jx[:, 10, 10] = ph + dP[:, 1]
    Ju = x.new_zeros(x.shape[0], 12, 4)
    Ju[:, 1, 0] = pa * (cphi * sth * cpsi + sphi * spsi) + dT0 * cphi * sth
    Ju[:, 3, 0] = pa * (cphi * sth * spsi - sphi * cpsi) - dT0 * sphi
    Ju[:, 5, 0] = pa * cphi * cth + dT0 * cphi * cth
    Ju[:, 9, 1] = pe + dR[:, 2]
    Ju[:, 10, 2] = pl + dP[:, 2]
    return f, Jx, Ju


def _cart_fc_and_jac(par, hyp, Zs, alpha, use_gp, x, u):
    """f (N, 4), Jx (N, 4, 4), Ju (N, 4, 1) of the GP-augmented cartpole
    (`models/cartpole.py`; GP0 sees (v, w, F) and adds to x'', GP1 sees
    (theta, w, F) and adds to theta''). par = [m_cart, m_pole, length, 0...].

    With M = m_cart + m_pole, k = m_pole l / M: p = (F + k M w^2 s) / M,
    n = g s - c p, e = l (4/3 - m_pole c^2 / M), theta'' = n / e,
    x'' = p - k c theta''; partials by the chain rule through (p, n, e)."""
    mc, mp, ln = par[0], par[1], par[2]
    M = mc + mp
    k = mp * ln / M
    v, th, w, F = x[:, 1], x[:, 2], x[:, 3], u[:, 0]
    s, c = torch.sin(th), torch.cos(th)
    g0, d0 = _gp(hyp, Zs, alpha, use_gp, 0, torch.stack([v, w, F], dim=-1))
    g1, d1 = _gp(hyp, Zs, alpha, use_gp, 1, torch.stack([th, w, F], dim=-1))

    p = (F + mp * ln * w * w * s) / M
    e = ln * (4.0 / 3.0 - mp * c * c / M)
    n = GRAVITY * s - c * p
    thdd = n / e
    xdd = p - k * thdd * c
    p_th, p_w, p_F = mp * ln * w * w * c / M, 2.0 * mp * ln * w * s / M, 1.0 / M
    e_th = 2.0 * ln * mp * c * s / M
    n_th, n_w, n_F = GRAVITY * c + s * p - c * p_th, -c * p_w, -c * p_F
    thdd_th, thdd_w, thdd_F = (n_th - thdd * e_th) / e, n_w / e, n_F / e

    f = torch.stack([v, xdd + g0, w, thdd + g1], dim=-1)
    Jx = x.new_zeros(x.shape[0], 4, 4)
    Jx[:, 0, 1] = 1.0
    Jx[:, 2, 3] = 1.0
    Jx[:, 1, 1] = d0[:, 0]
    Jx[:, 1, 2] = p_th - k * (c * thdd_th - s * thdd)
    Jx[:, 1, 3] = p_w - k * c * thdd_w + d0[:, 1]
    Jx[:, 3, 2] = thdd_th + d1[:, 0]
    Jx[:, 3, 3] = thdd_w + d1[:, 1]
    Ju = x.new_zeros(x.shape[0], 4, 1)
    Ju[:, 1, 0] = p_F - k * c * thdd_F + d0[:, 2]
    Ju[:, 3, 0] = thdd_F + d1[:, 2]
    return f, Jx, Ju


TWOLINK_TAU_SCALE = 0.1  # models/residual.py::_TWOLINK_TAU_SCALE


def _twolink_fc_and_jac(par, hyp, Zs, alpha, use_gp, x, u):
    """f (N, 4), Jx (N, 4, 4), Ju (N, 4, 2) of the GP-augmented two-link arm
    (`models/twolink.py`; both GPs see z = (q1, q2, dq1, dq2, t1/10, t2/10)
    and add to ddq1 and ddq2). par = [m1, m2, l1, l2, 0...].

    M(q) ddq = r with r = t - C dq - g; ddq = M^-1 r by the 2x2 inverse, and
    d ddq / dp = M^-1 (dr/dp - dM/dp ddq), where only q2 moves M."""
    m1, m2, l1, l2 = par[0], par[1], par[2], par[3]
    lc1, lc2 = 0.5 * l1, 0.5 * l2
    i1, i2 = m1 * l1 * l1 / 12.0, m2 * l2 * l2 / 12.0
    k1 = i1 + i2 + m1 * lc1 * lc1 + m2 * (l1 * l1 + lc2 * lc2)
    k2 = i2 + m2 * lc2 * lc2
    a = m2 * l1 * lc2
    g1c, g2c = (m1 * lc1 + m2 * l1) * GRAVITY, m2 * lc2 * GRAVITY
    q1, q2, dq1, dq2 = x.unbind(-1)
    c2, s2, c12, s12 = torch.cos(q2), torch.sin(q2), torch.cos(q1 + q2), torch.sin(q1 + q2)
    z = torch.cat([x, TWOLINK_TAU_SCALE * u], dim=-1)
    gm0, gd0 = _gp(hyp, Zs, alpha, use_gp, 0, z)
    gm1, gd1 = _gp(hyp, Zs, alpha, use_gp, 1, z)

    m11, m12, m22 = k1 + 2.0 * a * c2, k2 + a * c2, k2.expand_as(c2)
    det = m11 * m22 - m12 * m12
    h = a * s2
    r1 = u[:, 0] + h * dq2 * (2.0 * dq1 + dq2) - (g1c * torch.cos(q1) + g2c * c12)
    r2 = u[:, 1] - h * dq1 * dq1 - g2c * c12
    dd1 = (m22 * r1 - m12 * r2) / det
    dd2 = (m11 * r2 - m12 * r1) / det

    dh, gs12 = a * c2, g2c * s12
    dr1 = torch.stack([g1c * torch.sin(q1) + gs12, dh * dq2 * (2.0 * dq1 + dq2) + gs12,
                       2.0 * h * dq2, 2.0 * h * (dq1 + dq2)], dim=-1)
    dr2 = torch.stack([gs12, -dh * dq1 * dq1 + gs12, -2.0 * h * dq1, torch.zeros_like(q1)], dim=-1)
    w1, w2 = dr1.clone(), dr2.clone()  # dr/dp - dM/dp ddq
    w1[:, 1] += 2.0 * a * s2 * dd1 + a * s2 * dd2  # dm11/dq2 = -2 a s2, dm12/dq2 = -a s2
    w2[:, 1] += a * s2 * dd1  # dm22/dq2 = 0
    m11_, m12_, m22_, det_ = (t[:, None] for t in (m11, m12, m22, det))

    f = torch.stack([dq1, dq2, dd1 + gm0, dd2 + gm1], dim=-1)
    Jx = x.new_zeros(x.shape[0], 4, 4)
    Jx[:, 0, 2] = 1.0
    Jx[:, 1, 3] = 1.0
    Jx[:, 2] = (m22_ * w1 - m12_ * w2) / det_ + gd0[:, :4]
    Jx[:, 3] = (m11_ * w2 - m12_ * w1) / det_ + gd1[:, :4]
    Ju = x.new_zeros(x.shape[0], 4, 2)
    Ju[:, 2, 0] = m22 / det + TWOLINK_TAU_SCALE * gd0[:, 4]
    Ju[:, 2, 1] = -m12 / det + TWOLINK_TAU_SCALE * gd0[:, 5]
    Ju[:, 3, 0] = -m12 / det + TWOLINK_TAU_SCALE * gd1[:, 4]
    Ju[:, 3, 1] = m11 / det + TWOLINK_TAU_SCALE * gd1[:, 5]
    return f, Jx, Ju


class Family(NamedTuple):
    """One closure of the linearize kernel: `kid` is the family id of
    `csrc/linearize.cu::linearize_launch`."""

    kid: int
    nx: int
    nu: int
    num_gps: int
    gp_dim: int
    fc_and_jac: Callable


# family name (== ResidualSpec.name) -> closure, as the reference's _FAMILY_FC_JAC
FAMILIES = {
    "quadrotor": Family(0, 12, 4, 3, 3, _quad_fc_and_jac),
    "cartpole": Family(1, 4, 1, 2, 3, _cart_fc_and_jac),
    "twolink": Family(2, 4, 2, 2, 6, _twolink_fc_and_jac),
}


def family_of(name: str) -> Family:
    if name not in FAMILIES:
        raise ValueError(
            f"no hand-derived kernel linearizer for model family {name!r} "
            f"(have {sorted(FAMILIES)})"
        )
    return FAMILIES[name]


def linearize_ocp_lanes_plain(
    params8: torch.Tensor,  # (8,) the family's plant coefficients (ResidualSpec.kernel_params)
    hyp: torch.Tensor,  # (G, 1+D) per GP [sf2, 1/ell^2 per input dim]
    Zs: torch.Tensor,  # (G, Ms, D)
    alpha: torch.Tensor,  # (G, Ms)
    X: torch.Tensor,  # (n_tiles, T+1, nx, L)
    U: torch.Tensor,  # (n_tiles, T, nu, L)
    dt: float,
    use_gp: bool = True,
    family: str = "quadrotor",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fnext (n_tiles, T, nx, L), A (n_tiles, T, nx, nx, L), B (n_tiles, T, nx, nu, L)):
    one RK4 step of prior + GP mean per stage and its exact Jacobians."""
    closure = family_of(family).fc_and_jac
    n, Tp1, nx, L = X.shape
    T = Tp1 - 1
    x = X[:, :T].permute(0, 1, 3, 2).reshape(-1, nx)  # (n*T*L, nx)
    u = U.permute(0, 1, 3, 2).reshape(-1, U.shape[2])
    fcj = lambda xx: closure(params8, hyp, Zs, alpha, use_gp, xx, u)  # noqa: E731
    eye = torch.eye(nx, dtype=X.dtype, device=X.device)
    h = 0.5 * dt
    k1, J1x, J1u = fcj(x)
    k2, J2x, J2u = fcj(x + h * k1)
    dk2x = J2x @ (eye + h * J1x)
    dk2u = J2x @ (h * J1u) + J2u
    k3, J3x, J3u = fcj(x + h * k2)
    dk3x = J3x @ (eye + h * dk2x)
    dk3u = J3x @ (h * dk2u) + J3u
    k4, J4x, J4u = fcj(x + dt * k3)
    dk4x = J4x @ (eye + dt * dk3x)
    dk4u = J4x @ (dt * dk3u) + J4u
    fnext = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    A = eye + dt / 6.0 * (J1x + 2 * dk2x + 2 * dk3x + dk4x)
    B = dt / 6.0 * (J1u + 2 * dk2u + 2 * dk3u + dk4u)
    lanes = lambda t: t.reshape(n, T, L, *t.shape[1:]).movedim(2, -1).contiguous()  # noqa: E731
    return lanes(fnext), lanes(A), lanes(B)


def linearize_ocp_lanes(
    params8: torch.Tensor,
    hyp: torch.Tensor,
    Zs: torch.Tensor,
    alpha: torch.Tensor,
    X: torch.Tensor,
    U: torch.Tensor,
    dt: float,
    use_gp: bool = True,
    family: str = "quadrotor",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper with `linearize_ocp_lanes_plain`'s signature. CPU tensors
    take the plain version; CUDA tensors launch `linearize_kernel` for the
    family (one launch a call, counted in `launches`). Shapes are checked
    against the family on both routes."""
    fam = family_of(family)
    dev = X.device
    n, Tp1, _, L = X.shape
    T = Tp1 - 1
    G, D, Ms = fam.num_gps, fam.gp_dim, Zs.shape[1]
    check("params8", params8, (8,), dev)
    check("hyp", hyp, (G, 1 + D), dev)
    check("Zs", Zs, (G, Ms, D), dev)
    check("alpha", alpha, (G, Ms), dev)
    check("X", X, (n, T + 1, fam.nx, L), dev)
    check("U", U, (n, T, fam.nu, L), dev)
    if route(dev) == "plain":
        return linearize_ocp_lanes_plain(params8, hyp, Zs, alpha, X, U, dt, use_gp, family)

    if L > 1024 or n == 0 or T == 0:
        raise ValueError(f"linearize kernel needs 0 < L <= 1024, n_tiles > 0, T > 0 (L={L})")
    fnext = torch.empty(n, T, fam.nx, L, dtype=torch.float32, device=dev)
    A = torch.empty(n, T, fam.nx, fam.nx, L, dtype=torch.float32, device=dev)
    B = torch.empty(n, T, fam.nx, fam.nu, L, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        "linearize_launch", fam.kid, fam.nx, fam.nu, p(params8), p(hyp), p(X), p(U), p(Zs), p(alpha),
        n, T, L, Ms, int(use_gp), float(dt), p(fnext), p(A), p(B), _build.stream_handle(dev),
    )
    linearize_ocp_lanes.launches += 1
    return fnext, A, B


linearize_ocp_lanes.launches = 0

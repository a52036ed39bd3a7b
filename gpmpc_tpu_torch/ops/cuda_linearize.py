"""Quadrotor dynamics linearization in lanes layout: kernel 3 of the port.

Port of `gpmpc_tpu/ops/pallas_linearize.py::linearize_ocp_lanes` with the
quadrotor closure (`_quad_fc_and_jac`); the cartpole and two-link closures are
not ported yet (ROADMAP.md Queue 2). The CUDA kernel is `csrc/linearize.cu`;
`linearize_ocp_lanes_plain` computes the same RK4 step and Jacobian chain in
plain PyTorch, which the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, route

NX = 12
NU = 4
GRAVITY = 9.81


def _gp_mean_grad(Zs, alpha, inv_ell2, sf2, z):
    """SE posterior mean (N,) and its gradient (N, D) at queries z (N, D)."""
    diff = Zs[None, :, :] - z[:, None, :]  # (N, Ms, D)
    d2 = torch.sum(diff * diff * inv_ell2, dim=-1)
    ka = sf2 * torch.exp(-0.5 * d2) * alpha[None, :]
    return ka.sum(-1), torch.sum(ka[..., None] * diff, dim=1) * inv_ell2


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

    if use_gp:
        gp = lambda g, z: _gp_mean_grad(Zs[g], alpha[g], hyp[g, 1:], hyp[g, 0], z)  # noqa: E731
        Tp, dT = gp(0, torch.stack([u0, zero, zero], dim=-1))
        Rp, dR = gp(1, torch.stack([phi, dphi, u1], dim=-1))
        Pp, dP = gp(2, torch.stack([theta, dtheta, u2], dim=-1))
        dT0 = dT[:, 0]
    else:
        Tp = Rp = Pp = dT0 = zero
        dR = dP = torch.zeros_like(x[:, :3])

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
    Jx = torch.zeros(x.shape[0], NX, NX, dtype=x.dtype, device=x.device)
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
    Ju = torch.zeros(x.shape[0], NX, NU, dtype=x.dtype, device=x.device)
    Ju[:, 1, 0] = pa * (cphi * sth * cpsi + sphi * spsi) + dT0 * cphi * sth
    Ju[:, 3, 0] = pa * (cphi * sth * spsi - sphi * cpsi) - dT0 * sphi
    Ju[:, 5, 0] = pa * cphi * cth + dT0 * cphi * cth
    Ju[:, 9, 1] = pe + dR[:, 2]
    Ju[:, 10, 2] = pl + dP[:, 2]
    return f, Jx, Ju


def linearize_ocp_lanes_plain(
    params8: torch.Tensor,  # (8,) [a, b, c, d, e, f, h, l]
    hyp: torch.Tensor,  # (3, 4) per GP [sf2, 1/ell^2 per input dim]
    Zs: torch.Tensor,  # (3, Ms, 3)
    alpha: torch.Tensor,  # (3, Ms)
    X: torch.Tensor,  # (n_tiles, T+1, 12, L)
    U: torch.Tensor,  # (n_tiles, T, 4, L)
    dt: float,
    use_gp: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fnext (n_tiles, T, 12, L), A (n_tiles, T, 12, 12, L), B (n_tiles, T, 12, 4, L)):
    one RK4 step of prior + GP mean per stage and its exact Jacobians."""
    n, Tp1, nx, L = X.shape
    T = Tp1 - 1
    x = X[:, :T].permute(0, 1, 3, 2).reshape(-1, nx)  # (n*T*L, nx)
    u = U.permute(0, 1, 3, 2).reshape(-1, NU)
    fcj = lambda xx: _quad_fc_and_jac(params8, hyp, Zs, alpha, use_gp, xx, u)  # noqa: E731
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper with `linearize_ocp_lanes_plain`'s signature. CPU tensors
    take the plain version; CUDA tensors launch `linearize_kernel`, one block
    per tile."""
    dev = X.device
    n, Tp1, nx, L = X.shape
    T = Tp1 - 1
    G, Ms, D = Zs.shape
    check("params8", params8, (8,), dev)
    check("hyp", hyp, (3, 4), dev)
    check("Zs", Zs, (3, Ms, 3), dev)
    check("alpha", alpha, (3, Ms), dev)
    check("X", X, (n, T + 1, NX, L), dev)
    check("U", U, (n, T, NU, L), dev)
    if route(dev) == "plain":
        return linearize_ocp_lanes_plain(params8, hyp, Zs, alpha, X, U, dt, use_gp)

    if L > 1024 or n == 0 or T == 0:
        raise ValueError(f"linearize kernel needs 0 < L <= 1024, n_tiles > 0, T > 0 (L={L})")
    fnext = torch.empty(n, T, NX, L, dtype=torch.float32, device=dev)
    A = torch.empty(n, T, NX, NX, L, dtype=torch.float32, device=dev)
    B = torch.empty(n, T, NX, NU, L, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        "linearize_launch", p(params8), p(hyp), p(X), p(U), p(Zs), p(alpha),
        n, T, L, Ms, int(use_gp), float(dt), p(fnext), p(A), p(B), _build.stream_handle(dev),
    )
    linearize_ocp_lanes.launches += 1
    return fnext, A, B


linearize_ocp_lanes.launches = 0

"""Box-constrained OCP-QP: the reference's infeasible-start primal-dual
interior point, batch-first.

Port of `gpmpc_tpu/ops/boxqp.py` (see its docstring for the method): fixed
`n_iter` iterations, each a Newton step through the Riccati recursion
(`ops/riccati.py`) with the barrier terms on its diagonals (factored once an
iteration; Mehrotra's predictor and corrector share the factorization),
fixed centering `sigma` or Mehrotra's predictor-corrector, hard state bounds or L1-soft ones
(`soft_x`, the bounded-multiplier formulation with the penalty duals kept
explicitly). Every leaf carries a leading scenario axis B and the scenarios
are independent, as under `jax.vmap`: each has its own step lengths, centering
and gap, and once a scenario's mean complementarity gap is at `gap_tol` its
iterations are frozen (the state before the iteration kept, which also
discards a NaN computed past validity) while the others go on. The loop
always runs `n_iter` times; there is no batch-wide exit.

Problem (delta form around the current SQP iterate; x0 pinned, dx_0 = 0):

    min  sum_k 1/2 dx_k'Qxx_k dx_k + qx_k'dx_k + 1/2 du_k'Ruu_k du_k + ru_k'du_k
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + r_k
         lx_k <= dx_k <= ux_k   (k = 1..T; +-BOUND_INF at k=0)
         lu_k <= du_k <= uu_k   (k = 0..T-1)

This is not the lanes QP's plain version (`ops/cuda_ocp.py`), whose tile-wide
exit and `qp_tol` are the lanes kernels' semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch.ops.riccati import LqProblem, riccati_apply, riccati_factor, stack_dynamics
from gpmpc_tpu_torch.ops.riccati_parallel import riccati_solve_parallel

BOUND_INF = 1e8  # the reference's inactive-bound magnitude


class OcpQpData(NamedTuple):
    """Stage-wise QP data, every leaf leading with the scenario axis B."""

    A: torch.Tensor  # (B, T, nx, nx)
    B: torch.Tensor  # (B, T, nx, nu)
    r: torch.Tensor  # (B, T, nx)
    Qxx: torch.Tensor  # (B, T+1, nx, nx)
    qx: torch.Tensor  # (B, T+1, nx)
    Ruu: torch.Tensor  # (B, T, nu, nu)
    ru: torch.Tensor  # (B, T, nu)
    lx: torch.Tensor  # (B, T+1, nx)
    ux: torch.Tensor  # (B, T+1, nx)
    lu: torch.Tensor  # (B, T, nu)
    uu: torch.Tensor  # (B, T, nu)


class OcpQpSolution(NamedTuple):
    dx: torch.Tensor  # (B, T+1, nx)
    du: torch.Tensor  # (B, T, nu)
    gap: torch.Tensor  # (B,) final mean complementarity gap


class _IpState(NamedTuple):
    dx: torch.Tensor
    du: torch.Tensor
    s_lx: torch.Tensor
    s_ux: torch.Tensor
    s_lu: torch.Tensor
    s_uu: torch.Tensor
    lam_lx: torch.Tensor
    lam_ux: torch.Tensor
    lam_lu: torch.Tensor
    lam_uu: torch.Tensor
    mu: torch.Tensor  # (B,)
    # soft state bounds: the violation slacks and the penalty duals nu = rho - lam,
    # kept explicitly (recomputing rho - lam quantizes to 0 in float32 as lam -> rho)
    e_lx: torch.Tensor
    e_ux: torch.Tensor
    nu_lx: torch.Tensor
    nu_ux: torch.Tensor


def _per_scenario(a: torch.Tensor, op) -> torch.Tensor:
    """Reduce (B, ...) to (B,) with `op` (torch.sum, torch.amin, ...)."""
    return op(a.reshape(a.shape[0], -1), dim=1)


def _fraction_to_boundary(vals, deltas, tau) -> torch.Tensor:
    """Per scenario (B,), the largest alpha in (0, 1] with
    vals + alpha*deltas >= (1 - tau)*vals for every pair."""
    ratios = [
        _per_scenario(torch.where(d < 0, -tau * v / torch.clamp_max(d, -1e-30), torch.inf),
                      torch.amin)
        for v, d in zip(vals, deltas)
    ]
    return torch.clamp_max(torch.amin(torch.stack(ratios), dim=0), 1.0)


def solve_ocp_qp(
    qp: OcpQpData,
    n_iter: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    parallel_scan: bool = False,
    mehrotra: bool = False,
    soft_x: torch.Tensor | float | None = None,
    gap_tol: float | None = None,
) -> OcpQpSolution:
    """Solve the box-constrained OCP-QP of every scenario, `n_iter` fixed
    iterations. `mehrotra` replaces the fixed centering with Mehrotra's
    predictor-corrector (two Riccati solves an iteration). `soft_x`, a
    scalar or a tensor broadcastable to (B, T+1, nx), is the L1 penalty
    weight that makes the state bounds soft; None keeps them hard.
    `gap_tol` (default 1e-14 in float64, 1e-8 in float32, the numerical
    validity bound of the reference) freezes a scenario once its gap is at
    it. `parallel_scan` solves each Newton system with the associative-scan
    Riccati (`ops/riccati_parallel.py`, O(log T) depth), as the reference
    does; otherwise one sequential factorization an iteration serves both
    of Mehrotra's solves."""
    Bn, T, nx = qp.A.shape[0], qp.A.shape[1], qp.A.shape[2]
    nu = qp.B.shape[3]
    dtype, dev = qp.A.dtype, qp.A.device
    f64 = dtype == torch.float64
    s_min = 1e-2
    if gap_tol is None:
        gap_tol = 1e-14 if f64 else 1e-8
    soft = soft_x is not None
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=dev)  # noqa: E731
    if soft:
        rho = torch.as_tensor(soft_x, dtype=dtype, device=dev).expand(Bn, T + 1, nx)

    dx0 = full((Bn, T + 1, nx), 0.0)
    du0 = full((Bn, T, nu), 0.0)
    e0 = full((Bn, T + 1, nx), s_min if soft else 0.0)
    s_lx = torch.clamp_min(dx0 + e0 - qp.lx, s_min)
    s_ux = torch.clamp_min(qp.ux + e0 - dx0, s_min)
    s_lu = torch.clamp_min(du0 - qp.lu, s_min)
    s_uu = torch.clamp_min(qp.uu - du0, s_min)
    mu_init = torch.tensor(mu0, dtype=dtype, device=dev)
    lam_lx0 = mu_init / s_lx
    lam_ux0 = mu_init / s_ux
    if soft:
        # multipliers of soft bounds live in (0, rho); start well inside
        lam_lx0 = torch.minimum(lam_lx0, 0.49 * rho)
        lam_ux0 = torch.minimum(lam_ux0, 0.49 * rho)
    st = _IpState(
        dx=dx0, du=du0, s_lx=s_lx, s_ux=s_ux, s_lu=s_lu, s_uu=s_uu,
        lam_lx=lam_lx0, lam_ux=lam_ux0, lam_lu=mu_init / s_lu, lam_uu=mu_init / s_uu,
        mu=mu_init.expand(Bn), e_lx=e0, e_ux=e0,
        nu_lx=rho - lam_lx0 if soft else dx0, nu_ux=rho - lam_ux0 if soft else dx0,
    )
    # complementarity pairs: (s, lam) for every bound, (e, rho - lam) per soft state bound
    m_total = 2.0 * ((T + 1) * nx + T * nu)
    if soft:
        m_total += 2.0 * (T + 1) * nx
    zeros_x = torch.zeros(Bn, nx, dtype=dtype, device=dev)
    AB = stack_dynamics(qp.A, qp.B)
    w_max = 1e16 if f64 else 1e6
    t_floor = 1e-14 if f64 else 1e-10

    def ssum(a):
        return _per_scenario(a, torch.sum)

    def gap_of(s: _IpState) -> torch.Tensor:
        g = (ssum(s.s_lx * s.lam_lx) + ssum(s.s_ux * s.lam_ux)
             + ssum(s.s_lu * s.lam_lu) + ssum(s.s_uu * s.lam_uu))
        if soft:
            g = g + ssum(s.e_lx * s.nu_lx) + ssum(s.e_ux * s.nu_ux)
        return g / m_total

    def col(v):  # (B,) -> broadcastable against (B, ., .)
        return v[:, None, None]

    for _ in range(n_iter):
        gap_now = gap_of(st)
        # the numerical-validity stop: below gap_tol the iteration is a no-op
        done = gap_now <= gap_tol

        r_slx = st.dx + st.e_lx - qp.lx - st.s_lx
        r_sux = qp.ux + st.e_ux - st.dx - st.s_ux
        r_slu = st.du - qp.lu - st.s_lu
        r_suu = qp.uu - st.du - st.s_uu

        if soft:
            nu_lx, nu_ux = st.nu_lx, st.nu_ux
            # the fused barrier weight w = lam nu / (s nu + e lam), its
            # denominator floored so that w <= w_max (see the reference)
            den_lx = st.s_lx * nu_lx + st.e_lx * st.lam_lx
            den_ux = st.s_ux * nu_ux + st.e_ux * st.lam_ux
            den_lx = torch.maximum(den_lx, st.lam_lx * nu_lx * (1.0 / w_max))
            den_ux = torch.maximum(den_ux, st.lam_ux * nu_ux * (1.0 / w_max))
            w_lx = st.lam_lx * nu_lx / den_lx
            w_ux = st.lam_ux * nu_ux / den_ux
        else:
            nu_lx = nu_ux = None
            w_lx = st.lam_lx / st.s_lx
            w_ux = st.lam_ux / st.s_ux

        # barrier diagonals, shared by predictor and corrector: one factorization
        Qxx_hat = qp.Qxx + torch.diag_embed(w_lx + w_ux)
        Ruu_hat = qp.Ruu + torch.diag_embed(st.lam_lu / st.s_lu + st.lam_uu / st.s_uu)
        factor = None if parallel_scan else riccati_factor(AB, Qxx_hat, Ruu_hat)
        qx_base = torch.matmul(qp.Qxx, st.dx[..., None])[..., 0] + qp.qx - st.lam_lx + st.lam_ux
        ru_base = torch.matmul(qp.Ruu, st.du[..., None])[..., 0] + qp.ru - st.lam_lu + st.lam_uu
        # the dynamics infeasibility this Newton step corrects
        r_dyn = (torch.matmul(AB, torch.cat([st.dx[:, :-1], st.du], dim=-1)[..., None])[..., 0]
                 + qp.r - st.dx[:, 1:])

        def newton_step(r_clx, r_cux, r_clu, r_cuu, r_elx=None, r_eux=None):
            """Eliminate (ds, de, dlam) for these complementarity residuals and
            solve the stage-wise Newton system by Riccati."""
            if soft:
                cg_lx = (st.lam_lx * nu_lx * r_slx + nu_lx * r_clx - st.lam_lx * r_elx) / den_lx
                cg_ux = (st.lam_ux * nu_ux * r_sux + nu_ux * r_cux - st.lam_ux * r_eux) / den_ux
                corr_x = cg_lx - cg_ux
            else:
                corr_x = ((r_clx + st.lam_lx * r_slx) / st.s_lx
                          - (r_cux + st.lam_ux * r_sux) / st.s_ux)
            corr_u = (r_clu + st.lam_lu * r_slu) / st.s_lu - (r_cuu + st.lam_uu * r_suu) / st.s_uu
            if parallel_scan:
                sol = riccati_solve_parallel(LqProblem(qp.A, qp.B, r_dyn, Qxx_hat, qx_base + corr_x,
                                                       Ruu_hat, ru_base + corr_u), zeros_x)
                ddx, ddu = sol.dx, sol.du
            else:
                ddx, ddu, _ = riccati_apply(factor, r_dyn, qx_base + corr_x, ru_base + corr_u,
                                            zeros_x)
            if soft:
                dlam_lx = -(w_lx * ddx + cg_lx)
                dlam_ux = w_ux * ddx - cg_ux
                de_lx = (-r_elx + st.e_lx * dlam_lx) / nu_lx
                de_ux = (-r_eux + st.e_ux * dlam_ux) / nu_ux
                ds_lx = ddx + de_lx + r_slx
                ds_ux = -ddx + de_ux + r_sux
            else:
                ds_lx = ddx + r_slx
                ds_ux = r_sux - ddx
                dlam_lx = -(r_clx + st.lam_lx * ds_lx) / st.s_lx
                dlam_ux = -(r_cux + st.lam_ux * ds_ux) / st.s_ux
                de_lx = de_ux = None
            ds_lu = ddu + r_slu
            ds_uu = r_suu - ddu
            dlam_lu = -(r_clu + st.lam_lu * ds_lu) / st.s_lu
            dlam_uu = -(r_cuu + st.lam_uu * ds_uu) / st.s_uu
            return ((ddx, ddu), (ds_lx, ds_ux, ds_lu, ds_uu),
                    (dlam_lx, dlam_ux, dlam_lu, dlam_uu), (de_lx, de_ux))

        def alpha_primal(ds, de, t):
            vals = (st.s_lx, st.s_ux, st.s_lu, st.s_uu) + ((st.e_lx, st.e_ux) if soft else ())
            return _fraction_to_boundary(vals, ds + (de if soft else ()), t)

        def alpha_dual(dlam, t):
            vals = (st.lam_lx, st.lam_ux, st.lam_lu, st.lam_uu)
            deltas = dlam
            if soft:  # nu = rho - lam must stay positive too: d(nu) = -dlam
                vals = vals + (nu_lx, nu_ux)
                deltas = deltas + (-dlam[0], -dlam[1])
            return _fraction_to_boundary(vals, deltas, t)

        if mehrotra:
            # affine predictor: pure Newton on complementarity (mu = 0)
            re_a = (st.e_lx * nu_lx, st.e_ux * nu_ux) if soft else (None, None)
            _, ds_a, dlam_a, de_a = newton_step(
                st.s_lx * st.lam_lx, st.s_ux * st.lam_ux, st.s_lu * st.lam_lu,
                st.s_uu * st.lam_uu, re_a[0], re_a[1],
            )
            a_p = col(alpha_primal(ds_a, de_a, 1.0))
            a_d = col(alpha_dual(dlam_a, 1.0))
            slacks = (st.s_lx, st.s_ux, st.s_lu, st.s_uu)
            lams = (st.lam_lx, st.lam_ux, st.lam_lu, st.lam_uu)
            gap_aff = 0
            for s, ds, lam, dl in zip(slacks, ds_a, lams, dlam_a):
                gap_aff = gap_aff + ssum((s + a_p * ds) * (lam + a_d * dl))
            if soft:
                gap_aff = (gap_aff + ssum((st.e_lx + a_p * de_a[0]) * (nu_lx - a_d * dlam_a[0]))
                           + ssum((st.e_ux + a_p * de_a[1]) * (nu_ux - a_d * dlam_a[1])))
            gap_aff = gap_aff / m_total
            sig = torch.clamp((gap_aff / torch.clamp_min(gap_now, 1e-16)) ** 3, 1e-4, 1.0)
            # the centering target's floor: below ~sqrt(eps) the complementarity
            # products are rounding noise
            target = col(torch.clamp_min(sig * gap_now, t_floor))
            # corrector: centering and the second-order ds_aff * dlam_aff terms
            re_c = ((st.e_lx * nu_lx - de_a[0] * dlam_a[0] - target,
                     st.e_ux * nu_ux - de_a[1] * dlam_a[1] - target) if soft else (None, None))
            (ddx, ddu), ds, dlam, de = newton_step(
                st.s_lx * st.lam_lx + ds_a[0] * dlam_a[0] - target,
                st.s_ux * st.lam_ux + ds_a[1] * dlam_a[1] - target,
                st.s_lu * st.lam_lu + ds_a[2] * dlam_a[2] - target,
                st.s_uu * st.lam_uu + ds_a[3] * dlam_a[3] - target,
                re_c[0], re_c[1],
            )
        else:
            mu = col(st.mu)
            re = (st.e_lx * nu_lx - mu, st.e_ux * nu_ux - mu) if soft else (None, None)
            (ddx, ddu), ds, dlam, de = newton_step(
                st.s_lx * st.lam_lx - mu, st.s_ux * st.lam_ux - mu,
                st.s_lu * st.lam_lu - mu, st.s_uu * st.lam_uu - mu, re[0], re[1],
            )
        ds_lx, ds_ux, ds_lu, ds_uu = ds
        dlam_lx, dlam_ux, dlam_lu, dlam_uu = dlam
        a_p = col(alpha_primal(ds, de, tau))
        a_d = col(alpha_dual(dlam, tau))

        new = _IpState(
            dx=st.dx + a_p * ddx, du=st.du + a_p * ddu,
            s_lx=st.s_lx + a_p * ds_lx, s_ux=st.s_ux + a_p * ds_ux,
            s_lu=st.s_lu + a_p * ds_lu, s_uu=st.s_uu + a_p * ds_uu,
            lam_lx=st.lam_lx + a_d * dlam_lx, lam_ux=st.lam_ux + a_d * dlam_ux,
            lam_lu=st.lam_lu + a_d * dlam_lu, lam_uu=st.lam_uu + a_d * dlam_uu,
            mu=st.mu,
            e_lx=st.e_lx + a_p * de[0] if soft else st.e_lx,
            e_ux=st.e_ux + a_p * de[1] if soft else st.e_ux,
            nu_lx=st.nu_lx - a_d * dlam_lx if soft else st.nu_lx,
            nu_ux=st.nu_ux - a_d * dlam_ux if soft else st.nu_ux,
        )
        new = new._replace(mu=torch.clamp_min(sigma * gap_of(new), 1e-12))
        # a scenario that was done keeps its state (and drops any NaN computed past validity)
        st = _IpState(*[torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                        for a, b in zip(st, new)])
    return OcpQpSolution(dx=st.dx, du=st.du, gap=gap_of(st))

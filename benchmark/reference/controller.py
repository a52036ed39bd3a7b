"""The GP-MPC step in plain PyTorch, batch-first: the chance-constraint
tightening, then a Gauss-Newton SQP whose QPs a Mehrotra interior point
solves through a Riccati recursion.

The step, for each scenario: the GP variances along the previous solution,
mapped onto the GP rows, propagate a state covariance under the LQR feedback
of the prior linearized at hover; ppf sqrt(diag) of it and of its input image
tighten the state and input boxes (none on an episode's first step, at most
45 % of a box from each side). Then `sqp_iters` SQP iterations from the
previous solution (or the observation and the hover input on an episode's
first step), each linearizing the prior plus the GP means by forward-mode
differentiation of RK4 and solving one box QP in delta form; a scenario
whose step falls under `step_tol` keeps its iterate from then on. The QP's
interior point stops a tile of `tile` scenarios once every scenario in it
has a gap at or under `qp_tol`, as the program's kernel does, so the
reference groups scenarios in the same tiles. Nothing here imports the
program. The family's dynamics, reference, GP features and their
variance map come from `benchmark/reference/<family>.py` (`family`).
"""

from __future__ import annotations

import importlib
import statistics
from typing import NamedTuple

import numpy as np
import scipy.linalg
import torch

from benchmark.reference.common import GpSet, rk4
from benchmark.reference.precision import Precision, full_float32

BOUND_INF = 1e8  # the magnitude of the pinned stage's open bounds
MU0, SIGMA, TAU, S_MIN = 0.1, 0.2, 0.995, 1e-2  # the interior point's start and steps


class Consts(NamedTuple):
    """What the controller derives once from its configuration."""

    fam: object  # the family's module of the reference
    p: torch.Tensor  # (n_params,) the prior's coefficients
    Q: torch.Tensor  # (nx,) state weights
    R: torch.Tensor  # (nu,) input weights
    scale: torch.Tensor  # (T+1,) [dt, ..., dt, 1]
    uref: torch.Tensor  # (T, nu)
    traj: torch.Tensor  # (N, nx) the periodic reference
    lx: torch.Tensor  # (nx,) boxes
    ux: torch.Tensor
    lu: torch.Tensor  # (nu,)
    uu: torch.Tensor
    A: torch.Tensor  # (nx, nx) the prior discretized at hover
    B: torch.Tensor  # (nx, nu)
    K: torch.Tensor  # (nu, nx) its LQR gain
    Bd: torch.Tensor  # (nx, 5) the GP rows
    ppf: float


def family(config: dict):
    """`benchmark/reference/<family>.py` of a configuration."""
    return importlib.import_module(f"benchmark.reference.{config['family']}")


def gp_set(config: dict, arrays: dict, device) -> GpSet:
    """The GPs handed over in `arrays`, reading the family's feature
    columns."""
    return GpSet(arrays, device, family(config).GP_COLUMNS)


def dare_doubling(A, B, Q, R, iters: int = 60) -> np.ndarray:
    """The discrete algebraic Riccati equation's P by the structure-preserving
    doubling algorithm, float64. The quadrotor's yaw is neither controllable
    nor damped (scipy's solver finds no stabilizing solution); it is
    decoupled at hover, so its block of P grows without touching the gain."""
    G = B @ np.linalg.solve(R, B.T)
    Ak, Gk, Hk = A.copy(), G.copy(), Q.copy()
    eye = np.eye(A.shape[0])
    for _ in range(iters):
        W = eye + Gk @ Hk
        W_inv_A, W_inv_G = np.linalg.solve(W, Ak), np.linalg.solve(W, Gk)
        A_next, G_next = Ak @ W_inv_A, Gk + Ak @ W_inv_G @ Ak.T
        H_next = Hk + W_inv_A.T @ Hk @ Ak
        done = np.linalg.norm(H_next - Hk) <= 1e-14 * max(1.0, np.linalg.norm(Hk))
        Ak, Gk, Hk = A_next, G_next, H_next
        if done:
            break
    return 0.5 * (Hk + Hk.T)


def make_consts(cfg: dict, device) -> Consts:
    """The controller's constants from a configuration file's mapping: the
    prior's Jacobians at hover in float64, exactly discretized (expm), the
    discrete LQR gain and the chance quantile."""
    fam = family(cfg)
    dt, T = float(cfg["dt"]), int(cfg["horizon"])
    nx, nu = int(cfg["n_states"]), int(cfg["n_inputs"])
    u_eq = torch.tensor(cfg["u_eq"], dtype=torch.float64)
    p64 = fam.params_tensor(cfg["prior_params"], "cpu", torch.float64)
    jx, ju = torch.func.jacfwd(lambda x, u: fam.dynamics(x, u, p64), argnums=(0, 1))(
        torch.zeros(nx, dtype=torch.float64), u_eq)
    M = np.zeros((nx + nu, nx + nu))
    M[:nx, :nx], M[:nx, nx:] = jx.numpy(), ju.numpy()
    Md = scipy.linalg.expm(M * dt)
    Ad, Bd_in = Md[:nx, :nx], Md[:nx, nx:]
    Qm, Rm = np.diag(cfg["q_mpc"]).astype(np.float64), np.diag(cfg["r_mpc"]).astype(np.float64)
    P = dare_doubling(Ad, Bd_in, Qm, Rm)
    K = -np.linalg.solve(Rm + Bd_in.T @ P @ Bd_in, Bd_in.T @ P @ Ad)
    prob = float(cfg["prob"])
    ppf = statistics.NormalDist().inv_cdf(1 - (1 / nx - (prob + 1) / (2 * nx)))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    scale = np.full(T + 1, dt)
    scale[-1] = 1.0
    (lx, ux), (lu, uu) = cfg["state_bounds"], cfg["input_bounds"]
    return Consts(
        fam=fam, p=fam.params_tensor(cfg["prior_params"], device), Q=f32(cfg["q_mpc"]),
        R=f32(cfg["r_mpc"]), scale=f32(scale), uref=f32(np.tile(cfg["u_eq"], (T, 1))),
        traj=fam.reference_trajectory(cfg, device),
        lx=f32(lx), ux=f32(ux), lu=f32(lu), uu=f32(uu), A=f32(Ad), B=f32(Bd_in), K=f32(K),
        Bd=f32(np.eye(nx)[:, list(fam.GP_ROWS)]), ppf=float(np.float32(ppf)),
    )


def tightening(c: Consts, gp: GpSet, X: torch.Tensor, U: torch.Tensor, dt: float, prec):
    """(t_x (B, T+1, nx), t_u (B, T, nu)) along the solution X (B, T+1, nx),
    U (B, T, nu): the GP variances and noise on the GP rows times dt^2
    propagate cov_x under the LQR feedback."""
    z = c.fam.gp_features(X[:, :-1], U)  # (B, T, features)
    F = c.fam.variance_factors(z)  # (B, T, GP rows, G)
    dn = (torch.sum(F * gp.variance(z, prec)[..., None, :], -1)
          + torch.sum(F * gp.noise, -1)) * dt ** 2  # (B, T, GP rows)
    A, Bm, K, Bd = c.A, c.B, c.K, c.Bd
    Bn, T = dn.shape[:2]

    def sd(m):
        return c.ppf * torch.sqrt(torch.clamp_min(torch.diagonal(m, dim1=-2, dim2=-1), 0.0))

    nx = A.shape[0]
    cov = torch.zeros(Bn, nx, nx, dtype=torch.float32, device=X.device)
    t_x, t_u = [], []
    mm = prec.mm
    for k in range(T):
        cov_xu = mm(cov, K.T)
        cov_u = mm(mm(K, cov), K.T)
        t_x.append(sd(cov))
        t_u.append(sd(cov_u))
        cov = (mm(mm(A, cov), A.T) + mm(mm(A, cov_xu), Bm.T)
               + mm(mm(Bm, cov_xu.transpose(-1, -2)), A.T) + mm(mm(Bm, cov_u), Bm.T)
               + mm(mm(Bd, torch.diag_embed(dn[:, k])), Bd.T))
    t_x.append(sd(cov))
    return torch.stack(t_x, 1), torch.stack(t_u, 1)


class Boxes(NamedTuple):
    lx: torch.Tensor  # (B, T+1, nx)
    ux: torch.Tensor
    lu: torch.Tensor  # (B, T, nu)
    uu: torch.Tensor


def tightened_boxes(c: Consts, gp: GpSet, traj_step, X_warm, U_warm, dt, prec) -> Boxes:
    """The boxes of this step: tightened on every step but an episode's
    first (and not at all with an untrained GP), at most 45 % of a box from
    each side."""
    t_x, t_u = tightening(c, gp, X_warm, U_warm, dt, prec)
    use = ((traj_step > 0) & gp.trained)[:, None, None]
    t_x = torch.where(use, t_x, torch.zeros_like(t_x))
    t_u = torch.where(use, t_u, torch.zeros_like(t_u))
    t_x = torch.minimum(t_x, 0.45 * (c.ux - c.lx))
    t_u = torch.minimum(t_u, 0.45 * (c.uu - c.lu))
    return Boxes(c.lx + t_x, c.ux - t_x, c.lu + t_u, c.uu - t_u)


def linearize(f, dt: float, X: torch.Tensor, U: torch.Tensor):
    """(fnext, A, B) of RK4(f) at X (..., nx), U (..., nu): forward mode, one
    tangent of the nx + nu basis at a time."""
    fd = lambda x, u: rk4(f, x, u, dt)  # noqa: E731
    nx, nu = X.shape[-1], U.shape[-1]
    basis = torch.eye(nx + nu, dtype=X.dtype, device=X.device)

    def push(t):
        return torch.func.jvp(fd, (X, U), (t[:nx].expand_as(X), t[nx:].expand_as(U)))[1]

    J = torch.func.vmap(push)(basis).movedim(0, -1)
    return fd(X, U), J[..., :nx], J[..., nx:]


class Qp(NamedTuple):
    """One box QP in delta form per scenario, batch-first: minimize
    sum 1/2 dx' diag(qdiag) dx + qx' dx + 1/2 du' diag(rdiag) du + ru' du
    s.t. dx_{k+1} = A dx_k + B du_k + r, lx <= dx <= ux, lu <= du <= uu,
    dx_0 = 0."""

    A: torch.Tensor  # (N, T, nx, nx)
    B: torch.Tensor  # (N, T, nx, nu)
    r: torch.Tensor  # (N, T, nx)
    qdiag: torch.Tensor  # (N, T+1, nx)
    qx: torch.Tensor
    rdiag: torch.Tensor  # (N, T, nu)
    ru: torch.Tensor
    lx: torch.Tensor  # (N, T+1, nx)
    ux: torch.Tensor
    lu: torch.Tensor  # (N, T, nu)
    uu: torch.Tensor


def solve_qp(qp: Qp, n_ip: int, tol: float, tile: int, prec):
    """Mehrotra predictor-corrector interior point on the box QPs, at most
    `n_ip` iterations; a tile of `tile` consecutive scenarios stops once the
    gap of every scenario in it is at or under `tol`. Returns (dx, du, the
    iterations each tile ran (n_tiles,))."""
    A, Bm = qp.A, qp.B
    N, T, nx, _ = A.shape
    nu = Bm.shape[-1]
    if N % tile:
        raise ValueError(f"{N} scenarios do not fill tiles of {tile}")
    mm, mv = prec.mm, prec.mv
    At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
    m_total = 2.0 * ((T + 1) * nx + T * nu)
    dev = A.device
    s = dict(dx=torch.zeros(N, T + 1, nx, device=dev), du=torch.zeros(N, T, nu, device=dev))
    s["slx"], s["sux"] = torch.clamp_min(-qp.lx, S_MIN), torch.clamp_min(qp.ux, S_MIN)
    s["slu"], s["suu"] = torch.clamp_min(-qp.lu, S_MIN), torch.clamp_min(qp.uu, S_MIN)
    for sl, ll in (("slx", "llx"), ("sux", "lux"), ("slu", "llu"), ("suu", "luu")):
        s[ll] = MU0 / s[sl]
    pairs = (("slx", "llx"), ("sux", "lux"), ("slu", "llu"), ("suu", "luu"))
    tot = lambda v: torch.sum(v, dim=(1, 2))  # noqa: E731

    def gap(sl, ll):
        return sum(tot(a * b) for a, b in zip(sl, ll)) / m_total

    def riccati(sigx, sigu, qhat, rhat, rdyn, stores):
        p = qhat[:, T]
        kff = [None] * T
        if stores is None:
            K, Pr, L, Gxu = [None] * T, [None] * T, [None] * T, [None] * T
            P = torch.diag_embed(qp.qdiag[:, T] + sigx[:, T])
            for k in range(T - 1, -1, -1):
                Pr[k] = mv(P, rdyn[:, k])
                fr = Pr[k] + p
                AtP, BtP = mm(At[:, k], P), mm(Bt[:, k], P)
                Gxx = mm(AtP, A[:, k]) + torch.diag_embed(qp.qdiag[:, k] + sigx[:, k])
                Guu = mm(BtP, Bm[:, k]) + torch.diag_embed(qp.rdiag[:, k] + sigu[:, k])
                Gxu[k] = mm(AtP, Bm[:, k])
                gx = qhat[:, k] + mv(At[:, k], fr)
                gu = rhat[:, k] + mv(Bt[:, k], fr)
                L[k] = torch.linalg.cholesky_ex(Guu)[0]
                K[k] = -torch.cholesky_solve(Gxu[k].transpose(-1, -2), L[k])
                kff[k] = -torch.cholesky_solve(gu[..., None], L[k])[..., 0]
                P = Gxx + mm(Gxu[k], K[k])
                P = 0.5 * (P + P.transpose(-1, -2))
                p = gx + mv(Gxu[k], kff[k])
            stores = (K, Pr, L, Gxu)
        else:
            K, Pr, L, Gxu = stores
            for k in range(T - 1, -1, -1):
                fr = Pr[k] + p
                gx = qhat[:, k] + mv(At[:, k], fr)
                gu = rhat[:, k] + mv(Bt[:, k], fr)
                kff[k] = -torch.cholesky_solve(gu[..., None], L[k])[..., 0]
                p = gx + mv(Gxu[k], kff[k])
        ddx, ddu = [torch.zeros(N, nx, device=dev)], []
        for k in range(T):
            ddu.append(mv(K[k], ddx[-1]) + kff[k])
            ddx.append(mv(A[:, k], ddx[-1]) + mv(Bm[:, k], ddu[-1]) + rdyn[:, k])
        return torch.stack(ddx, 1), torch.stack(ddu, 1), stores

    def iterate(s):
        sl = tuple(s[a] for a, _ in pairs)
        ll = tuple(s[b] for _, b in pairs)
        res = (s["dx"] - qp.lx - sl[0], qp.ux - s["dx"] - sl[1],
               s["du"] - qp.lu - sl[2], qp.uu - s["du"] - sl[3])
        sigx = ll[0] / sl[0] + ll[1] / sl[1]
        sigu = ll[2] / sl[2] + ll[3] / sl[3]
        rdyn = mv(A, s["dx"][:, :T]) + mv(Bm, s["du"]) + qp.r - s["dx"][:, 1:]

        def directions(rc, stores):
            corr_x = (rc[0] + ll[0] * res[0]) / sl[0] - (rc[1] + ll[1] * res[1]) / sl[1]
            corr_u = (rc[2] + ll[2] * res[2]) / sl[2] - (rc[3] + ll[3] * res[3]) / sl[3]
            qhat = qp.qdiag * s["dx"] + qp.qx - ll[0] + ll[1] + corr_x
            rhat = qp.rdiag * s["du"] + qp.ru - ll[2] + ll[3] + corr_u
            ddx, ddu, stores = riccati(sigx, sigu, qhat, rhat, rdyn, stores)
            ds = (ddx + res[0], res[1] - ddx, ddu + res[2], res[3] - ddu)
            dl = tuple(-(rc[i] + ll[i] * ds[i]) / sl[i] for i in range(4))
            return ddx, ddu, ds, dl, stores

        def steps(ds, dl, t):
            ratio = lambda v, d: torch.where(  # noqa: E731
                d < 0, -t * v / torch.clamp_max(d, -1e-30), torch.full_like(v, torch.inf))
            a_p = torch.stack([torch.amin(ratio(sl[i], ds[i]), (1, 2)) for i in range(4)]).amin(0)
            a_d = torch.stack([torch.amin(ratio(ll[i], dl[i]), (1, 2)) for i in range(4)]).amin(0)
            return torch.clamp_max(a_p, 1.0), torch.clamp_max(a_d, 1.0)

        prod = tuple(sl[i] * ll[i] for i in range(4))
        gap_now = gap(sl, ll)
        _, _, ds_a, dl_a, stores = directions(prod, None)
        ap, ad = (a[:, None, None] for a in steps(ds_a, dl_a, 1.0))
        gap_aff = gap(tuple(sl[i] + ap * ds_a[i] for i in range(4)),
                      tuple(ll[i] + ad * dl_a[i] for i in range(4)))
        sig = torch.clamp((gap_aff / torch.clamp_min(gap_now, 1e-16)) ** 3, 1e-4, 1.0)
        target = torch.clamp_min(sig * gap_now, 1e-14)[:, None, None]
        rc = tuple(prod[i] + ds_a[i] * dl_a[i] - target for i in range(4))
        ddx, ddu, ds, dl, _ = directions(rc, stores)
        ap, ad = (a[:, None, None] for a in steps(ds, dl, TAU))
        new = dict(dx=s["dx"] + ap * ddx, du=s["du"] + ap * ddu)
        for i, (a, b) in enumerate(pairs):
            new[a] = sl[i] + ap * ds[i]
            new[b] = ll[i] + ad * dl[i]
        mu = torch.clamp_min(SIGMA * gap(tuple(new[a] for a, _ in pairs),
                                         tuple(new[b] for _, b in pairs)), 1e-12)
        return new, mu

    mu = torch.full((N,), MU0, device=dev)
    iters = torch.zeros(N // tile, dtype=torch.int32, device=dev)
    for _ in range(n_ip):
        active = ~torch.all((mu <= tol).reshape(-1, tile), dim=1)  # (n_tiles,)
        if not bool(active.any()):
            break
        new, new_mu = iterate(s)
        lane = active.repeat_interleave(tile)
        s = {k: torch.where(lane.reshape((N,) + (1,) * (v.dim() - 1)), new[k], v)
             for k, v in s.items()}
        mu = torch.where(lane, new_mu, mu)
        iters += active.to(torch.int32)
    return s["dx"], s["du"], iters


class StepOut(NamedTuple):
    u: torch.Tensor  # (B, nu) the actions
    X: torch.Tensor  # (B, T+1, nx) the solution, the next step's warm start
    U: torch.Tensor  # (B, T, nu)
    boxes: Boxes  # the tightened boxes the QPs were solved in
    ip_iters: list  # per SQP iteration, the IP iterations of each tile (n_tiles,)


def gpmpc_step(c: Consts, gp: GpSet, solver: dict, traj_step, X_warm, U_warm, obs,
               precision: str = "float32") -> StepOut:
    """One GP-MPC step of B scenarios from the controller's state (traj_step
    (B,), X_warm (B, T+1, nx), U_warm (B, T, nu)) and observations (B, nx)."""
    prec = Precision(precision)
    with full_float32(), torch.no_grad():
        T = c.uref.shape[0]
        dt = float(c.scale[0])
        boxes = tightened_boxes(c, gp, traj_step, X_warm, U_warm, dt, prec)
        idx = torch.remainder(traj_step[:, None].long()
                              + torch.arange(T + 1, device=obs.device), c.traj.shape[0])
        xref = c.traj[idx]
        first = (traj_step == 0)[:, None, None]
        X = torch.where(first, obs[:, None, :].expand(-1, T + 1, -1), X_warm)
        U = torch.where(first, c.uref[None], U_warm)
        qdiag = torch.cat([c.scale[:-1, None] * c.Q, c.scale[-1:, None] * c.Q])
        rdiag = c.scale[:-1, None] * c.R
        B = obs.shape[0]
        f = c.fam.augmented(c.p, gp)
        converged = torch.zeros(B, dtype=torch.bool, device=obs.device)
        ip_iters = []
        lm = float(solver.get("lm_reg", 0.0))
        for _ in range(int(solver["sqp_iters"])):
            Xi = X.clone()
            Xi[:, 0] = obs
            fnext, A, Bm = linearize(f, dt, Xi[:, :-1], U)
            lx, ux = boxes.lx - Xi, boxes.ux - Xi
            lx[:, 0], ux[:, 0] = -BOUND_INF, BOUND_INF
            qp = Qp(A=A, B=Bm, r=fnext - Xi[:, 1:], qdiag=(qdiag + lm).expand(B, -1, -1),
                    qx=qdiag * (Xi - xref), rdiag=(rdiag + lm).expand(B, -1, -1),
                    ru=rdiag * (U - c.uref), lx=lx, ux=ux, lu=boxes.lu - U, uu=boxes.uu - U)
            dx, du, iters = solve_qp(qp, int(solver["qp_iters"]), float(solver["qp_tol"]),
                                     int(solver["tile"]), prec)
            ip_iters.append(iters)
            step = torch.maximum(torch.amax(dx.abs(), (1, 2)), torch.amax(du.abs(), (1, 2)))
            active = (~converged)[:, None, None]
            X = torch.where(active, X + dx, X)
            U = torch.where(active, U + du, U)
            converged = converged | (step < float(solver["step_tol"]))
        X = X.clone()
        X[:, 0] = obs
        return StepOut(U[:, 0], X, U, boxes, ip_iters)

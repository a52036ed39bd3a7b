"""Box-constrained OCP-QP interior point in lanes layout: kernel 4 of the port.

Port of `gpmpc_tpu/ops/pallas_ocp.py::solve_ocp_qp_lanes`, the resident
kernel, in its hard-bound modes (plain centering or Mehrotra, fixed count or
the tile-wide adaptive exit). Soft state bounds and the streamed tiers are not
ported yet (ROADMAP.md Queue 2). The CUDA kernel is `csrc/ocp_ip.cu`;
`solve_ocp_qp_lanes_plain` is the same algorithm in plain PyTorch, which the
wrapper runs for CPU tensors. Unlike the reference, which takes one tile per
call, both take every tile at once: arrays lead with n_tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, route


class LanesQp(NamedTuple):
    """QP data in lanes layout (n = tiles, T = horizon, L = lanes):
    A (n,T,nx,nx,L)  B (n,T,nx,nu,L)  r (n,T,nx,L)
    qdiag/qx/lx/ux (n,T+1,nx,L)  rdiag/ru/lu/uu (n,T,nu,L)"""

    A: torch.Tensor
    B: torch.Tensor
    r: torch.Tensor
    qdiag: torch.Tensor
    qx: torch.Tensor
    rdiag: torch.Tensor
    ru: torch.Tensor
    lx: torch.Tensor
    ux: torch.Tensor
    lu: torch.Tensor
    uu: torch.Tensor


# --- lane-wise small linear algebra on (n, a, b, L) blocks --------------------


def _mm(x, y):
    """(n, a, b, L) @ (n, b, c, L) -> (n, a, c, L), elementwise (no TF32)."""
    return torch.sum(x[:, :, :, None, :] * y[:, None, :, :, :], dim=2)


def _mv(x, v):
    """(n, a, b, L) @ (n, b, L) -> (n, a, L)."""
    return torch.sum(x * v[:, None, :, :], dim=2)


def _t(x):
    return x.transpose(1, 2)


def _chol_factor(G):
    """Lane-wise Cholesky of SPD G (n, m, m, L): lower rows as lists of (n, L)."""
    m = G.shape[1]
    l = [[None] * m for _ in range(m)]  # noqa: E741
    for j in range(m):
        s = G[:, j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        l[j][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
        inv = 1.0 / l[j][j]
        for i in range(j + 1, m):
            s = G[:, i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    return l


def _chol_pack(l):
    m = len(l)
    zero = torch.zeros_like(l[0][0])
    return torch.stack(
        [torch.stack([l[i][j] if j <= i else zero for j in range(m)], dim=1) for i in range(m)],
        dim=1,
    )


def _chol_unpack(lmat):
    m = lmat.shape[1]
    return [[lmat[:, i, j] if j <= i else None for j in range(m)] for i in range(m)]


def _chol_sub(l, rhs):
    """Solve L L' X = rhs with rhs (n, m, c, L)."""
    m = len(l)
    y = [None] * m
    for i in range(m):
        s = rhs[:, i]
        for k in range(i):
            s = s - l[i][k][:, None, :] * y[k]
        y[i] = s / l[i][i][:, None, :]
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for k in range(i + 1, m):
            s = s - l[k][i][:, None, :] * x[k]
        x[i] = s / l[i][i][:, None, :]
    return torch.stack(x, dim=1)


def _ratio(v, d, t):
    return torch.where(d < 0, -t * v / torch.clamp_max(d, -1e-30), torch.full_like(v, torch.inf))


def _lane_min(a):
    return torch.amin(a, dim=(1, 2))  # (n, L)


def _lane_sum(a):
    return torch.sum(a, dim=(1, 2))


def solve_ocp_qp_lanes_plain(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx (n,T+1,nx,L), du (n,T,nu,L), gap (n,L)). With `adaptive_tol`, a tile
    stops iterating once every lane in it has mu <= adaptive_tol."""
    A, Bm = qp.A, qp.B
    n, T, nx, _, L = A.shape
    nu = Bm.shape[3]
    dev, f32 = A.device, torch.float32
    s_min = 1e-2
    eye_x = torch.eye(nx, dtype=f32, device=dev)[None, :, :, None]
    eye_u = torch.eye(nu, dtype=f32, device=dev)[None, :, :, None]
    m_total = 2.0 * ((T + 1) * nx + T * nu)

    slx = torch.clamp_min(-qp.lx, s_min)
    sux = torch.clamp_min(qp.ux, s_min)
    slu = torch.clamp_min(-qp.lu, s_min)
    suu = torch.clamp_min(qp.uu, s_min)
    st = dict(
        dx=torch.zeros(n, T + 1, nx, L, dtype=f32, device=dev),
        du=torch.zeros(n, T, nu, L, dtype=f32, device=dev),
        slx=slx, sux=sux, slu=slu, suu=suu,
        llx=mu0 / slx, lux=mu0 / sux, llu=mu0 / slu, luu=mu0 / suu,
    )

    def solve_newton(s, rdyn, sigx, sigu, corr_x, corr_u, stores=None):
        """Riccati sweep + rollout. `stores` (K, Pr, lchol, Gxu) from an earlier
        sweep of the same iteration turn it into the vector-only corrector."""
        qhat = qp.qdiag * s["dx"] + qp.qx - s["llx"] + s["lux"] + corr_x
        rhat = qp.rdiag * s["du"] + qp.ru - s["llu"] + s["luu"] + corr_u
        K_s, kff_s = [None] * T, [None] * T
        p = qhat[:, T]
        if stores is None:
            Pr_s, lchol_s, Gxu_s = [None] * T, [None] * T, [None] * T
            P = eye_x * (qp.qdiag[:, T] + sigx[:, T])[:, None, :, :]
            for k in range(T - 1, -1, -1):
                Ak, Bk = A[:, k], Bm[:, k]
                Pr = _mv(P, rdyn[:, k])
                Fr_p = Pr + p
                AtP = _mm(_t(Ak), P)
                BtP = _mm(_t(Bk), P)
                Gxx = _mm(AtP, Ak) + eye_x * (qp.qdiag[:, k] + sigx[:, k])[:, None, :, :]
                Guu = _mm(BtP, Bk) + eye_u * (qp.rdiag[:, k] + sigu[:, k])[:, None, :, :]
                Gxu = _mm(AtP, Bk)
                gx = qhat[:, k] + _mv(_t(Ak), Fr_p)
                gu = rhat[:, k] + _mv(_t(Bk), Fr_p)
                rhs = torch.cat([_t(Gxu), gu[:, :, None, :]], dim=2)  # (n, nu, nx+1, L)
                lfac = _chol_factor(Guu)
                Pr_s[k], lchol_s[k], Gxu_s[k] = Pr, _chol_pack(lfac), Gxu
                sol = _chol_sub(lfac, rhs)
                K_s[k] = -sol[:, :, :nx]
                kff_s[k] = -sol[:, :, nx]
                P = Gxx + _mm(Gxu, K_s[k])
                P = 0.5 * (P + _t(P))
                p = gx + _mv(Gxu, kff_s[k])
            stores = (K_s, Pr_s, lchol_s, Gxu_s)
        else:
            K_s, Pr_s, lchol_s, Gxu_s = stores
            for k in range(T - 1, -1, -1):
                Fr_p = Pr_s[k] + p
                gx = qhat[:, k] + _mv(_t(A[:, k]), Fr_p)
                gu = rhat[:, k] + _mv(_t(Bm[:, k]), Fr_p)
                kff_s[k] = -_chol_sub(_chol_unpack(lchol_s[k]), gu[:, :, None, :])[:, :, 0]
                p = gx + _mv(Gxu_s[k], kff_s[k])
        ddx = [torch.zeros(n, nx, L, dtype=f32, device=dev)]
        ddu = []
        for k in range(T):
            ddu.append(_mv(K_s[k], ddx[-1]) + kff_s[k])
            ddx.append(_mv(A[:, k], ddx[-1]) + _mv(Bm[:, k], ddu[-1]) + rdyn[:, k])
        return torch.stack(ddx, dim=1), torch.stack(ddu, dim=1), stores

    def ip_iter(s, mu):
        r_slx = s["dx"] - qp.lx - s["slx"]
        r_sux = qp.ux - s["dx"] - s["sux"]
        r_slu = s["du"] - qp.lu - s["slu"]
        r_suu = qp.uu - s["du"] - s["suu"]
        sigx = s["llx"] / s["slx"] + s["lux"] / s["sux"]
        sigu = s["llu"] / s["slu"] + s["luu"] / s["suu"]
        rdyn = (
            _mv(A.flatten(0, 1), s["dx"][:, :T].flatten(0, 1)).unflatten(0, (n, T))
            + _mv(Bm.flatten(0, 1), s["du"].flatten(0, 1)).unflatten(0, (n, T))
            + qp.r - s["dx"][:, 1:]
        )
        sl = (s["slx"], s["sux"], s["slu"], s["suu"])
        ll = (s["llx"], s["lux"], s["llu"], s["luu"])

        def directions(rc, stores=None):
            corr_x = (rc[0] + ll[0] * r_slx) / sl[0] - (rc[1] + ll[1] * r_sux) / sl[1]
            corr_u = (rc[2] + ll[2] * r_slu) / sl[2] - (rc[3] + ll[3] * r_suu) / sl[3]
            ddx, ddu, stores = solve_newton(s, rdyn, sigx, sigu, corr_x, corr_u, stores)
            ds = (ddx + r_slx, r_sux - ddx, ddu + r_slu, r_suu - ddu)
            dl = tuple(-(rc[i] + ll[i] * ds[i]) / sl[i] for i in range(4))
            return ddx, ddu, ds, dl, stores

        def steps(ds, dl, t):
            a_p = torch.clamp_max(torch.stack(
                [_lane_min(_ratio(sl[i], ds[i], t)) for i in range(4)]).amin(0), 1.0)
            a_d = torch.clamp_max(torch.stack(
                [_lane_min(_ratio(ll[i], dl[i], t)) for i in range(4)]).amin(0), 1.0)
            return a_p, a_d

        def gap_of(sl_, ll_):
            g = _lane_sum(sl_[0] * ll_[0]) + _lane_sum(sl_[1] * ll_[1])
            g = g + _lane_sum(sl_[2] * ll_[2]) + _lane_sum(sl_[3] * ll_[3])
            return g / m_total

        if mehrotra:
            gap_now = gap_of(sl, ll)
            rc_a = tuple(sl[i] * ll[i] for i in range(4))
            _, _, ds_a, dl_a, stores = directions(rc_a)
            ap_a, ad_a = steps(ds_a, dl_a, 1.0)
            ap_, ad_ = ap_a[:, None, None, :], ad_a[:, None, None, :]
            gap_aff = gap_of(
                tuple(sl[i] + ap_ * ds_a[i] for i in range(4)),
                tuple(ll[i] + ad_ * dl_a[i] for i in range(4)),
            )
            sig = torch.clamp((gap_aff / torch.clamp_min(gap_now, 1e-16)) ** 3, 1e-4, 1.0)
            target = torch.clamp_min(sig * gap_now, 1e-14)[:, None, None, :]
            rc = tuple(sl[i] * ll[i] + ds_a[i] * dl_a[i] - target for i in range(4))
            ddx, ddu, ds, dl, _ = directions(rc, stores)
        else:
            mu_b = mu[:, None, None, :]
            ddx, ddu, ds, dl, _ = directions(tuple(sl[i] * ll[i] - mu_b for i in range(4)))

        a_p, a_d = steps(ds, dl, tau)
        ap_, ad_ = a_p[:, None, None, :], a_d[:, None, None, :]
        new = dict(
            dx=s["dx"] + ap_ * ddx, du=s["du"] + ap_ * ddu,
            slx=sl[0] + ap_ * ds[0], sux=sl[1] + ap_ * ds[1],
            slu=sl[2] + ap_ * ds[2], suu=sl[3] + ap_ * ds[3],
            llx=ll[0] + ad_ * dl[0], lux=ll[1] + ad_ * dl[1],
            llu=ll[2] + ad_ * dl[2], luu=ll[3] + ad_ * dl[3],
        )
        gap = gap_of(
            (new["slx"], new["sux"], new["slu"], new["suu"]),
            (new["llx"], new["lux"], new["llu"], new["luu"]),
        )
        return new, torch.clamp_min(sigma * gap, 1e-12)

    mu = torch.full((n, L), mu0, dtype=f32, device=dev)
    for _ in range(n_ip):
        if adaptive_tol is None:
            st, mu = ip_iter(st, mu)
            continue
        active = ~torch.all(mu <= adaptive_tol, dim=1)  # (n,) tile-wide vote
        if not bool(active.any()):
            break
        new, new_mu = ip_iter(st, mu)
        act = active[:, None, None, None]
        st = {k: torch.where(act, new[k], v) for k, v in st.items()}
        mu = torch.where(active[:, None], new_mu, mu)

    gap = (
        _lane_sum(st["slx"] * st["llx"]) + _lane_sum(st["sux"] * st["lux"])
        + _lane_sum(st["slu"] * st["llu"]) + _lane_sum(st["suu"] * st["luu"])
    ) / m_total
    return st["dx"], st["du"], gap


_QP_FIELDS_X1 = ("qdiag", "qx", "lx", "ux")  # (n, T+1, nx, L)
_QP_FIELDS_U = ("rdiag", "ru", "lu", "uu")  # (n, T, nu, L)


def solve_ocp_qp_lanes(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper with `solve_ocp_qp_lanes_plain`'s signature. CPU tensors
    take the plain version; CUDA tensors launch `ocp_ip_kernel`, one block per
    tile, with the per-scenario workspace allocated here."""
    dev = qp.A.device
    n, T, nx, _, L = qp.A.shape
    nu = qp.B.shape[3]
    check("A", qp.A, (n, T, nx, nx, L), dev)
    check("B", qp.B, (n, T, nx, nu, L), dev)
    check("r", qp.r, (n, T, nx, L), dev)
    for f in _QP_FIELDS_X1:
        check(f, getattr(qp, f), (n, T + 1, nx, L), dev)
    for f in _QP_FIELDS_U:
        check(f, getattr(qp, f), (n, T, nu, L), dev)
    if route(dev) == "plain":
        return solve_ocp_qp_lanes_plain(qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra)

    smem = 4 * (nx * nx + nx * (nx + nu)) * L
    if (nx, nu) != (12, 4) or n == 0 or T == 0 or smem > 232448:
        raise ValueError(
            f"ocp_ip kernel is built for nx=12, nu=4, T > 0 and L <= 172 (got nx={nx}, "
            f"nu={nu}, T={T}, L={L})"
        )
    lib = _build.load_library()
    ws = torch.empty(n, lib.ocp_ip_workspace_floats(T), L, dtype=torch.float32, device=dev)
    dx = torch.empty(n, T + 1, nx, L, dtype=torch.float32, device=dev)
    du = torch.empty(n, T, nu, L, dtype=torch.float32, device=dev)
    gap = torch.empty(n, L, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        "ocp_ip_launch", *(p(t) for t in qp), p(dx), p(du), p(gap), p(ws),
        n, T, L, int(n_ip), float(mu0), float(sigma), float(tau),
        -1.0 if adaptive_tol is None else float(adaptive_tol), int(mehrotra),
        _build.stream_handle(dev),
    )
    solve_ocp_qp_lanes.launches += 1
    return dx, du, gap


solve_ocp_qp_lanes.launches = 0

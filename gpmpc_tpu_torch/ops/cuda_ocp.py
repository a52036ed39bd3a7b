"""Box-constrained OCP-QP interior point in lanes layout: kernels 4, 5 and 6
of the port.

Port of `gpmpc_tpu/ops/pallas_ocp.py`'s three solvers: `solve_ocp_qp_lanes`
(the resident kernel), `solve_ocp_qp_lanes_streamed` (tier 1) and
`solve_ocp_qp_lanes_streamed2` (tier 2), each with plain centering or
Mehrotra, a fixed iteration count or the tile-wide adaptive exit, and hard or
L1-soft state bounds (`soft_rho`). The CUDA kernels share
two headers; each of the six variants (three tiers, hard and soft) has
its own source and entry points, instantiated for the (nx, nu) pairs in
`_wrap.KERNEL_SHAPES`. The resident kernel and tier 2
(`csrc/ocp_ip_resident.cuh`) give each scenario a team of threads and spread
a tile over a thread-block cluster (`resident_geometry`): tier 2 is the
resident kernel instantiated under its own names. Tier 1 (`csrc/ocp_ip.cuh`)
runs one thread per scenario and one block per tile. Beside each wrapper
stands the same algorithm in plain PyTorch (`*_plain`), which the wrapper
runs for CPU tensors: the streamed tiers' plain versions keep the TPU
kernels' arithmetic, with no factorization between the two sweeps of a
Mehrotra iteration, so their corrector repeats the matrix sweep (the tier-2
kernel keeps the affine sweep's factorization, whose matrices are the same).
Unlike the reference, which takes one tile per call, all of them take every
tile at once: arrays lead with n_tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, check_widths, route


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


def _ip_plain(qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho, refactor):
    """The interior point of all three kernels. `refactor` is the streamed
    kernels' arithmetic: the Mehrotra corrector repeats the full matrix sweep
    instead of reusing the affine sweep's factorization."""
    A, Bm = qp.A, qp.B
    n, T, nx, _, L = A.shape
    nu = Bm.shape[3]
    dev, f32 = A.device, torch.float32
    soft = soft_rho is not None
    if soft:
        # float32 validity floor of the soft mode: the adaptive exit doubles as
        # the numerical stop, so it is always on
        adaptive_tol = max(adaptive_tol or 0.0, 1e-8)
    s_min = 1e-2
    eye_x = torch.eye(nx, dtype=f32, device=dev)[None, :, :, None]
    eye_u = torch.eye(nu, dtype=f32, device=dev)[None, :, :, None]
    m_total = 2.0 * ((T + 1) * nx + T * nu) + (2.0 * (T + 1) * nx if soft else 0.0)
    target_floor, mu_floor = (1e-8, 1e-8) if soft else (1e-14, 1e-12)

    slu = torch.clamp_min(-qp.lu, s_min)
    suu = torch.clamp_min(qp.uu, s_min)
    st = dict(
        dx=torch.zeros(n, T + 1, nx, L, dtype=f32, device=dev),
        du=torch.zeros(n, T, nu, L, dtype=f32, device=dev),
        slu=slu, suu=suu, llu=mu0 / slu, luu=mu0 / suu,
    )
    if soft:
        # L1-soft state bounds in the bounded-multiplier form: s = dx + e - lx,
        # multipliers in (0, rho), one more pair e * nu = mu per bound, with
        # nu = rho - lam kept as state (rho - lam rounds to 0 once lam -> rho)
        slx = torch.clamp_min(s_min - qp.lx, s_min)
        sux = torch.clamp_min(qp.ux + s_min, s_min)
        llx = torch.clamp_max(mu0 / slx, 0.49 * soft_rho)
        lux = torch.clamp_max(mu0 / sux, 0.49 * soft_rho)
        st.update(
            slx=slx, sux=sux, llx=llx, lux=lux,
            elx=torch.full_like(slx, s_min), eux=torch.full_like(slx, s_min),
            nulx=soft_rho - llx, nuux=soft_rho - lux,
        )
    else:
        slx = torch.clamp_min(-qp.lx, s_min)
        sux = torch.clamp_min(qp.ux, s_min)
        st.update(slx=slx, sux=sux, llx=mu0 / slx, lux=mu0 / sux)

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
        sl = (s["slx"], s["sux"], s["slu"], s["suu"])
        ll = (s["llx"], s["lux"], s["llu"], s["luu"])
        r_slx = s["dx"] - qp.lx - sl[0]
        r_sux = qp.ux - s["dx"] - sl[1]
        r_slu = s["du"] - qp.lu - sl[2]
        r_suu = qp.uu - s["du"] - sl[3]
        if soft:
            el, nl = (s["elx"], s["eux"]), (s["nulx"], s["nuux"])
            r_slx = r_slx + el[0]
            r_sux = r_sux + el[1]
            # fused barrier weight w = lam nu / den, den = s nu + e lam: never
            # divides by a multiplier that may have underflowed; the floor on
            # den caps w at 1e6
            den = tuple(
                torch.maximum(sl[i] * nl[i] + el[i] * ll[i], ll[i] * nl[i] * 1e-6) for i in range(2)
            )
            w = tuple(ll[i] * nl[i] / den[i] for i in range(2))
        else:
            w = (ll[0] / sl[0], ll[1] / sl[1])
        sigx = w[0] + w[1]
        sigu = ll[2] / sl[2] + ll[3] / sl[3]
        rdyn = (
            _mv(A.flatten(0, 1), s["dx"][:, :T].flatten(0, 1)).unflatten(0, (n, T))
            + _mv(Bm.flatten(0, 1), s["du"].flatten(0, 1)).unflatten(0, (n, T))
            + qp.r - s["dx"][:, 1:]
        )

        def directions(rc, re, stores=None):
            """Newton directions for complementarity right-hand sides rc (the
            four box pairs) and re (the two soft pairs e * nu, else None)."""
            if soft:
                cg_l = (ll[0] * nl[0] * r_slx + nl[0] * rc[0] - ll[0] * re[0]) / den[0]
                cg_u = (ll[1] * nl[1] * r_sux + nl[1] * rc[1] - ll[1] * re[1]) / den[1]
                corr_x = cg_l - cg_u
            else:
                corr_x = (rc[0] + ll[0] * r_slx) / sl[0] - (rc[1] + ll[1] * r_sux) / sl[1]
            corr_u = (rc[2] + ll[2] * r_slu) / sl[2] - (rc[3] + ll[3] * r_suu) / sl[3]
            ddx, ddu, stores = solve_newton(s, rdyn, sigx, sigu, corr_x, corr_u, stores)
            ds_lu, ds_uu = ddu + r_slu, r_suu - ddu
            dl_lu = -(rc[2] + ll[2] * ds_lu) / sl[2]
            dl_uu = -(rc[3] + ll[3] * ds_uu) / sl[3]
            if soft:
                dl_lx = -(w[0] * ddx + cg_l)
                dl_ux = w[1] * ddx - cg_u
                de = ((-re[0] + el[0] * dl_lx) / nl[0], (-re[1] + el[1] * dl_ux) / nl[1])
                ds_lx = ddx + de[0] + r_slx
                ds_ux = -ddx + de[1] + r_sux
            else:
                ds_lx, ds_ux = ddx + r_slx, r_sux - ddx
                dl_lx = -(rc[0] + ll[0] * ds_lx) / sl[0]
                dl_ux = -(rc[1] + ll[1] * ds_ux) / sl[1]
                de = None
            return ddx, ddu, (ds_lx, ds_ux, ds_lu, ds_uu), (dl_lx, dl_ux, dl_lu, dl_uu), de, stores

        def steps(ds, dl, de, t):
            a_p = torch.stack([_lane_min(_ratio(sl[i], ds[i], t)) for i in range(4)]).amin(0)
            a_d = torch.stack([_lane_min(_ratio(ll[i], dl[i], t)) for i in range(4)]).amin(0)
            if soft:  # e stays positive (primal), nu = rho - lam positive (dual)
                for i in range(2):
                    a_p = torch.minimum(a_p, _lane_min(_ratio(el[i], de[i], t)))
                    a_d = torch.minimum(a_d, _lane_min(_ratio(nl[i], -dl[i], t)))
            return torch.clamp_max(a_p, 1.0), torch.clamp_max(a_d, 1.0)

        def gap_of(sl_, ll_, el_=None, nl_=None):
            g = _lane_sum(sl_[0] * ll_[0]) + _lane_sum(sl_[1] * ll_[1])
            g = g + _lane_sum(sl_[2] * ll_[2]) + _lane_sum(sl_[3] * ll_[3])
            if soft:
                g = g + _lane_sum(el_[0] * nl_[0]) + _lane_sum(el_[1] * nl_[1])
            return g / m_total

        prod = tuple(sl[i] * ll[i] for i in range(4))
        prod_e = tuple(el[i] * nl[i] for i in range(2)) if soft else None
        if mehrotra:
            gap_now = gap_of(sl, ll, *((el, nl) if soft else ()))
            _, _, ds_a, dl_a, de_a, stores = directions(prod, prod_e)
            ap_a, ad_a = steps(ds_a, dl_a, de_a, 1.0)
            ap_, ad_ = ap_a[:, None, None, :], ad_a[:, None, None, :]
            gap_aff = gap_of(
                tuple(sl[i] + ap_ * ds_a[i] for i in range(4)),
                tuple(ll[i] + ad_ * dl_a[i] for i in range(4)),
                *((tuple(el[i] + ap_ * de_a[i] for i in range(2)),
                   tuple(nl[i] - ad_ * dl_a[i] for i in range(2))) if soft else ()),
            )
            sig = torch.clamp((gap_aff / torch.clamp_min(gap_now, 1e-16)) ** 3, 1e-4, 1.0)
            target = torch.clamp_min(sig * gap_now, target_floor)[:, None, None, :]
            rc = tuple(prod[i] + ds_a[i] * dl_a[i] - target for i in range(4))
            # d(e) d(nu) = -de_aff dlam_aff for the soft pairs
            re = tuple(prod_e[i] - de_a[i] * dl_a[i] - target for i in range(2)) if soft else None
            ddx, ddu, ds, dl, de, _ = directions(rc, re, None if refactor else stores)
        else:
            mu_b = mu[:, None, None, :]
            ddx, ddu, ds, dl, de, _ = directions(
                tuple(c - mu_b for c in prod), tuple(c - mu_b for c in prod_e) if soft else None
            )

        a_p, a_d = steps(ds, dl, de, tau)
        ap_, ad_ = a_p[:, None, None, :], a_d[:, None, None, :]
        new = dict(
            dx=s["dx"] + ap_ * ddx, du=s["du"] + ap_ * ddu,
            slx=sl[0] + ap_ * ds[0], sux=sl[1] + ap_ * ds[1],
            slu=sl[2] + ap_ * ds[2], suu=sl[3] + ap_ * ds[3],
            llx=ll[0] + ad_ * dl[0], lux=ll[1] + ad_ * dl[1],
            llu=ll[2] + ad_ * dl[2], luu=ll[3] + ad_ * dl[3],
        )
        if soft:
            new.update(
                elx=el[0] + ap_ * de[0], eux=el[1] + ap_ * de[1],
                nulx=nl[0] - ad_ * dl[0], nuux=nl[1] - ad_ * dl[1],
            )
        return new, torch.clamp_min(sigma * final_gap(new), mu_floor)

    def final_gap(s):
        g = (
            _lane_sum(s["slx"] * s["llx"]) + _lane_sum(s["sux"] * s["lux"])
            + _lane_sum(s["slu"] * s["llu"]) + _lane_sum(s["suu"] * s["luu"])
        )
        if soft:
            g = g + _lane_sum(s["elx"] * s["nulx"]) + _lane_sum(s["eux"] * s["nuux"])
        return g / m_total

    mu = torch.full((n, L), mu0, dtype=f32, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)  # per tile, as the kernels count them
    for _ in range(n_ip):
        if adaptive_tol is None:
            st, mu = ip_iter(st, mu)
            iters += 1
            continue
        active = ~torch.all(mu <= adaptive_tol, dim=1)  # (n,) tile-wide vote
        if not bool(active.any()):
            break
        new, new_mu = ip_iter(st, mu)
        act = active[:, None, None, None]
        st = {k: torch.where(act, new[k], v) for k, v in st.items()}
        mu = torch.where(active[:, None], new_mu, mu)
        iters += active.to(torch.int32)
    return st["dx"], st["du"], final_gap(st), iters


def solve_ocp_qp_lanes_plain(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
    soft_rho: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx (n,T+1,nx,L), du (n,T,nu,L), gap (n,L)). With `adaptive_tol`, a tile
    stops iterating once every lane in it has mu <= adaptive_tol. `soft_rho`
    is the L1 penalty weight that makes the state bounds soft; it floors
    `adaptive_tol` at 1e-8, so the tile-wide exit is then always on."""
    *out, solve_ocp_qp_lanes_plain.last_iterations = _ip_plain(
        qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho, refactor=False)
    return tuple(out)


def solve_ocp_qp_lanes_streamed_plain(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
    soft_rho: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the tier-1 streamed kernel: the resident interior
    point without factorization stores (two matrix sweeps per Mehrotra
    iteration)."""
    *out, solve_ocp_qp_lanes_streamed_plain.last_iterations = _ip_plain(
        qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho, refactor=True)
    return tuple(out)


def solve_ocp_qp_lanes_streamed2_plain(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
    soft_rho: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the tier-2 kernel: the TPU kernel's arithmetic, which is
    tier 1's (the CUDA kernel keeps the affine sweep's factorization for the
    corrector; its matrices are the ones the repeated sweep forms)."""
    *out, solve_ocp_qp_lanes_streamed2_plain.last_iterations = _ip_plain(
        qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho, refactor=True)
    return tuple(out)


class ResidentGeometry(NamedTuple):
    """Launch geometry of the resident kernel for one tile width: `team`
    threads a scenario, `scenarios_per_block` scenarios a block, `cluster`
    blocks a tile, `shared_bytes` of shared memory a block."""

    team: int
    scenarios_per_block: int
    cluster: int
    shared_bytes: int

    @property
    def threads(self) -> int:
        return self.team * self.scenarios_per_block


# Scenarios a block of the resident kernel takes, by (nx, nu): 8 x 16 threads
# at 12x4 (a tile of 128 lanes is a cluster of 16 blocks), 16 x 8 threads at
# the narrow widths (a cluster of 8). The smaller blocks measured faster on
# the card than 16 and 64 (scripts/bench_resident_geometry_torch.py, PERF.md).
RESIDENT_SCENARIOS_PER_BLOCK = {(12, 4): 8, (4, 1): 16, (4, 2): 16}
RESIDENT_MAX_THREADS = 256  # csrc/ocp_ip_resident.cuh::kMaxThreads
RESIDENT_MAX_CLUSTER = 16  # past the portable 8: the kernel allows the H100's 16


def resident_geometry(nx: int, nu: int, L: int) -> ResidentGeometry:
    """The resident kernel's launch geometry (kernel 4, and tier 2 on the
    same code) for tiles of L lanes: the team is the power of two at or above
    nx + nu; a tile is split over the fewest blocks (at most 16, a cluster)
    that keep a block at or under its scenarios-per-block target. Raises for
    a tile the cluster cannot split evenly or a block past 256 threads.
    Shared memory, as the kernel lays it out (csrc/ocp_ip_resident.cuh::Cfg):
    two stage slabs of [A_k | B_k] for the block's scenarios, rows padded to
    16-byte quads; per scenario W, the dynamics residual, F, K, Guu and gu,
    and two state vectors; each scenario's area an odd number of quads; and
    two vote slots."""
    if (nx, nu) not in RESIDENT_SCENARIOS_PER_BLOCK:
        raise ValueError(f"ocp_ip kernel is instantiated for (nx, nu) in "
                         f"{tuple(RESIDENT_SCENARIOS_PER_BLOCK)}, got ({nx}, {nu})")
    team = 1 << (nx + nu - 1).bit_length()
    target = RESIDENT_SCENARIOS_PER_BLOCK[(nx, nu)]
    cluster = min(RESIDENT_MAX_CLUSTER, -(-L // target))
    spb = L // cluster if L > 0 else 0
    if L <= 0 or L % cluster or spb * team > RESIDENT_MAX_THREADS:
        raise ValueError(
            f"ocp_ip kernel: a tile of L={L} lanes does not split over a cluster of at most "
            f"{RESIDENT_MAX_CLUSTER} blocks of at most {RESIDENT_MAX_THREADS // team} scenarios "
            f"({team} threads each) at (nx, nu) = ({nx}, {nu})"
        )
    row = -(-(nx + nu) // 4) * 4  # a row of [A_k | B_k] padded to 16-byte quads
    slab = _odd_quads(nx * row)
    team_floats = _odd_quads(nx * row + 2 * nx + nu * nx + nu * nu + nu + 2 * nx)
    smem = 4 * (2 * slab * spb + spb * team_floats + 2)
    return ResidentGeometry(team, spb, cluster, smem)


def _odd_quads(n: int) -> int:
    """n floats rounded up to an odd number of 16-byte quads
    (csrc/ocp_ip_resident.cuh::odd_quads)."""
    q = -(-n // 4)
    return 4 * (q if q % 2 else q + 1)


_QP_FIELDS_X1 = ("qdiag", "qx", "lx", "ux")  # (n, T+1, nx, L)
_QP_FIELDS_U = ("rdiag", "ru", "lu", "uu")  # (n, T, nu, L)


def _solve_on_card(wrapper, kernel, plain, qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra,
                   soft_rho, check_free=False, resident=False):
    """Shared body of the three wrappers: checks, the plain route for CPU
    tensors, workspace and outputs, the launch, the wrapper's count and the
    iterations each tile ran. The workspace's size is the library's
    (`workspace_floats` of `csrc/ocp_ip_resident.cuh` or `csrc/ocp_ip.cuh`);
    with `check_free` it is held against the card's free memory before
    anything is allocated. `resident` launches with `resident_geometry`."""
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
    if soft_rho is not None and not soft_rho > 0:
        raise ValueError(f"soft_rho must be positive, got {soft_rho}")
    if route(dev) == "plain":
        return plain(qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho)

    check_widths(kernel, nx, nu)
    if n == 0 or T == 0:
        raise ValueError(f"{kernel} kernel needs n_tiles > 0 and T > 0 (n_tiles={n}, T={T})")
    if resident:
        geom = resident_geometry(nx, nu, L)
        extra = (geom.team, geom.cluster)
    else:
        smem = 4 * (nx * nx + nx * (nx + nu)) * L
        if smem > 232448 or L > 1024:
            raise ValueError(
                f"{kernel} kernel needs {smem} <= 232448 bytes of shared memory per block and "
                f"L <= 1024 (nx={nx}, nu={nu}, L={L})"
            )
        extra = ()
    soft = soft_rho is not None
    if soft:
        adaptive_tol = max(adaptive_tol or 0.0, 1e-8)
    name = kernel + ("_soft" if soft else "")
    lib = _build.load_library()
    ws_floats = getattr(lib, name + "_workspace_floats")(T, nx, nu)
    if check_free:
        ws_bytes, free = 4 * n * ws_floats * L, torch.cuda.mem_get_info(dev)[0]
        if ws_bytes > free:
            raise ValueError(
                f"{name}: the workspace of {n} tiles at T={T} takes {ws_bytes} bytes, the card "
                f"has {free} free; solve fewer scenarios per call"
            )
    ws = torch.empty(n, ws_floats, L, dtype=torch.float32, device=dev)
    dx = torch.empty(n, T + 1, nx, L, dtype=torch.float32, device=dev)
    du = torch.empty(n, T, nu, L, dtype=torch.float32, device=dev)
    gap = torch.empty(n, L, dtype=torch.float32, device=dev)
    n_iters = torch.empty(n, dtype=torch.int32, device=dev)
    p = _build.ptr
    _build.launch(
        name + "_launch", *(p(t) for t in qp), p(dx), p(du), p(gap), p(n_iters), p(ws),
        n, T, L, nx, nu, int(n_ip), float(mu0), float(sigma), float(tau),
        -1.0 if adaptive_tol is None else float(adaptive_tol), int(mehrotra),
        float(soft_rho) if soft else 0.0, *extra, _build.stream_handle(dev),
    )
    wrapper.launches += 1
    wrapper.last_iterations = n_iters
    return dx, du, gap


def solve_ocp_qp_lanes(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
    soft_rho: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resident kernel, with `solve_ocp_qp_lanes_plain`'s signature. CPU
    tensors take the plain version; CUDA tensors launch `csrc/ocp_ip.cu`
    (`csrc/ocp_ip_soft.cu` with `soft_rho`): a cluster of blocks per tile and
    a team of threads per scenario (`resident_geometry`), with the
    per-scenario workspace allocated here."""
    return _solve_on_card(
        solve_ocp_qp_lanes, "ocp_ip", solve_ocp_qp_lanes_plain,
        qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho, resident=True,
    )


def solve_ocp_qp_lanes_streamed(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
    soft_rho: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tier-1 streamed kernel (`csrc/ocp_ip_streamed.cu`, `..._soft.cu`): the
    same interior point with no factorization stores and a smaller workspace,
    for horizons past the resident cap."""
    return _solve_on_card(
        solve_ocp_qp_lanes_streamed, "ocp_ip_streamed", solve_ocp_qp_lanes_streamed_plain,
        qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho,
    )


def solve_ocp_qp_lanes_streamed2(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
    soft_rho: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tier-2 kernel (`csrc/ocp_ip_streamed2.cu`, `..._soft.cu`), for the
    longest horizons of the lanes path: the resident kernel under tier 2's
    names (`resident_geometry`, the Mehrotra stores kept). Its workspace is
    the largest a wrapper allocates, so it is checked against the card's
    free memory first."""
    return _solve_on_card(
        solve_ocp_qp_lanes_streamed2, "ocp_ip_streamed2", solve_ocp_qp_lanes_streamed2_plain,
        qp, n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho, check_free=True,
        resident=True,
    )


# launches: kernel launches so far. last_iterations: (n_tiles,) int32, the
# interior-point iterations each tile of the last call ran (the plain
# versions count them as the kernels do).
for _w in (solve_ocp_qp_lanes, solve_ocp_qp_lanes_streamed, solve_ocp_qp_lanes_streamed2):
    _w.launches = 0
    _w.last_iterations = None
for _w in (solve_ocp_qp_lanes_plain, solve_ocp_qp_lanes_streamed_plain,
           solve_ocp_qp_lanes_streamed2_plain):
    _w.last_iterations = None

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips when no CUDA card is present. Imports torch and
the port only (the card's machine has no JAX), so run it there without the
suite's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch import _build, convert, roofline
from gpmpc_tpu_torch.control.gpmpc import softplus
from gpmpc_tpu_torch.ops import cuda_chain, cuda_gp, cuda_linearize, cuda_ocp, cuda_tighten

pytestmark = pytest.mark.gpu

LANES = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda:0")


def _t(a, dev):
    return torch.as_tensor(np.array(a, np.float32, order="C"), device=dev)


def _maxdiff(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize(
    "n,ard,family",
    [(300, False, "quadrotor"), (25_600, False, "quadrotor"), (1000, True, "quadrotor"),
     (25_600, False, "cartpole"), (25_600, False, "twolink"), (1000, True, "twolink")],
)
def test_gp_kernel_matches_plain(dev, n, ard, family):
    """D = 3 (quadrotor, cartpole) and D = 6 (two-link arm) queries."""
    rng = np.random.default_rng(n)
    gp = convert.load_bench_gp(dev, family)
    D = gp.var_Z.shape[2]
    pad = 128 - gp.var_Z.shape[1]
    F = torch.nn.functional
    ell = softplus(gp.hypers.raw_lengthscale[0])
    if ard:
        ell = _t(np.linspace(0.7, 1.6, D), dev)
    args = (
        _t(rng.normal(0, 0.4, (n, D)), dev), F.pad(gp.var_Z[0], (0, 0, 0, pad)),
        F.pad(gp.alpha_s[0], (0, pad)), F.pad(gp.var_mat[0], (0, pad, 0, pad)),
        ell, softplus(gp.hypers.raw_outputscale[0]), softplus(gp.hypers.raw_noise[0]),
        F.pad(gp.var_mask[0], (0, pad)),
    )
    before = cuda_gp.gp_mean_var_multi.launches
    mean_k, var_k = cuda_gp.gp_mean_var(*args, include_noise=True)
    mean_p, var_p = cuda_gp.gp_mean_var_plain(*args, include_noise=True)
    torch.cuda.synchronize()
    assert cuda_gp.gp_mean_var_multi.launches == before + 1
    assert _maxdiff(mean_k, mean_p) <= 1e-4
    assert _maxdiff(var_k, var_p) <= 1e-4


def _gp_leaves(dev, G, D, seed, m=128, n_live=40, density=None):
    """G GPs of m padded points, n_live - 3 g live ones each at scattered
    positions (not a prefix); masked points keep nonzero inputs and W. With
    `density`, the lengthscales shrink by (density / n_live)^(1/D) (as many
    points within a lengthscale as `density` points at the unscaled ones)."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(G, m, D))
    mask = np.zeros((G, m))
    W, alpha = np.zeros((G, m, m)), np.zeros((G, m))
    ell = np.linspace(0.7, 1.6, G * D).reshape(G, D)
    if density is not None:
        ell = ell * (density / n_live) ** (1.0 / D)
    sf2, noise = np.linspace(0.8, 1.5, G), np.linspace(0.03, 0.08, G)
    for g in range(G):
        mask[g, np.sort(rng.choice(m, size=n_live - 3 * g, replace=False))] = 1.0
        diff = (Z[g][:, None, :] - Z[g][None, :, :]) / ell[g]
        K = sf2[g] * np.exp(-0.5 * (diff**2).sum(-1)) * np.outer(mask[g], mask[g])
        W[g] = np.linalg.inv(K + np.diag(noise[g] * mask[g] + (1 - mask[g])))
        alpha[g] = W[g] @ (rng.normal(size=m) * mask[g])
    return [_t(a, dev) for a in (Z, alpha, W, ell, sf2, noise, mask)]


@pytest.mark.parametrize("n", [300, 25_637])  # 25,637: not a multiple of the 128-query tile
@pytest.mark.parametrize("G,D", [(2, 3), (3, 3), (2, 6), (3, 6)])
def test_gp_multi_kernel_matches_plain(dev, G, D, n):
    """All G GPs in one launch on the packed form (live points only, 40, 37
    and 34 of 128, scattered), against G calls of the plain version."""
    form = cuda_gp.pack_form(*_gp_leaves(dev, G, D, seed=G * 10 + D))
    assert form.Z.shape[1] == 40
    z = _t(np.random.default_rng(n).normal(0, 0.6, (G, n, D)), dev)
    before = cuda_gp.gp_mean_var_multi.launches
    mean_k, var_k = cuda_gp.gp_mean_var_multi(z, form, include_noise=True)
    mean_p, var_p = cuda_gp.gp_mean_var_multi_plain(z, form, include_noise=True)
    torch.cuda.synchronize()
    assert cuda_gp.gp_mean_var_multi.launches == before + 1
    assert mean_k.shape == var_k.shape == (G, n)
    assert _maxdiff(mean_k, mean_p) <= 1e-4
    assert _maxdiff(var_k, var_p) <= 1e-4


@pytest.mark.parametrize("density", [None, 40])
@pytest.mark.parametrize("m,n", [(136, 25_637), (304, 25_637), (512, 25_637), (2048, 4096)])
@pytest.mark.parametrize("G,D", [(2, 6), (3, 3)])
def test_gp_tiled_kernel_matches_plain(dev, G, D, m, n, density):
    """Past 128 live points (F7): the tiled instantiation, on GPs whose live
    points are scattered, at their own lengthscales and at those of 40
    points' density. With d the plain version's distance from its own
    float64 evaluation on the same inputs (float32 cancels in k W k^T), the
    kernel lies within 1e-4 + d of both the plain version and the float64
    value. Its sums run in float64, so it also lies within 1e-4 + d32 of
    the float64 value, d32 the distance of k's float32 rounding alone (the
    plain version's k with float64 sums)."""
    form = cuda_gp.pack_form(*_gp_leaves(dev, G, D, seed=m + G, m=m + 16, n_live=m,
                                         density=density))
    assert form.Z.shape[1] == m and cuda_gp.gp_geometry(m, D).bucket == 0
    z = _t(np.random.default_rng(n).normal(0, 0.6, (G, n, D)), dev)
    before = cuda_gp.gp_mean_var_multi.launches
    out_k = cuda_gp.gp_mean_var_multi(z, form, include_noise=True)
    out_p = cuda_gp.gp_mean_var_multi_plain(z, form, include_noise=True)
    out_64 = cuda_gp.gp_mean_var_multi_plain(z.double(), cuda_gp.GpForm(*[t.double() for t in form]),
                                             include_noise=True)
    torch.cuda.synchronize()
    assert cuda_gp.gp_mean_var_multi.launches == before + 1
    d = max(_maxdiff(a.double(), b) for a, b in zip(out_p, out_64))
    assert max(_maxdiff(a.double(), b) for a, b in zip(out_k, out_64)) <= 1e-4 + d
    assert max(_maxdiff(a, b) for a, b in zip(out_k, out_p)) <= 1e-4 + d
    k32 = torch.stack([cuda_gp.se_kernel(z[g], form.Z[g], form.lengthscale[g], form.outputscale[g])
                       * form.mask[g] for g in range(G)]).double()
    mean_32 = torch.einsum("gnm,gm->gn", k32, form.alpha.double())
    var_32 = torch.clamp_min(form.outputscale.double()[:, None]
                             - (torch.einsum("gnm,gmk->gnk", k32, form.W.double()) * k32).sum(-1),
                             1e-12) + form.noise.double()[:, None]
    d32 = max(_maxdiff(a, b) for a, b in zip((mean_32, var_32), out_64))
    assert max(_maxdiff(a.double(), b) for a, b in zip(out_k, out_64)) <= 1e-4 + d32


def _train_data(dev, n=120, cap=128, seed=0):
    from gpmpc_tpu_torch.control.gpmpc import pack_training_data
    from gpmpc_tpu_torch.utils.benchkit import synthetic_residual_dataset

    x7, y3 = synthetic_residual_dataset(n, seed)
    return pack_training_data(torch.as_tensor(x7, device=dev), torch.as_tensor(y3, device=dev), cap)


@pytest.mark.parametrize("sparse", [True, False])
def test_trained_model_on_the_card_matches_the_cpus(dev, sparse):
    """train_gp_models on the card and on the CPU from the same data (120
    points, 40 Adam iterations: before any freeze) and the same generator
    seed: the raw hypers within 1e-4 (float32 Cholesky on two libraries),
    every leaf on the card."""
    from gpmpc_tpu_torch.control.gpmpc import train_gp_models

    out = {}
    for where in (dev, torch.device("cpu")):
        data = _train_data(where)
        gen = torch.Generator(device=where).manual_seed(0)
        out[where.type] = train_gp_models(data, gen, sparse=sparse, max_inducing=40, n_train=40,
                                          lr=0.05, return_info=True)
    (card, info_card), (cpu, info_cpu) = out["cuda"], out["cpu"]
    assert info_card.freeze_step.tolist() == info_cpu.freeze_step.tolist() == [-1, -1, -1]
    for a, b in zip(card.hypers, cpu.hypers):
        assert _maxdiff(a.cpu(), b) <= 1e-4
    for leaf in (card.Z, card.y, card.mask, *card.hypers, card.Zs, card.alpha_s, card.var_Z,
                 card.var_mat, card.var_mask, card.trained):
        assert leaf.device.type == "cuda"


def test_train_gp_leaves_nothing_on_the_cpu(dev):
    """GPMPC.train_gp on the card: the new GpModel's every leaf on the card,
    new tensors (none of the untrained model's)."""
    from gpmpc_tpu_torch.control.gpmpc import GPMPC
    from gpmpc_tpu_torch.envs import drone
    from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS
    from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
    from gpmpc_tpu_torch.utils.benchkit import Q_MPC, R_MPC, synthetic_residual_dataset

    env_p = drone.EnvParams.default()
    ctrl = GPMPC(symbolic_attitude(dt=0.02, params=PRIOR_PARAMS._asdict()),
                 drone.make_trajectory(env_p, dev).cpu().numpy(), PRIOR_PARAMS._asdict(), horizon=10,
                 q_mpc=Q_MPC, r_mpc=R_MPC, sparse_gp=True, max_gp_samples=20, device=dev)
    old = ctrl.gp_model
    ctrl.train_gp(*synthetic_residual_dataset(60, 0), lr=0.05, iterations=20)
    leaves = [v for f in ctrl.gp_model for v in (f if isinstance(f, tuple) else (f,))]
    assert all(t.device.type == "cuda" for t in leaves)
    olds = [v for f in old for v in (f if isinstance(f, tuple) else (f,))]
    assert not any(t is o for t in leaves for o in olds)
    u = ctrl.select_action(drone.make_trajectory(env_p, dev)[0].cpu().numpy())
    assert np.all(np.isfinite(u))


# (nx, nu, uncertain rows) of the quadrotor, the cartpole and the two-link arm
WIDTHS = [(12, 4, [1, 3, 5, 9, 10]), (4, 1, [1, 3]), (4, 2, [2, 3])]


@pytest.mark.parametrize("nx,nu,unc", WIDTHS)
@pytest.mark.parametrize("B,T", [(5, 7), (1024, 25), (1, 1), (1000, 25), (256, 512)])
def test_tighten_kernel_matches_plain(dev, B, T, nx, nu, unc):
    """The direct form on the card against the recursion, one wrapper launch
    a call. At T=512 the perturbations of A, B and K are halved, so that the
    covariance stays inside float32 (at full size it overflows at 12x4), and
    the reference is the recursion in float64: on this data the float32
    recursion itself drifts from it by more than the bar at 12x4, where the
    direct form stays well inside it."""
    rng = np.random.default_rng(B)
    s = 0.5 if T > 100 else 1.0
    A = np.eye(nx) + 0.02 * s * rng.normal(size=(nx, nx))
    args = (
        _t(rng.uniform(1e-6, 4e-4, (B, T, len(unc))), dev), _t(A, dev),
        _t(0.05 * s * rng.normal(size=(nx, nu)), dev), _t(0.3 * s * rng.normal(size=(nu, nx)), dev),
        _t(np.eye(nx)[:, unc], dev), _t(1.7, dev),
    )
    before = cuda_tighten.tighten_lanes.launches
    tx_k, tu_k = cuda_tighten.tighten_lanes(*args)
    assert cuda_tighten.tighten_lanes.launches == before + 1
    if T > 100:
        tx_p, tu_p = (t.float() for t in cuda_tighten.tighten_lanes_plain(*(a.double() for a in args)))
    else:
        tx_p, tu_p = cuda_tighten.tighten_lanes_plain(*args)
    torch.cuda.synchronize()
    assert tx_k.shape == (B, T + 1, nx) and tu_k.shape == (B, T, nu)
    assert _maxdiff(tx_k, tx_p) <= 1e-5 * max(1.0, float(tx_p.abs().max()))
    assert _maxdiff(tu_k, tu_p) <= 1e-5 * max(1.0, float(tu_p.abs().max()))


PAR8 = {
    "quadrotor": [12.1432, 1.8118, -72.08, -7.5755, 39.8653, -72.08, -7.5755, 39.8653],
    "cartpole": [1.0, 0.1, 0.5, 0, 0, 0, 0, 0],
    "twolink": [1.0, 1.0, 1.0, 1.0, 0, 0, 0, 0],
}


def _states_inputs(family, rng, n_tiles, T, L=LANES):
    """States and inputs in each family's operating range (as the reference's
    tests/test_pallas_linearize.py draws them), L lanes a tile."""
    x_shape, u_shape = (n_tiles, T + 1, L), (n_tiles, T, L)
    if family == "quadrotor":
        X = rng.normal(0, 0.3, (n_tiles, T + 1, 12, L))
        U = np.stack([rng.uniform(0.15, 0.55, u_shape)]
                     + [rng.uniform(-0.3, 0.3, u_shape) for _ in range(3)], axis=2)
    elif family == "cartpole":
        X = rng.normal(0, 0.3, (n_tiles, T + 1, 4, L))
        U = rng.uniform(-5.0, 5.0, (n_tiles, T, 1, L))
    else:
        X = np.stack([rng.uniform(-2.0, 0.2, x_shape), rng.uniform(-0.4, 1.8, x_shape),
                      rng.normal(0, 0.8, x_shape), rng.normal(0, 0.8, x_shape)], axis=2)
        U = rng.uniform(-12.0, 12.0, (n_tiles, T, 2, L))
    return X, U


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
@pytest.mark.parametrize(
    "n_tiles,T,L,use_gp,n_pad",
    [(1, 5, LANES, True, 0), (1, 5, LANES, False, 0), (8, 25, LANES, True, 0),
     (1, 1, LANES, True, 0), (1, 1, LANES, False, 0), (8, 100, LANES, True, 0),
     (8, 100, LANES, False, 0), (2, 25, LANES, True, 28), (2, 25, LANES, False, 28),
     (3, 7, 40, True, 0), (3, 7, 40, False, 0), (2, 25, 200, True, 0)],
)
def test_linearize_kernel_matches_plain(dev, n_tiles, T, L, use_gp, n_pad, family):
    """The family's team at T=1, T=100, with a batch whose last `n_pad`
    lanes are padding (zero states and inputs, as the SQP loop packs them),
    and at tile widths L that leave the last block's lanes past L idle (40
    and 200 are no multiple of a block's lanes at any team): finite and equal
    to the plain version everywhere. One wrapper launch a call."""
    rng = np.random.default_rng(T)
    gp = convert.load_bench_gp(dev, family)
    G, _, D = gp.Zs.shape
    X, U = _states_inputs(family, rng, n_tiles, T, L)
    if n_pad:
        X[-1, ..., L - n_pad:] = 0.0
        U[-1, ..., L - n_pad:] = 0.0
    ell = softplus(gp.hypers.raw_lengthscale)
    hyp = torch.cat([softplus(gp.hypers.raw_outputscale)[:, None],
                     (1.0 / ell**2)[:, None].expand(G, D)], dim=1).contiguous()
    args = (_t(PAR8[family], dev), hyp, gp.Zs, gp.alpha_s, _t(X, dev), _t(U, dev))
    kw = dict(dt=0.02, use_gp=use_gp, family=family)
    before = cuda_linearize.linearize_ocp_lanes.launches
    f_k, A_k, B_k = cuda_linearize.linearize_ocp_lanes(*args, **kw)
    f_p, A_p, B_p = cuda_linearize.linearize_ocp_lanes_plain(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_linearize.linearize_ocp_lanes.launches == before + 1
    assert all(bool(torch.isfinite(o).all()) for o in (f_k, A_k, B_k))
    assert _maxdiff(f_k, f_p) <= 2e-5
    assert _maxdiff(A_k, A_p) <= 2e-4
    assert _maxdiff(B_k, B_p) <= 2e-4


def _qp(dev, n_tiles, T, seed, nx=12, nu=4, box=1.5, scale=1.0):
    """tests/test_pallas_ocp.py::make_batch in lanes layout: `scale` contracts
    the dynamics perturbation (long horizons), `box` bounds stages 1..T."""
    rng = np.random.default_rng(seed)
    shp = lambda *s: (n_tiles, T) + s + (LANES,)  # noqa: E731
    lx = np.full((n_tiles, T + 1, nx, LANES), -box, np.float32)
    lx[:, 0] = -1e8
    A = np.eye(nx)[None, None, :, :, None] + 0.1 * scale * rng.normal(size=shp(nx, nx))
    return cuda_ocp.LanesQp(
        A=_t(A, dev),
        B=_t(0.4 * rng.normal(size=shp(nx, nu)), dev), r=_t(0.05 * rng.normal(size=shp(nx)), dev),
        qdiag=_t(rng.uniform(0.5, 2.0, (n_tiles, T + 1, nx, LANES)), dev),
        qx=_t(0.5 * rng.normal(size=(n_tiles, T + 1, nx, LANES)), dev),
        rdiag=_t(rng.uniform(0.5, 2.0, shp(nu)), dev), ru=_t(0.5 * rng.normal(size=shp(nu)), dev),
        lx=_t(lx, dev), ux=_t(-lx, dev), lu=_t(np.full(shp(nu), -0.3), dev),
        uu=_t(np.full(shp(nu), 0.3), dev),
    )


@pytest.mark.parametrize(
    "n_tiles,T,kw",
    [
        (1, 5, dict(n_ip=12)),
        (1, 5, dict(n_ip=10, mehrotra=True, adaptive_tol=1e-6)),
        (8, 25, dict(n_ip=10, mehrotra=True, adaptive_tol=1e-6)),
        (8, 25, dict(n_ip=10)),
    ],
)
@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 1), (4, 2)])
def test_ocp_kernel_matches_plain(dev, n_tiles, T, kw, nx, nu):
    qp = _qp(dev, n_tiles, T, seed=T, nx=nx, nu=nu)
    dx_k, du_k, gap_k = cuda_ocp.solve_ocp_qp_lanes(qp, **kw)
    dx_p, du_p, gap_p = cuda_ocp.solve_ocp_qp_lanes_plain(qp, **kw)
    assert bool(torch.isfinite(gap_k).all())
    assert _maxdiff(du_k, du_p) <= 5e-4
    assert _maxdiff(dx_k, dx_p) <= 5e-4
    assert float(du_k.abs().max()) <= 0.3 + 1e-4


@pytest.mark.parametrize("adaptive", [None, 1e-6], ids=["fixed", "exit"])
@pytest.mark.parametrize("mehrotra", [False, True], ids=["plain", "mehrotra"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 1), (4, 2)])
def test_resident_kernel_modes_match_plain(dev, nx, nu, soft, mehrotra, adaptive):
    """The resident kernel (a team of threads per scenario, a cluster of
    blocks per tile) in every mode at every width, two tiles at T=25: dx and
    du within 5e-4 of the plain version (chip_smoke.py TOL["ocp"]). Soft
    bounds floor the exit at 1e-8, so "fixed" runs the soft mode's own stop."""
    qp = _qp(dev, 2, 25, seed=7, nx=nx, nu=nu, box=0.15 if soft else 1.5)
    kw = dict(n_ip=10, mehrotra=mehrotra, adaptive_tol=adaptive)
    if soft:
        kw["soft_rho"] = 2.0 if nx == 12 else 0.5
    fn = cuda_ocp.solve_ocp_qp_lanes
    before = fn.launches
    dx_k, du_k, gap_k = fn(qp, **kw)
    dx_p, du_p, _ = cuda_ocp.solve_ocp_qp_lanes_plain(qp, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and fn.last_iterations.shape == (2,)
    assert bool(torch.isfinite(gap_k).all())
    assert _maxdiff(du_k, du_p) <= 5e-4 and _maxdiff(dx_k, dx_p) <= 5e-4


def _plain_iterations(qp, kw, n_max):
    """The IP iterations each tile of the plain version ran: the fewest after
    which its solution is that of n_max iterations (an exited tile is left
    as it is, bit for bit)."""
    ref = cuda_ocp.solve_ocp_qp_lanes_plain(qp, **dict(kw, n_ip=n_max))[1]
    counts = [None] * ref.shape[0]
    for m in range(n_max + 1):
        du = cuda_ocp.solve_ocp_qp_lanes_plain(qp, **dict(kw, n_ip=m))[1]
        for t in range(ref.shape[0]):
            if counts[t] is None and torch.equal(du[t], ref[t]):
                counts[t] = m
    return counts


def test_resident_kernel_tile_exit_counts_match_plain_across_the_cluster(dev):
    """Two tiles that exit at different IP iterations (the second has three
    times larger gradients), the second with 28 padded lanes (no dynamics
    and no gradient, as the SQP pads a batch): every block of a tile's
    cluster must leave at the iteration the plain version's 128-lane vote
    does, so the per-tile counts are equal, and the solutions agree."""
    qp = _qp(dev, 2, 25, seed=5)
    qp.qx[1] *= 3.0
    qp.ru[1] *= 3.0
    for f in ("A", "B", "r", "qx", "ru"):
        getattr(qp, f)[1, ..., 100:] = 0.0
    kw = dict(n_ip=10, mehrotra=True, adaptive_tol=1e-6)
    assert cuda_ocp.resident_geometry(12, 4, LANES).cluster > 1
    dx_k, du_k, _ = cuda_ocp.solve_ocp_qp_lanes(qp, **kw)
    counts_k = cuda_ocp.solve_ocp_qp_lanes.last_iterations.tolist()
    dx_p, du_p, _ = cuda_ocp.solve_ocp_qp_lanes_plain(qp, **kw)
    counts_p = _plain_iterations(qp, kw, 10)
    assert counts_k == counts_p and counts_p[0] != counts_p[1]
    assert _maxdiff(du_k, du_p) <= 5e-4 and _maxdiff(dx_k, dx_p) <= 5e-4


def test_resident_kernel_refuses_a_tile_the_cluster_cannot_split(dev):
    with pytest.raises(ValueError, match="does not split over a cluster"):
        cuda_ocp.solve_ocp_qp_lanes(_qp_lanes(dev, 100), n_ip=2)


def _qp_lanes(dev, lanes):
    """A one-tile QP of `lanes` lanes at 12x4, T=3."""
    full = _qp(dev, 1, 3, seed=0)
    return cuda_ocp.LanesQp(*(f[..., :lanes].contiguous() for f in full))


TIERS = {
    "resident": (cuda_ocp.solve_ocp_qp_lanes, cuda_ocp.solve_ocp_qp_lanes_plain, 25, 1.0),
    "streamed": (cuda_ocp.solve_ocp_qp_lanes_streamed, cuda_ocp.solve_ocp_qp_lanes_streamed_plain,
                 60, 0.3),
    "streamed2": (cuda_ocp.solve_ocp_qp_lanes_streamed2,
                  cuda_ocp.solve_ocp_qp_lanes_streamed2_plain, 60, 0.3),
}


@pytest.mark.parametrize("kw", [dict(n_ip=15), dict(n_ip=10, mehrotra=True, adaptive_tol=1e-6)],
                         ids=["plain", "mehrotra-exit"])
@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 1), (4, 2)])
@pytest.mark.parametrize("tier", list(TIERS))
def test_soft_ocp_kernels_match_plain(dev, tier, nx, nu, kw):
    """L1-soft state bounds in all three kernels, boxes of +-0.15 with a
    penalty below the hard multipliers, so the optimum violates them. 5e-4 as
    for the hard kernels: the barrier weights reach 1e6 before the exit and
    amplify float32 rounding differences on weakly determined states, so the
    soft differences lie nearer the bar than the hard ones."""
    fn, plain, T, scale = TIERS[tier]
    qp = _qp(dev, 2, T, seed=T, nx=nx, nu=nu, box=0.15, scale=scale)
    rho = 2.0 if nx == 12 else 0.5
    before = fn.launches
    dx_k, du_k, gap_k = fn(qp, soft_rho=rho, **kw)
    dx_p, du_p, _ = plain(qp, soft_rho=rho, **kw)
    assert fn.launches == before + 1 and fn.last_iterations.shape == (2,)
    assert bool(torch.isfinite(gap_k).all())
    assert float(dx_k[:, 1:].abs().max()) > 0.15 + 1e-3  # violates its boxes
    worst = max(_maxdiff(du_k, du_p), _maxdiff(dx_k, dx_p))
    print(f"soft {tier} {nx}x{nu}: max|kernel - plain| = {worst:.3e}")
    assert worst <= 5e-4


@pytest.mark.parametrize("kw", [dict(n_ip=12), dict(n_ip=10, mehrotra=True, adaptive_tol=1e-6)],
                         ids=["plain", "mehrotra-exit"])
@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 1), (4, 2)])
@pytest.mark.parametrize("tier", ["streamed", "streamed2"])
def test_streamed_ocp_kernels_match_plain(dev, tier, nx, nu, kw):
    fn, plain, T, scale = TIERS[tier]
    qp = _qp(dev, 2, T, seed=T, nx=nx, nu=nu, scale=scale)
    dx_k, du_k, _ = fn(qp, **kw)
    dx_p, du_p, _ = plain(qp, **kw)
    assert _maxdiff(du_k, du_p) <= 5e-4
    assert _maxdiff(dx_k, dx_p) <= 5e-4
    assert float(du_k.abs().max()) <= 0.3 + 1e-4


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 1), (4, 2)])
def test_tier2_kernel_matches_plain_with_per_tile_counts(dev, nx, nu, soft):
    """Kernel 6 (the resident kernel under tier 2's names) in all six
    instantiations just past tier 1's caps, T = 401 (321 soft): two tiles
    that exit at different IP iterations (the second has three times larger
    gradients), the second with 28 padded lanes (no dynamics and no
    gradient). The per-tile counts equal the plain version's, and the
    solutions agree within 5e-4."""
    T = 321 if soft else 401
    qp = _qp(dev, 2, T, seed=11, nx=nx, nu=nu, box=0.15 if soft else 1.5, scale=0.1)
    qp.qx[1] *= 3.0
    qp.ru[1] *= 3.0
    for f in ("A", "B", "r", "qx", "ru"):
        getattr(qp, f)[1, ..., 100:] = 0.0
    kw = dict(n_ip=10, mehrotra=True, adaptive_tol=1e-6)
    if soft:
        kw["soft_rho"] = 2.0 if nx == 12 else 0.5
    fn, plain = cuda_ocp.solve_ocp_qp_lanes_streamed2, cuda_ocp.solve_ocp_qp_lanes_streamed2_plain
    before = fn.launches
    dx_k, du_k, gap_k = fn(qp, **kw)
    dx_p, du_p, _ = plain(qp, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    counts_k, counts_p = fn.last_iterations.tolist(), plain.last_iterations.tolist()
    print(f"tier 2 {nx}x{nu} {'soft' if soft else 'hard'} T={T}: iterations {counts_k} / {counts_p}")
    assert counts_k == counts_p and counts_p[0] != counts_p[1]
    assert bool(torch.isfinite(gap_k).all())
    assert _maxdiff(du_k, du_p) <= 5e-4 and _maxdiff(dx_k, dx_p) <= 5e-4


@pytest.mark.parametrize("T", [100, "cap"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 1), (4, 2)])
def test_tier1_kernel_matches_plain_with_per_tile_counts(dev, nx, nu, soft, T):
    """Kernel 5 (the resident kernel under tier 1's names) in all six
    instantiations at T = 100 and at tier 1's caps (400, 320 soft): two tiles
    that exit at different IP iterations (the second has three times larger
    gradients), the second with 28 padded lanes (no dynamics and no
    gradient). Its plain version keeps the TPU kernel's arithmetic (the
    corrector repeats the matrix sweep); the per-tile counts equal the plain
    version's, and the solutions agree within 5e-4."""
    if T == "cap":
        T = 320 if soft else 400
    qp = _qp(dev, 2, T, seed=13, nx=nx, nu=nu, box=0.15 if soft else 1.5,
             scale=0.3 if T <= 100 else 0.1)
    qp.qx[1] *= 3.0
    qp.ru[1] *= 3.0
    for f in ("A", "B", "r", "qx", "ru"):
        getattr(qp, f)[1, ..., 100:] = 0.0
    kw = dict(n_ip=10, mehrotra=True, adaptive_tol=1e-6)
    if soft:
        kw["soft_rho"] = 2.0 if nx == 12 else 0.5
    fn, plain = cuda_ocp.solve_ocp_qp_lanes_streamed, cuda_ocp.solve_ocp_qp_lanes_streamed_plain
    before = fn.launches
    dx_k, du_k, gap_k = fn(qp, **kw)
    dx_p, du_p, _ = plain(qp, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    counts_k, counts_p = fn.last_iterations.tolist(), plain.last_iterations.tolist()
    print(f"tier 1 {nx}x{nu} {'soft' if soft else 'hard'} T={T}: iterations {counts_k} / "
          f"{counts_p}")
    assert counts_k == counts_p and counts_p[0] != counts_p[1]
    assert bool(torch.isfinite(gap_k).all())
    assert _maxdiff(du_k, du_p) <= 5e-4 and _maxdiff(dx_k, dx_p) <= 5e-4


def test_tier2_shared_bytes_match_the_library(dev):
    """Every QP tier's library reports the shared memory `resident_geometry`
    gives its block: the three tiers are one kernel."""
    lib = _build.load_library()
    for nx, nu in ((12, 4), (4, 1), (4, 2)):
        g = cuda_ocp.resident_geometry(nx, nu, LANES)
        for name in _build.OCP_IP_KERNELS:
            assert getattr(lib, name + "_shared_bytes")(nx, nu, g.scenarios_per_block) == \
                g.shared_bytes


def test_streamed_kernel_matches_resident_at_T100(dev):
    """Tier 1 is the resident kernel under its own names: on one QP the two
    give the same solution bit for bit and run the same per-tile counts."""
    qp = _qp(dev, 2, 100, seed=1, scale=0.3)
    kw = dict(n_ip=10, mehrotra=True, adaptive_tol=1e-6)
    res, tier1 = cuda_ocp.solve_ocp_qp_lanes, cuda_ocp.solve_ocp_qp_lanes_streamed
    out_r = res(qp, **kw)
    out_s = tier1(qp, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(r, s) for r, s in zip(out_r, out_s))
    assert res.last_iterations.tolist() == tier1.last_iterations.tolist()


@pytest.mark.parametrize("tier", list(TIERS))
def test_workspace_past_the_card_raises(dev, tier):
    """A call of any QP tier whose workspace the card cannot hold raises
    ValueError, with no launch. The allocator is held to the memory it has
    reserved plus half the workspace; at T = 400 the workspace (52 MB) is
    larger than any free block of a cached segment, so it needs a new one."""
    fn = TIERS[tier][0]
    qp = _qp(dev, 1, 400, seed=0, scale=0.1)
    name = {"resident": "ocp_ip"}.get(tier, "ocp_ip_" + tier)
    need = 4 * LANES * getattr(_build.load_library(), name + "_workspace_floats")(400, 12, 4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    before = fn.launches
    allowed = torch.cuda.memory_reserved(dev) + need // 2
    torch.cuda.set_per_process_memory_fraction(allowed / total, dev)
    try:
        with pytest.raises(ValueError, match="workspace of 1 tiles at T=400"):
            fn(qp, n_ip=1)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    assert fn.launches == before


def test_kernels_refuse_widths_they_are_not_built_for(dev):
    """A CUDA tensor of another (nx, nu) raises; it never takes the plain route."""
    with pytest.raises(ValueError, match="instantiated for"):
        cuda_ocp.solve_ocp_qp_lanes(_qp(dev, 1, 3, seed=0, nx=4, nu=3), n_ip=2)
    args = (_t(np.ones((3, 3, 2)), dev), _t(np.eye(6), dev), _t(np.zeros((6, 3)), dev),
            _t(np.zeros((3, 6)), dev), _t(np.eye(6)[:, :2], dev), _t(1.7, dev))
    with pytest.raises(ValueError, match="instantiated for"):
        cuda_tighten.tighten_lanes(*args)


CHAINS = {
    "lanes_chain": (cuda_chain.lanes_chain, cuda_chain.lanes_chain_plain, 128, False, torch.float32),
    "lanes_chain_bf16": (cuda_chain.lanes_chain_bf16, cuda_chain.lanes_chain_bf16_plain, 256, False,
                         torch.bfloat16),
    "lanes_chain_16": (cuda_chain.lanes_chain_16, cuda_chain.lanes_chain_16_plain, 128, True,
                       torch.float32),
}


def _chain_input(dev, lanes, pad, dtype, tiles=2, stages=3):
    mats = roofline.reference_mats(tiles * lanes, stages)
    if pad:
        mats = roofline.pad16_mats(mats, stages)
    return roofline.to_lanes(torch.as_tensor(mats, device=dev), lanes).to(dtype)


@pytest.mark.parametrize("n_chain", [0, 1, 4])
@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_kernels_match_plain(dev, name, n_chain):
    """The reference's data after a few rounds, where the chain is finite and
    of order one: float32 within 1e-5 of max(1, |plain|) (the kernel sums with
    FMAs, the plain version in another order); bf16 within 2 bf16 ulps (both
    round every product and partial sum in the same order)."""
    fn, plain, lanes, pad, dtype = CHAINS[name]
    x = _chain_input(dev, lanes, pad, dtype)
    before = fn.launches
    out_k = fn(x, n_chain)
    out_p = plain(x, n_chain)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and out_k.dtype == dtype and out_k.shape == x.shape
    tol = 2 * 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    rel = (out_k.float() - out_p.float()).abs() / out_p.float().abs().clamp_min(1.0)
    assert bool(torch.isfinite(out_k.float()).all()) and float(rel.max()) <= tol
    if n_chain == 0:
        assert torch.equal(out_k, x)


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_kernels_agree_with_plain_in_where_200_rounds_are_non_finite(dev, name):
    fn, plain, lanes, pad, dtype = CHAINS[name]
    x = _chain_input(dev, lanes, pad, dtype, tiles=1)
    out_k, out_p = fn(x, roofline.N_CHAIN), plain(x, roofline.N_CHAIN)
    finite = torch.isfinite(out_p.float())
    assert torch.equal(torch.isfinite(out_k.float()), finite)
    assert 0.0 < float(finite.float().mean()) < 1.0


@pytest.mark.parametrize("n_chain", [0, 1, 4])
@pytest.mark.parametrize("lanes", [40, 64, 128, 192])
def test_padded_chain_kernel_matches_plain_at_every_tile_width(dev, lanes, n_chain):
    """Kernel 9 (a team of threads per scenario, one shared buffer each) at
    tiles a block takes whole (40, 64), in two slices (128) and in three
    (192): within 1e-5 of max(1, |plain|) after a few rounds, and its input
    exactly after none."""
    x = _chain_input(dev, lanes, True, torch.float32)
    before = cuda_chain.lanes_chain_16.launches
    out_k = cuda_chain.lanes_chain_16(x, n_chain)
    out_p = cuda_chain.lanes_chain_16_plain(x, n_chain)
    torch.cuda.synchronize()
    assert cuda_chain.lanes_chain_16.launches == before + 1 and out_k.shape == x.shape
    rel = (out_k - out_p).abs() / out_p.abs().clamp_min(1.0)
    assert bool(torch.isfinite(out_k).all()) and float(rel.max()) <= 1e-5
    if n_chain == 0:
        assert torch.equal(out_k, x)


@pytest.mark.parametrize("n_chain", [0, 1, 4])
@pytest.mark.parametrize("kind,lanes", [(kind, lanes) for kind in ("f32", "bf16")
                                        for lanes in (2, 40, 64, 128, 192, 256)])
def test_chain_kernels_7_and_8_match_plain_at_every_tile_width(dev, kind, lanes, n_chain):
    """Kernels 7 and 8 (one thread a 32-bit slot, the whole matrix in
    registers) at the tile widths their slicing produces (`chain_geometry`):
    one block of 1, 20, 32 or 40 slots (1, 20 and 40 end in a part warp), one
    of 64, and two to four slices: float32 within 1e-5 of max(1, |plain|) and bf16 within 2 bf16
    ulps after a few rounds, and the input exactly after none."""
    fn, plain, _, _, dtype = CHAINS["lanes_chain" if kind == "f32" else "lanes_chain_bf16"]
    x = _chain_input(dev, lanes, False, dtype)
    before = fn.launches
    out_k, out_p = fn(x, n_chain), plain(x, n_chain)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and out_k.dtype == dtype and out_k.shape == x.shape
    tol = 2 * 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    rel = (out_k.float() - out_p.float()).abs() / out_p.float().abs().clamp_min(1.0)
    assert bool(torch.isfinite(out_k.float()).all()) and float(rel.max()) <= tol
    if n_chain == 0:
        assert torch.equal(out_k, x)


def test_chain_kernels_slice_wide_tiles_and_refuse_odd_bf16_tiles(dev):
    """Tiles wider than a block run as slices (`chain_geometry`, and kernel
    9's own slicing); packed bf16 needs an even width."""
    x = _chain_input(dev, 256, False, torch.float32, tiles=1, stages=2)
    out_k, out_p = cuda_chain.lanes_chain(x, 4), cuda_chain.lanes_chain_plain(x, 4)
    assert float((out_k - out_p).abs().max()) <= 1e-5 * float(out_p.abs().max())
    wide = _chain_input(dev, 192, True, torch.float32, tiles=1, stages=2)
    out_k, out_p = cuda_chain.lanes_chain_16(wide, 4), cuda_chain.lanes_chain_16_plain(wide, 4)
    assert float((out_k - out_p).abs().max()) <= 1e-5 * float(out_p.abs().max())
    odd = torch.zeros(1, 1, 12, 12, 7, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        cuda_chain.lanes_chain_bf16(odd, 1)

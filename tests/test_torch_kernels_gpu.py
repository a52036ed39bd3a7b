"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips when no CUDA card is present. Imports torch and
the port only (the card's machine has no JAX), so run it there without the
suite's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control.gpmpc import softplus
from gpmpc_tpu_torch.ops import cuda_gp, cuda_linearize, cuda_ocp, cuda_tighten

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


@pytest.mark.parametrize("n,ard", [(300, False), (25_600, False), (1000, True)])
def test_gp_kernel_matches_plain(dev, n, ard):
    rng = np.random.default_rng(n)
    gp = convert.load_bench_gp(dev)
    pad = 128 - gp.var_Z.shape[1]
    F = torch.nn.functional
    ell = softplus(gp.hypers.raw_lengthscale[0])
    if ard:
        ell = _t([0.7, 1.1, 1.6], dev)
    args = (
        _t(rng.normal(0, 0.4, (n, 3)), dev), F.pad(gp.var_Z[0], (0, 0, 0, pad)),
        F.pad(gp.alpha_s[0], (0, pad)), F.pad(gp.var_mat[0], (0, pad, 0, pad)),
        ell, softplus(gp.hypers.raw_outputscale[0]), softplus(gp.hypers.raw_noise[0]),
        F.pad(gp.var_mask[0], (0, pad)),
    )
    before = cuda_gp.gp_mean_var.launches
    mean_k, var_k = cuda_gp.gp_mean_var(*args, include_noise=True)
    mean_p, var_p = cuda_gp.gp_mean_var_plain(*args, include_noise=True)
    torch.cuda.synchronize()
    assert cuda_gp.gp_mean_var.launches == before + 1
    assert _maxdiff(mean_k, mean_p) <= 1e-4
    assert _maxdiff(var_k, var_p) <= 1e-4


@pytest.mark.parametrize("B,T", [(5, 7), (1024, 25)])
def test_tighten_kernel_matches_plain(dev, B, T):
    rng = np.random.default_rng(B)
    A = np.eye(12) + 0.02 * rng.normal(size=(12, 12))
    args = (
        _t(rng.uniform(1e-6, 4e-4, (B, T, 5)), dev), _t(A, dev),
        _t(0.05 * rng.normal(size=(12, 4)), dev), _t(0.3 * rng.normal(size=(4, 12)), dev),
        _t(np.eye(12)[:, [1, 3, 5, 9, 10]], dev), _t(1.7, dev),
    )
    tx_k, tu_k = cuda_tighten.tighten_lanes(*args)
    tx_p, tu_p = cuda_tighten.tighten_lanes_plain(*args)
    assert tx_k.shape == (B, T + 1, 12) and tu_k.shape == (B, T, 4)
    assert _maxdiff(tx_k, tx_p) <= 1e-5 * max(1.0, float(tx_p.abs().max()))
    assert _maxdiff(tu_k, tu_p) <= 1e-5 * max(1.0, float(tu_p.abs().max()))


@pytest.mark.parametrize("n_tiles,T,use_gp", [(1, 5, True), (1, 5, False), (8, 25, True)])
def test_linearize_kernel_matches_plain(dev, n_tiles, T, use_gp):
    rng = np.random.default_rng(T)
    gp = convert.load_bench_gp(dev)
    X = _t(rng.normal(0, 0.3, (n_tiles, T + 1, 12, LANES)), dev)
    U = _t(np.stack([rng.uniform(0.15, 0.55, (n_tiles, T, LANES))]
                    + [rng.uniform(-0.3, 0.3, (n_tiles, T, LANES)) for _ in range(3)], axis=2), dev)
    ell = softplus(gp.hypers.raw_lengthscale)
    hyp = torch.cat([softplus(gp.hypers.raw_outputscale)[:, None],
                     (1.0 / ell**2)[:, None].expand(3, 3)], dim=1).contiguous()
    par8 = _t([12.1432, 1.8118, -72.08, -7.5755, 39.8653, -72.08, -7.5755, 39.8653], dev)
    args = (par8, hyp, gp.Zs, gp.alpha_s, X, U)
    f_k, A_k, B_k = cuda_linearize.linearize_ocp_lanes(*args, dt=0.02, use_gp=use_gp)
    f_p, A_p, B_p = cuda_linearize.linearize_ocp_lanes_plain(*args, dt=0.02, use_gp=use_gp)
    assert _maxdiff(f_k, f_p) <= 2e-5
    assert _maxdiff(A_k, A_p) <= 2e-4
    assert _maxdiff(B_k, B_p) <= 2e-4


def _qp(dev, n_tiles, T, seed):
    rng = np.random.default_rng(seed)
    shp = lambda *s: (n_tiles, T) + s + (LANES,)  # noqa: E731
    lx = np.full((n_tiles, T + 1, 12, LANES), -1.5, np.float32)
    lx[:, 0] = -1e8
    return cuda_ocp.LanesQp(
        A=_t(np.eye(12)[None, None, :, :, None] + 0.1 * rng.normal(size=shp(12, 12)), dev),
        B=_t(0.4 * rng.normal(size=shp(12, 4)), dev), r=_t(0.05 * rng.normal(size=shp(12)), dev),
        qdiag=_t(rng.uniform(0.5, 2.0, (n_tiles, T + 1, 12, LANES)), dev),
        qx=_t(0.5 * rng.normal(size=(n_tiles, T + 1, 12, LANES)), dev),
        rdiag=_t(rng.uniform(0.5, 2.0, shp(4)), dev), ru=_t(0.5 * rng.normal(size=shp(4)), dev),
        lx=_t(lx, dev), ux=_t(-lx, dev), lu=_t(np.full(shp(4), -0.3), dev),
        uu=_t(np.full(shp(4), 0.3), dev),
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
def test_ocp_kernel_matches_plain(dev, n_tiles, T, kw):
    qp = _qp(dev, n_tiles, T, seed=T)
    dx_k, du_k, gap_k = cuda_ocp.solve_ocp_qp_lanes(qp, **kw)
    dx_p, du_p, gap_p = cuda_ocp.solve_ocp_qp_lanes_plain(qp, **kw)
    assert bool(torch.isfinite(gap_k).all())
    assert _maxdiff(du_k, du_p) <= 5e-4
    assert _maxdiff(dx_k, dx_p) <= 5e-4
    assert float(du_k.abs().max()) <= 0.3 + 1e-4

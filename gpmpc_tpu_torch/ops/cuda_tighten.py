"""Chance-constraint covariance recursion: kernel 2 of the port.

Port of `gpmpc_tpu/ops/pallas_tighten.py::tighten_lanes`. The CUDA kernel is
`csrc/tighten.cu` (one thread per scenario, lane tiles of width `lanes`);
`tighten_lanes_plain` is the recursion in plain PyTorch, batched over B, which
the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, route

LANES = 128


def tighten_lanes_plain(
    cov_dn: torch.Tensor,  # (B, T, nd) disturbance-covariance diagonals
    Ad: torch.Tensor,  # (nx, nx)
    Bd_in: torch.Tensor,  # (nx, nu)
    lqr_gain: torch.Tensor,  # (nu, nx)
    Bd: torch.Tensor,  # (nx, nd)
    inverse_cdf: torch.Tensor,  # ()
    lanes: int = LANES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(t_x (B, T+1, nx), t_u (B, T, nu)): ppf * sqrt of the state and input
    covariance diagonals along the recursion from cov_0 = 0."""
    B, T, _ = cov_dn.shape
    nx = Ad.shape[0]
    A, Bm, K, ppf = Ad, Bd_in, lqr_gain, inverse_cdf
    cov = torch.zeros(B, nx, nx, dtype=cov_dn.dtype, device=cov_dn.device)
    tx, tu = [], []
    for k in range(T):
        cov_xu = cov @ K.T
        cov_u = K @ cov @ K.T
        tx.append(ppf * torch.sqrt(torch.clamp_min(torch.diagonal(cov, dim1=1, dim2=2), 0.0)))
        tu.append(ppf * torch.sqrt(torch.clamp_min(torch.diagonal(cov_u, dim1=1, dim2=2), 0.0)))
        cov = (
            A @ cov @ A.T
            + A @ cov_xu @ Bm.T
            + Bm @ cov_xu.transpose(1, 2) @ A.T
            + Bm @ cov_u @ Bm.T
            + (Bd * cov_dn[:, k, None, :]) @ Bd.T
        )
    tx.append(ppf * torch.sqrt(torch.clamp_min(torch.diagonal(cov, dim1=1, dim2=2), 0.0)))
    return torch.stack(tx, dim=1), torch.stack(tu, dim=1)


def tighten_lanes(
    cov_dn: torch.Tensor,
    Ad: torch.Tensor,
    Bd_in: torch.Tensor,
    lqr_gain: torch.Tensor,
    Bd: torch.Tensor,
    inverse_cdf: torch.Tensor,
    lanes: int = LANES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper with `tighten_lanes_plain`'s signature. CPU tensors take
    the plain version; CUDA tensors launch `tighten_kernel` over
    ceil(B / lanes) tiles (padded scenarios are zero and dropped)."""
    dev = cov_dn.device
    B, T, nd = cov_dn.shape
    nx, nu = Bd_in.shape
    check("cov_dn", cov_dn, (B, T, nd), dev)
    check("Ad", Ad, (nx, nx), dev)
    check("Bd_in", Bd_in, (nx, nu), dev)
    check("lqr_gain", lqr_gain, (nu, nx), dev)
    check("Bd", Bd, (nx, nd), dev)
    check("inverse_cdf", inverse_cdf, (), dev)
    if route(dev) == "plain":
        return tighten_lanes_plain(cov_dn, Ad, Bd_in, lqr_gain, Bd, inverse_cdf, lanes)

    if (nx, nu) != (12, 4) or B == 0:
        raise ValueError(f"tighten kernel is built for nx=12, nu=4 and B > 0 (got {nx}, {nu}, B={B})")
    smem = 4 * (nx * nx + nu * nx + nx * nd + 2 * nx * nx * lanes)
    if smem > 232448 or lanes > 1024:
        raise ValueError(f"lanes={lanes} needs {smem} bytes of shared memory per block")
    B_pad = B + (-B) % lanes
    n_tiles = B_pad // lanes
    x = torch.nn.functional.pad(cov_dn, (0, 0, 0, 0, 0, B_pad - B))
    tiles = x.reshape(n_tiles, lanes, T, nd).permute(0, 2, 3, 1).contiguous()
    tx = torch.empty(n_tiles, T + 1, nx, lanes, dtype=torch.float32, device=dev)
    tu = torch.empty(n_tiles, T, nu, lanes, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        "tighten_launch", p(tiles), p(Ad), p(Bd_in), p(lqr_gain), p(Bd), p(inverse_cdf),
        n_tiles, T, nd, lanes, p(tx), p(tu), _build.stream_handle(dev),
    )
    tighten_lanes.launches += 1
    tx = tx.permute(0, 3, 1, 2).reshape(B_pad, T + 1, nx)[:B]
    tu = tu.permute(0, 3, 1, 2).reshape(B_pad, T, nu)[:B]
    return tx, tu


tighten_lanes.launches = 0

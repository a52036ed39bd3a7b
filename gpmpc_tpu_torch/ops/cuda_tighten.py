"""Chance-constraint tightening: kernel 2 of the port.

Port of `gpmpc_tpu/ops/pallas_tighten.py::tighten_lanes`. The CUDA route
(`csrc/tighten.cu`, instantiated for the (nx, nu) pairs in
`_wrap.KERNEL_SHAPES`) computes the direct form of the covariance recursion:
since A, B, K and Bd are shared and only the diagonal D varies, the diagonals
of the covariance are triangular Toeplitz sums of D against the squared
weights W_m = (A + B K)^m Bd and V_m = K W_m (`tighten_weights_plain`, formed
in float64). `tighten_lanes_plain` is the recursion in plain PyTorch, batched
over B, which the wrapper runs for CPU tensors; `tighten_direct_plain` is the
direct form in plain PyTorch, the CUDA route's oracle on the CPU.
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, check_widths, route

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


def tighten_weights_plain(
    Ad: torch.Tensor,  # (nx, nx)
    Bd_in: torch.Tensor,  # (nx, nu)
    lqr_gain: torch.Tensor,  # (nu, nx)
    Bd: torch.Tensor,  # (nx, nd)
    T: int,
) -> torch.Tensor:
    """(T, nx + nu, nd) float32: the elementwise squares of W_m = Acl^m Bd
    (rows 0..nx-1) and V_m = K W_m (rows nx..), m = 0..T-1, Acl = A + B K,
    all formed in float64 from the float32 inputs (the twin of
    `csrc/tighten.cu::tighten_weights_kernel`)."""
    f64 = torch.float64
    A, Bm, K, W = Ad.to(f64), Bd_in.to(f64), lqr_gain.to(f64), Bd.to(f64)
    acl = A + Bm @ K
    rows = []
    for _ in range(T):
        rows.append(torch.cat([W, K @ W], dim=0))
        W = acl @ W
    nx, nd = Bd.shape
    if not rows:
        return Bd.new_zeros(0, nx + K.shape[0], nd)
    return (torch.stack(rows) ** 2).to(torch.float32)


def expanded_weights(wsq: torch.Tensor) -> torch.Tensor:
    """(T nd, (T+1) R) float32 matrix M of the direct form, R = nx + nu:
    M[(j, q), (k, r)] = wsq[k-1-j, r, q] for j < k, else 0, so that the state
    and input variances of a scenario are its diagonals D (T nd,) times M."""
    T, R, nd = wsq.shape
    j = torch.arange(T, device=wsq.device)[:, None]
    k = torch.arange(T + 1, device=wsq.device)[None, :]
    m = k - 1 - j  # (T, T+1)
    M = wsq[m.clamp_min(0)] * (m >= 0)[:, :, None, None]  # (T, T+1, R, nd)
    return M.permute(0, 3, 1, 2).reshape(T * nd, (T + 1) * R)


def tighten_direct_plain(
    cov_dn: torch.Tensor,
    Ad: torch.Tensor,
    Bd_in: torch.Tensor,
    lqr_gain: torch.Tensor,
    Bd: torch.Tensor,
    inverse_cdf: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`tighten_lanes_plain`'s function in the direct form the CUDA route
    computes: var = D @ `expanded_weights` in float32 with float64-formed
    weights, then ppf * sqrt(max(var, 0))."""
    B, T, nd = cov_dn.shape
    nx, nu = Bd_in.shape
    M = expanded_weights(tighten_weights_plain(Ad, Bd_in, lqr_gain, Bd, T))
    var = (cov_dn.reshape(B, T * nd) @ M).reshape(B, T + 1, nx + nu)
    t = inverse_cdf * torch.sqrt(torch.clamp_min(var, 0.0))
    return t[:, :, :nx].contiguous(), t[:, :T, nx:].contiguous()


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
    the plain version (the recursion); CUDA tensors launch the two kernels of
    `csrc/tighten.cu`, the squared weights into a (T, nx + nu, nd) workspace
    and then the sums, which write t_x and t_u in place (`lanes` does not
    enter the CUDA route). `launches` counts wrapper calls: one per call,
    for both kernels."""
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

    check_widths("tighten", nx, nu)
    if B == 0 or nd == 0:
        raise ValueError("tighten kernel needs B > 0 and nd > 0")
    wsq = torch.empty(T, nx + nu, nd, dtype=torch.float32, device=dev)
    tx = torch.empty(B, T + 1, nx, dtype=torch.float32, device=dev)
    tu = torch.empty(B, T, nu, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        "tighten_launch", p(cov_dn), p(Ad), p(Bd_in), p(lqr_gain), p(Bd), p(inverse_cdf),
        B, T, nd, nx, nu, p(wsq), p(tx), p(tu), _build.stream_handle(dev),
    )
    tighten_lanes.launches += 1
    return tx, tu


tighten_lanes.launches = 0

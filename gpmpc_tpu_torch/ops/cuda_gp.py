"""Fused GP posterior mean and variance: kernel 1 of the port.

Port of `gpmpc_tpu/ops/pallas_gp.py::gp_mean_var`. The CUDA kernel is
`csrc/gp_posterior.cu`; `gp_mean_var_plain` is the same function in plain
PyTorch, which the wrapper runs for CPU tensors. Strict float32 throughout:
run the plain version on a card only with TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`, the default), since the
quadratic form cancels entries ~1/noise down to variances ~1e-2.
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, route

QUERY_TILE = 128  # queries per thread block (csrc/gp_posterior.cu QTILE)
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def _inv_ell2(lengthscale: torch.Tensor, d: int) -> torch.Tensor:
    return (1.0 / lengthscale**2).expand(d).to(torch.float32)


def se_kernel(
    x1: torch.Tensor,  # (..., n, d)
    x2: torch.Tensor,  # (..., m, d)
    lengthscale: torch.Tensor,  # () or (d,)
    outputscale: torch.Tensor,  # ()
) -> torch.Tensor:
    """K[..., i, j] = sf2 * exp(-0.5 * sum_d (x1[i, d] - x2[j, d])^2 / ell_d^2),
    with the squared differences scaled by 1 / ell^2 as the CUDA kernels do."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return outputscale * torch.exp(-0.5 * torch.sum(diff * diff * (1.0 / lengthscale**2), dim=-1))


def gp_mean_var_plain(
    z: torch.Tensor,  # (N, D) queries
    Z: torch.Tensor,  # (M, D) inducing / training inputs (padded)
    alpha: torch.Tensor,  # (M,)
    W: torch.Tensor,  # (M, M) variance quadratic form
    lengthscale: torch.Tensor,  # () or (D,)
    outputscale: torch.Tensor,  # ()
    noise: torch.Tensor,  # ()
    mask: torch.Tensor,  # (M,)
    include_noise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean (N,), var (N,)) of the SE-kernel posterior."""
    k = se_kernel(z, Z, lengthscale, outputscale) * mask[None, :]
    mean = k @ alpha
    var = torch.clamp_min(outputscale - torch.sum((k @ W) * k, dim=-1), 1e-12)
    if include_noise:
        var = var + noise
    return mean, var


def gp_mean_var(
    z: torch.Tensor,
    Z: torch.Tensor,
    alpha: torch.Tensor,
    W: torch.Tensor,
    lengthscale: torch.Tensor,
    outputscale: torch.Tensor,
    noise: torch.Tensor,
    mask: torch.Tensor,
    include_noise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper with `gp_mean_var_plain`'s signature. CPU tensors take the
    plain version; CUDA tensors launch `gp_posterior_kernel`."""
    dev = z.device
    n, d = z.shape
    m = Z.shape[0]
    check("z", z, (n, d), dev)
    check("Z", Z, (m, d), dev)
    check("alpha", alpha, (m,), dev)
    check("W", W, (m, m), dev)
    check("mask", mask, (m,), dev)
    check("outputscale", outputscale, (), dev)
    check("noise", noise, (), dev)
    if lengthscale.shape not in ((), (d,)):
        raise ValueError(f"lengthscale: shape {tuple(lengthscale.shape)}, expected () or ({d},)")
    if route(dev) == "plain":
        return gp_mean_var_plain(z, Z, alpha, W, lengthscale, outputscale, noise, mask, include_noise)

    if n == 0 or d > 8 or m % 8:
        raise ValueError(f"gp_posterior kernel needs N > 0, D <= 8 and M % 8 == 0 (N={n}, D={d}, M={m})")
    smem = 4 * (m * m + m * QUERY_TILE + (d + 2) * m)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"gp_posterior kernel keeps W in shared memory: M={m} needs {smem} bytes "
            f"(> {_SMEM_LIMIT}); streaming W for large GPs is ROADMAP.md Queue 2 work"
        )
    flag = torch.ones((), dtype=torch.float32, device=dev) * float(include_noise)
    hyp = torch.cat([torch.stack([outputscale, noise, flag]), _inv_ell2(lengthscale, d)])
    Zt = Z.t().contiguous()
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    var = torch.empty(n, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        "gp_posterior_launch", p(z), p(Zt), p(alpha), p(W), p(mask), p(hyp), n, m, d,
        p(mean), p(var), _build.stream_handle(dev),
    )
    gp_mean_var.launches += 1
    return mean, var


gp_mean_var.launches = 0

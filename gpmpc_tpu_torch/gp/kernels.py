"""Squared-exponential kernels. Port of `gpmpc_tpu/gp/kernels.py`.

Padding convention of the GP stack: datasets live in fixed-capacity buffers
whose padded rows carry a 0 in an accompanying mask and whose padded feature
columns are zero in both arguments, so they add nothing to the distances.
"""

from __future__ import annotations

import torch


def se_kernel(
    x1: torch.Tensor,  # (..., n, d)
    x2: torch.Tensor,  # (..., m, d)
    lengthscale: torch.Tensor,  # broadcasts against (..., n, m, d): () or (d,) for one GP
    outputscale: torch.Tensor,  # broadcasts against (..., n, m)
) -> torch.Tensor:
    """K[..., i, j] = sf2 * exp(-0.5 * sum_d (x1[i, d] - x2[j, d])^2 / ell_d^2),
    with the squared differences scaled by 1 / ell^2 as the CUDA kernels do."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return outputscale * torch.exp(-0.5 * torch.sum(diff * diff * (1.0 / lengthscale**2), dim=-1))


def se_kernel_diag(x: torch.Tensor, outputscale: torch.Tensor) -> torch.Tensor:
    """diag K(x, x) = sf2 (stationary kernel): (..., n, d) -> (..., n)."""
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) * outputscale

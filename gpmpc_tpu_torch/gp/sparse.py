"""FITC sparse-GP posterior for the MPC dynamics. Port of
`gpmpc_tpu/gp/sparse.py`.

Up to `Ms` random active training points become inducing points, with FITC
weights

    Gamma     = diag(K + sigma^2 I - K_xs K_ss^-1 K_xs')
    Sigma_inv = K_ss + K_xs' Gamma^-1 K_xs
    alpha     = Sigma_inv^-1 K_xs' Gamma^-1 y

so that the in-dynamics mean is k(z, Zs) @ alpha. Shapes are padded and
fixed: the inducing set always has capacity Ms, and when fewer active points
exist the selection mask covers them all.
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch.device import ShardDraw, draw_rows, strict_float32
from gpmpc_tpu_torch.gp.exact_gp import GPData, GPHypers, _cho_solve, _cholesky_or_nan, _kernel


def select_inducing(
    generator: torch.Generator | ShardDraw, mask: torch.Tensor, n_inducing: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform choice without replacement of up to `n_inducing` active rows,
    per leading batch entry of `mask` (..., M): (idx (..., Ms) row indices
    into the padded buffer, s_mask (..., Ms) activity mask). Random scores
    with the inactive rows pushed to the bottom, then a sorted top-k: active
    rows come first, so when fewer than Ms are active, s_mask's leading
    entries are exactly the active ones. The scores come from `generator`,
    which must live on the mask's device (JAX's draw cannot be reproduced);
    a `ShardDraw` gives the rows of a larger population's draw."""
    scores = draw_rows("rand", generator, tuple(mask.shape), device=mask.device)
    scores = scores + torch.where(mask > 0, 0.0, -1e9)
    idx = torch.topk(scores, n_inducing, dim=-1, sorted=True).indices
    n_active = torch.sum(mask, dim=-1).to(torch.int64)
    s_mask = (torch.arange(n_inducing, device=mask.device)
              < torch.clamp_max(n_active, n_inducing)[..., None]).to(mask.dtype)
    return idx, s_mask


def fitc_posterior_mean(
    hypers: GPHypers, data: GPData, idx: torch.Tensor, s_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """FITC mean weights only: (Zs, alpha); see `fitc_posterior`."""
    Zs, alpha, _ = fitc_posterior(hypers, data, idx, s_mask)
    return Zs, alpha


def fitc_posterior(
    hypers: GPHypers, data: GPData, idx: torch.Tensor, s_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FITC posterior on the inducing subset `data.x[..., idx, :]`: (Zs
    (..., Ms, D) with padded rows zero, alpha (..., Ms) with padded entries
    zero, W (..., Ms, Ms)) such that mean(z) = k(z, Zs) @ alpha and
    var(z) = sf2 - k(z, Zs) @ W @ k(z, Zs)', W = K_ss^-1 - (K_ss +
    K_xs' Gamma^-1 K_xs)^-1. `idx` and `s_mask` broadcast against the data's
    leading axes (one inducing set shared by a GP ensemble, or one per
    seed). Computed in the stable form with L = chol(K_ss) and
    A = L^-1 K_xs' Gamma^-1/2: Sigma_inv = L (I + A A') L'."""
    with strict_float32(), torch.no_grad():
        return _fitc_posterior(hypers, data, idx, s_mask)


def _fitc_posterior(hypers, data, idx, s_mask):
    batch = data.y.shape[:-1]
    Ms, D = idx.shape[-1], data.x.shape[-1]
    idx = idx.expand(batch + (Ms,))
    s_mask = s_mask.expand(batch + (Ms,))
    Zs = torch.gather(data.x, -2, idx[..., None].expand(batch + (Ms, D))) * s_mask[..., None]
    sf2, noise = hypers.outputscale[..., None], hypers.noise[..., None]
    eye = torch.eye(Ms, dtype=Zs.dtype, device=Zs.device)
    smm = s_mask[..., :, None] * s_mask[..., None, :]

    K_ss = _kernel(Zs, Zs, hypers) * smm
    jitter = 1e-5 * sf2 + 1e-6
    K_ss = K_ss + torch.diag_embed(jitter * s_mask + (1.0 - s_mask))
    K_xs = _kernel(data.x, Zs, hypers) * (data.mask[..., :, None] * s_mask[..., None, :])

    chol_ss = _cholesky_or_nan(K_ss)[0]
    V = torch.linalg.solve_triangular(chol_ss, K_xs.transpose(-1, -2), upper=False)  # (Ms, N)
    # Gamma >= sigma^2 in exact arithmetic: the numerical floor
    k_diag = (sf2 + noise) * data.mask + (1.0 - data.mask)
    Gamma = torch.maximum(k_diag - torch.sum(V * V, dim=-2), noise.expand_as(k_diag))

    inv_sqrt_gamma = torch.rsqrt(Gamma) * data.mask
    A = V * inv_sqrt_gamma[..., None, :]
    Bm = eye + A @ A.transpose(-1, -2)
    chol_B = _cholesky_or_nan(Bm)[0]
    c = (A @ (data.y * inv_sqrt_gamma)[..., None])[..., 0]
    w = _cho_solve(chol_B, c)
    alpha = torch.linalg.solve_triangular(chol_ss.transpose(-1, -2), w[..., None], upper=True)[..., 0]

    # W = L^-T (I - B^-1) L^-1 from the same two factors
    L_inv = torch.linalg.solve_triangular(chol_ss, eye.expand(batch + (Ms, Ms)), upper=False)
    B_inv = _cho_solve(chol_B, eye.expand(batch + (Ms, Ms)))
    W = L_inv.transpose(-1, -2) @ (eye - B_inv) @ L_inv
    W = 0.5 * (W + W.transpose(-1, -2)) * smm
    return Zs, alpha * s_mask, W

"""What every family's plain reference shares: RK4, the squared-exponential
kernel, and the residual GPs' mean and variance as the benchmark hands the
GPs over. Nothing here imports the program."""

from __future__ import annotations

import torch


def rk4(f, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    k1 = f(x, u)
    k2 = f(x + dt / 2 * k1, u)
    k3 = f(x + dt / 2 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def gp_queries(z: torch.Tensor, width: int, columns) -> list[torch.Tensor]:
    """Each GP's inputs (..., width): its `columns` of the features z,
    zero-padded."""
    pad = lambda n: torch.zeros(z.shape[:-1] + (n,), dtype=z.dtype, device=z.device)  # noqa: E731
    return [torch.cat([z[..., list(cols)], pad(width - len(cols))], dim=-1) for cols in columns]


def se(q: torch.Tensor, pts: torch.Tensor, ell: torch.Tensor, sf2: torch.Tensor) -> torch.Tensor:
    """sf2 exp(-|q - pts|^2 / (2 ell^2)): q (N, D), pts (M, D) -> (N, M)."""
    d = q[:, None, :] - pts[None, :, :]
    return sf2 * torch.exp(-0.5 * torch.sum(d * d, dim=-1) / (ell * ell))


class GpSet:
    """The G GPs as the benchmark hands them over (a mapping of float32
    arrays in the GP file's names): the mean's points and weights, the
    variance's points, matrix and mask, and raw (softplus) hyperparameters.
    GP g reads the feature columns `columns[g]`."""

    def __init__(self, arrays: dict, device, columns):
        t = lambda k: torch.as_tensor(arrays[k], dtype=torch.float32, device=device)  # noqa: E731
        softplus = lambda v: torch.logaddexp(v, torch.zeros_like(v))  # noqa: E731
        self.columns = tuple(tuple(c) for c in columns)
        self.Zs, self.alpha = t("Zs"), t("alpha_s")
        self.var_Z, self.W, self.var_mask = t("var_Z"), t("var_mat"), t("var_mask")
        self.ell = softplus(t("raw_lengthscale"))
        self.sf2 = softplus(t("raw_outputscale"))
        self.noise = softplus(t("raw_noise")) + 1e-6
        self.trained = bool(arrays["trained"])

    def mean(self, z: torch.Tensor) -> torch.Tensor:
        """(..., G) posterior means at features z, k(z, Zs) alpha as a sum of
        products (forward mode differentiates it)."""
        qs = gp_queries(z.reshape(-1, z.shape[-1]), self.Zs.shape[-1], self.columns)
        out = [torch.sum(se(q, self.Zs[g], self.ell[g], self.sf2[g]) * self.alpha[g], -1)
               for g, q in enumerate(qs)]
        return torch.stack(out, dim=-1).reshape(z.shape[:-1] + (len(qs),))

    def variance(self, z: torch.Tensor, prec) -> torch.Tensor:
        """(..., G) predictive variances (no noise) at features z: sf2 - k W
        k', floored at 1e-12."""
        qs = gp_queries(z.reshape(-1, z.shape[-1]), self.var_Z.shape[-1], self.columns)
        out = []
        for g, q in enumerate(qs):
            k = se(q, self.var_Z[g], self.ell[g], self.sf2[g]) * self.var_mask[g]
            out.append(torch.clamp_min(self.sf2[g] - torch.sum(prec.mm(k, self.W[g]) * k, -1),
                                       1e-12))
        return torch.stack(out, dim=-1).reshape(z.shape[:-1] + (len(qs),))

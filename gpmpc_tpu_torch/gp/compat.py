"""The reference GP module's surface: `covSE_single`, `covSE_vectorized`,
`GaussianProcess` and `fit_gp`. Port of `gpmpc_tpu/gp/compat.py`, on the
port's exact GP."""

from __future__ import annotations

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve
from gpmpc_tpu_torch.gp import exact_gp
from gpmpc_tpu_torch.gp.kernels import se_kernel


def _ell(ell) -> torch.Tensor:
    ell = torch.as_tensor(ell, dtype=torch.float32)
    return ell.reshape(()) if ell.numel() == 1 else ell.reshape(-1)


def covSE_single(x, z, ell, sf2) -> torch.Tensor:
    """SE kernel of one test point x (d,) against a training matrix z (d, n)
    in the CasADi column convention: (n,)."""
    x = torch.as_tensor(x, dtype=torch.float32).reshape(1, -1)
    z = torch.as_tensor(z, dtype=torch.float32).T
    return se_kernel(x, z, _ell(ell), torch.as_tensor(sf2, dtype=torch.float32).reshape(()))[0]


def covSE_vectorized(x, Z, ell, sf2) -> torch.Tensor:
    """SE kernel of one test point x (d,) against an inducing matrix Z (n, d): (n,)."""
    x = torch.as_tensor(x, dtype=torch.float32).reshape(1, -1)
    Z = torch.as_tensor(Z, dtype=torch.float32)
    return se_kernel(x, Z, _ell(ell), torch.as_tensor(sf2, dtype=torch.float32).reshape(()))[0]


class GaussianProcess:
    """Exact GP with the reference's surface: construct from (x, y), `fit`,
    then `predict`. After fitting, `K` (Gram + noise) and `K_inv` as numpy
    arrays, `n_ind_points` and `input_dimension`. `device=None` is the card."""

    def __init__(self, x, y, device=None):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32).reshape(-1)
        assert x.ndim == 2, "x must be a 2D array"
        assert x.shape[0] == y.shape[0]
        self.device = resolve(device)
        self.n_ind_points = x.shape[0]
        self.input_dimension = x.shape[1]
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self._data = exact_gp.GPData(x=t(x), y=t(y), mask=torch.ones(x.shape[0], device=self.device))
        self.hypers = exact_gp.init_hypers(device=self.device)
        self._post = None
        self.K, self.K_inv = None, None

    def fit(self, n_train: int = 500, lr: float = 0.01) -> float:
        """Train the hyperparameters and cache K and K_inv; the final loss."""
        self.hypers, loss = exact_gp.fit_gp(self._data, n_train=n_train, lr=lr)
        self._post = exact_gp.posterior(self.hypers, self._data)
        K = se_kernel(self._data.x, self._data.x, self.hypers.lengthscale,
                      self.hypers.outputscale).cpu().numpy()
        self.K = K + float(self.hypers.noise) * np.eye(self.n_ind_points)
        self.K_inv = np.linalg.inv(self.K)
        return float(loss)

    def predict(self, z, include_noise: bool = True):
        """Posterior mean and variance at z (n, d), as numpy arrays."""
        assert self._post is not None, "call fit() first"
        z = torch.as_tensor(np.asarray(z, np.float32).reshape(-1, self.input_dimension),
                            device=self.device)
        mean = exact_gp.predict_mean(self.hypers, self._data, self._post, z)
        var = exact_gp.predict_var(self.hypers, self._data, self._post, z,
                                   include_noise=include_noise)
        return mean.cpu().numpy(), var.cpu().numpy()


def fit_gp(gp: GaussianProcess, n_train: int = 500, lr: float = 0.01, device: str = "cuda"):
    """The reference's functional form. `device` is informational: the GP
    trains where it was built."""
    assert isinstance(gp, GaussianProcess), f"gp must be a GaussianProcess, got {type(gp)}"
    gp.fit(n_train=n_train, lr=lr)
    return gp

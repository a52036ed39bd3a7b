"""The residual GPs both sides are handed, as a mapping of float32 arrays in
the GP file's names (`Z`, `y`, `mask`, `raw_*`, `Zs`, `alpha_s`, `var_Z`,
`var_mat`, `var_mask`, `trained`).

A configuration's `gp` is either `{"kind": "file", "file": ...}`, a GP
stored under `benchmark/data/`, or `{"kind": "fitc", ...}`: `points` residual
transitions drawn from the seed by the family's generator
(`benchmark/reference/<family>.py::residual_dataset`), the configuration's
hyperparameters, `inducing` points drawn from the seed and
the FITC posterior formed here in float64:

    Gamma = diag(K + noise I - K_xs K_ss^-1 K_xs'),
    alpha = (K_ss + K_xs' Gamma^-1 K_xs)^-1 K_xs' Gamma^-1 y,
    W = K_ss^-1 - (K_ss + K_xs' Gamma^-1 K_xs)^-1,

so that the mean is k(z, Zs) alpha and the variance sf2 - k W k'. Fitting the
hyperparameters is a workload of its own and not part of these cells.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import gp_queries
from benchmark.reference.controller import family

JITTER = (1e-5, 1e-6)  # K_ss + (1e-5 sf2 + 1e-6) I


def _inv_softplus(v: np.ndarray) -> np.ndarray:
    return np.log(np.expm1(v))


def fitc(config: dict, seed: int, device) -> dict:
    """The FITC GP of a configuration whose `gp` is of kind `fitc`, for this
    seed."""
    fam, gpcfg = family(config), config["gp"]
    G, d = len(fam.GP_COLUMNS), max(len(c) for c in fam.GP_COLUMNS)
    n, m = int(gpcfg["points"]), int(gpcfg["inducing"])
    rng = np.random.default_rng(seed)
    z, y = fam.residual_dataset(n, rng)
    idx = np.sort(rng.choice(n, m, replace=False))
    ell = np.asarray(gpcfg["lengthscale"], np.float32)
    sf2 = np.asarray(gpcfg["outputscale"], np.float32)
    raw_noise = _inv_softplus(np.asarray(gpcfg["noise"], np.float32) - 1e-6).astype(np.float32)
    noise = np.log1p(np.exp(raw_noise.astype(np.float64))) + 1e-6
    qs = gp_queries(torch.as_tensor(z, dtype=torch.float64), d, fam.GP_COLUMNS)
    Zs, alpha, W = [], [], []
    for g in range(G):
        X = qs[g].to(device)
        S = X[torch.as_tensor(idx, device=device)]
        kern = lambda a, b: float(sf2[g]) * torch.exp(  # noqa: E731
            -0.5 * torch.cdist(a, b).square() / float(ell[g]) ** 2)
        eye = torch.eye(m, dtype=torch.float64, device=device)
        Kss = kern(S, S) + (JITTER[0] * float(sf2[g]) + JITTER[1]) * eye
        L = torch.linalg.cholesky(Kss)
        V = torch.linalg.solve_triangular(L, kern(X, S).T, upper=False)  # (m, n)
        gamma = torch.clamp_min(float(sf2[g]) + noise[g] - (V * V).sum(0), float(noise[g]))
        A = V / torch.sqrt(gamma)
        LB = torch.linalg.cholesky(eye + A @ A.T)
        c = A @ (torch.as_tensor(y[:, g], dtype=torch.float64, device=device) / torch.sqrt(gamma))
        w = torch.cholesky_solve(c[:, None], LB)[:, 0]
        alpha.append(torch.linalg.solve_triangular(L.T, w[:, None], upper=True)[:, 0])
        L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
        W.append(L_inv.T @ (eye - torch.cholesky_solve(eye, LB)) @ L_inv)
        Zs.append(S)
    f32 = lambda ts: torch.stack(ts).to(torch.float32).cpu().numpy()  # noqa: E731
    Zs, W = f32(Zs), f32([0.5 * (w_ + w_.T) for w_ in W])
    return dict(
        Z=np.stack([q.numpy() for q in qs]).astype(np.float32), y=np.ascontiguousarray(y.T),
        mask=np.ones((G, n), np.float32), raw_lengthscale=_inv_softplus(ell).astype(np.float32),
        raw_outputscale=_inv_softplus(sf2).astype(np.float32), raw_noise=raw_noise, Zs=Zs,
        alpha_s=f32(alpha), var_Z=Zs.copy(), var_mat=W, var_mask=np.ones((G, m), np.float32),
        trained=np.asarray(True),
    )


def gp_arrays(config: dict, seed: int, root, device) -> dict:
    """The GP of `config` for this seed (a stored GP is the same for every
    seed)."""
    gpcfg = config["gp"]
    if gpcfg["kind"] == "file":
        with np.load(root / gpcfg["file"]) as d:
            return {k: d[k] for k in d.files}
    if gpcfg["kind"] == "fitc":
        return fitc(config, seed, device)
    raise ValueError(f"gp kind must be 'file' or 'fitc', got {gpcfg['kind']!r}")

"""Shared helpers for benchmarks and entry points. Port of
`gpmpc_tpu/utils/benchkit.py`: the bench's cost weights, the reference prior
dict, the synthetic residual dataset and the three families' synthetic GP
ensembles, trained by the port itself (`train_gp_models`). Data comes from
numpy seeds, as in the reference; the inducing draws from a torch generator
seeded alike (JAX's draw cannot be reproduced, so a model trained here has
other inducing points than the reference's)."""

from __future__ import annotations

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS

Q_MPC = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
R_MPC = [3, 3, 3, 0.1]


def reference_prior_dict() -> dict:
    """The reference config's prior-parameter dict."""
    return dict(zip("abcdefhl", PRIOR_PARAMS))


def synthetic_residual_dataset(n: int = 60, seed: int = 0):
    """A quadrotor residual dataset at the reference's scale: a thrust-map
    deficit of ~4 m/s^2 plus small attitude-rate residuals. numpy float32
    (x7 (n, 7), y3 (n, 3))."""
    rng = np.random.default_rng(seed)
    x7 = np.zeros((n, 7), np.float32)
    x7[:, 0] = rng.uniform(0.2, 0.5, n)  # thrust command
    x7[:, 1:] = rng.normal(0, 0.2, (n, 6))
    y3 = np.stack(
        [
            4.0 + 0.5 * np.sin(5 * x7[:, 0]) + 0.01 * rng.normal(size=n),
            0.1 * x7[:, 1] + 0.01 * rng.normal(size=n),
            0.1 * x7[:, 4] + 0.01 * rng.normal(size=n),
        ],
        axis=1,
    ).astype(np.float32)
    return x7, y3


def _train(xz, y, max_points, max_inducing, n_train, seed, spec, device, ard=False):
    from gpmpc_tpu_torch.control.gpmpc import pack_training_data, train_gp_models

    device = resolve(device)
    data = pack_training_data(torch.as_tensor(xz, device=device),
                              torch.as_tensor(y, device=device), max_points, spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    return train_gp_models(data, gen, sparse=True, max_inducing=max_inducing, n_train=n_train,
                           lr=0.05, ard=ard)


def synthetic_gp_model(max_points: int = 128, max_inducing: int = 40, n_data: int = 60,
                       n_train: int = 30, seed: int = 0, ard: bool = False, device=None):
    """The quadrotor's GP ensemble (G = 3) trained on the synthetic dataset."""
    from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC

    x7, y3 = synthetic_residual_dataset(n_data, seed)
    return _train(x7, y3, max_points, max_inducing, n_train, seed, QUADROTOR_SPEC, device, ard)


def synthetic_cartpole_gp_model(max_points: int = 128, max_inducing: int = 40, n_data: int = 60,
                                n_train: int = 30, seed: int = 0, device=None):
    """The cartpole's GP ensemble (G = 2, D = 3) on synthetic acceleration residuals."""
    from gpmpc_tpu_torch.models.residual import CARTPOLE_SPEC

    rng = np.random.default_rng(seed)
    xz = np.zeros((n_data, 4), np.float32)  # z = [x_dot, theta, theta_dot, F]
    xz[:, 0] = rng.normal(0, 0.5, n_data)
    xz[:, 1] = rng.normal(0, 0.2, n_data)
    xz[:, 2] = rng.normal(0, 0.5, n_data)
    xz[:, 3] = rng.uniform(-6.0, 6.0, n_data)
    y = np.stack(
        [
            -0.4 * xz[:, 0] + 0.12 * xz[:, 3] + 0.01 * rng.normal(size=n_data),
            -0.5 * xz[:, 2] - 0.3 * xz[:, 1] + 0.01 * rng.normal(size=n_data),
        ],
        axis=1,
    ).astype(np.float32)
    return _train(xz, y, max_points, max_inducing, n_train, seed, CARTPOLE_SPEC, device)


def synthetic_twolink_gp_model(max_points: int = 128, max_inducing: int = 40, n_data: int = 60,
                               n_train: int = 30, seed: int = 0, device=None):
    """The two-link arm's GP ensemble (G = 2, D = 6) on synthetic acceleration residuals."""
    from gpmpc_tpu_torch.models.residual import TWOLINK_SPEC

    rng = np.random.default_rng(seed)
    xz = np.zeros((n_data, 6), np.float32)  # z = [q1, q2, dq1, dq2, t1/10, t2/10]
    xz[:, 0] = rng.uniform(-2.0, 0.0, n_data)
    xz[:, 1] = rng.uniform(0.0, 1.5, n_data)
    xz[:, 2:4] = rng.normal(0, 0.5, (n_data, 2))
    xz[:, 4:] = rng.uniform(-1.0, 1.0, (n_data, 2))
    y = np.stack(
        [
            1.5 + 0.4 * np.sin(xz[:, 1]) + 0.8 * xz[:, 4] + 0.01 * rng.normal(size=n_data),
            -9.0 - 0.5 * xz[:, 2] + 0.6 * xz[:, 5] + 0.01 * rng.normal(size=n_data),
        ],
        axis=1,
    ).astype(np.float32)
    return _train(xz, y, max_points, max_inducing, n_train, seed, TWOLINK_SPEC, device)

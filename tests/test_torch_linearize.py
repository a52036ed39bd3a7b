"""Port linearization (kernel 3's plain version, via its wrapper on CPU
tensors) against the JAX package: fnext against `augmented_fd` (or the prior's
RK4 step without the GP), A and B against `jax.jacfwd` of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control.gpmpc import augmented_fd
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.utils.benchkit import reference_prior_dict, synthetic_gp_model
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control.gpmpc import softplus
from gpmpc_tpu_torch.models.quadrotor import QuadrotorParams
from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC
from gpmpc_tpu_torch.ops.cuda_linearize import linearize_ocp_lanes

F32 = np.float32
N_TILES, T, L = 2, 5, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 0.3, (N_TILES, T + 1, 12, L)).astype(F32)
    U = np.stack(
        [rng.uniform(0.15, 0.55, (N_TILES, T, L))]
        + [rng.uniform(-0.3, 0.3, (N_TILES, T, L)) for _ in range(3)], axis=2,
    ).astype(F32)
    return X, U


@pytest.mark.parametrize("use_gp", [True, False])
@pytest.mark.parametrize("ard", [False, True])
def test_linearize_matches_jax_augmented_fd_and_jacfwd(use_gp, ard):
    prior = reference_prior_dict()
    model = j_sym(dt=0.02, params=prior)
    gp = synthetic_gp_model(max_points=32, max_inducing=12, n_data=24, n_train=10, ard=ard)
    flat = {k: np.asarray(v) for k, v in gp._asdict().items() if k != "hypers"}
    flat.update({k: np.asarray(v) for k, v in gp.hypers._asdict().items()})
    gp_t = convert.gp_model_from_numpy(flat)
    X, U = _inputs(1 if ard else 0)

    ell = softplus(gp_t.hypers.raw_lengthscale)  # (3,) or (3, 3)
    inv_ell2 = (1.0 / (ell * ell)).reshape(3, -1).expand(3, 3)
    hyp = torch.cat([softplus(gp_t.hypers.raw_outputscale)[:, None], inv_ell2], dim=1).contiguous()
    par8 = QUADROTOR_SPEC.kernel_params(QuadrotorParams.from_dict(prior))
    fnext, A, B = linearize_ocp_lanes(
        par8, hyp, gp_t.Zs, gp_t.alpha_s, torch.as_tensor(X), torch.as_tensor(U),
        dt=0.02, use_gp=use_gp,
    )
    assert fnext.shape == (N_TILES, T, 12, L) and A.shape == (N_TILES, T, 12, 12, L)

    fd = (lambda x, u: augmented_fd(model, gp, x, u)) if use_gp else model.fd_func
    Xb = jnp.asarray(np.moveaxis(X[:, :T], -1, 1).reshape(-1, 12))  # (n*L*T, 12)
    Ub = jnp.asarray(np.moveaxis(U, -1, 1).reshape(-1, 4))
    f_ref = jax.jit(jax.vmap(fd))(Xb, Ub)
    A_ref, B_ref = jax.jit(jax.vmap(jax.jacfwd(fd, argnums=(0, 1))))(Xb, Ub)

    def flat_lanes(t):  # (n, T, ..., L) -> (n*L*T, ...) in the order of Xb
        return np.moveaxis(t.numpy(), -1, 1).reshape((-1,) + tuple(t.shape[2:-1]))

    np.testing.assert_allclose(flat_lanes(fnext), np.asarray(f_ref, F32), atol=2e-5)
    np.testing.assert_allclose(flat_lanes(A), np.asarray(A_ref, F32), atol=2e-4)
    np.testing.assert_allclose(flat_lanes(B), np.asarray(B_ref, F32), atol=2e-4)

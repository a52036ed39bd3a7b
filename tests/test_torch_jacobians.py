"""The port's analytic Jacobians (`gpmpc_tpu_torch/models/jacobians.py`)
against the JAX package's (`make_augmented_fd_jac` and its parts) and against
the port's own forward-mode linearization (`ops/sqp_lanes.py::jacfwd_linearize`),
on the quadrotor's benchmark GP (the committed fixture) and seeded numpy
states, both sides in float32. Tolerance 1e-5 absolute, the bar of
tests/test_jacobians.py carried to float32: the discrete Jacobians are of
order one and differ by float32 rounding of sums taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models import jacobians as j_jac
from gpmpc_tpu.models.quadrotor import PRIOR_PARAMS as J_PRIOR
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.models import jacobians as t_jac
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS as T_PRIOR
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.ops.sqp_lanes import jacfwd_linearize
from tests._torch_threads import _one_thread  # noqa: F401


F32 = np.float32
B, T = 4, 3
TOL = 1e-5


def points(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 0.3, (B, T, 12)).astype(F32)
    U = (np.array([0.35, 0.05, -0.08, 0.02]) + 0.05 * rng.normal(size=(B, T, 4))).astype(F32)
    return X, U


def gps(ard=False):
    with np.load(convert.bench_gp_path("quadrotor")) as f:
        d = {k: np.asarray(v) for k, v in f.items()}
    if ard:  # one lengthscale per input dimension
        rng = np.random.default_rng(4)
        d["raw_lengthscale"] = (d["raw_lengthscale"][:, None]
                                + 0.3 * rng.normal(size=(3, 3))).astype(F32)
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    gp_j = j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"),
        hypers=JGPHypers(leaf("raw_lengthscale"), leaf("raw_outputscale"), leaf("raw_noise")),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(True),
    )
    return gp_j, convert.gp_model_from_numpy(d, "cpu")


def over_points(f):
    return jax.vmap(jax.vmap(f))


def test_prior_jacobians_match_jax_and_the_models_own():
    X, U = points()
    A_j, B_j = over_points(lambda x, u: j_jac.prior_jacobians(J_PRIOR, x, u))(
        jnp.asarray(X), jnp.asarray(U))
    A_t, B_t = t_jac.prior_jacobians(T_PRIOR, torch.tensor(X), torch.tensor(U))
    assert A_t.shape == (B, T, 12, 12) and B_t.shape == (B, T, 12, 4) and A_t.dtype == torch.float32
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), atol=TOL)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), atol=TOL)
    # and the model's own float64 jacfwd at one point
    A64, B64 = t_jac.prior_jacobians(T_PRIOR, torch.tensor(X[0, 0], dtype=torch.float64),
                                     torch.tensor(U[0, 0], dtype=torch.float64))
    A_ref, B_ref = t_sym(dt=0.02).df_func(X[0, 0], U[0, 0])
    np.testing.assert_allclose(A64.numpy(), A_ref, atol=1e-10)
    np.testing.assert_allclose(B64.numpy(), B_ref, atol=1e-10)


@pytest.mark.parametrize("ard", [False, True], ids=["isotropic", "ard"])
def test_augmented_jacobians_match_jax(ard):
    gp_j, gp_t = gps(ard)
    model_j, model_t = j_sym(dt=0.02), t_sym(dt=0.02)
    X, U = points(3)
    A_j, B_j = over_points(lambda x, u: j_jac.augmented_jacobians(model_j, gp_j, x, u))(
        jnp.asarray(X), jnp.asarray(U))
    A_t, B_t = t_jac.augmented_jacobians(model_t, gp_t, torch.tensor(X), torch.tensor(U))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), atol=TOL)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), atol=TOL)
    # the GP moves the Jacobians: this is not the prior's test again
    A_p, _ = t_jac.prior_jacobians(T_PRIOR, torch.tensor(X), torch.tensor(U))
    assert float((A_t - A_p).abs().max()) > 1e-3


@pytest.mark.parametrize("ard", [False, True], ids=["isotropic", "ard"])
def test_discrete_jacobians_match_jax_and_the_ports_forward_mode(ard):
    gp_j, gp_t = gps(ard)
    model_j, model_t = j_sym(dt=0.02), t_sym(dt=0.02)
    X, U = points(5)
    f_j, A_j, B_j = over_points(j_jac.make_augmented_fd_jac(model_j, gp_j))(
        jnp.asarray(X), jnp.asarray(U))
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    f_t, A_t, B_t = t_jac.make_augmented_fd_jac(model_t, gp_t)(Xt, Ut)
    for got, want in ((f_t, f_j), (A_t, A_j), (B_t, B_j)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)

    fd = lambda x, u: t_gpmpc.augmented_fd(model_t, gp_t, x, u)  # noqa: E731
    f_f, A_f, B_f = jacfwd_linearize(fd, Xt, Ut)
    assert A_f.shape == (B, T, 12, 12) and B_f.shape == (B, T, 12, 4) and A_f.dtype == torch.float32
    np.testing.assert_allclose(f_f.numpy(), f_t.numpy(), atol=TOL)
    np.testing.assert_allclose(A_f.numpy(), A_t.numpy(), atol=TOL)
    np.testing.assert_allclose(B_f.numpy(), B_t.numpy(), atol=TOL)
    # the forward-mode linearization against jax.jacfwd of the reference's fd
    fd_j = lambda x, u: j_gpmpc.augmented_fd(model_j, gp_j, x, u)  # noqa: E731
    A_r, B_r = over_points(jax.jacfwd(fd_j, argnums=(0, 1)))(jnp.asarray(X), jnp.asarray(U))
    np.testing.assert_allclose(A_f.numpy(), np.asarray(A_r), atol=TOL)
    np.testing.assert_allclose(B_f.numpy(), np.asarray(B_r), atol=TOL)

"""`ops/sqp.py::kkt_residuals` and `ops/sqp_lanes.py::sqp_solve_batch_lanes`
of the port against the JAX package, set up as tests/test_kkt.py sets up its
lanes case: the quadrotor on a figure-eight reference, T=5, B=5, the
benchmark GP (the committed fixture) in the dynamics, 4 SQP x 8 IP
iterations, kkt_tol 1e-4. The reference runs its Pallas QP kernel in interpret
mode; the port runs the kernel's plain version (CPU tensors). Three
linearizers: forward-mode differentiation of `fd`, the analytic `fd_jac3`,
and a whole-batch `linearize_fn` over a GP population. Both sides in float32.

Tolerances: X and U 2e-4 absolute (two float32 runs of the same SQP and
interior point, sums in another order), residuals 1e-3 relative as
tests/test_kkt.py holds the reference's own two backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models import jacobians as j_jac
from gpmpc_tpu.models import quadrotor as j_quad
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.models.trajectory import figure_eight_trajectory as j_traj
from gpmpc_tpu.ops import sqp as j_sqp
from gpmpc_tpu.ops import sqp_lanes as j_lanes
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.models import jacobians as t_jac
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.ops import sqp as t_sqp
from gpmpc_tpu_torch.ops import sqp_lanes as t_lanes
from tests._torch_threads import _one_thread  # noqa: F401


F32 = np.float32
Q12 = [8.0, 0.1, 8.0, 0.1, 8.0, 0.1, 0.1, 0.1, 0.1, 0.01, 0.01, 0.01]
R4 = [0.1, 0.1, 0.1, 0.1]
T, NX, NU, B = 5, 12, 4, 5
HYPERS = ("raw_lengthscale", "raw_outputscale", "raw_noise")


def test_kkt_residuals_match():
    rng = np.random.default_rng(0)
    r = lambda *s: rng.normal(size=s).astype(F32)  # noqa: E731
    A = (np.eye(NX, dtype=F32) + 0.1 * r(B, T, NX, NX)).astype(F32)
    Bm, defect, qx, ru, U = r(B, T, NX, NU), 0.1 * r(B, T, NX), r(B, T + 1, NX), r(B, T, NU), r(B, T, NU)
    lu, uu = np.full((B, T, NU), -0.5, F32), np.full((B, T, NU), 0.8, F32)
    args = (A, Bm, defect, qx, ru, U, lu, uu)
    eq_j, stat_j = jax.vmap(j_sqp.kkt_residuals)(*map(jnp.asarray, args))
    eq_t, stat_t = t_sqp.kkt_residuals(*map(torch.tensor, args))
    assert eq_t.shape == (B,) and stat_t.shape == (B,)
    np.testing.assert_allclose(eq_t.numpy(), np.asarray(eq_j), rtol=1e-6)
    np.testing.assert_allclose(stat_t.numpy(), np.asarray(stat_j), rtol=1e-5)
    assert float(stat_t.min()) > 0


def gp_pair(population=0):
    with np.load(convert.bench_gp_path("quadrotor")) as f:
        d = {k: np.asarray(v) for k, v in f.items()}
    if population:
        rng = np.random.default_rng(7)
        d = {k: np.repeat(v[None], population, axis=0) for k, v in d.items()}
        d["alpha_s"] = (d["alpha_s"] * (1.0 + 0.3 * rng.normal(size=d["alpha_s"].shape))).astype(F32)
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    gp_j = j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"), hypers=JGPHypers(*[leaf(k) for k in HYPERS]),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(d["trained"], bool),
    )
    return gp_j, convert.gp_model_from_numpy(d, "cpu")


def problem():
    """tests/test_kkt.py::test_lanes_backend_reports_matching_residuals' data
    as numpy: (obs, xref, uref, Q, scale, boxes, X0, U0)."""
    (lx, ux), (lu, uu) = j_quad.state_bounds(), j_quad.input_bounds()
    rng = np.random.default_rng(3)
    traj = np.asarray(j_traj(n_steps=64, dt=0.02), F32)
    obs = (traj[0][None] + rng.normal(0, 0.05, (B, NX))).astype(F32)
    scale = np.full((T + 1,), 0.02, F32)
    scale[-1] = 1.0
    tile = lambda a, n: np.tile(np.asarray(a, F32)[None, None], (B, n, 1))  # noqa: E731
    return dict(
        obs=obs, xref=np.tile(traj[: T + 1][None], (B, 1, 1)),
        uref=np.tile(np.asarray(j_quad.U_EQ, F32)[None], (T, 1)),
        Q=np.diag(np.asarray(Q12, F32)), R=np.diag(np.asarray(R4, F32)), scale=scale,
        lx=tile(lx, T + 1), ux=tile(ux, T + 1), lu=tile(lu, T), uu=tile(uu, T),
        X0=np.tile(obs[:, None], (1, T + 1, 1)), U0=tile(j_quad.U_EQ, T),
    )


def solve_both(linearizer, cfg_kw):
    p = problem()
    population = B if linearizer == "linearize_fn" else 0
    gp_j, gp_t = gp_pair(population)
    model_j, model_t = j_sym(dt=0.02), t_sym(dt=0.02)
    cfg_j = j_sqp.SqpConfig(**cfg_kw)
    cfg_t = convert.sqp_config_from_mapping(cfg_j._asdict())

    ja = lambda k: jnp.asarray(p[k])  # noqa: E731
    cost_j = j_sqp.OcpCost(xref=ja("xref"), uref=ja("uref"), Q=ja("Q"), R=ja("R"), Qe=ja("Q"),
                           scale=ja("scale"))
    bounds_j = j_sqp.OcpBounds(lx=ja("lx"), ux=ja("ux"), lu=ja("lu"), uu=ja("uu"))
    kw_j = {}
    fd_j = lambda x, u: j_gpmpc.augmented_fd(model_j, gp_j, x, u)  # noqa: E731
    if linearizer == "fd_jac3":
        kw_j["fd_jac3"] = j_jac.make_augmented_fd_jac(model_j, gp_j)
    elif linearizer == "linearize_fn":
        def one(g, Xb, Ub):
            fd_g = lambda x, u: j_gpmpc.augmented_fd(model_j, g, x, u)  # noqa: E731
            A, Bm = jax.vmap(jax.jacfwd(fd_g, argnums=(0, 1)))(Xb, Ub)
            return jax.vmap(fd_g)(Xb, Ub), A, Bm

        kw_j["linearize_fn"] = lambda X, U: jax.vmap(one)(gp_j, X, U)
        fd_j = None
    sol_j = jax.jit(lambda: j_lanes.sqp_solve_batch_lanes(
        fd_j, cost_j, bounds_j, ja("obs"), ja("X0"), ja("U0"), cfg_j, interpret=True, **kw_j))()

    ta = lambda k: torch.tensor(p[k])  # noqa: E731
    cost_t = t_sqp.OcpCost(xref=ta("xref"), uref=ta("uref"), Q=ta("Q"), R=ta("R"), Qe=ta("Q"),
                           scale=ta("scale"))
    bounds_t = t_sqp.OcpBounds(lx=ta("lx"), ux=ta("ux"), lu=ta("lu"), uu=ta("uu"))
    kw_t = {}
    fd_t = lambda x, u: t_gpmpc.augmented_fd(model_t, gp_t, x, u)  # noqa: E731
    if linearizer == "fd_jac3":
        kw_t["fd_jac3"] = t_jac.make_augmented_fd_jac(model_t, gp_t)
    elif linearizer == "linearize_fn":
        kw_t["linearize_fn"] = lambda X, U: torch.func.vmap(
            lambda g, Xb, Ub: t_lanes.jacfwd_linearize(
                lambda x, u: t_gpmpc.augmented_fd(model_t, g, x, u), Xb, Ub))(gp_t, X, U)
        fd_t = None
    sol_t = t_lanes.sqp_solve_batch_lanes(
        fd_t, cost_t, bounds_t, ta("obs"), ta("X0"), ta("U0"), cfg_t, lanes=8, **kw_t)
    return sol_j, sol_t


def assert_solutions_match(sol_j, sol_t):
    assert sol_t.X.shape == (B, T + 1, NX) and sol_t.U.shape == (B, T, NU)
    assert sol_t.X.dtype == torch.float32
    np.testing.assert_allclose(sol_t.X.numpy(), np.asarray(sol_j.X), atol=2e-4)
    np.testing.assert_allclose(sol_t.U.numpy(), np.asarray(sol_j.U), atol=2e-4)
    np.testing.assert_array_equal(sol_t.n_iters.numpy(), np.asarray(sol_j.n_iters))
    np.testing.assert_array_equal(sol_t.converged.numpy(), np.asarray(sol_j.converged))
    np.testing.assert_allclose(sol_t.eq_res.numpy(), np.asarray(sol_j.eq_res), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(sol_t.stat_res.numpy(), np.asarray(sol_j.stat_res), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(sol_t.step_norm.numpy(), np.asarray(sol_j.step_norm), rtol=1e-2,
                               atol=1e-5)


@pytest.mark.parametrize("linearizer", ["jacfwd", "fd_jac3", "linearize_fn"])
def test_sqp_solve_batch_lanes_matches_jax(linearizer):
    sol_j, sol_t = solve_both(linearizer, dict(sqp_iters=4, qp_iters=8, kkt_tol=1e-4))
    assert_solutions_match(sol_j, sol_t)
    assert int(sol_t.n_iters.max()) >= 2  # the solve iterated: this is not the warm start


def test_fixed_iteration_count_and_lm_damping_match_jax():
    """early_exit=False runs every iteration; lm_reg damps the Hessian diagonals only."""
    sol_j, sol_t = solve_both("jacfwd", dict(sqp_iters=3, qp_iters=8, early_exit=False, lm_reg=0.5,
                                             qp_mehrotra=True))
    assert_solutions_match(sol_j, sol_t)


def test_lane_width_refuses_horizons_past_the_last_kernel():
    assert t_lanes._lane_width(t_lanes.MAX_STREAM2_HORIZON) == t_lanes.LANES
    assert t_lanes._lane_width(8, lanes=4) == 4
    with pytest.raises(ValueError, match="supports horizons up to 1024") as e_t:
        t_lanes._lane_width(t_lanes.MAX_STREAM2_HORIZON + 1)
    with pytest.raises(ValueError) as e_j:
        j_lanes._lane_width(j_lanes.MAX_STREAM2_HORIZON + 1)
    assert str(e_t.value) == str(e_j.value)

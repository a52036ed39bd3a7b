"""The port's generic SQP (`ops/sqp.py::sqp_solve`) and nominal MPC
(`control/mpc.py`: `select_action`, the stateful `MPC`, `GPMPC.prior_ctrl`)
against the JAX package's, on the CPU, in float32 on both sides. Bars: the
SQP's X and U within 5e-4 (chip_smoke.py's QP bar) with equal per-scenario
iteration counts; the closed loop's control RMSE <= 1e-3 (BASELINE.md), the
reference driving the plant and the port solving the same observation at
every step (tests/test_accuracy.py:94)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
from gpmpc_tpu.control.mpc import MPC as JMPC
from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.models import quadrotor as j_quad
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.ops import sqp as j_sqp
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.ops import sqp as t_sqp

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: torch's intra-op threads cost more than they give on a
    shared CPU. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(B=3, T=10, seed=0):
    """B tracking problems on the figure eight: x0 near the trajectory at
    different phases, the reference windows from there, the quadrotor's
    boxes, a cold start (x0 repeated, the hover input)."""
    rng = np.random.default_rng(seed)
    traj = np.asarray(j_drone.make_trajectory(j_drone.EnvParams.default()), F32)
    starts = np.array([0, 40, 90][:B])
    x0 = (traj[starts] + rng.normal(0, 0.05, (B, 12))).astype(F32)
    xref = np.stack([traj[(s + np.arange(T + 1)) % len(traj)] for s in starts]).astype(F32)
    (lx, ux), (lu, uu) = j_quad.state_bounds(), j_quad.input_bounds()
    tile = lambda a, n: np.broadcast_to(np.asarray(a, F32), (B, n, len(a))).copy()  # noqa: E731
    scale = np.full(T + 1, 0.02, F32)
    scale[-1] = 1.0
    return dict(
        xref=xref, uref=np.tile(np.asarray(j_quad.U_EQ, F32), (T, 1)),
        Q=np.diag(np.asarray(Q_MPC, F32)), R=np.diag(np.asarray(R_MPC, F32)), scale=scale,
        lx=tile(lx, T + 1), ux=tile(ux, T + 1), lu=tile(lu, T), uu=tile(uu, T),
        x0=x0, X_init=np.repeat(x0[:, None], T + 1, axis=1),
        U_init=np.tile(np.asarray(j_quad.U_EQ, F32), (B, T, 1)),
    )


def _sqp_both(cfg_kw):
    p = _problem()
    prior = reference_prior_dict()
    cfg_j, cfg_t = j_sqp.SqpConfig(**cfg_kw), t_sqp.SqpConfig(**cfg_kw)
    cost = lambda m, c: c.OcpCost(xref=m(p["xref"]), uref=m(p["uref"]), Q=m(p["Q"]),  # noqa: E731
                                  R=m(p["R"]), Qe=m(p["Q"]), scale=m(p["scale"]))
    bounds = lambda m, c: c.OcpBounds(*[m(p[k]) for k in ("lx", "ux", "lu", "uu")])  # noqa: E731
    run_j = jax.jit(jax.vmap(
        partial(j_sqp.sqp_solve, j_sym(dt=0.02, params=prior).fd_func, cfg=cfg_j),
        in_axes=(j_sqp.OcpCost(0, None, None, None, None, None), 0, 0, 0, 0)))
    want = run_j(cost(jnp.asarray, j_sqp), bounds(jnp.asarray, j_sqp),
                 *[jnp.asarray(p[k]) for k in ("x0", "X_init", "U_init")])
    t = torch.as_tensor
    got = t_sqp.sqp_solve(t_sym(dt=0.02, params=prior).fd_func, cost(t, t_sqp), bounds(t, t_sqp),
                          *[t(p[k]) for k in ("x0", "X_init", "U_init")], cfg_t)
    return want, got, (cost(t, t_sqp), bounds(t, t_sqp), [t(p[k]) for k in ("x0", "X_init", "U_init")])


@pytest.mark.parametrize("cfg_kw", [
    dict(sqp_iters=8, qp_iters=10, early_exit=True),
    dict(sqp_iters=8, qp_iters=10, early_exit=False),
    dict(sqp_iters=8, qp_iters=10, qp_mehrotra=True, kkt_tol=1e-3),
    dict(sqp_iters=8, qp_iters=10, lm_reg=0.05, step_tol=2e-2),
], ids=["early-exit", "fixed-count", "mehrotra-kkt", "lm-reg"])
def test_sqp_solve_matches_jax(cfg_kw):
    """T = 10, B = 3 cold-started quadrotor problems on the prior's fd_func:
    per-scenario n_iters (5, 5, 6 with step_tol 1e-6; 5, 4, 4 under lm_reg
    with step_tol 2e-2) and converged equal to JAX's vmapped sqp_solve, X
    and U within 5e-4, the residuals within 5e-4 of their scale; and the
    port's run with early_exit flipped gives the same X, U and n_iters bit
    for bit (a converged scenario is frozen either way)."""
    want, got, args = _sqp_both(cfg_kw)
    assert len(set(got.n_iters.tolist())) == 2  # the scenarios stop at different iterations
    assert got.n_iters.tolist() == np.asarray(want.n_iters).tolist()
    assert got.converged.tolist() == np.asarray(want.converged).tolist()
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=5e-4)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=5e-4)
    for name in ("eq_res", "stat_res", "step_norm"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=5e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)
    cfg = t_sqp.SqpConfig(**cfg_kw)
    cfg = cfg._replace(early_exit=not cfg.early_exit)
    flip = t_sqp.sqp_solve(t_sym(dt=0.02, params=reference_prior_dict()).fd_func, *args[:2],
                           *args[2], cfg)
    assert torch.equal(flip.X, got.X) and torch.equal(flip.U, got.U)
    assert torch.equal(flip.n_iters, got.n_iters)


def _mpcs(T=10, **kw):
    prior = reference_prior_dict()
    traj = np.asarray(j_drone.make_trajectory(j_drone.EnvParams.default()))
    args = dict(horizon=T, sqp_iters=6, qp_iters=10, **kw)
    return (JMPC(j_sym(dt=0.02, params=prior), traj, Q_MPC, R_MPC, **args),
            t_mpc.MPC(t_sym(dt=0.02, params=prior), traj, Q_MPC, R_MPC, device="cpu", **args))


def test_mpc_closed_loop_matches_jax():
    """The stateful nominal MPC, quadrotor, T = 10, 6 SQP / 10 IP
    iterations, 30 steps: the reference drives the mismatched plant, the
    port solves each observation from its own warm start. Control RMSE <=
    1e-3; the reference window and the step counter as JAX's; after
    `reset`, step 0 again."""
    jm, tm = _mpcs()
    envp = j_drone.EnvParams.default()
    state, obs = j_drone.env_reset(envp, jax.random.PRNGKey(0))
    u_j, u_t = [], []
    for _ in range(30):
        u_j.append(jm.select_action(obs))
        u_t.append(tm.select_action(np.asarray(obs)))
        state, obs, *_ = j_drone.env_step(envp, state, jnp.asarray(u_j[-1]))
    err = np.asarray(u_t) - np.asarray(u_j)
    assert float(np.sqrt(np.mean(err**2))) <= 1e-3
    np.testing.assert_allclose(tm.reference_trajectory(), jm.reference_trajectory(), atol=1e-6)
    assert int(tm.state.traj_step[0]) == int(jm.state.traj_step) == 30
    info = tm._last_info
    assert float(info.clamp_frac) == 0.0 and float(info.soft_viol) == 0.0
    tm.reset()
    assert int(tm.state.traj_step[0]) == 0


def test_gpmpc_prior_ctrl_is_the_references():
    """GPMPC.prior_ctrl is the nominal MPC built with the controller's
    arguments, as the reference's: its cfg fields and consts equal the
    reference's prior_ctrl's, the GP-MPC constants share its consts, and its
    first action equals a standalone port MPC's with the same arguments bit
    for bit."""
    prior = reference_prior_dict()
    traj = np.asarray(j_drone.make_trajectory(j_drone.EnvParams.default()))
    kw = dict(horizon=8, q_mpc=Q_MPC, r_mpc=R_MPC, sqp_iters=5, qp_iters=9, lm_reg=0.1)
    jc = JGPMPC(j_sym(dt=0.02, params=prior), traj, prior, **kw)
    tc = t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), traj, prior, device="cpu", **kw)
    assert isinstance(tc.prior_ctrl, t_mpc.MPC) and tc.consts.mpc is tc.prior_ctrl.consts
    assert tuple(tc.prior_ctrl.cfg) == tuple(jc.prior_ctrl.cfg)
    for a, b in zip(tc.prior_ctrl.consts, jc.prior_ctrl.consts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    _, alone = _mpcs(T=8, lm_reg=0.1)
    alone.cfg = alone.cfg._replace(sqp_iters=5, qp_iters=9)
    obs = traj[3].astype(F32)
    assert np.array_equal(tc.prior_ctrl.select_action(obs), alone.select_action(obs))


def test_a_nan_solve_raises():
    """A non-finite action is the reference's failed-solver status: the MPC,
    the prior controller and the GP-MPC controller on xla raise
    RuntimeError."""
    _, tm = _mpcs(T=4)
    bad = np.full(12, np.nan, F32)
    with pytest.raises(RuntimeError, match="non-finite action"):
        tm.select_action(bad)
    prior = reference_prior_dict()
    traj = np.asarray(j_drone.make_trajectory(j_drone.EnvParams.default()))
    tc = t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), traj, prior, horizon=4, q_mpc=Q_MPC,
                       r_mpc=R_MPC, sqp_iters=2, qp_iters=3, device="cpu", step_backend="xla")
    for ctrl in (tc.prior_ctrl, tc):
        with pytest.raises(RuntimeError, match="non-finite action"):
            ctrl.select_action(bad)


def test_fd_and_dfd_func_match_jax():
    """SymbolicModel.fd_func (RK4 of fc_func) and dfd_func (its forward-mode
    Jacobians) on a batch of 5 points against JAX's per point: 1e-6 and 1e-5,
    float32 out."""
    prior = reference_prior_dict()
    mj, mt = j_sym(dt=0.02, params=prior), t_sym(dt=0.02, params=prior)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.3, (5, 12)).astype(F32)
    u = (np.asarray(j_quad.U_EQ) + rng.normal(0, 0.05, (5, 4))).astype(F32)
    fd_j = np.asarray(jax.vmap(mj.fd_func)(jnp.asarray(x), jnp.asarray(u)))
    A_j, B_j = (np.asarray(a) for a in jax.vmap(mj.dfd_func)(jnp.asarray(x), jnp.asarray(u)))
    fd_t = mt.fd_func(torch.as_tensor(x), torch.as_tensor(u))
    A_t, B_t = mt.dfd_func(torch.as_tensor(x), torch.as_tensor(u))
    assert fd_t.dtype == A_t.dtype == torch.float32
    np.testing.assert_allclose(fd_t.numpy(), fd_j, atol=1e-6)
    np.testing.assert_allclose(A_t.numpy(), A_j, atol=1e-5)
    np.testing.assert_allclose(B_t.numpy(), B_j, atol=1e-5)

"""Port models, trajectory, residual spec and plant against the JAX package.

Same seeded numpy inputs through both; float32 on both sides (the suite's
conftest turns on JAX x64, so the JAX side is cast explicitly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.models import quadrotor as j_quad
from gpmpc_tpu.models.residual import QUADROTOR_SPEC as J_SPEC
from gpmpc_tpu.models.trajectory import figure_eight_trajectory as j_traj
from gpmpc_tpu.control.gpmpc import slice_gp_inputs as j_slice
from gpmpc_tpu_torch.control.gpmpc import slice_gp_inputs as t_slice
from gpmpc_tpu_torch.envs import drone as t_drone
from gpmpc_tpu_torch.models import quadrotor as t_quad
from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC as T_SPEC
from gpmpc_tpu_torch.models.trajectory import figure_eight_trajectory as t_traj

F32 = np.float32
ATOL = 1e-6


def _xu(seed, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.4, (n, 12)).astype(F32)
    u = np.concatenate([rng.uniform(0.15, 0.55, (n, 1)), rng.uniform(-0.4, 0.4, (n, 3))],
                       axis=1).astype(F32)
    return x, u


def _j(a):
    return jnp.asarray(a, jnp.float32)


@pytest.mark.parametrize("params", ["PRIOR_PARAMS", "TRUE_PARAMS"])
def test_dynamics_and_rk4_match_jax(params):
    x, u = _xu(0)
    pj, pt = getattr(j_quad, params), getattr(t_quad, params)
    assert tuple(pj) == tuple(pt)
    fj = jax.vmap(lambda a, b: j_quad.continuous_dynamics(a, b, pj))(_j(x), _j(u))
    ft = t_quad.continuous_dynamics(torch.as_tensor(x), torch.as_tensor(u), pt)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj, F32), atol=ATOL)

    dyn_j = lambda a, b: j_quad.continuous_dynamics(a, b, pj)  # noqa: E731
    dyn_t = lambda a, b: t_quad.continuous_dynamics(a, b, pt)  # noqa: E731
    xn_j = jax.vmap(lambda a, b: j_quad.rk4(dyn_j, a, b, 0.02))(_j(x), _j(u))
    xn_t = t_quad.rk4(dyn_t, torch.as_tensor(x), torch.as_tensor(u), 0.02)
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn_j, F32), atol=ATOL)


def test_bounds_and_constants_match_jax():
    for fj, ft in ((j_quad.state_bounds, t_quad.state_bounds),
                   (j_quad.input_bounds, t_quad.input_bounds)):
        for a, b in zip(fj(), ft()):
            np.testing.assert_array_equal(np.asarray(a, F32), b)
    np.testing.assert_array_equal(j_quad.U_EQ, t_quad.U_EQ)
    assert (t_quad.IDX_PHI, t_quad.IDX_THETA, t_quad.IDX_DPHI, t_quad.IDX_DTHETA) == (
        j_quad.IDX_PHI, j_quad.IDX_THETA, j_quad.IDX_DPHI, j_quad.IDX_DTHETA)


@pytest.mark.parametrize("n_steps,amplitude", [(300, 0.8), (64, 0.1)])
def test_trajectory_matches_jax(n_steps, amplitude):
    tj = j_traj(n_steps=n_steps, dt=0.02, amplitude=amplitude)
    tt = t_traj(n_steps=n_steps, dt=0.02, amplitude=amplitude)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj, F32), atol=ATOL)


def test_residual_spec_matches_jax():
    x, u = _xu(1)
    zj = J_SPEC.gp_input(_j(x), _j(u))
    zt = T_SPEC.gp_input(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj, F32), atol=ATOL)
    np.testing.assert_allclose(
        t_slice(zt, T_SPEC).numpy(), np.asarray(j_slice(zj, J_SPEC), F32), atol=ATOL
    )
    np.testing.assert_allclose(
        T_SPEC.var_factors(zt).numpy(), np.asarray(J_SPEC.var_factors(zj), F32), atol=ATOL
    )
    np.testing.assert_allclose(
        T_SPEC.kernel_params(t_quad.PRIOR_PARAMS).numpy(),
        np.asarray(J_SPEC.kernel_params(j_quad.PRIOR_PARAMS), F32), atol=0,
    )
    for attr in ("gp_idx", "uncertain_dim", "z_dim", "num_gps", "gp_input_dim",
                 "supports_kernel_linearize"):
        assert getattr(T_SPEC, attr) == getattr(J_SPEC, attr)


def test_env_step_matches_jax_default_plant():
    """Default plant (lag, drag, 1-step delay): 6 steps of both on the same
    state, delay queue and actions."""
    rng = np.random.default_rng(2)
    B = 16
    pj, pt = j_drone.EnvParams.default(), t_drone.EnvParams.default()
    x0 = (np.asarray(j_drone.make_trajectory(pj))[0] + 0.02 * rng.normal(size=(B, 12))).astype(F32)
    u_h = np.asarray(j_drone.hover_input(pj.params), F32)
    np.testing.assert_allclose(t_drone.hover_input(pt.params).numpy(), u_h, atol=0)
    actions = (u_h + np.concatenate([0.05 * rng.normal(size=(6, B, 1)),
                                     0.1 * rng.normal(size=(6, B, 3))], axis=2)).astype(F32)

    sj = j_drone.EnvState(
        x=_j(x0), t=jnp.zeros(B, jnp.int32), rng=jax.random.split(jax.random.PRNGKey(0), B),
        u_act=_j(np.tile(u_h, (B, 1))), u_queue=_j(np.tile(u_h, (B, pj.delay_steps, 1))),
    )
    st = t_drone.EnvState(
        x=torch.as_tensor(x0), t=torch.zeros(B, dtype=torch.int32),
        u_act=torch.as_tensor(np.tile(u_h, (B, 1))),
        u_queue=torch.as_tensor(np.tile(u_h, (B, pt.delay_steps, 1))),
    )
    step_j = jax.jit(jax.vmap(lambda s, a: j_drone.env_step(pj, s, a)))
    for a in actions:
        sj, oj, rj, tj, trj = step_j(sj, _j(a))
        st, ot, rt, tt, trt = t_drone.env_step(pt, st, torch.as_tensor(a))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj, F32), atol=ATOL)
        np.testing.assert_allclose(st.u_act.numpy(), np.asarray(sj.u_act, F32), atol=ATOL)
        np.testing.assert_allclose(st.u_queue.numpy(), np.asarray(sj.u_queue, F32), atol=0)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj, F32), atol=ATOL)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(trt.numpy(), np.asarray(trj))
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(sj.t))


def test_env_reset_starts_at_trajectory_with_hover_actuators():
    p = t_drone.EnvParams.default()
    gen = torch.Generator().manual_seed(0)
    st, obs = t_drone.env_reset(p, 32, gen)
    traj0 = t_drone.make_trajectory(p)[0]
    dev = (obs - traj0).std().item()
    assert obs.shape == (32, 12) and abs(dev - p.init_noise) < 0.3 * p.init_noise
    np.testing.assert_allclose(st.u_queue[:, 0].numpy(), st.u_act.numpy(), atol=0)
    gen2 = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(t_drone.env_reset(p, 32, gen2)[1].numpy(), obs.numpy())

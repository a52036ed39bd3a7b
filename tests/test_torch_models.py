"""Port models, trajectory, residual spec and plant against the JAX package.

Same seeded numpy inputs through both; float32 on both sides (the suite's
conftest turns on JAX x64, so the JAX side is cast explicitly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.envs import cartpole_env as j_cart_env
from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.envs import twolink_env as j_twolink_env
from gpmpc_tpu.models import cartpole as j_cart
from gpmpc_tpu.models import quadrotor as j_quad
from gpmpc_tpu.models import residual as j_residual
from gpmpc_tpu.models import twolink as j_twolink
from gpmpc_tpu.models.trajectory import figure_eight_trajectory as j_traj
from gpmpc_tpu.control.gpmpc import slice_gp_inputs as j_slice
from gpmpc_tpu_torch.control.gpmpc import slice_gp_inputs as t_slice
from gpmpc_tpu_torch.envs import cartpole_env as t_cart_env
from gpmpc_tpu_torch.envs import drone as t_drone
from gpmpc_tpu_torch.envs import twolink_env as t_twolink_env
from gpmpc_tpu_torch.models import cartpole as t_cart
from gpmpc_tpu_torch.models import quadrotor as t_quad
from gpmpc_tpu_torch.models import residual as t_residual
from gpmpc_tpu_torch.models import twolink as t_twolink
from gpmpc_tpu_torch.models.trajectory import figure_eight_trajectory as t_traj

F32 = np.float32
ATOL = 1e-6


# family -> (JAX model module, port model module, JAX plant, port plant, spec name)
FAMILY_MODULES = {
    "quadrotor": (j_quad, t_quad, j_drone, t_drone, "QUADROTOR_SPEC"),
    "cartpole": (j_cart, t_cart, j_cart_env, t_cart_env, "CARTPOLE_SPEC"),
    "twolink": (j_twolink, t_twolink, j_twolink_env, t_twolink_env, "TWOLINK_SPEC"),
}


def _xu(seed, n=64, family="quadrotor"):
    """States and inputs in the family's operating range."""
    rng = np.random.default_rng(seed)
    if family == "quadrotor":
        x = rng.normal(0, 0.4, (n, 12))
        u = np.concatenate([rng.uniform(0.15, 0.55, (n, 1)), rng.uniform(-0.4, 0.4, (n, 3))], axis=1)
    elif family == "cartpole":
        x = rng.normal(0, 0.4, (n, 4))
        u = rng.uniform(-8.0, 8.0, (n, 1))
    else:
        x = np.stack([rng.uniform(-2.5, 0.2, n), rng.uniform(-0.5, 2.0, n),
                      rng.normal(0, 1.0, n), rng.normal(0, 1.0, n)], axis=1)
        u = rng.uniform(-15.0, 15.0, (n, 2))
    return x.astype(F32), u.astype(F32)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _params(family, which):
    """(JAX params, port params): the prior's, or the plant's true ones."""
    jm, tm, je, te, _ = FAMILY_MODULES[family]
    if family == "quadrotor":
        return getattr(jm, which), getattr(tm, which)
    if which == "PRIOR_PARAMS":
        return type(je.TRUE_PARAMS)(), type(te.TRUE_PARAMS)()
    return je.TRUE_PARAMS, te.TRUE_PARAMS


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
@pytest.mark.parametrize("params", ["PRIOR_PARAMS", "TRUE_PARAMS"])
def test_dynamics_and_rk4_match_jax(params, family):
    jm, tm = FAMILY_MODULES[family][:2]
    x, u = _xu(0, family=family)
    pj, pt = _params(family, params)
    assert tuple(pj) == tuple(pt)
    fj = jax.vmap(lambda a, b: jm.continuous_dynamics(a, b, pj))(_j(x), _j(u))
    ft = tm.continuous_dynamics(torch.as_tensor(x), torch.as_tensor(u), pt)
    # the arm's accelerations reach ~200 here, where float32 rounding through
    # the 2x2 mass-matrix solve (order of operations) is ~2e-6 relative
    rtol = 1e-5 if family == "twolink" else 0.0
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj, F32), atol=ATOL, rtol=rtol)

    dyn_j = lambda a, b: jm.continuous_dynamics(a, b, pj)  # noqa: E731
    dyn_t = lambda a, b: tm.continuous_dynamics(a, b, pt)  # noqa: E731
    xn_j = jax.vmap(lambda a, b: jm.rk4(dyn_j, a, b, 0.02))(_j(x), _j(u))
    xn_t = tm.rk4(dyn_t, torch.as_tensor(x), torch.as_tensor(u), 0.02)
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn_j, F32), atol=ATOL)


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_bounds_and_constants_match_jax(family):
    jm, tm = FAMILY_MODULES[family][:2]
    for fj, ft in ((jm.state_bounds, tm.state_bounds), (jm.input_bounds, tm.input_bounds)):
        for a, b in zip(fj(), ft()):
            np.testing.assert_array_equal(np.asarray(a, F32), b)
    assert (tm.NX, tm.NU, tm.GRAVITY) == (jm.NX, jm.NU, jm.GRAVITY)
    if family == "quadrotor":
        np.testing.assert_array_equal(j_quad.U_EQ, t_quad.U_EQ)
        assert (t_quad.IDX_PHI, t_quad.IDX_THETA, t_quad.IDX_DPHI, t_quad.IDX_DTHETA) == (
            j_quad.IDX_PHI, j_quad.IDX_THETA, j_quad.IDX_DPHI, j_quad.IDX_DTHETA)
    elif family == "twolink":  # the trim pair of symbolic_twolink
        mj, mt = j_twolink.symbolic_twolink(0.02), t_twolink.symbolic_twolink(0.02)
        np.testing.assert_allclose(mt.u_eq, np.asarray(mj.u_eq), rtol=1e-6)
        np.testing.assert_array_equal(mt.x_eq, np.asarray(mj.x_eq))
        q = (jnp.asarray(-1.2), jnp.asarray(0.4))
        np.testing.assert_allclose(
            t_twolink.gravity_torques(torch.tensor(-1.2), torch.tensor(0.4)).numpy(),
            np.asarray(j_twolink.gravity_torques(*q), F32), atol=ATOL)


@pytest.mark.parametrize("n_steps,amplitude", [(300, 0.8), (64, 0.1)])
def test_trajectory_matches_jax(n_steps, amplitude):
    tj = j_traj(n_steps=n_steps, dt=0.02, amplitude=amplitude)
    tt = t_traj(n_steps=n_steps, dt=0.02, amplitude=amplitude, device="cpu")
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj, F32), atol=ATOL)


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_residual_spec_matches_jax(family):
    J_SPEC = getattr(j_residual, FAMILY_MODULES[family][4])
    T_SPEC = getattr(t_residual, FAMILY_MODULES[family][4])
    pj, pt = _params(family, "PRIOR_PARAMS")
    x, u = _xu(1, family=family)
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
        T_SPEC.kernel_params(pt).numpy(), np.asarray(J_SPEC.kernel_params(pj), F32), atol=0,
    )
    for attr in ("name", "gp_idx", "uncertain_dim", "z_dim", "num_gps", "gp_input_dim",
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
    np.testing.assert_allclose(t_drone.hover_input(pt.params, device="cpu").numpy(), u_h, atol=0)
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


@pytest.mark.parametrize("family", ["cartpole", "twolink"])
def test_family_plant_matches_jax(family):
    """Default plant (the cartpole's friction, gain error and force bias; the
    arm's tip payload, joint friction and torque gain/bias) and its
    trajectory: 6 steps of both from the same state and actions."""
    je, te = FAMILY_MODULES[family][2:4]
    pj, pt = je.EnvParams.default(), te.EnvParams.default()
    assert tuple(pj.params) == tuple(pt.params) and pj._fields == pt._fields
    np.testing.assert_allclose(te.make_trajectory(pt, device="cpu").numpy(), np.asarray(je.make_trajectory(pj), F32),
                               atol=ATOL)
    rng = np.random.default_rng(3)
    B = 16
    x0 = (np.asarray(je.make_trajectory(pj))[0] + 0.05 * rng.normal(size=(B, 4))).astype(F32)
    nu = 1 if family == "cartpole" else 2
    actions = rng.uniform(-6.0, 6.0, (6, B, nu)).astype(F32)
    sj = je.EnvState(x=_j(x0), t=jnp.zeros(B, jnp.int32), rng=jax.random.split(jax.random.PRNGKey(0), B))
    st = te.EnvState(x=torch.as_tensor(x0), t=torch.zeros(B, dtype=torch.int32))
    step_j = jax.jit(jax.vmap(lambda s, a: je.env_step(pj, s, a)))
    for a in actions:
        sj, oj, rj, tj, trj = step_j(sj, _j(a))
        st, ot, rt, tt, trt = te.env_step(pt, st, torch.as_tensor(a))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj, F32), atol=ATOL)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj, F32), atol=ATOL)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(trt.numpy(), np.asarray(trj))
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(sj.t))
    with pytest.raises(NotImplementedError, match="process noise"):
        te.env_step(pt._replace(noise_std=0.1), st, torch.as_tensor(actions[0]))


@pytest.mark.parametrize("family", ["cartpole", "twolink"])
def test_family_env_reset_starts_at_trajectory(family):
    """env_reset's state from the drawn x0: t = 0, obs = state.x = traj[0] +
    init_noise * N(0, 1) from the caller's generator, reproducible."""
    te = FAMILY_MODULES[family][3]
    p = te.EnvParams.default()
    st, obs = te.env_reset(p, 64, torch.Generator().manual_seed(0), device="cpu")
    noise = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(obs.numpy(), (te.make_trajectory(p, device="cpu")[0] + p.init_noise * noise).numpy(),
                               atol=1e-7)
    np.testing.assert_array_equal(st.x.numpy(), obs.numpy())
    assert st.t.dtype == torch.int32 and int(st.t.abs().max()) == 0


def test_env_reset_starts_at_trajectory_with_hover_actuators():
    p = t_drone.EnvParams.default()
    gen = torch.Generator().manual_seed(0)
    st, obs = t_drone.env_reset(p, 32, gen, device="cpu")
    traj0 = t_drone.make_trajectory(p, device="cpu")[0]
    dev = (obs - traj0).std().item()
    assert obs.shape == (32, 12) and abs(dev - p.init_noise) < 0.3 * p.init_noise
    np.testing.assert_allclose(st.u_queue[:, 0].numpy(), st.u_act.numpy(), atol=0)
    gen2 = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(t_drone.env_reset(p, 32, gen2, device="cpu")[1].numpy(), obs.numpy())

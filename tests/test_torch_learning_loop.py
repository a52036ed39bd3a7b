"""tests/test_learning_loop.py on the port, for the quadrotor and the
cartpole: collect transitions with the untrained controller (whose GP mean
is zero and whose tightening is off: the prior controller's problem; the
nominal MPC is not ported), preprocess them through the family's
ResidualSpec, train the GPs at the config-default 500 iterations and control
with the trained GP-MPC. The tail cost must drop below 0.6 of the untrained
controller's (the JAX test's bar) with clamp_frac 0. On the CPU, the lanes
step with the plain versions."""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.control.gpmpc import GPMPC
from gpmpc_tpu_torch.envs import cartpole_env, drone
from gpmpc_tpu_torch.models import cartpole
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
from tests._torch_threads import _one_thread  # noqa: F401


QUAD_PRIOR = {
    "a": 12.1432, "b": 1.8118, "c": -72.08, "d": -7.5755,
    "e": 39.8653, "f": -72.08, "h": -7.5755, "l": 39.8653,
}
QUAD_Q = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
QUAD_R = [3, 3, 3, 0.1]


def _quadrotor_setup():
    env_p = drone.EnvParams.default()
    ctrl = GPMPC(
        symbolic_attitude(dt=0.02, params=QUAD_PRIOR), drone.make_trajectory(env_p, "cpu").numpy(),
        QUAD_PRIOR, horizon=15, q_mpc=QUAD_Q, r_mpc=QUAD_R, sparse_gp=True, max_gp_samples=20,
        seed=1, sqp_iters=6, qp_iters=8, max_gp_points=64, device="cpu", step_backend="lanes",
    )
    return drone, env_p, ctrl, 60, 0.6, 1


def _cartpole_setup():
    env_p = cartpole_env.EnvParams.default()._replace(
        n_steps=80, traj_period_steps=300, force_bias=2.5, gain=0.85)
    ctrl = GPMPC(
        cartpole.symbolic_cartpole(dt=0.02), cartpole_env.make_trajectory(env_p, "cpu").numpy(), None,
        horizon=20, q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05], sparse_gp=True, max_gp_samples=30,
        seed=1, sqp_iters=5, qp_iters=8, max_gp_points=80,
        bounds=(cartpole.state_bounds(), cartpole.input_bounds()), device="cpu", step_backend="lanes",
    )
    return cartpole_env, env_p, ctrl, 80, 0.6, 1


FAMILIES = {"quadrotor": _quadrotor_setup, "cartpole": _cartpole_setup}


def _rollout(env, env_p, ctrl, n, seed):
    """(states (n+1, nx), actions (n, nu), costs (n,)) from reset `seed`."""
    es, obs = env.env_reset(env_p, 1, torch.Generator().manual_seed(seed), "cpu")
    ctrl.reset()
    X, U, costs = [obs[0].numpy()], [], []
    for _ in range(n):
        u = ctrl.select_action(X[-1])
        es, obs, reward, *_ = env.env_step(env_p, es, torch.as_tensor(u)[None])
        X.append(obs[0].numpy())
        U.append(u)
        costs.append(-float(reward[0]))
    return np.asarray(X), np.asarray(U), np.asarray(costs)


@pytest.mark.slow
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_learning_improves_over_the_untrained_controller(family):
    env, env_p, ctrl, n, max_ratio, n_episodes = FAMILIES[family]()
    eps = [_rollout(env, env_p, ctrl, n, seed) for seed in range(n_episodes)]
    cost_prior = eps[0][2]
    xi, ti = ctrl.preprocess_data(np.concatenate([e[0][:-1] for e in eps]),
                                  np.concatenate([e[1] for e in eps]),
                                  np.concatenate([e[0][1:] for e in eps]))
    spec = ctrl.spec
    assert xi.shape == (n * n_episodes, spec.z_dim) and ti.shape == (n * n_episodes, spec.num_gps)
    assert np.max(np.abs(ti.mean(axis=0))) > 0.1  # the mismatch shows in the targets
    ctrl.train_gp(xi, ti, lr=0.05, iterations=500)
    _, _, cost_gp = _rollout(env, env_p, ctrl, n, 0)
    tail = slice(-max(n // 3, 10), None)
    ratio = cost_gp[tail].mean() / cost_prior[tail].mean()
    assert ratio < max_ratio, (
        f"{family}: GP-MPC tail cost ratio {ratio:.3f} (untrained {cost_prior[tail].mean():.4f} -> "
        f"GP {cost_gp[tail].mean():.4f})"
    )
    assert float(ctrl._last_info.clamp_frac) == 0.0

"""The plants' process noise and the stateful single-scenario envs of the port
(`envs/drone.py::DroneFigureEightEnv`, `envs/cartpole_env.py::
CartpoleTrackEnv`, `envs/twolink_env.py::TwoLinkTrackEnv`, `env_step(...,
generator=)`) against the JAX package.

The classes run at `init_noise=0` (JAX's draws cannot be reproduced, so the
start is the trajectory's first point on both sides) and take the same
seeded actions: observations and rewards within 1e-5 absolute at each of 12
steps (float32 RK4 in another order, compounded over the steps; the batched
plants' bar is 1e-6 a step, tests/test_torch_models.py), the flags equal.
The noise is checked by its law: added to the family's velocity rows only,
mean within 5 standard errors of 0 and standard deviation within 3 % of
noise_std * sqrt(dt) over 4,000 scenarios x rows.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.envs import cartpole_env as j_cart_env
from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.envs import twolink_env as j_twolink_env
from gpmpc_tpu_torch.envs import cartpole_env as t_cart_env
from gpmpc_tpu_torch.envs import drone as t_drone
from gpmpc_tpu_torch.envs import twolink_env as t_twolink_env
from tests._torch_threads import _one_thread  # noqa: F401


F32 = np.float32
# family -> (JAX module, JAX class, port module, port class, nu, velocity rows, action range)
FAMILIES = {
    "quadrotor": (j_drone, j_drone.DroneFigureEightEnv, t_drone, t_drone.DroneFigureEightEnv, 4,
                  [1, 3, 5, 9, 10], None),
    "cartpole": (j_cart_env, j_cart_env.CartpoleTrackEnv, t_cart_env, t_cart_env.CartpoleTrackEnv,
                 1, [1, 3], 4.0),
    "twolink": (j_twolink_env, j_twolink_env.TwoLinkTrackEnv, t_twolink_env,
                t_twolink_env.TwoLinkTrackEnv, 2, [2, 3], 4.0),
}


def actions(family: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nu, span = FAMILIES[family][4], FAMILIES[family][6]
    if span is None:  # the quadrotor: thrust near hover, small attitude commands
        return np.concatenate([rng.uniform(0.25, 0.4, (n, 1)), rng.uniform(-0.1, 0.1, (n, 3))],
                              axis=1).astype(F32)
    return rng.uniform(-span, span, (n, nu)).astype(F32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stateful_env_matches_jax(family):
    """reset(seed), 12 steps, trajectory and dt of the port's class against
    the reference's, both at init_noise=0."""
    j_mod, j_cls, t_mod, t_cls, *_ = FAMILIES[family]
    env_j = j_cls(j_mod.EnvParams.default()._replace(init_noise=0.0))
    env_t = t_cls(t_mod.EnvParams.default()._replace(init_noise=0.0), device="cpu")
    np.testing.assert_allclose(env_t.trajectory.numpy(), np.asarray(env_j.trajectory, F32),
                               atol=1e-6)
    assert env_t.dt == env_j.dt
    obs_j, info_j = env_j.reset(seed=3)
    obs_t, info_t = env_t.reset(seed=3)
    assert info_t == info_j == {}
    assert isinstance(obs_t, torch.Tensor) and obs_t.shape == obs_j.shape
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j, F32), atol=1e-6)
    for a in actions(family, 12):
        obs_j, r_j, term_j, trunc_j, _ = env_j.step(jnp.asarray(a))
        obs_t, r_t, term_t, trunc_t, info = env_t.step(a)
        assert obs_t.shape == obs_j.shape and r_t.shape == ()
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j, F32), atol=1e-5)
        np.testing.assert_allclose(float(r_t), float(r_j), atol=1e-5)
        assert (term_t, trunc_t, info) == (term_j, trunc_j, {})
        assert isinstance(term_t, bool) and isinstance(trunc_t, bool)
    env_t.close()
    assert env_t._state is None


@pytest.mark.parametrize("family", list(FAMILIES))
def test_process_noise_on_velocity_rows_at_its_scale(family):
    """One batched step with noise_std = 0.5 against the same step without:
    the difference is zero off the velocity rows, and on them it has the law
    of noise_std * sqrt(dt) * N(0, 1), drawn from the given generator; both
    functional entry points take it."""
    _, _, t_mod, _, nu, rows, _ = FAMILIES[family]
    p = t_mod.EnvParams.default()
    noisy = p._replace(noise_std=0.5)
    n = 4000 // len(rows)
    st, _ = t_mod.env_reset(p, n, torch.Generator().manual_seed(0), "cpu")
    u = torch.as_tensor(np.repeat(actions(family, 1), n, axis=0))
    gen = torch.Generator().manual_seed(1)
    quiet = t_mod.env_step(p, st, u)[1]
    noisy_obs = t_mod.env_step(noisy, st, u, generator=gen)[1]
    params = t_mod.params_to_array(p.params, "cpu")
    dynamic = t_mod.env_step_dynamic(noisy, params, st, u, generator=gen)[1]
    for obs in (noisy_obs, dynamic):
        diff = (obs - quiet).numpy()
        other = [i for i in range(diff.shape[1]) if i not in rows]
        assert np.abs(diff[:, other]).max() <= 1e-6
        d = diff[:, rows].ravel()
        sigma = 0.5 * math.sqrt(p.dt)
        assert abs(d.mean()) < 5 * sigma / math.sqrt(d.size)
        assert abs(d.std() / sigma - 1.0) < 0.03
    assert not torch.equal(noisy_obs, dynamic)  # the generator moved on


@pytest.mark.parametrize("family", list(FAMILIES))
def test_process_noise_needs_a_generator(family):
    """noise_std > 0 without a generator raises, in the functional steps;
    it never draws from torch's global generator."""
    _, _, t_mod, _, nu, _, _ = FAMILIES[family]
    p = t_mod.EnvParams.default()._replace(noise_std=0.1)
    st, _ = t_mod.env_reset(p, 2, torch.Generator().manual_seed(0), "cpu")
    state = torch.random.get_rng_state()
    with pytest.raises(ValueError, match="generator"):
        t_mod.env_step(p, st, torch.zeros(2, nu))
    with pytest.raises(ValueError, match="generator"):
        t_mod.env_step_dynamic(p, t_mod.params_to_array(p.params, "cpu"), st, torch.zeros(2, nu))
    assert torch.equal(torch.random.get_rng_state(), state)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_same_seed_same_draw(family):
    """Two envs with process noise reset with the same seed give the same
    start and the same noisy steps; another seed gives others."""
    _, _, t_mod, t_cls, *_ = FAMILIES[family]
    p = t_mod.EnvParams.default()._replace(noise_std=0.2)
    runs = []
    for seed in (7, 7, 8):
        env = t_cls(p, device="cpu")
        obs = [env.reset(seed=seed)[0]]
        obs += [env.step(a)[0] for a in actions(family, 3)]
        runs.append(torch.stack(obs))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])

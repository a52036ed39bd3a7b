"""The port's plants with per-scenario coefficients and its episodes
(`parallel/batch.py::batched_episode` on lanes) against the JAX package's,
on the CPU. The JAX episodes run on `xla` (the vmapped `select_action`
inside a scan). With `init_noise=0` and fixed coefficients both sides
start from the trajectory's first point, so the random draws (which cannot
match) do not enter. Bars: the plants at 1e-6, the episodes' actions within
5e-4 at every step (tests/test_torch_step.py's bar) and the observations
within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.envs import cartpole_env as j_cart_env
from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.envs import twolink_env as j_two_env
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.parallel.batch import batched_episode as j_batched_episode
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict, synthetic_gp_model
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.envs import cartpole_env as t_cart_env
from gpmpc_tpu_torch.envs import drone as t_drone
from gpmpc_tpu_torch.envs import twolink_env as t_two_env
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.parallel import batch as t_batch
from tests._torch_threads import _one_thread  # noqa: F401

ENVS = {"quadrotor": (j_drone, t_drone), "cartpole": (j_cart_env, t_cart_env),
        "twolink": (j_two_env, t_two_env)}


@pytest.mark.parametrize("family", sorted(ENVS))
def test_env_step_dynamic_and_params_match_jax(family):
    """params_to_array exactly; three steps of env_step_dynamic for 4
    scenarios, each with its own coefficients (scaled by 0.9-1.1), against
    JAX's per scenario (1e-6); randomize_params' deterministic part: scale 0
    gives the base, and every factor lies in 1 +- 2 scale."""
    je, te = ENVS[family]
    p_j, p_t = je.EnvParams.default(), te.EnvParams.default()
    base_j, base_t = je.params_to_array(p_j.params), te.params_to_array(p_t.params, "cpu")
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    rng = np.random.default_rng(0)
    B, k = 4, base_t.shape[0]
    params = (np.asarray(base_j) * rng.uniform(0.9, 1.1, (B, k))).astype(np.float32)
    s_j, obs_j = jax.vmap(lambda key: je.env_reset(p_j, key))(jax.random.split(jax.random.PRNGKey(1), B))
    s_t, _ = te.env_reset(p_t, B, torch.Generator().manual_seed(0), "cpu")
    s_t = s_t._replace(x=torch.as_tensor(np.asarray(obs_j)))
    nu = {"quadrotor": 4, "cartpole": 1, "twolink": 2}[family]
    for i in range(3):
        u = rng.normal(0, 0.1, (B, nu)).astype(np.float32)
        if family == "quadrotor":
            u[:, 0] += 0.45
        s_j, o_j, r_j, *_ = jax.vmap(lambda pa, s, a: je.env_step_dynamic(p_j, pa, s, a))(
            jnp.asarray(params), s_j, jnp.asarray(u))
        s_t, o_t, r_t, *_ = te.env_step_dynamic(p_t, torch.as_tensor(params), s_t, torch.as_tensor(u))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-6)
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-6)
    gen = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(te.randomize_params(gen, p_t.params, 0.0, 5).numpy(),
                                  np.broadcast_to(base_t.numpy(), (5, k)))
    f = te.randomize_params(gen, p_t.params, 0.1, 200) / base_t
    assert f.shape == (200, k) and float(f.min()) >= 0.8 - 1e-6 and float(f.max()) <= 1.2 + 1e-6
    assert float(f.std()) > 0.05


def _jax_gp(population: bool, B: int):
    gp = synthetic_gp_model(max_points=32, max_inducing=12, n_data=24, n_train=10, seed=3)
    if not population:
        return gp
    scale = jnp.asarray(1.0 + 0.1 * np.arange(B), jnp.float32)
    pop = jax.tree.map(lambda l: jnp.broadcast_to(l[None], (B,) + l.shape), gp)
    return pop._replace(alpha_s=pop.alpha_s * scale[:, None, None])


def _to_port(gp_j):
    flat = {k: np.asarray(v) for k, v in gp_j._asdict().items() if k != "hypers"}
    flat.update({k: np.asarray(v) for k, v in gp_j.hypers._asdict().items()})
    return convert.gp_model_from_numpy(flat, "cpu")


@pytest.mark.parametrize("population", [False, True])
def test_batched_episode_matches_jax(population):
    """B = 3 scenarios, T = 8, 10 steps, the quadrotor with the synthetic
    sparse GP (12 inducing points), shared or a population whose scenarios'
    mean weights are scaled by 1, 1.1, 1.2: the port on lanes against JAX
    on xla."""
    B, T, n = 3, 8, 10
    prior = reference_prior_dict()
    envp_j = j_drone.EnvParams.default()._replace(init_noise=0.0)
    envp_t = t_drone.EnvParams.default()._replace(init_noise=0.0)
    traj = np.asarray(j_drone.make_trajectory(envp_j))
    jc = j_gpmpc.GPMPC(j_sym(dt=0.02, params=prior), traj, prior, horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC,
                       sqp_iters=4, qp_iters=10, step_backend="xla")
    tc = t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), traj, prior, horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC,
                       sqp_iters=4, qp_iters=10, device="cpu", step_backend="lanes")
    gp_j = _jax_gp(population, B)
    ep_j = j_batched_episode(jc.model, jc.cfg, envp_j, jc.consts, gp_j,
                             jax.random.split(jax.random.PRNGKey(0), B), n, backend="xla",
                             gp_batched=population)
    ep_t = t_batch.batched_episode(tc.model, tc.cfg, envp_t, tc.consts, _to_port(gp_j),
                                   torch.Generator().manual_seed(0), n, B, gp_batched=population,
                                   backend="lanes")
    assert ep_t.obs.shape == (B, n + 1, 12) and ep_t.actions.shape == (B, n, 4)
    assert ep_t.rewards.shape == (B, n)
    np.testing.assert_allclose(ep_t.actions.numpy(), np.asarray(ep_j.actions), atol=5e-4)
    np.testing.assert_allclose(ep_t.obs.numpy(), np.asarray(ep_j.obs), atol=1e-4)
    np.testing.assert_allclose(ep_t.rewards.numpy(), np.asarray(ep_j.rewards), atol=1e-4)


def test_episode_refuses_the_unported_paths():
    """The reference's refusals: the nominal MPC on lanes (a ValueError, as
    in the reference), a `gp_batched` flag the GpModel contradicts. The
    `xla` backend and `use_gp=False` run (tests/test_torch_step_xla.py holds
    them against the reference): two steps on each, from the same draws,
    give the same initial observations."""
    prior = reference_prior_dict()
    envp = t_drone.EnvParams.default()
    tc = t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), t_drone.make_trajectory(envp, "cpu").numpy(),
                       prior, horizon=5, q_mpc=Q_MPC, r_mpc=R_MPC, sqp_iters=2, qp_iters=4,
                       device="cpu")
    args = (tc.model, tc.cfg, envp, tc.consts, tc.gp_model)
    eps = [t_batch.batched_episode(*args, torch.Generator().manual_seed(0), 2, 2, **kw)
           for kw in ({}, {"use_gp": False})]
    for ep in eps:
        assert ep.actions.shape == (2, 2, 4) and bool(torch.isfinite(ep.obs).all())
    assert torch.equal(eps[0].obs[:, 0], eps[1].obs[:, 0])
    args = args + (torch.Generator(), 2, 2)
    with pytest.raises(ValueError, match="requires use_gp=True"):
        t_batch.batched_episode(*args, use_gp=False, backend="lanes")
    with pytest.raises(ValueError, match="gp_batched=True"):
        t_batch.batched_episode(*args, gp_batched=True)
    assert t_batch.cfg_horizon(tc.consts) == 5


def test_twolink_learning_starts_are_the_reference_tests():
    """chip_smoke.py's two-link learning path starts from the initial states
    of tests/test_learning_loop.py's episodes (`env.reset(seed=0)` and
    `(seed=1)`, JAX's PRNG): exactly those float32 numbers."""
    import chip_smoke

    env = j_two_env.TwoLinkTrackEnv(j_two_env.EnvParams.default())
    for seed, start in enumerate(chip_smoke.TWOLINK_STARTS):
        obs, _ = env.reset(seed=seed)
        np.testing.assert_array_equal(np.asarray(start, np.float32), np.asarray(obs, np.float32))

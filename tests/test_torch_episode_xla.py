"""The port's `xla` controllers in closed loop against the JAX package's on
the CPU, in float32 on both sides: the stateful `GPMPC` with
step_backend="xla" and "auto" (which resolves to xla off the card, as in the
reference), and the episodes on xla: `batched_episode(use_gp=False)` (the
nominal MPC) and `batched_episode_randomized` (per-scenario plants). The
episodes start from the same initial states as JAX's (`init_noise=0`) and,
for the randomized plants, run JAX's draws of the coefficients (monkeypatched
into the port's `randomize_params`: JAX's keys cannot be reproduced). Bars:
control RMSE <= 1e-3 (BASELINE.md) for the stateful controller, which solves
the observations of the JAX-driven plant; actions within 5e-4 at every step
and observations within 1e-4 for the episodes (tests/test_torch_episode.py's
bars)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.parallel import batch as j_batch
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.envs import drone as t_drone
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.parallel import batch as t_batch

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: torch's intra-op threads cost more than they give on a
    shared CPU. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench_gp():
    with np.load(convert.bench_gp_path("quadrotor")) as d:
        d = dict(d)
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    return j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"),
        hypers=JGPHypers(leaf("raw_lengthscale"), leaf("raw_outputscale"), leaf("raw_noise")),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(bool(d["trained"])),
    )


def _controllers(T, **kw):
    prior = reference_prior_dict()
    traj = np.asarray(j_drone.make_trajectory(j_drone.EnvParams.default()))
    kw = dict(horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC, prob=0.95, sqp_iters=6, qp_iters=10, **kw)
    jc = j_gpmpc.GPMPC(j_sym(dt=0.02, params=prior), traj, prior, step_backend="xla", **kw)
    return traj, jc, kw


def test_gpmpc_xla_and_auto_closed_loop_match_jax():
    """The stateful GPMPC with the benchmark GP, quadrotor, T = 8, 20 steps:
    the reference's controller on xla drives the plant, the port's on xla
    and on "auto" solve each observation from their own warm starts.
    Control RMSE <= 1e-3 for both, clamp_frac as JAX's."""
    traj, jc, kw = _controllers(8)
    prior = reference_prior_dict()
    ports = [t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), traj, prior, device="cpu",
                           step_backend=b, **kw) for b in ("xla", "auto")]
    jc.gp_model = _jax_bench_gp()
    for tc in ports:
        tc.gp_model = convert.load_bench_gp("cpu")
        assert tc._resolve_step_backend() == "xla"
    envp = j_drone.EnvParams.default()
    state, obs = j_drone.env_reset(envp, jax.random.PRNGKey(0))
    u_j, u_t = [], [[] for _ in ports]
    for _ in range(20):
        u_j.append(jc.select_action(obs))
        for tc, us in zip(ports, u_t):
            us.append(tc.select_action(np.asarray(obs)))
        state, obs, *_ = j_drone.env_step(envp, state, jnp.asarray(u_j[-1]))
    for tc, us in zip(ports, u_t):
        rmse = float(np.sqrt(np.mean((np.asarray(us) - np.asarray(u_j)) ** 2)))
        assert rmse <= 1e-3, (tc.step_backend, rmse)
        assert float(tc._last_info.clamp_frac) == float(jc._last_info.clamp_frac)
        assert tc.traj_step == 20


def _episodes(monkeypatch, use_gp, param_scale, B=2, T=6, n=6):
    traj, jc, kw = _controllers(T)
    prior = reference_prior_dict()
    tc = t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), traj, prior, device="cpu", **kw)
    envp_j = j_drone.EnvParams.default()._replace(init_noise=0.0)
    envp_t = t_drone.EnvParams.default()._replace(init_noise=0.0)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    gp_j, gp_t = _jax_bench_gp(), convert.load_bench_gp("cpu")
    if param_scale is None:
        ep_j = jax.jit(lambda c, g, k: j_batch.batched_episode(
            jc.model, jc.cfg, envp_j, c, g, k, n, use_gp=use_gp))(jc.consts, gp_j, keys)
        ep_t = t_batch.batched_episode(tc.model, tc.cfg, envp_t, tc.consts, gp_t,
                                       torch.Generator().manual_seed(0), n, B, use_gp=use_gp)
    else:
        # the plants JAX's episodes draw: each key split into (env, params) halves
        plants = jax.vmap(lambda k: j_drone.randomize_params(
            jax.random.split(k)[1], envp_j.params, scale=param_scale))(keys)
        monkeypatch.setattr(t_drone, "randomize_params", lambda gen, base, scale, batch: (
            torch.as_tensor(np.array(plants))))
        ep_j = jax.jit(lambda c, g, k: j_batch.batched_episode_randomized(
            jc.model, jc.cfg, envp_j, c, g, k, n, param_scale=param_scale, use_gp=use_gp))(
            jc.consts, gp_j, keys)
        ep_t = t_batch.batched_episode_randomized(
            tc.model, tc.cfg, envp_t, tc.consts, gp_t, torch.Generator().manual_seed(0), n, B,
            param_scale=param_scale, use_gp=use_gp)
    assert ep_t.obs.shape == (B, n + 1, 12) and ep_t.actions.shape == (B, n, 4)
    np.testing.assert_allclose(ep_t.obs[:, 0].numpy(), np.asarray(ep_j.obs)[:, 0], atol=1e-7)
    np.testing.assert_allclose(ep_t.actions.numpy(), np.asarray(ep_j.actions), atol=5e-4)
    np.testing.assert_allclose(ep_t.obs.numpy(), np.asarray(ep_j.obs), atol=1e-4)
    np.testing.assert_allclose(ep_t.rewards.numpy(), np.asarray(ep_j.rewards), atol=1e-4)
    return ep_t


def test_nominal_episode_matches_jax(monkeypatch):
    """batched_episode(use_gp=False) on xla: the nominal MPC (consts.mpc, the
    prior model) against JAX's at B = 2, T = 6, 6 steps."""
    _episodes(monkeypatch, use_gp=False, param_scale=None)


def test_randomized_episode_matches_jax(monkeypatch):
    """batched_episode_randomized (GP-MPC with the benchmark GP, each
    scenario its own plant coefficients at scale 0.1) against JAX's at
    B = 2, T = 6, 6 steps; the two plants give different trajectories."""
    ep = _episodes(monkeypatch, use_gp=True, param_scale=0.1)
    assert float((ep.obs[0, -1] - ep.obs[1, -1]).abs().max()) > 1e-5

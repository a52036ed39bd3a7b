"""The port's slice as a whole: `batched_gpmpc_step` on the lanes-fused path
(plain versions on the CPU) against the JAX package's vmapped `select_action`,
closed loop. The JAX controller drives the JAX plant; the port solves the same
observation at every step from its own warm starts. Configuration: bench.py's
defaults at a reduced horizon and batch, with the benchmark's GP (the committed
fixture) on both sides. Bars: u within 5e-4 at every step and control RMSE
<= 1e-3 (BASELINE.md)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step

F32 = np.float32


def _jax_bench_gp():
    with np.load(convert.BENCH_GP_PATH) as d:
        d = dict(d)
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    return j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"),
        hypers=JGPHypers(leaf("raw_lengthscale"), leaf("raw_outputscale"), leaf("raw_noise")),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(bool(d["trained"])),
    )


def run_closed_loop(T, B, n_steps):
    """Per-step actions (n_steps, B, 4) of the JAX reference and the port."""
    prior = reference_prior_dict()
    env_p = j_drone.EnvParams.default()
    traj = j_drone.make_trajectory(env_p)
    jc = j_gpmpc.GPMPC(
        j_sym(dt=0.02, params=prior), traj, prior, horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC,
        sparse_gp=True, prob=0.95, max_gp_samples=40, seed=1, max_gp_points=128,
        sqp_iters=6, qp_iters=10,
    )
    cfg_j = jc.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
    gp_j = _jax_bench_gp()
    step_j = jax.jit(jax.vmap(
        lambda s, o: j_gpmpc.select_action(jc.model, cfg_j, jc.consts, gp_j, s, o)))
    plant = jax.jit(jax.vmap(lambda s, a: j_drone.env_step(env_p, s, a)))

    model_t = t_sym(dt=0.02, params=prior)
    tc = t_gpmpc.GPMPC(model_t, np.asarray(traj), prior, horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC,
                       prob=0.95, sqp_iters=6, qp_iters=10)
    cfg_t = tc.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
    gp_t = convert.load_bench_gp()

    es, obs = jax.vmap(lambda k: j_drone.env_reset(env_p, k))(
        jax.random.split(jax.random.PRNGKey(0), B))
    st_j = jax.vmap(lambda _: j_mpc.init_state(T, 12, 4))(jnp.arange(B))
    st_t = t_mpc.init_state(B, T)
    u_j, u_t = [], []
    for _ in range(n_steps):
        obs32 = np.asarray(obs, F32)
        uj, st_j, _ = step_j(st_j, jnp.asarray(obs32))
        ut, st_t, info = batched_gpmpc_step(model_t, cfg_t, tc.consts, gp_t, st_t,
                                            torch.tensor(obs32))
        assert bool(torch.isfinite(ut).all())
        u_j.append(np.asarray(uj, F32))
        u_t.append(ut.numpy())
        es, obs, *_ = plant(es, uj)
    return np.stack(u_j), np.stack(u_t), info


def test_fused_step_matches_jax_select_action_closed_loop():
    u_j, u_t, info = run_closed_loop(T=8, B=5, n_steps=10)  # B=5: padded inside one tile
    for k in range(len(u_j)):
        np.testing.assert_allclose(u_t[k], u_j[k], atol=5e-4, err_msg=f"step {k}")
    rmse = float(np.sqrt(np.mean((u_t - u_j) ** 2)))
    assert rmse <= 1e-3, rmse
    assert info.n_iters.shape == (5,) and float(info.clamp_frac.max()) == 0.0


@pytest.mark.slow
def test_fused_step_matches_jax_at_slice_horizon_after_transient():
    """B=128 (one full tile), T=25, 60 steps; checked from step 15 on."""
    u_j, u_t, _ = run_closed_loop(T=25, B=128, n_steps=60)
    window = slice(15, None)
    err = u_t[window] - u_j[window]
    rmse = float(np.sqrt(np.mean(err**2)))
    print(f"T=25 B=128 steps 15-59: control RMSE {rmse:.3e}, max abs {np.abs(err).max():.3e}; "
          f"all 60 steps: RMSE {float(np.sqrt(np.mean((u_t - u_j) ** 2))):.3e}")
    for k in range(15, len(u_j)):
        np.testing.assert_allclose(u_t[k], u_j[k], atol=5e-4, err_msg=f"step {k}")
    assert rmse <= 1e-3, rmse


def test_other_dispatch_paths_raise_instead_of_falling_back():
    prior = reference_prior_dict()
    model_t = t_sym(dt=0.02, params=prior)
    traj = np.asarray(j_drone.make_trajectory(j_drone.EnvParams.default()))
    tc = t_gpmpc.GPMPC(model_t, traj, prior, horizon=6, q_mpc=Q_MPC, r_mpc=R_MPC)
    gp_t = convert.load_bench_gp()
    st = t_mpc.init_state(2, 6)
    obs = torch.as_tensor(traj[:2])
    for cfg, kw in (
        (tc.cfg, {}),  # kernel_linearize off -> the jacfwd 'lanes' path
        (tc.cfg._replace(kernel_linearize=True), {"backend": "xla"}),
    ):
        with pytest.raises(t_gpmpc.UnsupportedPathError, match="not ported"):
            batched_gpmpc_step(model_t, cfg, tc.consts, gp_t, st, obs, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        batched_gpmpc_step(model_t, tc.cfg._replace(kernel_linearize=True, soft_x_penalty=50.0),
                           tc.consts, gp_t, st, obs)

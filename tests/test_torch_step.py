"""The port's slice as a whole: `batched_gpmpc_step` on the lanes-fused path
(plain versions on the CPU) against the JAX package's vmapped `select_action`,
closed loop, for each model family. The JAX controller drives the JAX plant;
the port solves the same observation at every step from its own warm starts.
Configuration: bench.py's for the family (`BENCH_MODEL`) at a reduced horizon
and batch, with the family's benchmark GP (the committed fixture) on both
sides. Bars: u within 5e-4 at every step and control RMSE <= 1e-3
(BASELINE.md)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.envs import cartpole_env as j_cart_env
from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.envs import twolink_env as j_twolink_env
from gpmpc_tpu.models import cartpole as j_cart
from gpmpc_tpu.models import twolink as j_twolink
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.models import cartpole as t_cart
from gpmpc_tpu_torch.models import twolink as t_twolink
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.parallel import batch as t_batch
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step

F32 = np.float32


def _jax_bench_gp(family="quadrotor"):
    with np.load(convert.bench_gp_path(family)) as d:
        d = dict(d)
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    return j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"),
        hypers=JGPHypers(leaf("raw_lengthscale"), leaf("raw_outputscale"), leaf("raw_noise")),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(bool(d["trained"])),
    )


def _family(family):
    """bench.py:94-145 for the family: (JAX model, JAX plant module, port
    model, prior params, q_mpc, r_mpc, JAX boxes, port boxes, lm_reg)."""
    if family == "quadrotor":
        prior = reference_prior_dict()
        return (j_sym(dt=0.02, params=prior), j_drone, t_sym(dt=0.02, params=prior), prior,
                Q_MPC, R_MPC, None, None, 0.0)
    if family == "cartpole":
        return (j_cart.symbolic_cartpole(0.02), j_cart_env, t_cart.symbolic_cartpole(0.02), None,
                [5.0, 0.1, 20.0, 0.5], [0.05], (j_cart.state_bounds(), j_cart.input_bounds()),
                (t_cart.state_bounds(), t_cart.input_bounds()), 0.0)
    return (j_twolink.symbolic_twolink(0.02), j_twolink_env, t_twolink.symbolic_twolink(0.02),
            None, [20.0, 20.0, 0.5, 0.5], [0.1, 0.1],
            (j_twolink.state_bounds(), j_twolink.input_bounds()),
            (t_twolink.state_bounds(), t_twolink.input_bounds()), 0.5)


def run_closed_loop(T, B, n_steps, family="quadrotor"):
    """Per-step actions (n_steps, B, nu) of the JAX reference and the port."""
    model_j, env_mod, model_t, prior, q, r, bounds_j, bounds_t, lm = _family(family)
    env_p = env_mod.EnvParams.default()
    traj = env_mod.make_trajectory(env_p)
    jc = j_gpmpc.GPMPC(
        model_j, traj, prior, horizon=T, q_mpc=q, r_mpc=r,
        sparse_gp=True, prob=0.95, max_gp_samples=40, seed=1, max_gp_points=128,
        sqp_iters=6, qp_iters=10, bounds=bounds_j, lm_reg=lm,
    )
    cfg_j = jc.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
    gp_j = _jax_bench_gp(family)
    step_j = jax.jit(jax.vmap(
        lambda s, o: j_gpmpc.select_action(jc.model, cfg_j, jc.consts, gp_j, s, o)))
    plant = jax.jit(jax.vmap(lambda s, a: env_mod.env_step(env_p, s, a)))

    tc = t_gpmpc.GPMPC(model_t, np.asarray(traj), prior, horizon=T, q_mpc=q, r_mpc=r,
                       prob=0.95, sqp_iters=6, qp_iters=10, bounds=bounds_t, lm_reg=lm,
                       device="cpu")
    cfg_t = tc.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
    gp_t = convert.load_bench_gp("cpu", family=family)

    es, obs = jax.vmap(lambda k: env_mod.env_reset(env_p, k))(
        jax.random.split(jax.random.PRNGKey(0), B))
    nx, nu = model_t.nx, model_t.nu
    st_j = jax.vmap(lambda _: j_mpc.init_state(T, nx, nu))(jnp.arange(B))
    st_t = t_mpc.init_state(B, T, nx, nu, device="cpu")
    u_j, u_t = [], []
    for _ in range(n_steps):
        obs32 = np.asarray(obs, F32)
        uj, st_j, _ = step_j(st_j, jnp.asarray(obs32))
        ut, st_t, info = batched_gpmpc_step(model_t, cfg_t, tc.consts, gp_t, st_t,
                                            torch.tensor(obs32), backend="lanes")
        assert bool(torch.isfinite(ut).all())
        u_j.append(np.asarray(uj, F32))
        u_t.append(ut.numpy())
        es, obs, *_ = plant(es, uj)
    return np.stack(u_j), np.stack(u_t), info


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_fused_step_matches_jax_select_action_closed_loop(family):
    u_j, u_t, info = run_closed_loop(T=8, B=5, n_steps=10, family=family)  # B=5: padded in one tile
    for k in range(len(u_j)):
        np.testing.assert_allclose(u_t[k], u_j[k], atol=5e-4, err_msg=f"step {k}")
    rmse = float(np.sqrt(np.mean((u_t - u_j) ** 2)))
    assert rmse <= 1e-3, rmse
    assert info.n_iters.shape == (5,) and float(info.clamp_frac.max()) == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_fused_step_matches_jax_at_slice_horizon_after_transient(family):
    """B=128 (one full tile), T=25, 60 steps; checked from step 15 on."""
    u_j, u_t, _ = run_closed_loop(T=25, B=128, n_steps=60, family=family)
    window = slice(15, None)
    err = u_t[window] - u_j[window]
    rmse = float(np.sqrt(np.mean(err**2)))
    print(f"{family} T=25 B=128 steps 15-59: control RMSE {rmse:.3e}, max abs {np.abs(err).max():.3e}; "
          f"all 60 steps: RMSE {float(np.sqrt(np.mean((u_t - u_j) ** 2))):.3e}")
    for k in range(15, len(u_j)):
        np.testing.assert_allclose(u_t[k], u_j[k], atol=5e-4, err_msg=f"step {k}")
    assert rmse <= 1e-3, rmse


def test_other_dispatch_paths_raise_instead_of_falling_back():
    """Every decision runs: `xla` requested (the default) or decided by a
    horizon past the last QP kernel's cap (one SQP and one IP iteration at
    B = 2, warning once), and every `lanes` decision
    (tests/test_torch_dispatch.py, tests/test_torch_step_lanes.py)."""
    prior = reference_prior_dict()
    model_t = t_sym(dt=0.02, params=prior)
    traj = np.asarray(j_drone.make_trajectory(j_drone.EnvParams.default()))
    tc = t_gpmpc.GPMPC(model_t, traj, prior, horizon=6, q_mpc=Q_MPC, r_mpc=R_MPC,
                       device="cpu")
    gp_t = convert.load_bench_gp("cpu")
    st = t_mpc.init_state(2, 6, device="cpu")
    obs = torch.as_tensor(traj[:2])
    cfg1 = tc.cfg._replace(kernel_linearize=True, sqp_iters=1, qp_iters=1)
    u0, _, _ = batched_gpmpc_step(model_t, cfg1, tc.consts, gp_t, st, obs)
    assert bool(torch.isfinite(u0).all())
    long = t_gpmpc.GPMPC(model_t, traj, prior, horizon=1025, q_mpc=Q_MPC, r_mpc=R_MPC, device="cpu")
    t_batch._DISPATCH_WARNED.clear()
    with pytest.warns(UserWarning, match="exceeds the lanes cap"):
        u1, _, info = batched_gpmpc_step(model_t, cfg1, long.consts, gp_t,
                                         t_mpc.init_state(2, 1025, device="cpu"), obs,
                                         backend="lanes")
    assert bool(torch.isfinite(u1).all()) and info.n_iters.tolist() == [1, 1]
    # kernel_linearize off -> the 'lanes' path, which runs; so does a family
    # with no kernel linearizer closure (with its one-time warning)
    u, _, _ = batched_gpmpc_step(model_t, tc.cfg, tc.consts, gp_t, st, obs, backend="lanes", lanes=2)
    assert bool(torch.isfinite(u).all())
    spec = dataclasses.replace(model_t.residual_spec, name="unicycle", supports_kernel_linearize=False)
    with pytest.warns(UserWarning, match="no in-kernel linearizer"):
        u2, _, _ = batched_gpmpc_step(dataclasses.replace(model_t, residual_spec=spec),
                                      tc.cfg._replace(kernel_linearize=True), tc.consts, gp_t, st, obs,
                                      backend="lanes", lanes=2)
    np.testing.assert_allclose(u2.numpy(), u.numpy(), atol=1e-5)

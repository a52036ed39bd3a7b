"""The slice with soft state bounds and horizons past the resident cap, as a
whole: the port's `batched_gpmpc_step` (plain versions on the CPU) against the
JAX package's `batched_select_action_lanes` with its Pallas kernels in
interpret mode, on the fused path of both; `_bounds_from_tightening(soft=)`
against the reference's; and the entry points' device default."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.envs.drone import DroneFigureEightEnv
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.ops import sqp_lanes as j_sqp_lanes
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert, device
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.envs import cartpole_env as t_cart_env
from gpmpc_tpu_torch.envs import drone as t_drone
from gpmpc_tpu_torch.envs import twolink_env as t_twolink_env
from gpmpc_tpu_torch.models import quadrotor as t_quadrotor
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.models.trajectory import figure_eight_trajectory
from gpmpc_tpu_torch.ops import sqp_lanes as t_sqp_lanes
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step, dispatch_decision
from tests._torch_threads import _one_thread  # noqa: F401


F32 = np.float32


def _flat_gp(gp) -> dict:
    d = {k: np.asarray(v) for k, v in gp._asdict().items() if k != "hypers"}
    d.update({k: np.asarray(v) for k, v in gp.hypers._asdict().items()})
    return d


def _setup(T, B, soft, **ctrl_kw):
    """tests/test_pallas_ocp.py's soft-step set-up on both sides: an untrained
    exact GP flagged trained with raw_outputscale 30 (a large variance, so
    the tightening is large), warm states at traj_step 1."""
    prior = reference_prior_dict()
    env = DroneFigureEightEnv()
    jc = j_gpmpc.GPMPC(
        j_sym(dt=0.02, params=prior), env.trajectory, prior, horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC,
        sparse_gp=False, seed=0, max_gp_points=16, soft_constraints=soft, **ctrl_kw,
    )
    gp_j = jc.gp_model._replace(
        hypers=jc.gp_model.hypers._replace(raw_outputscale=jnp.full((3,), 30.0, jnp.float32)),
        trained=jnp.asarray(True),
    )
    rng = np.random.default_rng(0)
    obs = np.asarray(env.trajectory[:B] + 0.01 * rng.normal(size=(B, 12)), F32)
    st_j = jax.vmap(lambda i: j_mpc.init_state(T, 12, 4)._replace(
        traj_step=jnp.asarray(1, jnp.int32), X_warm=jnp.tile(jnp.asarray(obs)[i][None], (T + 1, 1)),
    ))(jnp.arange(B))

    model_t = t_sym(dt=0.02, params=prior)
    tc = t_gpmpc.GPMPC(model_t, np.asarray(env.trajectory), prior, horizon=T, q_mpc=Q_MPC,
                       r_mpc=R_MPC, soft_constraints=soft, device="cpu", **ctrl_kw)
    gp_t = convert.gp_model_from_numpy(_flat_gp(gp_j), device="cpu")
    st_t = convert.state_from_numpy({k: np.asarray(v) for k, v in st_j._asdict().items()}, "cpu")
    return jc, gp_j, st_j, model_t, tc, gp_t, st_t, obs


def _both_steps(T, B, soft, **ctrl_kw):
    jc, gp_j, st_j, model_t, tc, gp_t, st_t, obs = _setup(T, B, soft, **ctrl_kw)
    cfg_j = jc.cfg._replace(kernel_linearize=True, qp_mehrotra=True, qp_tol=1e-6)
    cfg_t = convert.sqp_config_from_mapping(cfg_j._asdict())
    assert cfg_t == tc.cfg._replace(kernel_linearize=True, qp_mehrotra=True, qp_tol=1e-6)
    assert dispatch_decision(cfg_t, model_t.residual_spec, T).path == "lanes-fused"
    u_j, _, info_j = j_gpmpc.batched_select_action_lanes(
        jc.model, cfg_j, jc.consts, gp_j, st_j, jnp.asarray(obs), interpret=True)
    u_t, _, info_t = batched_gpmpc_step(model_t, cfg_t, tc.consts, gp_t, st_t, torch.tensor(obs),
                                        backend="lanes")
    info_j = convert.info_from_numpy({k: np.asarray(v) for k, v in info_j._asdict().items()}, "cpu")
    return np.asarray(u_j, F32), u_t.numpy(), info_j, info_t


@pytest.mark.parametrize("z_max", [None, 0.9], ids=["reference-boxes", "start-outside-box"])
def test_soft_step_matches_jax_lanes_step(z_max):
    """T=5, B=4, soft_constraints=50: u and soft_viol within 2e-3, the
    reference's bar between its own two soft backends. With the quadrotor's
    boxes the optimum stays inside them (soft_viol 0 on both sides); with the
    altitude box lowered to 0.9 m under the start at 1 m, no trajectory can
    satisfy it and both report the same violation."""
    kw = {}
    if z_max is not None:
        (lx, ux), u_box = t_quadrotor.state_bounds(), t_quadrotor.input_bounds()
        ux = ux.copy()
        ux[4] = z_max
        kw["bounds"] = ((lx, ux), u_box)
    u_j, u_t, info_j, info_t = _both_steps(5, 4, 50.0, sqp_iters=2, qp_iters=8, **kw)
    np.testing.assert_allclose(u_t, u_j, atol=2e-3)
    np.testing.assert_allclose(info_t.soft_viol.numpy(), info_j.soft_viol.numpy(), atol=2e-3)
    np.testing.assert_array_equal(info_t.clamp_frac.numpy(), info_j.clamp_frac.numpy())
    assert (float(info_j.soft_viol.min()) > 0.05) == (z_max is not None)


def _count_calls(monkeypatch, mod, attr):
    calls = []
    orig = getattr(mod, attr)

    def wrapper(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(mod, attr, wrapper)
    return calls


@pytest.mark.parametrize("soft", [None, 50.0], ids=["hard", "soft"])
def test_tier1_step_matches_jax_lanes_step(monkeypatch, soft):
    """T=8 with both packages' resident caps lowered to 4 for the test, so
    both send the QP to the tier-1 streamed kernel. u within 1e-3 hard (the
    reference's bar for its fused path past the resident cap), 2e-3 soft."""
    for mod in (j_sqp_lanes, t_sqp_lanes):
        monkeypatch.setattr(mod, "MAX_LANES_HORIZON", 4)
        monkeypatch.setattr(mod, "MAX_LANES_HORIZON_MEHROTRA", 4)
    calls_j = _count_calls(monkeypatch, j_sqp_lanes, "solve_ocp_qp_lanes_streamed")
    calls_t = _count_calls(monkeypatch, t_sqp_lanes, "solve_ocp_qp_lanes_streamed")
    u_j, u_t, info_j, info_t = _both_steps(8, 3, soft, sqp_iters=2, qp_iters=8)
    assert len(calls_j) > 0 and len(calls_t) > 0
    np.testing.assert_allclose(u_t, u_j, atol=2e-3 if soft else 1e-3)
    np.testing.assert_allclose(info_t.soft_viol.numpy(), info_j.soft_viol.numpy(), atol=2e-3)


def test_bounds_from_tightening_soft_matches_jax_exactly():
    """A tightening that exceeds the 45 % cap in some state and input entries:
    with soft bounds the state part is kept in full and not counted in
    clamp_frac; inputs are always clamped. Bounds and clamp_frac equal the
    reference's bit for bit."""
    T, B = 5, 3
    jc, gp_j, st_j, _, tc, gp_t, st_t, obs = _setup(T, B, 50.0, sqp_iters=2, qp_iters=8)
    rng = np.random.default_rng(1)
    span_x = np.asarray(jc.consts.mpc.ux - jc.consts.mpc.lx, F32)
    span_u = np.asarray(jc.consts.mpc.uu - jc.consts.mpc.lu, F32)
    t_x = (rng.uniform(0.0, 0.7, (B, T + 1, 12)) * span_x).astype(F32)  # crosses some boxes
    t_u = (rng.uniform(0.0, 0.7, (B, T, 4)) * span_u).astype(F32)
    for soft in (True, False):
        ref = jax.vmap(lambda s, o, tx, tu: j_gpmpc._bounds_from_tightening(
            jc.consts, gp_j, s, o, tx, tu, soft=soft))(
                st_j, jnp.asarray(obs), jnp.asarray(t_x), jnp.asarray(t_u))
        got = t_gpmpc._bounds_from_tightening(
            tc.consts, gp_t, st_t, torch.tensor(obs), torch.tensor(t_x), torch.tensor(t_u), soft=soft)
        for name in ("lx", "ux", "lu", "uu"):
            np.testing.assert_array_equal(getattr(got[1], name).numpy(),
                                          np.asarray(getattr(ref[1], name)), err_msg=name)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
        assert float(got[4].min()) > 0
        crossed = bool((got[1].lx > got[1].ux).any())
        assert crossed == soft


def test_soft_past_the_lanes_cap_warns_and_falls_back_to_hard_bounds(monkeypatch):
    """T=769 with soft bounds: the reference warns, clears soft_x_penalty and
    solves on the `lanes` path (the horizon is past the fused path's cap) with
    hard bounds and the feasibility clamp; the port does the same. The solver
    is stopped at its door: a T=769 solve on the CPU takes minutes."""

    class Reached(Exception):
        pass

    def stop(fd, cost, bounds, x0, X_init, U_init, cfg, **kw):
        assert cfg.soft_x_penalty is None and U_init.shape[1] == T
        assert bool((bounds.lx <= bounds.ux).all())  # hard bounds: the boxes never cross
        raise Reached

    monkeypatch.setattr(t_gpmpc, "sqp_solve_batch_lanes", stop)
    prior = reference_prior_dict()
    model_t = t_sym(dt=0.02, params=prior)
    T = t_sqp_lanes.MAX_STREAM2_HORIZON_SOFT + 1
    tc = t_gpmpc.GPMPC(model_t, np.zeros((10, 12), F32), prior, horizon=T, q_mpc=Q_MPC,
                       r_mpc=R_MPC, soft_constraints=50.0, device="cpu")
    assert tc.cfg.soft_x_penalty == 50.0
    st = t_mpc.init_state(1, T, device="cpu")
    with pytest.warns(UserWarning, match="exceeds the lanes soft horizon cap .768."):
        with pytest.raises(Reached):
            t_gpmpc.batched_select_action_lanes(
                model_t, tc.cfg._replace(kernel_linearize=True), tc.consts,
                convert.load_bench_gp("cpu"), st, torch.zeros(1, 12))


@pytest.mark.parametrize("call", [
    lambda: t_gpmpc.GPMPC(t_sym(dt=0.02, params=reference_prior_dict()), np.zeros((10, 12), F32),
                          reference_prior_dict(), horizon=5, q_mpc=Q_MPC, r_mpc=R_MPC),
    lambda: t_mpc.init_state(2, 5),
    lambda: t_mpc.default_u_eq(4),
    lambda: convert.load_bench_gp(),
    lambda: convert.state_from_numpy({}),
    lambda: t_drone.env_reset(t_drone.EnvParams.default(), 2, None),
    lambda: t_drone.make_trajectory(t_drone.EnvParams.default()),
    lambda: t_cart_env.env_reset(t_cart_env.EnvParams.default(), 2, None),
    lambda: t_twolink_env.make_trajectory(t_twolink_env.EnvParams.default()),
    lambda: figure_eight_trajectory(),
], ids=["GPMPC", "init_state", "default_u_eq", "load_bench_gp", "state_from_numpy",
        "drone.env_reset", "drone.make_trajectory", "cartpole.env_reset",
        "twolink.make_trajectory", "figure_eight_trajectory"])
def test_default_device_is_the_card_and_raises_without_one(monkeypatch, call):
    """Entry points left on their default device never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.NoCudaDeviceError, match='pass device="cpu"'):
        call()
    assert device.resolve("cpu") == torch.device("cpu")

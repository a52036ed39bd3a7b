"""The `lanes` dispatch path of the port as a whole: `batched_gpmpc_step` with
the dynamics linearized in plain torch (forward mode, the quadrotor's analytic
Jacobians, or per scenario against a GP population) and the QP through the
kernels' plain versions (CPU tensors), against the JAX package's
`batched_select_action_lanes(interpret=True)` on the same observations, closed
loop. The JAX controller drives the JAX plant; the port solves the same
observation at every step from its own warm starts. Configuration: bench.py's
quadrotor (prob 0.95, 6 SQP x 10 Mehrotra IP iterations, exit at gap 1e-6) at
T=8, B=5, with the benchmark GP (the committed fixture); the population is
that GP per scenario with `alpha_s` and the raw hyperparameters perturbed from
a seeded generator. Both sides in float32. Bar: actions within 1e-3 at every
step (BASELINE.md's control RMSE bar, held per action)."""

import warnings

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
from gpmpc_tpu.parallel.batch import dispatch_decision as j_dispatch
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.ops import cuda_ocp, sqp_lanes
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step, dispatch_decision

F32 = np.float32
HYPERS = ("raw_lengthscale", "raw_outputscale", "raw_noise")


def gp_pair(population=0):
    with np.load(convert.bench_gp_path("quadrotor")) as f:
        d = {k: np.asarray(v) for k, v in f.items()}
    if population:
        rng = np.random.default_rng(11)
        d = {k: np.repeat(v[None], population, axis=0) for k, v in d.items()}
        d["alpha_s"] = (d["alpha_s"] * (1.0 + 0.3 * rng.normal(size=d["alpha_s"].shape))).astype(F32)
        for k in HYPERS:
            d[k] = (d[k] + 0.05 * rng.normal(size=d[k].shape)).astype(F32)
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    gp_j = j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"), hypers=JGPHypers(*[leaf(k) for k in HYPERS]),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(d["trained"], bool),
    )
    return gp_j, convert.gp_model_from_numpy(d, "cpu")


def run_closed_loop(T, B, n_steps, population=False, lanes=8, sqp_iters=6, **cfg_kw):
    """Per-step actions (n_steps, B, nu) of the JAX lanes step and the port's,
    and the port's last MpcInfo."""
    prior = reference_prior_dict()
    env_p = j_drone.EnvParams.default()
    traj = j_drone.make_trajectory(env_p)
    jc = j_gpmpc.GPMPC(
        j_sym(dt=0.02, params=prior), traj, prior, horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC,
        sparse_gp=True, prob=0.95, max_gp_samples=40, seed=1, max_gp_points=128,
        sqp_iters=sqp_iters, qp_iters=10,
    )
    cfg_j = jc.cfg._replace(qp_tol=1e-6, qp_mehrotra=True, **cfg_kw)
    gp_j, gp_t = gp_pair(B if population else 0)
    step_j = jax.jit(lambda s, o: j_gpmpc.batched_select_action_lanes(
        jc.model, cfg_j, jc.consts, gp_j, s, o, interpret=True))
    plant = jax.jit(jax.vmap(lambda s, a: j_drone.env_step(env_p, s, a)))

    model_t = t_sym(dt=0.02, params=prior)
    tc = t_gpmpc.GPMPC(model_t, np.asarray(traj), prior, horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC,
                       prob=0.95, sqp_iters=sqp_iters, qp_iters=10, device="cpu")
    cfg_t = convert.sqp_config_from_mapping(cfg_j._asdict())
    d_t = dispatch_decision(cfg_t, model_t.residual_spec, T, population)
    assert d_t.path == "lanes"
    assert tuple(d_t) == tuple(j_dispatch(cfg_j, jc.model.residual_spec, T, population))

    es, obs = jax.vmap(lambda k: j_drone.env_reset(env_p, k))(
        jax.random.split(jax.random.PRNGKey(0), B))
    st_j = jax.vmap(lambda _: j_mpc.init_state(T, 12, 4))(jnp.arange(B))
    st_t = t_mpc.init_state(B, T, 12, 4, device="cpu")
    u_j, u_t = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the degradation warnings have their own test
        for _ in range(n_steps):
            obs32 = np.asarray(obs, F32)
            uj, st_j, _ = step_j(st_j, jnp.asarray(obs32))
            ut, st_t, info = batched_gpmpc_step(model_t, cfg_t, tc.consts, gp_t, st_t,
                                                torch.tensor(obs32), backend="lanes", lanes=lanes)
            assert bool(torch.isfinite(ut).all())
            u_j.append(np.asarray(uj, F32))
            u_t.append(ut.numpy())
            es, obs, *_ = plant(es, uj)
    return np.stack(u_j), np.stack(u_t), info


CASES = {
    "jacfwd": dict(kernel_linearize=False),
    "analytic": dict(kernel_linearize=False, analytic_jac=True),
    "population": dict(kernel_linearize=True, population=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_step_matches_jax_lanes_step_closed_loop(case, monkeypatch):
    linearize_calls = []
    monkeypatch.setattr(sqp_lanes, "linearize_ocp_lanes",
                        lambda *a, **k: linearize_calls.append(1))
    u_j, u_t, info = run_closed_loop(T=8, B=5, n_steps=4, **CASES[case])
    assert not linearize_calls  # the `lanes` path linearizes outside any kernel wrapper
    for k in range(len(u_j)):
        np.testing.assert_allclose(u_t[k], u_j[k], atol=1e-3, err_msg=f"step {k}")
    assert float(np.sqrt(np.mean((u_t - u_j) ** 2))) <= 1e-3
    assert info.n_iters.shape == (5,) and float(info.clamp_frac.max()) == 0.0


@pytest.mark.slow
def test_lanes_step_past_the_fused_cap_reaches_tier_2(monkeypatch):
    """T=401, B=2: one past the fused path's cap, so the dispatcher takes the
    `lanes` path and the QP goes to the tier-2 streamed solver on both sides
    (the port: its plain version). Two steps, 2 SQP iterations each. Slow:
    the two sides together take over a minute."""
    calls = []
    orig = cuda_ocp.solve_ocp_qp_lanes_streamed2_plain

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(cuda_ocp, "solve_ocp_qp_lanes_streamed2_plain", counted)
    u_j, u_t, info = run_closed_loop(T=401, B=2, n_steps=2, lanes=2, sqp_iters=2,
                                     kernel_linearize=True)
    assert len(calls) >= 2
    np.testing.assert_allclose(u_t, u_j, atol=1e-3)
    assert bool(torch.isfinite(info.X).all())

"""Port chance-constraint tightening (kernel 2's plain version, via its
wrapper on CPU tensors) and step preparation against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
from gpmpc_tpu.envs.drone import DroneFigureEightEnv
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control.mpc import MpcState
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.ops import cuda_tighten

F32 = np.float32
T = 7


def _setup(train=True):
    prior = reference_prior_dict()
    env = DroneFigureEightEnv()
    jc = JGPMPC(
        j_sym(dt=0.02, params=prior), env.trajectory, prior, horizon=T, q_mpc=Q_MPC,
        r_mpc=R_MPC, sparse_gp=False, seed=0, max_gp_points=16, sqp_iters=2, qp_iters=6,
    )
    if train:
        rng = np.random.default_rng(1)
        jc.train_gp(rng.normal(0, 0.3, (12, 7)).astype(F32),
                    rng.normal(0, 0.3, (12, 3)).astype(F32), lr=0.05, iterations=5)
    d = {k: np.asarray(v) for k, v in jc.consts._asdict().items() if k != "mpc"}
    d["mpc"] = {k: np.asarray(v) for k, v in jc.consts.mpc._asdict().items()}
    model_t = t_sym(dt=0.02, params=prior)
    return env, jc, model_t, convert.consts_from_numpy(d)


def _gp_t(gp):
    flat = {k: np.asarray(v) for k, v in gp._asdict().items() if k != "hypers"}
    flat.update({k: np.asarray(v) for k, v in gp.hypers._asdict().items()})
    return convert.gp_model_from_numpy(flat)


def test_tightening_matches_jax_tightening_from_variances():
    """Disturbance diagonals + covariance recursion for B=5 scenarios (B < one
    lane tile) against the reference's per-scenario scan."""
    env, jc, model_t, consts_t = _setup()
    B = 5
    rng = np.random.default_rng(0)
    zq = np.concatenate([rng.uniform(0.2, 0.5, (B, T, 1)), rng.normal(0, 0.3, (B, T, 6))],
                        axis=2).astype(F32)
    covs = rng.uniform(1e-3, 5e-2, (3, B, T)).astype(F32)
    tx_j, tu_j = jax.jit(jax.vmap(
        lambda z, c: j_gpmpc.tightening_from_variances(jc.consts, jc.gp_model, z, c)
    ))(jnp.asarray(zq), jnp.moveaxis(jnp.asarray(covs), 1, 0))

    gp_t = _gp_t(jc.gp_model)
    cov_dn = t_gpmpc._gp_disturbance_batch(consts_t, gp_t, torch.as_tensor(zq), torch.as_tensor(covs))
    c = consts_t
    tx_t, tu_t = cuda_tighten.tighten_lanes(
        cov_dn, c.Ad, c.Bd_in, c.lqr_gain, c.Bd, c.inverse_cdf
    )
    assert tx_t.shape == (B, T + 1, 12) and tu_t.shape == (B, T, 4)
    np.testing.assert_allclose(tx_t.numpy(), np.asarray(tx_j, F32), atol=1e-6)
    np.testing.assert_allclose(tu_t.numpy(), np.asarray(tu_j, F32), atol=1e-6)
    assert tx_t[:, 1:, 1].min() > 0  # variance reaches the velocity rows


@pytest.mark.parametrize(
    "case", ["trained", "untrained", "first_step", "clamped"],
)
def test_batched_prepare_step_matches_jax(case):
    """The port's prepare step against JAX's with the XLA variance and
    tightening backends: untrained GPs and the first step give no tightening,
    a huge output scale drives the 45% clamp."""
    env, jc, model_t, consts_t = _setup(train=case != "untrained")
    gp = jc.gp_model
    if case == "clamped":
        # prior variance everywhere (no data term), far above what the boxes allow
        gp = gp._replace(var_mat=jnp.zeros_like(gp.var_mat), hypers=gp.hypers._replace(
            raw_outputscale=jnp.full((3,), 1000.0, jnp.float32)))
    B = 3
    rng = np.random.default_rng(1)
    obs = (np.asarray(env.trajectory)[:B] + 0.01 * rng.normal(size=(B, 12))).astype(F32)
    step = 0 if case == "first_step" else 1
    X_warm = (obs[:, None, :] + 0.05 * rng.normal(size=(B, T + 1, 12))).astype(F32)
    U_warm = (np.asarray([0.3234, 0, 0, 0], F32) + 0.05 * rng.normal(size=(B, T, 4))).astype(F32)
    states_j = j_mpc.MpcState(
        traj_step=jnp.full((B,), step, jnp.int32), X_warm=jnp.asarray(X_warm),
        U_warm=jnp.asarray(U_warm),
    )
    out_j = j_gpmpc.batched_prepare_step(
        jc.model, jc.consts, gp, states_j, jnp.asarray(obs),
        var_backend="xla", tighten_backend="xla",
    )
    states_t = MpcState(
        traj_step=torch.full((B,), step, dtype=torch.int32), X_warm=torch.as_tensor(X_warm),
        U_warm=torch.as_tensor(U_warm),
    )
    out_t = t_gpmpc.batched_prepare_step(model_t, consts_t, _gp_t(gp), states_t, torch.as_tensor(obs))
    leaves_j = jax.tree.leaves(out_j)
    leaves_t = [out_t[0], *out_t[1], out_t[2], out_t[3], out_t[4]]
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, F32), atol=2e-5)
    clamp = out_t[4]
    if case == "clamped":
        assert float(clamp.min()) > 0
    else:
        assert float(clamp.max()) == 0.0
    if case in ("untrained", "first_step"):
        np.testing.assert_array_equal(out_t[1].lx[:, 1:].numpy(),
                                      np.broadcast_to(consts_t.mpc.lx.numpy(), (B, T, 12)))

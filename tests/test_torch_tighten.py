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
from gpmpc_tpu.envs import cartpole_env as j_cart_env
from gpmpc_tpu.envs import twolink_env as j_twolink_env
from gpmpc_tpu.envs.drone import DroneFigureEightEnv
from gpmpc_tpu.models import cartpole as j_cart
from gpmpc_tpu.models import twolink as j_twolink
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.ops.pallas_tighten import tighten_lanes as j_tighten_lanes
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control.mpc import MpcState
from gpmpc_tpu_torch.models import cartpole as t_cart
from gpmpc_tpu_torch.models import twolink as t_twolink
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
    return env, jc, model_t, convert.consts_from_numpy(d, device="cpu")


def _gp_t(gp):
    flat = {k: np.asarray(v) for k, v in gp._asdict().items() if k != "hypers"}
    flat.update({k: np.asarray(v) for k, v in gp.hypers._asdict().items()})
    return convert.gp_model_from_numpy(flat, device="cpu")


def _family_setup(family):
    """(JAX controller, port spec, port consts) of the cartpole or the two-link
    arm at bench.py's weights and boxes (untrained GP: only its noise enters
    the tightening)."""
    j_mod, j_env, t_mod = {
        "cartpole": (j_cart, j_cart_env, t_cart), "twolink": (j_twolink, j_twolink_env, t_twolink),
    }[family]
    q, r, lm = {"cartpole": ([5.0, 0.1, 20.0, 0.5], [0.05], 0.0),
                "twolink": ([20.0, 20.0, 0.5, 0.5], [0.1, 0.1], 0.5)}[family]
    model_j = j_cart.symbolic_cartpole(0.02) if family == "cartpole" else j_twolink.symbolic_twolink(0.02)
    jc = JGPMPC(
        model_j, j_env.make_trajectory(j_env.EnvParams.default()), None, horizon=T, q_mpc=q,
        r_mpc=r, sparse_gp=False, seed=0, max_gp_points=16, sqp_iters=2, qp_iters=6,
        bounds=(j_mod.state_bounds(), j_mod.input_bounds()), lm_reg=lm,
    )
    d = {k: np.asarray(v) for k, v in jc.consts._asdict().items() if k != "mpc"}
    d["mpc"] = {k: np.asarray(v) for k, v in jc.consts.mpc._asdict().items()}
    model_t = t_mod.symbolic_cartpole(0.02) if family == "cartpole" else t_mod.symbolic_twolink(0.02)
    return jc, model_t.residual_spec, convert.consts_from_numpy(d, device="cpu")


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_tightening_matches_jax_tightening_from_variances(family):
    """Disturbance diagonals + covariance recursion for B=5 scenarios (B < one
    lane tile) against the reference's per-scenario scan: the quadrotor at
    (nx, nu) = (12, 4) with a trained GP, the cartpole at (4, 1) and the
    two-link arm at (4, 2)."""
    B = 5
    rng = np.random.default_rng(0)
    if family == "quadrotor":
        _, jc, _, consts_t = _setup()
        spec_t = t_gpmpc.QUADROTOR_SPEC
        zq = np.concatenate([rng.uniform(0.2, 0.5, (B, T, 1)), rng.normal(0, 0.3, (B, T, 6))], axis=2)
    else:
        jc, spec_t, consts_t = _family_setup(family)
        zq = rng.normal(0, 0.5, (B, T, spec_t.z_dim))
    zq = zq.astype(F32)
    nx, nu = consts_t.Bd_in.shape
    covs = rng.uniform(1e-3, 5e-2, (spec_t.num_gps, B, T)).astype(F32)
    tx_j, tu_j = jax.jit(jax.vmap(
        lambda z, c: j_gpmpc.tightening_from_variances(jc.consts, jc.gp_model, z, c, jc.spec)
    ))(jnp.asarray(zq), jnp.moveaxis(jnp.asarray(covs), 1, 0))

    gp_t = _gp_t(jc.gp_model)
    cov_dn = t_gpmpc.disturbance_diagonals(
        consts_t, gp_t, torch.as_tensor(zq), torch.as_tensor(covs), spec_t
    )
    c = consts_t
    tx_t, tu_t = cuda_tighten.tighten_lanes(
        cov_dn, c.Ad, c.Bd_in, c.lqr_gain, c.Bd, c.inverse_cdf
    )
    assert tx_t.shape == (B, T + 1, nx) and tu_t.shape == (B, T, nu)
    np.testing.assert_allclose(tx_t.numpy(), np.asarray(tx_j, F32), atol=1e-6)
    np.testing.assert_allclose(tu_t.numpy(), np.asarray(tu_j, F32), atol=1e-6)
    assert tx_t[:, 1:, spec_t.uncertain_dim[0]].min() > 0  # variance reaches the uncertain rows


# (nx, nu, uncertain rows) of the quadrotor, the cartpole and the two-link arm
WIDTHS = {"quadrotor": (12, 4, [1, 3, 5, 9, 10]), "cartpole": (4, 1, [1, 3]),
          "twolink": (4, 2, [2, 3])}


def _weights_f32(Ad, Bd_in, lqr_gain, Bd, T):
    """`tighten_weights_plain` with the powers formed in float32."""
    acl, W, rows = Ad + Bd_in @ lqr_gain, Bd, []
    for _ in range(T):
        rows.append(torch.cat([W, lqr_gain @ W]))
        W = acl @ W
    return torch.stack(rows) ** 2


@pytest.mark.parametrize("family", list(WIDTHS))
@pytest.mark.parametrize("oracle,T", [("pallas", 5), ("scan", 25), ("recursion", 100),
                                      ("recursion", 512)])
def test_direct_tightening_matches_reference(family, oracle, T, monkeypatch):
    """The direct form of the CUDA route (`tighten_weights_plain`, float64
    weights, and `tighten_direct_plain`, float32 sums) against the
    reference's Pallas kernel in interpret mode (T=5), its per-scenario scan
    `tightening_from_variances` (T=25, the family's controller) and the
    recursion `tighten_lanes_plain` (T=100, 512; on A = I + 0.02 N(0, 1) the
    tightening grows to ~1e18 at T=512), B=8, within 1e-5 x max(1, max|t|).
    At T=512 the same sums over weights formed in float32 are no closer than
    over float64 ones (on this data: 1.6e-5 against 2.4e-6 relative at 4x1,
    7.8e-6 against 1.2e-6 at 12x4)."""
    nx, nu, unc = WIDTHS[family]
    B = 8
    rng = np.random.default_rng(T)
    if oracle == "scan":
        if family == "quadrotor":
            _, jc, _, _ = _setup(train=False)
            spec_t = t_gpmpc.QUADROTOR_SPEC
        else:
            jc, spec_t, _ = _family_setup(family)
        zq = rng.normal(0, 0.4, (B, T, spec_t.z_dim)).astype(F32)
        covs = rng.uniform(1e-3, 5e-2, (B, spec_t.num_gps, T)).astype(F32)
        ref_x, ref_u = jax.jit(jax.vmap(
            lambda z, c: j_gpmpc.tightening_from_variances(jc.consts, jc.gp_model, z, c, jc.spec)
        ))(jnp.asarray(zq), jnp.asarray(covs))
        cov_dn = jax.vmap(
            lambda z, c: j_gpmpc.disturbance_diagonals(jc.consts, jc.gp_model, z, c, jc.spec)
        )(jnp.asarray(zq), jnp.asarray(covs))
        c = jc.consts
        mats = [np.asarray(m, F32) for m in (cov_dn, c.Ad, c.Bd_in, c.lqr_gain, c.Bd, c.inverse_cdf)]
    else:
        A = np.eye(nx) + 0.02 * rng.normal(size=(nx, nx))  # test_torch_kernels_gpu.py's draws
        mats = [rng.uniform(1e-6, 4e-4, (B, T, len(unc))), A, 0.05 * rng.normal(size=(nx, nu)),
                0.3 * rng.normal(size=(nu, nx)), np.eye(nx)[:, unc], np.asarray(1.7)]
        mats = [np.asarray(m, F32) for m in mats]
    args = [torch.as_tensor(m) for m in mats]
    if oracle == "pallas":
        ref_x, ref_u = j_tighten_lanes(*map(jnp.asarray, mats), interpret=True)
    elif oracle == "recursion":
        ref_x, ref_u = cuda_tighten.tighten_lanes_plain(*args)
    ref_x, ref_u = np.asarray(ref_x, F32), np.asarray(ref_u, F32)

    def rel_err():
        tx, tu = cuda_tighten.tighten_direct_plain(*args)
        assert tx.shape == (B, T + 1, nx) and tu.shape == (B, T, nu)
        scale = max(1.0, float(np.abs(ref_x).max()), float(np.abs(ref_u).max()))
        return max(float(np.abs(tx.numpy() - ref_x).max()),
                   float(np.abs(tu.numpy() - ref_u).max())) / scale

    wsq = cuda_tighten.tighten_weights_plain(*args[1:5], T)
    assert wsq.shape == (T, nx + nu, len(unc)) and wsq.dtype == torch.float32
    err = rel_err()
    assert err <= 1e-5
    if T == 512:
        monkeypatch.setattr(cuda_tighten, "tighten_weights_plain", _weights_f32)
        assert rel_err() >= err


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

"""Port controller setup and the numpy bridge against the JAX package.

The slice's configuration is bench.py's default (quadrotor, T=25, prob 0.95,
6 SQP / 10 IP iterations)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.envs.drone import DroneFigureEightEnv
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict, synthetic_gp_model
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym

REPO = Path(__file__).resolve().parents[1]
T = 25


def _controllers():
    prior = reference_prior_dict()
    env = DroneFigureEightEnv()
    jc = JGPMPC(
        j_sym(dt=0.02, params=prior), env.trajectory, prior, horizon=T, q_mpc=Q_MPC,
        r_mpc=R_MPC, sparse_gp=True, prob=0.95, max_gp_samples=40, seed=1,
        max_gp_points=128, sqp_iters=6, qp_iters=10,
    )
    tc = t_gpmpc.GPMPC(
        t_sym(dt=0.02, params=prior), np.asarray(env.trajectory), prior, horizon=T,
        q_mpc=Q_MPC, r_mpc=R_MPC, prob=0.95, sqp_iters=6, qp_iters=10,
    )
    return jc, tc


def _close(t, j, rtol=1e-5):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * max(1e-6, float(np.abs(j).max())))


def test_gpmpc_consts_match_jax():
    jc, tc = _controllers()
    for name in ("Ad", "Bd_in", "lqr_gain", "Bd", "inverse_cdf", "dt"):
        _close(getattr(tc.consts, name), getattr(jc.consts, name))
    for name in t_mpc.MpcConsts._fields:
        _close(getattr(tc.consts.mpc, name), getattr(jc.consts.mpc, name))
    for name in tc.consts._fields[1:]:
        assert getattr(tc.consts, name).dtype == torch.float32
    assert tc.cfg._asdict() == jc.cfg._asdict()


def test_init_state_and_reference_window_match_jax():
    jc, tc = _controllers()
    sj = j_mpc.init_state(T, 12, 4)
    st = t_mpc.init_state(3, T)
    for name in ("X_warm", "U_warm"):
        for b in range(3):
            np.testing.assert_array_equal(getattr(st, name)[b].numpy(), np.asarray(getattr(sj, name)))
    steps = np.array([0, 7, 290], np.int32)
    wt = t_mpc.reference_window(tc.consts.mpc.traj, torch.as_tensor(steps), T)
    for b, k in enumerate(steps):
        wj = j_mpc.reference_window(jc.consts.mpc.traj, jnp.asarray(k), T)
        np.testing.assert_allclose(wt[b].numpy(), np.asarray(wj, np.float32), atol=1e-7)


def _flat_gp(gp) -> dict:
    d = {k: np.asarray(v) for k, v in gp._asdict().items() if k != "hypers"}
    d.update({k: np.asarray(v) for k, v in gp.hypers._asdict().items()})
    return d


def test_convert_round_trips_jax_pytrees():
    gp = synthetic_gp_model(max_points=32, max_inducing=12, n_data=24, n_train=5, seed=2)
    tg = convert.gp_model_from_numpy(_flat_gp(gp))
    for name in ("Z", "y", "mask", "Zs", "alpha_s", "var_Z", "var_mat", "var_mask"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(gp, name)))
    for name in tg.hypers._fields:
        np.testing.assert_array_equal(getattr(tg.hypers, name).numpy(),
                                      np.asarray(getattr(gp.hypers, name)))
    assert bool(tg.trained) is True

    jc, _ = _controllers()
    d = {k: np.asarray(v) for k, v in jc.consts._asdict().items() if k != "mpc"}
    d["mpc"] = {k: np.asarray(v) for k, v in jc.consts.mpc._asdict().items()}
    tcon = convert.consts_from_numpy(d)
    for name in ("Ad", "lqr_gain", "inverse_cdf"):
        np.testing.assert_array_equal(getattr(tcon, name).numpy(), np.asarray(getattr(jc.consts, name)))
    np.testing.assert_array_equal(tcon.mpc.traj.numpy(), np.asarray(jc.consts.mpc.traj))

    states = jax.vmap(lambda _: j_mpc.init_state(T, 12, 4))(jnp.arange(4))
    ts = convert.state_from_numpy({k: np.asarray(v) for k, v in states._asdict().items()})
    assert ts.traj_step.dtype == torch.int32 and ts.X_warm.shape == (4, T + 1, 12)
    np.testing.assert_array_equal(ts.U_warm.numpy(), np.asarray(states.U_warm))


def test_bench_gp_fixture_matches_regenerated_model():
    """The committed fixture equals synthetic_gp_model at bench.py's defaults,
    regenerated here (rtol 1e-4: Adam's float32 sums may round differently on
    another CPU)."""
    spec = importlib.util.spec_from_file_location(
        "export_torch_gp_fixture", REPO / "scripts" / "export_torch_gp_fixture.py"
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fresh = script.bench_gp_arrays()
    with np.load(convert.BENCH_GP_PATH) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_allclose(committed[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    gp = convert.load_bench_gp()
    assert gp.Zs.shape == (3, 40, 3) and gp.var_mat.shape == (3, 40, 40)
    assert gp.Z.shape == (3, 128, 3) and bool(gp.trained)

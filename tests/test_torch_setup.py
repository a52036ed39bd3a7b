"""Port controller setup and the numpy bridge against the JAX package.

The slice's configurations are bench.py's for each family (T=25, prob 0.95,
6 SQP / 10 IP iterations; the cartpole and the two-link arm with their own
weights, boxes and lm_reg)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.envs import cartpole_env as j_cart_env
from gpmpc_tpu.envs import twolink_env as j_twolink_env
from gpmpc_tpu.envs.drone import DroneFigureEightEnv
from gpmpc_tpu.models import cartpole as j_cart
from gpmpc_tpu.models import twolink as j_twolink
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict, synthetic_gp_model
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.models import cartpole as t_cart
from gpmpc_tpu_torch.models import twolink as t_twolink
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from tests._torch_threads import _one_thread  # noqa: F401


REPO = Path(__file__).resolve().parents[1]
T = 25


# bench.py:94-145: per family (JAX model, JAX plant module, port model
# factory, prior params, q_mpc, r_mpc, JAX boxes, port boxes, lm_reg)
def family_config(family):
    if family == "quadrotor":
        prior = reference_prior_dict()
        return (j_sym(dt=0.02, params=prior), None, lambda: t_sym(dt=0.02, params=prior), prior,
                Q_MPC, R_MPC, None, None, 0.0)
    if family == "cartpole":
        return (j_cart.symbolic_cartpole(0.02), j_cart_env, lambda: t_cart.symbolic_cartpole(0.02),
                None, [5.0, 0.1, 20.0, 0.5], [0.05], (j_cart.state_bounds(), j_cart.input_bounds()),
                (t_cart.state_bounds(), t_cart.input_bounds()), 0.0)
    return (j_twolink.symbolic_twolink(0.02), j_twolink_env,
            lambda: t_twolink.symbolic_twolink(0.02), None, [20.0, 20.0, 0.5, 0.5], [0.1, 0.1],
            (j_twolink.state_bounds(), j_twolink.input_bounds()),
            (t_twolink.state_bounds(), t_twolink.input_bounds()), 0.5)


def _controllers(family="quadrotor"):
    model_j, env_j, model_t, prior, q, r, bounds_j, bounds_t, lm = family_config(family)
    if env_j is None:
        traj = DroneFigureEightEnv().trajectory
    else:
        traj = env_j.make_trajectory(env_j.EnvParams.default())
    jc = JGPMPC(
        model_j, traj, prior, horizon=T, q_mpc=q, r_mpc=r, sparse_gp=True, prob=0.95,
        max_gp_samples=40, seed=1, max_gp_points=128, sqp_iters=6, qp_iters=10,
        bounds=bounds_j, lm_reg=lm,
    )
    tc = t_gpmpc.GPMPC(
        model_t(), np.asarray(traj), prior, horizon=T, q_mpc=q, r_mpc=r, prob=0.95,
        sqp_iters=6, qp_iters=10, bounds=bounds_t, lm_reg=lm, device="cpu",
    )
    return jc, tc


def _close(t, j, rtol=1e-5):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * max(1e-6, float(np.abs(j).max())))


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_gpmpc_consts_match_jax(family):
    """The two-link arm's trim pair is away from the origin, so it sets uref,
    Ad, Bd_in and the LQR gain; its lm_reg is 0.5."""
    jc, tc = _controllers(family)
    for name in ("Ad", "Bd_in", "lqr_gain", "Bd", "inverse_cdf", "dt"):
        _close(getattr(tc.consts, name), getattr(jc.consts, name))
    for name in t_mpc.MpcConsts._fields:
        _close(getattr(tc.consts.mpc, name), getattr(jc.consts.mpc, name))
    for name in tc.consts._fields[1:]:
        assert getattr(tc.consts, name).dtype == torch.float32
    assert tc.cfg._asdict() == jc.cfg._asdict()


@pytest.mark.parametrize("case", ["quadrotor", "cartpole", "sparse_gp"])
def test_gpmpc_positional_arguments_match_jax(case):
    """F6: the port's GPMPC takes the reference's parameter list in its order,
    so a positional call (here `sparse_gp=False` in the seventh place) builds
    the same controller: every const that the arguments decide, the chance
    quantile `inverse_cdf` among them, is bit for bit the reference's. Ad,
    Bd_in and the LQR gain come from each framework's Jacobian of the prior
    at the trim point and agree to rounding (test_gpmpc_consts_match_jax's
    bar). With `sparse_gp=True` in that place the untrained GP has the
    sparse shapes (the variance form at the 40 inducing points) of JAX's."""
    family = "quadrotor" if case == "sparse_gp" else case
    sparse = case == "sparse_gp"
    model_j, env_j, model_t, prior, q, r, _, _, _ = family_config(family)
    if env_j is None:
        traj = DroneFigureEightEnv().trajectory
    else:
        traj = env_j.make_trajectory(env_j.EnvParams.default())
    jc = JGPMPC(model_j, traj, prior, T, q, r, sparse, 0.95, 40, 1, "cpu", None, 128, 6, 10)
    tc = t_gpmpc.GPMPC(model_t(), np.asarray(traj), prior, T, q, r, sparse, 0.95, 40, 1, "cpu",
                       None, 128, 6, 10)
    assert tc.sparse is sparse
    for name in t_gpmpc.GpModel._fields:
        if name != "hypers":
            assert tuple(getattr(tc.gp_model, name).shape) == getattr(jc.gp_model, name).shape, name
    for name in ("Bd", "inverse_cdf", "dt"):
        np.testing.assert_array_equal(getattr(tc.consts, name).numpy(),
                                      np.asarray(getattr(jc.consts, name)), err_msg=name)
    for name in t_mpc.MpcConsts._fields:
        np.testing.assert_array_equal(getattr(tc.consts.mpc, name).numpy(),
                                      np.asarray(getattr(jc.consts.mpc, name)), err_msg=name)
    for name in ("Ad", "Bd_in", "lqr_gain"):
        _close(getattr(tc.consts, name), getattr(jc.consts, name))
    assert tc.cfg._asdict() == jc.cfg._asdict()
    assert (tc.max_gp_samples, tc.max_gp_points, tc.seed) == (40, 128, 1)
    np.testing.assert_array_equal(t_gpmpc.GPMPC.U_EQ, JGPMPC.U_EQ)


def test_init_state_and_reference_window_match_jax():
    jc, tc = _controllers()
    sj = j_mpc.init_state(T, 12, 4)
    st = t_mpc.init_state(3, T, device="cpu")
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
    tg = convert.gp_model_from_numpy(_flat_gp(gp), device="cpu")
    for name in ("Z", "y", "mask", "Zs", "alpha_s", "var_Z", "var_mat", "var_mask"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(gp, name)))
    for name in tg.hypers._fields:
        np.testing.assert_array_equal(getattr(tg.hypers, name).numpy(),
                                      np.asarray(getattr(gp.hypers, name)))
    assert bool(tg.trained) is True

    jc, _ = _controllers()
    d = {k: np.asarray(v) for k, v in jc.consts._asdict().items() if k != "mpc"}
    d["mpc"] = {k: np.asarray(v) for k, v in jc.consts.mpc._asdict().items()}
    tcon = convert.consts_from_numpy(d, device="cpu")
    for name in ("Ad", "lqr_gain", "inverse_cdf"):
        np.testing.assert_array_equal(getattr(tcon, name).numpy(), np.asarray(getattr(jc.consts, name)))
    np.testing.assert_array_equal(tcon.mpc.traj.numpy(), np.asarray(jc.consts.mpc.traj))

    states = jax.vmap(lambda _: j_mpc.init_state(T, 12, 4))(jnp.arange(4))
    ts = convert.state_from_numpy({k: np.asarray(v) for k, v in states._asdict().items()}, device="cpu")
    assert ts.traj_step.dtype == torch.int32 and ts.X_warm.shape == (4, T + 1, 12)
    np.testing.assert_array_equal(ts.U_warm.numpy(), np.asarray(states.U_warm))


@pytest.mark.parametrize("family,G,D", [("quadrotor", 3, 3), ("cartpole", 2, 3), ("twolink", 2, 6)])
def test_bench_gp_fixture_matches_regenerated_model(family, G, D):
    """The committed fixture equals the family's synthetic GP at bench.py's
    defaults, regenerated here (rtol 1e-4: Adam's float32 sums may round
    differently on another CPU)."""
    spec = importlib.util.spec_from_file_location(
        "export_torch_gp_fixture", REPO / "scripts" / "export_torch_gp_fixture.py"
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fresh = script.bench_gp_arrays(family)
    with np.load(convert.bench_gp_path(family)) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_allclose(committed[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    gp = convert.load_bench_gp("cpu", family=family)
    assert gp.Zs.shape == (G, 40, D) and gp.var_mat.shape == (G, 40, 40)
    assert gp.Z.shape == (G, 128, D) and bool(gp.trained)


def test_prior_params_are_required_only_for_the_quadrotor():
    """F1: the reference checks a/b only for the quadrotor, whose thrust map
    reads them; bench.py passes None for the other families."""
    _, _, model_t, _, q, r, _, bounds_t, _ = family_config("cartpole")
    traj = np.zeros((10, 4), np.float32)
    ctrl = t_gpmpc.GPMPC(model_t(), traj, None, horizon=5, q_mpc=q, r_mpc=r, bounds=bounds_t,
                         device="cpu")
    assert ctrl.consts.Ad.shape == (4, 4)
    with pytest.raises(ValueError, match="'a' and 'b'"):
        t_gpmpc.GPMPC(t_sym(dt=0.02), np.zeros((10, 12), np.float32), {"a": 1.0}, horizon=5,
                      q_mpc=Q_MPC, r_mpc=R_MPC, device="cpu")


def test_make_consts_bounds_u_eq_and_lm_reg_match_jax():
    """F2: make_consts(bounds=, u_eq=), init_state(u_eq=) and GPMPC(bounds=,
    lm_reg=) as in the reference."""
    model_j, _, model_t, _, q, r, bounds_j, bounds_t, _ = family_config("twolink")
    traj = np.zeros((30, 4), np.float32)
    u_eq = np.array([1.5, -0.5], np.float32)
    for kw_j, kw_t in (({}, {}), (dict(bounds=bounds_j), dict(bounds=bounds_t)),
                       (dict(bounds=bounds_j, u_eq=u_eq), dict(bounds=bounds_t, u_eq=u_eq))):
        cj = j_mpc.make_consts(model_j, jnp.asarray(traj), q, r, T, **kw_j)
        ct = t_mpc.make_consts(model_t(), traj, q, r, T, device="cpu", **kw_t)
        for name in t_mpc.MpcConsts._fields:
            np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                          np.asarray(getattr(cj, name), np.float32), err_msg=name)
    sj = j_mpc.init_state(T, 4, 2, u_eq=jnp.asarray(u_eq))
    st = t_mpc.init_state(2, T, 4, 2, u_eq=u_eq, device="cpu")
    np.testing.assert_array_equal(st.U_warm[1].numpy(), np.asarray(sj.U_warm))
    np.testing.assert_array_equal(t_mpc.init_state(1, T, 4, 2, device="cpu").U_warm[0].numpy(),
                                  np.asarray(j_mpc.init_state(T, 4, 2).U_warm))
    ctrl = t_gpmpc.GPMPC(model_t(), traj, None, horizon=T, q_mpc=q, r_mpc=r, bounds=bounds_t,
                         lm_reg=0.5, device="cpu")
    assert ctrl.cfg.lm_reg == 0.5
    np.testing.assert_array_equal(ctrl.consts.mpc.ux.numpy(), bounds_t[0][1])

"""The port's `xla` step (`control/gpmpc.py`: `propagate_constraint_limits`,
`select_action`; `parallel/batch.py::batched_gpmpc_step(backend="xla")`)
against the JAX package's vmapped `select_action`, on the CPU, in float32 on
both sides, with the committed benchmark GP. Bars: tightenings within 1e-5
of max(1, |t|); actions within 5e-4 at every step (tests/test_torch_step.py's
bar) with equal per-scenario SQP iterations; clamp_frac equal and soft_viol
within 5e-4. The path launches no kernel: every kernel wrapper is replaced
by one that raises."""

from functools import partial

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
from gpmpc_tpu.parallel import batch as j_batch
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.ops import sqp_lanes as t_sqp_lanes
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step
from tests._torch_threads import _one_thread  # noqa: F401

F32 = np.float32
STRESS_OUTPUTSCALE = 30.0  # chip_smoke.py's stress GP: tightenings past the boxes


@pytest.fixture(autouse=True)
def _no_kernel(monkeypatch):
    """The xla path must reach none of the kernel wrappers."""
    def refuse(*a, **k):
        raise AssertionError("the xla path reached a kernel wrapper")

    for mod, name in ((t_gpmpc, "gp_mean_var_multi"), (t_gpmpc, "tighten_lanes"),
                      (t_sqp_lanes, "linearize_ocp_lanes"), (t_sqp_lanes, "solve_ocp_qp_lanes"),
                      (t_sqp_lanes, "solve_ocp_qp_lanes_streamed"),
                      (t_sqp_lanes, "solve_ocp_qp_lanes_streamed2")):
        monkeypatch.setattr(mod, name, refuse)


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


def _controllers(T, soft=None):
    prior = reference_prior_dict()
    traj = np.asarray(j_drone.make_trajectory(j_drone.EnvParams.default()))
    kw = dict(horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC, prob=0.95, sqp_iters=6, qp_iters=10,
              soft_constraints=soft)
    jc = j_gpmpc.GPMPC(j_sym(dt=0.02, params=prior), traj, prior, **kw)
    tc = t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), traj, prior, device="cpu", **kw)
    return traj.astype(F32), jc, tc


def _stressed(gp_j, gp_t):
    """Both GPs with raw_outputscale STRESS_OUTPUTSCALE: large variances."""
    gp_j = gp_j._replace(hypers=gp_j.hypers._replace(
        raw_outputscale=jnp.full((3,), STRESS_OUTPUTSCALE, jnp.float32)))
    gp_t = gp_t._replace(hypers=gp_t.hypers._replace(
        raw_outputscale=torch.full((3,), STRESS_OUTPUTSCALE)))
    return gp_j, gp_t


def test_propagate_constraint_limits_matches_jax():
    """The trained benchmark GP along B = 3 perturbed previous solutions,
    T = 10: t_x and t_u within 1e-5 max(1, |t|) of JAX's per scenario."""
    B, T = 3, 10
    traj, jc, tc = _controllers(T)
    rng = np.random.default_rng(0)
    X = (traj[None, : T + 1] + rng.normal(0, 0.1, (B, T + 1, 12))).astype(F32)
    U = (np.asarray([0.3234, 0, 0, 0], F32) + rng.normal(0, 0.05, (B, T, 4))).astype(F32)
    gp_j, gp_t = _jax_bench_gp(), convert.load_bench_gp("cpu")
    tx_j, tu_j = jax.jit(jax.vmap(partial(j_gpmpc.propagate_constraint_limits, jc.consts, gp_j)))(
        jnp.asarray(X), jnp.asarray(U))
    tx_t, tu_t = t_gpmpc.propagate_constraint_limits(tc.consts, gp_t, torch.as_tensor(X),
                                                     torch.as_tensor(U))
    assert tx_t.shape == (B, T + 1, 12) and tu_t.shape == (B, T, 4)
    for got, want in ((tx_t, tx_j), (tu_t, tu_j)):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 1e-3  # the tightening is not trivially zero
        np.testing.assert_array_less(np.abs(got.numpy() - want), 1e-5 * np.maximum(1, np.abs(want)))


def _closed(T, B, cfg_edit, gp_edit=None, soft=None, population=False, n_steps=3):
    """`n_steps` steps of the port's batched_gpmpc_step(backend="xla") and
    JAX's, each from the same observations: the next observation is the
    JAX solution's predicted state plus a fixed perturbation. Returns the
    per-step infos of both."""
    traj, jc, tc = _controllers(T, soft)
    cfg_j, cfg_t = cfg_edit(jc.cfg), cfg_edit(tc.cfg)
    gp_j, gp_t = _jax_bench_gp(), convert.load_bench_gp("cpu")
    if gp_edit is not None:
        gp_j, gp_t = gp_edit(gp_j, gp_t)
    if population:  # each scenario's mean weights scaled by 1, 1.1, ...
        scale = 1.0 + 0.1 * np.arange(B, dtype=F32)
        gp_j = jax.tree.map(lambda l: jnp.broadcast_to(l[None], (B,) + l.shape), gp_j)
        gp_j = gp_j._replace(alpha_s=gp_j.alpha_s * jnp.asarray(scale)[:, None, None])
        gp_t = convert.gp_model_from_numpy(
            {**{k: np.array(v) for k, v in gp_j._asdict().items() if k != "hypers"},
             **{k: np.array(v) for k, v in gp_j.hypers._asdict().items()}}, "cpu")
    step_j = jax.jit(partial(j_batch.batched_gpmpc_step, jc.model, cfg_j, backend="xla"))
    rng = np.random.default_rng(1)
    obs = (traj[:B] + rng.normal(0, 0.02, (B, 12))).astype(F32)
    st_j = jax.vmap(lambda _: j_mpc.init_state(T, 12, 4))(jnp.arange(B))
    st_t = t_mpc.init_state(B, T, device="cpu")
    infos = []
    for k in range(n_steps):
        u_j, st_j, info_j = step_j(jc.consts, gp_j, st_j, jnp.asarray(obs))
        u_t, st_t, info_t = batched_gpmpc_step(tc.model, cfg_t, tc.consts, gp_t, st_t,
                                               torch.as_tensor(obs))
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=5e-4, err_msg=f"step {k}")
        np.testing.assert_allclose(st_t.X_warm.numpy(), np.asarray(st_j.X_warm), atol=5e-3)
        assert info_t.n_iters.tolist() == np.asarray(info_j.n_iters).tolist()
        assert info_t.clamp_frac.tolist() == np.asarray(info_j.clamp_frac, F32).tolist()
        np.testing.assert_allclose(info_t.soft_viol.numpy(), np.asarray(info_j.soft_viol), atol=5e-4)
        infos.append((info_j, info_t))
        obs = (np.asarray(st_j.X_warm)[:, 1] + rng.normal(0, 0.01, (B, 12))).astype(F32)
    return infos


def test_batched_gpmpc_step_xla_hard_matches_jax():
    """B = 4, T = 8, 6 SQP / 10 IP iterations (the default backend, xla):
    three steps, the tightening on from the second."""
    infos = _closed(8, 4, lambda c: c)
    assert float(infos[-1][1].clamp_frac.max()) == 0.0


def test_batched_gpmpc_step_xla_soft_warm_shift_matches_jax():
    """Soft state bounds (penalty 50) with the warm-start shift, B = 4,
    T = 8, Mehrotra, and the stressed GP, whose tightenings cross the state
    boxes: the soft path honours them in full and reports soft_viol > 0,
    as JAX does."""
    infos = _closed(8, 4, lambda c: c._replace(warm_shift=True, qp_mehrotra=True),
                    gp_edit=_stressed, soft=50.0)
    assert float(infos[-1][1].soft_viol.max()) > 1e-3


def test_batched_gpmpc_step_xla_population_matches_jax():
    """A GP population at B = 2 (each scenario's own mean weights and
    variance form): three steps against JAX's vmapped step with the GP
    mapped per scenario."""
    _closed(8, 2, lambda c: c, population=True)

"""`bench_torch.py` and `scripts/bench_step_breakdown_torch.py`, the port's
counterparts of `bench.py` and `scripts/bench_step_breakdown.py`, on the CPU:
each family's controller and every step knob against what bench.py builds
with the JAX package, the closed-loop step against the JAX package's
`batched_gpmpc_step` and plant (control RMSE <= 1e-3, BASELINE.md), the JSON
protocol of `main` at tiny sizes, and the breakdown's seven segments."""

import importlib.util
import json
import sys
from functools import partial
from pathlib import Path

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
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.parallel.batch import batched_gpmpc_step as j_batched_gpmpc_step
from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.envs import drone as t_drone
from gpmpc_tpu_torch.parallel.mesh import tree_leaves
from tests._torch_threads import _one_thread  # noqa: F401
from tests.test_torch_scripts import _assert_same_value
from tests.test_torch_step import _jax_bench_gp

REPO = Path(__file__).resolve().parents[1]
F32 = np.float32


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


BENCH = _load(REPO / "bench_torch.py", "bench_torch")
BREAKDOWN = _load(REPO / "scripts" / "bench_step_breakdown_torch.py", "bench_step_breakdown_torch")
FAMILIES = ("quadrotor", "cartpole", "twolink")
HORIZON = 8
# bench.py's GP defaults: the port reads the JAX package's GP from its fixture
GP_SIZES = dict(gp_points=128, gp_inducing=40, gp_data=128)


def _jax_controller(family, horizon=HORIZON, gp_points=128, gp_inducing=40):
    """bench.py:94-145's controller for the family, with the JAX package."""
    if family == "twolink":
        env = j_twolink_env.TwoLinkTrackEnv(j_twolink_env.EnvParams.default())
        return j_gpmpc.GPMPC(
            j_twolink.symbolic_twolink(dt=0.02), env.trajectory, None, horizon=horizon,
            q_mpc=[20.0, 20.0, 0.5, 0.5], r_mpc=[0.1, 0.1],
            sparse_gp=True, prob=0.95, max_gp_samples=gp_inducing, seed=1,
            max_gp_points=gp_points, sqp_iters=6, qp_iters=10, lm_reg=0.5,
            bounds=(j_twolink.state_bounds(), j_twolink.input_bounds()),
        )
    if family == "cartpole":
        env = j_cart_env.CartpoleTrackEnv(j_cart_env.EnvParams.default())
        return j_gpmpc.GPMPC(
            j_cart.symbolic_cartpole(dt=0.02), env.trajectory, None, horizon=horizon,
            q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05],
            sparse_gp=True, prob=0.95, max_gp_samples=gp_inducing, seed=1,
            max_gp_points=gp_points, sqp_iters=6, qp_iters=10,
            bounds=(j_cart.state_bounds(), j_cart.input_bounds()),
        )
    prior_params = reference_prior_dict()
    env = j_drone.DroneFigureEightEnv()
    return j_gpmpc.GPMPC(
        j_sym(dt=0.02, params=prior_params), env.trajectory, prior_params, horizon=horizon,
        q_mpc=Q_MPC, r_mpc=R_MPC, sparse_gp=True, prob=0.95, max_gp_samples=gp_inducing,
        seed=1, max_gp_points=gp_points, sqp_iters=6, qp_iters=10,
    )


def _bench_py_cfg(cfg, env):
    """bench.py:215-240, line for line, on the JAX package's SqpConfig."""
    qp_tol = env.get("BENCH_QP_TOL", "1e-6")
    if qp_tol and float(qp_tol) > 0:
        cfg = cfg._replace(qp_tol=float(qp_tol))
    if env.get("BENCH_KERNEL_LIN", "1") == "1":
        cfg = cfg._replace(kernel_linearize=True)
    if env.get("BENCH_MEHROTRA", "1") == "1":
        cfg = cfg._replace(qp_mehrotra=True)
    if env.get("BENCH_PSCAN", "0") == "1":
        cfg = cfg._replace(parallel_scan=True)
    if env.get("BENCH_WARM_SHIFT", "0") == "1":
        cfg = cfg._replace(warm_shift=True)
    if env.get("BENCH_ANALYTIC_JAC", "0") == "1":
        cfg = cfg._replace(analytic_jac=True)
    return cfg


_CONTROLLERS: dict = {}


def _controllers(family):
    """(JAX controller, port Problem) for the family at T = 8, built once."""
    if family not in _CONTROLLERS:
        _CONTROLLERS[family] = (_jax_controller(family),
                                BENCH.build_problem(family, HORIZON, device="cpu", **GP_SIZES))
    return _CONTROLLERS[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_controller_arguments_equal_bench_py(family):
    """The family's controller as bench.py builds it: the constants (the
    reference's float32 trajectory and LQR gain within a few float32 ulps,
    as tests/test_torch_scripts.py holds them), the SqpConfig, the horizon,
    the GP sizes and seed; the plant at its default parameters; the GP the
    JAX package's at bench.py's defaults (the fixture)."""
    jc, prob = _controllers(family)
    tc = prob.ctrl
    for k in jc.consts._fields:
        _assert_same_value(getattr(tc.consts, k), getattr(jc.consts, k), k, atol=1e-6, rtol=1e-6)
    assert tc.cfg._asdict() == jc.cfg._asdict()
    assert (tc.T, tc.max_gp_points, tc.max_gp_samples, tc.sparse) == (
        jc.T, jc.max_gp_points, jc.max_gp_samples, jc.sparse)
    # the seed: the reference keeps it as its numpy generator and inducing-draw key
    assert tc.np_random.bit_generator.state == jc.np_random.bit_generator.state
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(tc.seed)), np.asarray(jc._gp_key))
    assert (prob.model.nx, prob.model.nu, prob.model.dt) == (jc.model.nx, jc.model.nu, jc.model.dt)
    env_names = {"quadrotor": "drone", "cartpole": "cartpole_env", "twolink": "twolink_env"}
    assert prob.env_mod.__name__.split(".")[-1] == env_names[family]
    assert prob.env_p == prob.env_mod.EnvParams.default()
    _assert_same_value(prob.gp._replace(trained=bool(prob.gp.trained)),
                       _jax_bench_gp(family)._replace(trained=True))


KNOBS = [
    {},
    {"BENCH_QP_TOL": "0"},
    {"BENCH_QP_TOL": "1e-7"},
    {"BENCH_KERNEL_LIN": "0"},
    {"BENCH_MEHROTRA": "0"},
    {"BENCH_PSCAN": "1"},
    {"BENCH_WARM_SHIFT": "1"},
    {"BENCH_ANALYTIC_JAC": "1"},
    {"BENCH_QP_TOL": "0", "BENCH_KERNEL_LIN": "0", "BENCH_MEHROTRA": "0", "BENCH_PSCAN": "1",
     "BENCH_WARM_SHIFT": "1", "BENCH_ANALYTIC_JAC": "1"},
]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items())
                         or "defaults")
def test_configure_equals_bench_py(family, knobs):
    """`configure` gives the SqpConfig bench.py's `_replace` calls give;
    BENCH_QP_TOL=0 leaves qp_tol as constructed (None)."""
    jc, prob = _controllers(family)
    got = BENCH.configure(prob.ctrl.cfg, knobs)
    assert got._asdict() == _bench_py_cfg(jc.cfg, knobs)._asdict()
    if knobs.get("BENCH_QP_TOL") == "0":
        assert got.qp_tol is None


def jax_bench_loop(B: int):
    """The JAX side of bench.py's quadrotor loop at T = 8 (bench.py:247-255,
    :304-313): the JAX package's controller, bench.py's SqpConfig, the
    fixture GP, the plant's default parameters and B initial plant states,
    observations and controller states from PRNGKey(0); with the port's
    problem and config at the same settings."""
    jc, prob = _controllers("quadrotor")
    env_p = j_drone.EnvParams.default()
    es, obs = jax.vmap(lambda k: j_drone.env_reset(env_p, k))(
        jax.random.split(jax.random.PRNGKey(0), B))
    st_j = jax.vmap(lambda _: j_mpc.init_state(HORIZON, 12, 4))(jnp.arange(B))
    return dict(jc=jc, cfg_j=_bench_py_cfg(jc.cfg, {}), gp_j=_jax_bench_gp(), env_p=env_p, es=es,
                obs=obs, st_j=st_j, prob=prob, cfg_t=BENCH.configure(prob.ctrl.cfg, {}))


def port_env_state(es) -> t_drone.EnvState:
    """JAX's plant states as the port's, in float32."""
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return t_drone.EnvState(x=t(es.x).float(), t=t(es.t), u_act=t(es.u_act).float(),
                            u_queue=t(es.u_queue).float())


def test_closed_loop_step_matches_jax():
    """`closed_loop_step` at bench.py's quadrotor settings (T = 8, B = 4, 3
    steps, the fixture GP on both sides) from JAX's initial states
    (PRNGKey(0)), driven as tests/test_torch_step.py drives the reference:
    JAX's `batched_gpmpc_step` (its vmapped `select_action`) and plant run
    the loop, the port solves the same observation and steps its plant from
    JAX's plant state at every step. Bars: control RMSE <= 1e-3 (BASELINE.md)
    and u within 5e-4 at every step, as tests/test_torch_step.py's; the
    port's next observations within 1e-4 of JAX's."""
    T, B = HORIZON, 4
    loop = jax_bench_loop(B)
    jc, prob, cfg_t, env_p = loop["jc"], loop["prob"], loop["cfg_t"], loop["env_p"]
    step_j = jax.jit(partial(j_batched_gpmpc_step, jc.model, loop["cfg_j"], backend="xla"))
    plant = jax.jit(jax.vmap(lambda s, a: j_drone.env_step(env_p, s, a)))
    es, obs, st_j, gp_j = loop["es"], loop["obs"], loop["st_j"], loop["gp_j"]
    st_t = t_mpc.init_state(B, T, 12, 4, device="cpu")
    u_j, u_t = [], []
    for _ in range(3):
        es_t = port_env_state(es)
        _, st_t, obs_t, ut = BENCH.closed_loop_step(prob, cfg_t, prob.gp, es_t, st_t,
                                                    torch.tensor(np.asarray(obs, F32)))
        uj, st_j, _ = step_j(jc.consts, gp_j, st_j, jnp.asarray(np.asarray(obs, F32)))
        es, obs, *_ = plant(es, uj)
        u_j.append(np.asarray(uj, F32))
        u_t.append(ut.numpy())
        np.testing.assert_allclose(u_t[-1], u_j[-1], atol=5e-4)
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs, F32), atol=1e-4)
    rmse = float(np.sqrt(np.mean((np.stack(u_t) - np.stack(u_j)) ** 2)))
    assert rmse <= 1e-3, rmse


TINY = dict(BENCH_DEVICE="cpu", BENCH_BATCH="4", BENCH_HORIZON="6", BENCH_GP_POINTS="32",
            BENCH_GP_INDUCING="10", BENCH_STEPS="2", BENCH_PROV_STEPS="2")


def _lines(capsys):
    out = capsys.readouterr()
    return [json.loads(ln) for ln in out.out.splitlines() if ln.startswith("{")], out.err


def test_main_prints_the_provisional_then_the_final_line(capsys):
    run = BENCH.main(TINY)
    lines, err = _lines(capsys)
    assert lines == run.records and len(lines) == 2
    assert lines[0]["provisional"] is True and "provisional" not in lines[1]
    for rec in lines:
        assert rec["metric"] == "gpmpc_torch_solves_per_sec_cpu" and rec["unit"] == "solves/s"
        assert rec["value"] > 0 and rec["device"] == "cpu"
        assert rec["vs_baseline"] == pytest.approx(rec["value"] / 1e4, abs=1e-4)
    assert "timing window done" in err
    assert run.u.shape == (4, 4) and run.obs.shape == (4, 12) and bool(torch.isfinite(run.u).all())
    assert run.states.X_warm.shape == (4, 7, 12) and run.cfg.qp_tol == 1e-6


def test_budget_guard_keeps_the_provisional_line(capsys):
    run = BENCH.main(dict(TINY, BENCH_BUDGET_S="0"))
    lines, err = _lines(capsys)
    assert len(lines) == 1 and lines[0]["provisional"] is True and run.records == lines
    assert "over budget" in err


@pytest.mark.parametrize("knobs,metric", [
    ({"BENCH_MODEL": "cartpole"}, "gpmpc_torch_solves_per_sec_cpu_cartpole"),
    ({"BENCH_BACKEND": "xla"}, "gpmpc_torch_solves_per_sec_cpu"),
])
def test_main_family_suffix_and_xla_backend(capsys, knobs, metric):
    BENCH.main(dict(TINY, **knobs))
    lines, _ = _lines(capsys)
    assert [r["metric"] for r in lines] == [metric] * 2 and all(r["value"] > 0 for r in lines)


def test_main_real_gp(capsys):
    run = BENCH.main(dict(TINY, BENCH_REAL_GP="1", BENCH_REAL_GP_STEPS="5"))
    lines, err = _lines(capsys)
    assert "trained on 5 real transitions" in err
    assert len(lines) == 2 and lines[-1]["value"] > 0
    assert bool(run.gp.trained) and int(run.gp.mask[0].sum()) == 5


@pytest.mark.parametrize("knobs,error", [
    ({"BENCH_BACKEND": "pallas"}, ValueError),
    ({"BENCH_MODEL": "unicycle"}, ValueError),
    ({"BENCH_FUSED_UNROLL": "0", "BENCH_FUSED": "1"}, ValueError),
])
def test_main_refuses_what_it_does_not_run(knobs, error):
    with pytest.raises(error, match=next(iter(knobs))):
        BENCH.main(dict(TINY, **knobs))


_UNFUSED: dict = {}
# (BENCH_FUSED_UNROLL, the step's knobs): the lanes-fused step, the xla backend, the lanes path
FUSED_CASES = {"1": ("1", {}), "full": ("full", {}), "xla": ("1", {"BENCH_BACKEND": "xla"}),
               "jacfwd": ("1", {"BENCH_KERNEL_LIN": "0"})}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_main_fused(capsys, case):
    """BENCH_FUSED=1 on the CPU (the window body run eagerly, 2 steps, one
    or both a graph's worth; on the lanes-fused step, on BENCH_BACKEND=xla
    and on BENCH_KERNEL_LIN=0): the provisional line and the final line
    under the unfused run's metric name; after its 2 + 2 chained steps and
    two windows of 2 the run ends on the states, observations and actions of
    an unfused run of 2 + 2 + 4 chained steps with the same knobs, bit for
    bit, and it returns its window."""
    unroll, knobs = FUSED_CASES[case]
    key = tuple(sorted(knobs.items()))
    if key not in _UNFUSED:
        _UNFUSED[key] = BENCH.main(dict(TINY, BENCH_STEPS="4", **knobs))
        capsys.readouterr()
    unfused = _UNFUSED[key]
    run = BENCH.main(dict(TINY, BENCH_FUSED="1", BENCH_FUSED_UNROLL=unroll, **knobs))
    lines, err = _lines(capsys)
    assert lines == run.records and len(lines) == 2
    assert [r.get("provisional") for r in lines] == [True, None]
    assert all(r["metric"] == "gpmpc_torch_solves_per_sec_cpu" and r["value"] > 0 for r in lines)
    assert f"fused window: {2 if unroll == 'full' else 1} steps a graph" in err
    assert run.window is not None and unfused.window is None
    assert torch.equal(run.u, unfused.u) and torch.equal(run.obs, unfused.obs)
    got, want = tree_leaves((run.carry, run.states)), tree_leaves((unfused.carry, unfused.states))
    assert len(got) == len(want) == 11 and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("script", ["bench", "breakdown"])
def test_default_device_is_the_card(script):
    from gpmpc_tpu_torch.device import NoCudaDeviceError

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is runnable")
    env = {k: v for k, v in TINY.items() if k != "BENCH_DEVICE"}
    with pytest.raises(NoCudaDeviceError):
        (BENCH if script == "bench" else BREAKDOWN).main(env)


def test_breakdown_prints_the_seven_segments(capsys):
    rows = BREAKDOWN.main(dict(BENCH_DEVICE="cpu", BENCH_BATCH="128", BENCH_HORIZON="6",
                               BENCH_CALLS="1"))
    lines, err = _lines(capsys)
    assert [r["segment"] for r in rows] == list(BREAKDOWN.SEGMENTS) == [
        "step", "prepare", "sqp", "lin1", "qp1_warm", "qp1_cold", "env"]
    assert lines == rows
    assert all(r["ms_per_call"] > 0 and r["calls"] == 1 and r["device"] == "cpu" for r in rows)
    with pytest.raises(ValueError, match="multiple of the 128"):
        BREAKDOWN.main(dict(BENCH_DEVICE="cpu", BENCH_BATCH="64"))

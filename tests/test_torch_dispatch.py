"""Backend dispatch of the port (`gpmpc_tpu_torch/parallel/batch.py`) against
the JAX package's: every cell of tests/test_dispatch.py's matrix gives the same
path, the same `degraded` flag and the same reason text; all three paths
run (`xla` requested explicitly or decided by a horizon past the lanes
caps), and each degradation warns once per distinct reason."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from gpmpc_tpu.models import residual as j_residual
from gpmpc_tpu.ops.sqp import SqpConfig as JSqpConfig
from gpmpc_tpu.parallel.batch import dispatch_decision as j_dispatch
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.models import residual as t_residual
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.models.trajectory import figure_eight_trajectory
from gpmpc_tpu_torch.ops.sqp import SqpConfig as TSqpConfig
from gpmpc_tpu_torch.ops.sqp_lanes import (
    MAX_FUSED_HORIZON,
    MAX_STREAM2_HORIZON,
    MAX_STREAM2_HORIZON_SOFT,
    MAX_STREAM_HORIZON_SOFT,
)
from gpmpc_tpu_torch.parallel import batch as t_batch
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step, dispatch_decision

CFG = dict(sqp_iters=4, qp_iters=6, kernel_linearize=True)
SOFT = dict(CFG, soft_x_penalty=10.0)
NO_CLOSURE = "no-closure"  # the quadrotor's spec without a kernel linearizer

# tests/test_dispatch.py::MATRIX, cell by cell:
# (cfg fields, spec, T, gp_batched, backend) -> (path, reason substring)
MATRIX = [
    ((CFG, "QUADROTOR", 25, False, "xla"), ("xla", "requested")),
    ((CFG, "QUADROTOR", 25, False, "lanes"), ("lanes-fused", "flagship")),
    ((CFG, "CARTPOLE", 25, False, "lanes"), ("lanes-fused", "flagship")),
    ((CFG, "TWOLINK", 25, False, "lanes"), ("lanes-fused", "flagship")),
    ((CFG, "QUADROTOR", MAX_FUSED_HORIZON, False, "lanes"), ("lanes-fused", "flagship")),
    ((CFG, "QUADROTOR", MAX_FUSED_HORIZON + 1, False, "lanes"), ("lanes", "fused-path cap")),
    ((CFG, "QUADROTOR", MAX_STREAM2_HORIZON, False, "lanes"), ("lanes", "fused-path cap")),
    ((CFG, "QUADROTOR", MAX_STREAM2_HORIZON + 1, False, "lanes"), ("xla", "exceeds the lanes cap")),
    ((SOFT, "QUADROTOR", MAX_STREAM2_HORIZON_SOFT + 1, False, "lanes"), ("xla", "soft state bounds")),
    ((SOFT, "QUADROTOR", MAX_STREAM2_HORIZON_SOFT, False, "lanes"), ("lanes", "fused-path cap")),
    ((SOFT, "QUADROTOR", MAX_STREAM_HORIZON_SOFT, False, "lanes"), ("lanes-fused", "flagship")),
    ((CFG, "QUADROTOR", 25, True, "lanes"), ("lanes", "population")),
    ((CFG, NO_CLOSURE, 25, False, "lanes"), ("lanes", "no in-kernel linearizer")),
    ((dict(CFG, kernel_linearize=False), "QUADROTOR", 25, False, "lanes"),
     ("lanes", "kernel_linearize disabled")),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: torch's intra-op threads cost more than they give on a
    shared CPU (the T = 1025 xla step below is ~10^5 of them). Restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_of(mod, name):
    if name == NO_CLOSURE:
        return dataclasses.replace(mod.QUADROTOR_SPEC, supports_kernel_linearize=False)
    return getattr(mod, name + "_SPEC")


@pytest.mark.parametrize("case", MATRIX, ids=[f"cell{i}" for i in range(len(MATRIX))])
def test_dispatch_matrix_matches_jax(case):
    (cfg, spec, T, gp_batched, backend), (want_path, want_reason) = case
    d_t = dispatch_decision(TSqpConfig(**cfg), spec_of(t_residual, spec), T, gp_batched, backend)
    d_j = j_dispatch(JSqpConfig(**cfg), spec_of(j_residual, spec), T, gp_batched, backend)
    assert d_t.path == want_path and want_reason in d_t.reason, d_t
    assert tuple(d_t) == tuple(d_j)  # path, reason text and degraded flag


def setup(T=4, B=2, **spec_changes):
    model = t_sym(dt=0.02)
    if spec_changes:
        model = dataclasses.replace(
            model, residual_spec=dataclasses.replace(model.residual_spec, **spec_changes))
    traj = figure_eight_trajectory(n_steps=64, dt=0.02, device="cpu").numpy()
    ctrl = t_gpmpc.GPMPC(model, traj, {"a": 12.1432, "b": 1.8118}, horizon=T,
                         q_mpc=[8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001],
                         r_mpc=[3, 3, 3, 0.1], sqp_iters=2, qp_iters=6, device="cpu")
    gp = convert.load_bench_gp("cpu")
    st = t_mpc.init_state(B, T, device="cpu")
    obs = torch.as_tensor(np.asarray(traj[:B], np.float32))
    return model, ctrl, gp, st, obs


def step(model, ctrl, gp, st, obs, cfg=None, backend="lanes", **kw):
    return batched_gpmpc_step(model, cfg or ctrl.cfg._replace(kernel_linearize=True), ctrl.consts,
                              gp, st, obs, backend=backend, lanes=2, **kw)


def test_xla_raises_whether_requested_or_decided():
    """The `xla` path runs whether requested (silently; its actions within
    2e-3 of the flagship path's on the same problem, the reference's
    lanes-vs-xla bar, tests/test_parallel.py) or decided by a horizon past
    the last lanes cap (warning once): there one SQP and one IP iteration at
    B = 2, T = 1025."""
    model, ctrl, gp, st, obs = setup()
    t_batch._DISPATCH_WARNED.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an explicit choice: silent
        u_x, _, info = step(model, ctrl, gp, st, obs, backend="xla")
    u_f, _, _ = step(model, ctrl, gp, st, obs)
    assert bool(torch.isfinite(u_x).all()) and info.n_iters.shape == (2,)
    np.testing.assert_allclose(u_x.numpy(), u_f.numpy(), atol=2e-3)
    long = setup(T=MAX_STREAM2_HORIZON + 1)
    cfg = long[1].cfg._replace(sqp_iters=1, qp_iters=1, kernel_linearize=True)
    with pytest.warns(UserWarning, match="exceeds the lanes cap") as rec:
        u, st_long, info = step(*long, cfg=cfg)
    assert len([w for w in rec if "gpmpc dispatch" in str(w.message)]) == 1
    assert bool(torch.isfinite(u).all()) and info.n_iters.tolist() == [1, 1]
    assert st_long.X_warm.shape == (2, MAX_STREAM2_HORIZON + 2, 12)


def test_explicit_choices_run_silently():
    """kernel_linearize=False is the user's choice: the `lanes` path runs and
    nothing warns; so does the flagship path."""
    model, ctrl, gp, st, obs = setup()
    t_batch._DISPATCH_WARNED.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        u_f, _, _ = step(model, ctrl, gp, st, obs)
        u_l, _, info = step(model, ctrl, gp, st, obs, cfg=ctrl.cfg._replace(kernel_linearize=False))
    assert bool(torch.isfinite(u_l).all()) and info.n_iters.shape == (2,)
    np.testing.assert_allclose(u_l.numpy(), u_f.numpy(), atol=1e-4)  # two linearizers, one problem


def population_of(gp, n):
    rep = lambda a: a[None].expand((n,) + tuple(a.shape)).clone()  # noqa: E731
    return gp._replace(**{k: rep(v) for k, v in gp._asdict().items() if k != "hypers"},
                       hypers=type(gp.hypers)(*map(rep, gp.hypers)))


@pytest.mark.parametrize("case", ["no-closure", "population"])
def test_each_degradation_warns_once(case):
    if case == "no-closure":
        args = setup(name="custom", supports_kernel_linearize=False)
        match = "model family 'custom' has no in-kernel linearizer"
    else:
        model, ctrl, gp, st, obs = setup()
        args = (model, ctrl, population_of(gp, 2), st, obs)
        match = "per-scenario GP population"
    t_batch._DISPATCH_WARNED.clear()
    with pytest.warns(UserWarning, match=match) as rec:
        u, _, _ = step(*args)
    ours = [str(w.message) for w in rec if "gpmpc dispatch" in str(w.message)]
    assert len(ours) == 1 and "taking the 'lanes' path" in ours[0]
    assert bool(torch.isfinite(u).all())
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the same reason again: silent
        step(*args)


def _env_noise(mod):
    p = mod.EnvParams.default()._replace(noise_std=0.1)
    st, _ = mod.env_reset(p, 2, torch.Generator().manual_seed(0), "cpu")
    nu = {"drone": 4, "cartpole_env": 1, "twolink_env": 2}[mod.__name__.split(".")[-1]]
    return lambda: mod.env_step(p, st, torch.zeros(2, nu))


def _unported(case):
    """The call of an option that still raises, and its ROADMAP.md item."""
    from gpmpc_tpu_torch.envs import cartpole_env, drone, twolink_env

    if case.startswith("var"):
        model, ctrl, gp, st, obs = setup()
        kw = {"var_backend": "xla"} if case == "var_backend" else {"var_bf16": True}
        return (lambda: step(model, ctrl, gp, st, obs, backend="xla", **kw)), "item 8c"
    if case == "gp_variances_bf16":
        gp = convert.load_bench_gp("cpu")
        return (lambda: t_gpmpc.gp_variances(gp, torch.zeros(3, 2, 3), bf16=True)), "item 8c"
    if case.startswith("noise"):
        mod = {"noise_drone": drone, "noise_cartpole": cartpole_env,
               "noise_twolink": twolink_env}[case]
        return _env_noise(mod), "item 8c"
    traj = figure_eight_trajectory(n_steps=64, dt=0.02, device="cpu").numpy()
    if case == "gpmpc_parallel_scan":
        return (lambda: t_gpmpc.GPMPC(t_sym(dt=0.02), traj, {"a": 12.1432, "b": 1.8118}, horizon=4,
                                      q_mpc=[1.0] * 12, r_mpc=[1.0] * 4, parallel_scan=True,
                                      device="cpu")), "item 13"
    return (lambda: t_mpc.MPC(t_sym(dt=0.02), traj, [1.0] * 12, [1.0] * 4, parallel_scan=True,
                              device="cpu")), "item 13"


@pytest.mark.parametrize("case", ["var_backend", "var_bf16", "gp_variances_bf16", "noise_drone",
                                  "noise_cartpole", "noise_twolink", "gpmpc_parallel_scan",
                                  "mpc_parallel_scan"])
def test_unported_options_raise_naming_their_item(case):
    """Each option of ROADMAP.md item 8c that is still missing (the
    reference's variance backends and bf16 variances, plant process noise)
    and `parallel_scan` (item 13) raises UnsupportedPathError naming its
    item; none falls back."""
    call, item = _unported(case)
    with pytest.raises(t_gpmpc.UnsupportedPathError, match=item):
        call()

"""Backend dispatch of the port (`gpmpc_tpu_torch/parallel/batch.py`) against
the JAX package's: every cell of tests/test_dispatch.py's matrix gives the same
path, the same `degraded` flag and the same reason text; `lanes-fused` and
`lanes` run, `xla` raises `UnsupportedPathError`, and each degradation warns
once per distinct reason."""

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


def step(model, ctrl, gp, st, obs, cfg=None, **kw):
    return batched_gpmpc_step(model, cfg or ctrl.cfg._replace(kernel_linearize=True), ctrl.consts,
                              gp, st, obs, lanes=2, **kw)


def test_xla_raises_whether_requested_or_decided():
    model, ctrl, gp, st, obs = setup()
    with pytest.raises(t_gpmpc.UnsupportedPathError, match="requested explicitly"):
        step(model, ctrl, gp, st, obs, backend="xla")
    long = setup(T=MAX_STREAM2_HORIZON + 1)
    t_batch._DISPATCH_WARNED.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a path that raises does not also warn
        with pytest.raises(t_gpmpc.UnsupportedPathError, match="exceeds the lanes cap"):
            step(*long)


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

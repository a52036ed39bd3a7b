"""The system under test, built through the package API of
`gpmpc_tpu_torch`: the controller (`control.gpmpc.GPMPC`), the GP
(`convert.gp_model_from_numpy`), the family's plant and prior model
(`benchmark/systems/<family>.py`, found by the configuration's `family`) and
one closed-loop step, `parallel.batch.batched_gpmpc_step` on the
configuration's backend followed by the family's plant step, which
`parallel.fused.FusedWindow` captures in a CUDA graph.

Besides the actions and the carry, the step leaves two outputs in static
buffers of its own, which the captured graph writes on every replay: the
count of scenarios whose action or next state is not finite, and the
tightened boxes that the step's first stage (the GP variances and the
tightening) formed, copied where the program forms them
(`control.gpmpc._bounds_from_tightening`, which every step path calls once).
Every number the program gets comes from the configuration file."""

from __future__ import annotations

import contextlib
import importlib
from typing import NamedTuple

import numpy as np
import torch


class System(NamedTuple):
    fam: object  # benchmark/systems/<family>.py
    model: object
    cfg: object  # ops.sqp.SqpConfig of the step
    consts: object  # control.gpmpc.GpMpcConsts
    gp: object  # control.gpmpc.GpModel
    env_p: object  # the family's plant parameters
    B: int
    T: int
    nx: int
    nu: int
    tile: int
    backend: str
    params: torch.Tensor  # (B, n_params) this episode's plant coefficients, a static buffer
    fails: torch.Tensor  # () int64, non-finite scenarios so far
    boxes: tuple  # (lx, ux (B, T+1, nx), lu, uu (B, T, nu)) the last step's tightened boxes
    path: str


def family(config: dict):
    """`benchmark/systems/<family>.py` of a configuration."""
    try:
        return importlib.import_module(f"benchmark.systems.{config['family']}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no system for the family {config['family']!r}: {e}") from e


def build(config: dict, gp_arrays: dict, B: int, device) -> System:
    """The controller, GP and plant of `config` for B scenarios on `device`;
    raises unless the step dispatches to the configured path."""
    from gpmpc_tpu_torch.control.gpmpc import GPMPC, model_spec
    from gpmpc_tpu_torch.convert import gp_model_from_numpy
    from gpmpc_tpu_torch.parallel.batch import dispatch_decision

    fam = family(config)
    solver, gp_cfg = config["solver"], config["gp"]
    T, nx, nu = int(config["horizon"]), int(config["n_states"]), int(config["n_inputs"])
    env_p = fam.plant(config)
    model = fam.prior_model(config)
    if not np.allclose(model.u_eq, config["u_eq"]):
        raise ValueError(f"the program's hover input {model.u_eq} is not the configuration's")
    ctrl = GPMPC(model, fam.trajectory(env_p), dict(config["prior_params"]), horizon=T,
                 q_mpc=config["q_mpc"], r_mpc=config["r_mpc"], sparse_gp=True,
                 prob=float(config["prob"]), max_gp_samples=int(gp_cfg["inducing"]), seed=1,
                 max_gp_points=int(gp_cfg["capacity"]), sqp_iters=int(solver["sqp_iters"]),
                 qp_iters=int(solver["qp_iters"]),
                 bounds=(tuple(np.asarray(b, np.float32) for b in config["state_bounds"]),
                         tuple(np.asarray(b, np.float32) for b in config["input_bounds"])),
                 lm_reg=float(solver["lm_reg"]), device=device)
    cfg = ctrl.cfg._replace(qp_tol=float(solver["qp_tol"]), qp_mehrotra=bool(solver["qp_mehrotra"]),
                            kernel_linearize=bool(solver["kernel_linearize"]),
                            step_tol=float(solver["step_tol"]), early_exit=False)
    backend = str(solver["backend"])
    decision = dispatch_decision(cfg, model_spec(model), T, False, backend)
    if decision.path != solver["path"]:
        raise ValueError(f"the step dispatches to {decision.path!r} ({decision.reason}), the "
                         f"configuration runs {solver['path']!r}")
    nan = lambda *shape: torch.full(shape, float("nan"), device=device)  # noqa: E731
    return System(
        fam=fam, model=model, cfg=cfg, consts=ctrl.consts,
        gp=gp_model_from_numpy(gp_arrays, device), env_p=env_p, B=B, T=T, nx=nx, nu=nu,
        tile=int(solver["tile"]), backend=backend,
        params=torch.zeros(B, len(config["plant"]["params"]), dtype=torch.float32,
                           device=device),
        fails=torch.zeros((), dtype=torch.int64, device=device),
        boxes=(nan(B, T + 1, nx), nan(B, T + 1, nx), nan(B, T, nu), nan(B, T, nu)),
        path=decision.path)


@contextlib.contextmanager
def boxes_probe(dst: tuple):
    """While open, the tightened boxes the program forms are also copied
    into `dst` (lx, ux, lu, uu), on the step's stream, as the step runs (and
    so into a graph that captures it). Boxes of fewer scenarios than `dst`
    holds fill its first rows; the rest keep what they held (NaN, unless a
    step wrote them)."""
    from gpmpc_tpu_torch.control import gpmpc

    real = gpmpc._bounds_from_tightening

    def probe(*args, **kw):
        out = real(*args, **kw)
        for d, t in zip(dst, out[1]):
            d[: t.shape[0]].copy_(t)
        return out

    gpmpc._bounds_from_tightening = probe
    try:
        yield
    finally:
        gpmpc._bounds_from_tightening = real


def step_fn(s: System):
    """One closed-loop step of every scenario: (plant state, controller
    state, observations) -> (plant state, controller state, observations,
    actions). The program's functions are looked up at each call."""
    from gpmpc_tpu_torch.parallel import batch

    def step(env_state, ctrl_state, obs):
        with boxes_probe(s.boxes):
            u, ctrl_state, _ = batch.batched_gpmpc_step(s.model, s.cfg, s.consts, s.gp,
                                                        ctrl_state, obs, backend=s.backend,
                                                        lanes=s.tile)
        env_state, obs = s.fam.plant_step(s.env_p, s.params, env_state, u)
        s.fails.add_((~torch.isfinite(u.sum(-1) + obs.sum(-1))).sum())
        return env_state, ctrl_state, obs, u

    return step


def initial_carry(s: System, x0: torch.Tensor) -> tuple:
    """(plant state, controller state, observations) at an episode's start
    from the initial states x0 (B, nx)."""
    from gpmpc_tpu_torch.control import mpc

    return (s.fam.initial_plant(s.env_p, x0), mpc.init_state(x0.shape[0], s.T, s.nx, s.nu,
                                                             device=x0.device), x0.clone())

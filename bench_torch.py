"""Headline benchmark of the PyTorch/CUDA port: GP-MPC solves/s on one card.

The counterpart of `bench.py`: the full per-step GP-MPC pipeline
(chance-constraint covariance propagation, then the residual-GP-augmented SQP
with interior-point QPs) for a batch of scenarios in closed loop with the
plant on the card, and the aggregate solves/s. The defaults are bench.py's:
the quadrotor at T=25, B=1024, 3 GPs with 40 FITC inducing points, 6 SQP and
10 Mehrotra IP iterations, the IP exit at gap 1e-6 and in-kernel
linearization (`parallel/batch.py::batched_gpmpc_step(backend="lanes")`:
kernels 1-4 of `gpmpc_tpu_torch/csrc/`). vs_baseline divides by the north-star
target of 1e4 solves/s, as bench.py's does.

    python3 bench_torch.py

reads bench.py's knobs from the environment with bench.py's defaults and
meanings: BENCH_MODEL (quadrotor|cartpole|twolink), BENCH_HORIZON,
BENCH_GP_POINTS, BENCH_GP_INDUCING, BENCH_GP_DATA, BENCH_REAL_GP,
BENCH_REAL_GP_STEPS, BENCH_BATCH, BENCH_STEPS, BENCH_BACKEND (lanes|xla),
BENCH_QP_TOL (0 turns the IP exit off), BENCH_KERNEL_LIN, BENCH_MEHROTRA,
BENCH_PSCAN, BENCH_WARM_SHIFT, BENCH_ANALYTIC_JAC, BENCH_VAR_BACKEND
(auto|pallas|xla), BENCH_VAR_BF16, BENCH_PROV_STEPS and BENCH_BUDGET_S. One
knob of its own: BENCH_DEVICE (unset: the card, `cuda:0`, and
`NoCudaDeviceError` without one; `cpu` runs the plain versions, as the tests
do). BENCH_FUSED is not mirrored and raises: bench.py's fused window is one
`lax.scan` program, and in eager PyTorch a window of steps is the same host
loop whether or not it sits in one function.

At bench.py's GP defaults (128 points, 40 inducing, 128 data) the GP is the
one the JAX package trains there, read from its exported fixture
(`convert.load_bench_gp`), so both packages step the same GP; at other sizes
it is the port's own fit (`utils/benchkit.py`), not JAX's. The initial states
are drawn from a torch.Generator seeded 0 (JAX's PRNGKey(0) draw cannot be
reproduced). Progress lines go to stderr; stdout gets a provisional JSON line
after BENCH_PROV_STEPS steps, then, unless the run is over BENCH_BUDGET_S
seconds by then (counted from the start of `main`), the final line over
BENCH_STEPS steps: {"metric", "value", "unit", "vs_baseline", "device"}, the
metric `gpmpc_torch_solves_per_sec_1gpu` (`_cpu` on the CPU), with
`_{family}` appended for the cartpole and the two-link arm. Each window is
timed by the host clock around its chained steps, closed by one
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

sys.path.insert(0, str(Path(__file__).resolve().parent))

NORTH_STAR = 1.0e4  # solves/s, BASELINE.json north_star
FAMILIES = ("quadrotor", "cartpole", "twolink")
BACKENDS = ("lanes", "xla")
# bench.py's GP defaults, at which the JAX package's GP is read from its fixture
FIXTURE_GP = dict(gp_points=128, gp_inducing=40, gp_data=128)


class Problem(NamedTuple):
    """One family's plant, model, controller and GP (`build_problem`)."""

    family: str
    env_mod: object  # gpmpc_tpu_torch.envs.{drone, cartpole_env, twolink_env}
    env_p: object  # the plant's EnvParams
    model: object
    ctrl: object  # control/gpmpc.py::GPMPC
    gp: object  # control/gpmpc.py::GpModel


class BenchRun(NamedTuple):
    """What `main` measured: its JSON records (the provisional one first),
    and the last timed step's inputs and actions (controller states and
    observations before it, u after), with the step's settings."""

    records: list
    states: object  # control/mpc.py::MpcState before the last step
    obs: object  # (B, nx) the observations the last step solved
    u: object  # (B, nu) its actions
    problem: Problem
    cfg: object  # ops/sqp.py::SqpConfig
    gp: object
    backend: str
    var_backend: str
    var_bf16: bool


def build_problem(family: str, horizon: int, gp_points: int, gp_inducing: int, gp_data: int,
                  device) -> Problem:
    """bench.py:94-158 for `family`: the plant at its default parameters, the
    family's model and `GPMPC` (its weights, prob 0.95, boxes and `lm_reg`,
    6 SQP and 10 IP iterations, seed 1), and its GP: the JAX package's
    fixture at bench.py's GP defaults, else the port's own synthetic fit at
    these sizes (n_train=50)."""
    from gpmpc_tpu_torch import convert
    from gpmpc_tpu_torch.control.gpmpc import GPMPC
    from gpmpc_tpu_torch.device import resolve
    from gpmpc_tpu_torch.utils import benchkit

    device = resolve(device)
    kw = dict(sparse_gp=True, prob=0.95, max_gp_samples=gp_inducing, seed=1,
              max_gp_points=gp_points, sqp_iters=6, qp_iters=10, device=device)
    if family == "twolink":
        from gpmpc_tpu_torch.envs import twolink_env as env_mod
        from gpmpc_tpu_torch.models import twolink

        model = twolink.symbolic_twolink(dt=0.02)
        prior, q, r, synthetic = None, [20.0, 20.0, 0.5, 0.5], [0.1, 0.1], \
            benchkit.synthetic_twolink_gp_model
        kw.update(lm_reg=0.5, bounds=(twolink.state_bounds(), twolink.input_bounds()))
    elif family == "cartpole":
        from gpmpc_tpu_torch.envs import cartpole_env as env_mod
        from gpmpc_tpu_torch.models import cartpole

        model = cartpole.symbolic_cartpole(dt=0.02)
        prior, q, r, synthetic = None, [5.0, 0.1, 20.0, 0.5], [0.05], \
            benchkit.synthetic_cartpole_gp_model
        kw.update(bounds=(cartpole.state_bounds(), cartpole.input_bounds()))
    elif family == "quadrotor":
        from gpmpc_tpu_torch.envs import drone as env_mod
        from gpmpc_tpu_torch.models.symbolic import symbolic_attitude

        prior = benchkit.reference_prior_dict()
        model = symbolic_attitude(dt=0.02, params=prior)
        q, r, synthetic = benchkit.Q_MPC, benchkit.R_MPC, benchkit.synthetic_gp_model
    else:
        raise ValueError(f"BENCH_MODEL must be one of {FAMILIES}, got {family!r}")
    env_p = env_mod.EnvParams.default()
    traj = env_mod.make_trajectory(env_p, "cpu").numpy()
    ctrl = GPMPC(model, traj, prior, horizon=horizon, q_mpc=q, r_mpc=r, **kw)
    if (gp_points, gp_inducing, gp_data) == tuple(FIXTURE_GP.values()):
        gp = convert.load_bench_gp(device, family)
    else:
        gp = synthetic(max_points=gp_points, max_inducing=gp_inducing,
                       n_data=min(gp_data, gp_points), n_train=50, device=device)
    return Problem(family, env_mod, env_p, model, ctrl, gp)


def configure(cfg, env):
    """bench.py:215-240: the controller's SqpConfig after the knobs in `env`
    (BENCH_QP_TOL, BENCH_KERNEL_LIN, BENCH_MEHROTRA, BENCH_PSCAN,
    BENCH_WARM_SHIFT, BENCH_ANALYTIC_JAC), with bench.py's defaults."""
    qp_tol = env.get("BENCH_QP_TOL", "1e-6")
    if qp_tol and float(qp_tol) > 0:
        cfg = cfg._replace(qp_tol=float(qp_tol))
    flags = (("BENCH_KERNEL_LIN", "1", "kernel_linearize"), ("BENCH_MEHROTRA", "1", "qp_mehrotra"),
             ("BENCH_PSCAN", "0", "parallel_scan"), ("BENCH_WARM_SHIFT", "0", "warm_shift"),
             ("BENCH_ANALYTIC_JAC", "0", "analytic_jac"))
    for knob, default, field in flags:
        if env.get(knob, default) == "1":
            cfg = cfg._replace(**{field: True})
    return cfg


def closed_loop_step(prob: Problem, cfg, gp, env_states, ctrl_states, obs, backend: str = "lanes",
                     var_backend: str = "auto", var_bf16: bool = False):
    """bench.py:247-255: the controller's solve for every scenario, then the
    plant's step on its actions: (env_states, ctrl_states, obs, u)."""
    from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step

    u, ctrl_states, _ = batched_gpmpc_step(prob.model, cfg, prob.ctrl.consts, gp, ctrl_states, obs,
                                           backend=backend, var_backend=var_backend,
                                           var_bf16=var_bf16)
    env_states, obs, *_ = prob.env_mod.env_step(prob.env_p, env_states, u)
    return env_states, ctrl_states, obs, u


def gp_to(gp, device):
    """A GpModel with every leaf on `device`."""
    return type(gp)(*[type(v)(*[h.to(device) for h in v]) if isinstance(v, tuple) else v.to(device)
                      for v in gp])


def real_gp(family: str, sizes: dict, n_collect: int, device, progress):
    """bench.py:168-191: the prior controller's rollout of `n_collect` steps
    on a second problem built on the CPU (its plant reset from a generator
    seeded 7), its transitions preprocessed and the GPs trained there
    (lr 0.05, 100 iterations), then moved to `device` once. Returns (gp,
    transitions)."""
    import numpy as np
    import torch

    cpu = torch.device("cpu")
    prob = build_problem(family, device=cpu, **sizes)
    st, ob = prob.env_mod.env_reset(prob.env_p, 1, torch.Generator(device=cpu).manual_seed(7), cpu)
    X, U = [ob[0].numpy()], []
    for _ in range(n_collect):
        u = prob.ctrl.prior_ctrl.select_action(ob[0].numpy())
        st, ob, *_ = prob.env_mod.env_step(prob.env_p, st, torch.as_tensor(u).reshape(1, -1))
        X.append(ob[0].numpy())
        U.append(u)
    xi, ti = prob.ctrl.preprocess_data(np.asarray(X[:-1]), np.asarray(U), np.asarray(X[1:]))
    prob.ctrl.train_gp(xi, ti, lr=0.05, iterations=100)
    progress(f"BENCH_REAL_GP: trained on {len(U)} real transitions")
    return gp_to(prob.ctrl.gp_model, device), len(U)


def main(env=os.environ) -> BenchRun:
    """Runs the benchmark with the knobs in `env`; prints the JSON lines and
    returns them with the last step's inputs and actions."""
    t_start = time.perf_counter()

    def progress(msg: str):
        print(f"[bench +{time.perf_counter() - t_start:7.1f}s] {msg}", file=sys.stderr, flush=True)

    if env.get("BENCH_FUSED", "0") == "1":
        raise ValueError("BENCH_FUSED=1 is not mirrored by bench_torch.py: in eager PyTorch a "
                         "window of steps is the same host loop inside one function or not "
                         "(bench.py's fused window is one lax.scan program); unset it")
    backend = env.get("BENCH_BACKEND", "lanes")
    if backend not in BACKENDS:
        raise ValueError(f"BENCH_BACKEND must be one of {BACKENDS}, got {backend!r}")
    progress("importing torch")
    import torch

    from gpmpc_tpu_torch.control import mpc as mpc_mod
    from gpmpc_tpu_torch.device import resolve
    from gpmpc_tpu_torch.utils.benchkit import card_line

    device = resolve(env.get("BENCH_DEVICE") or None)
    card = card_line(device)
    progress(f"device {device}" + (f": {card}" if card else ""))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    gp_points = int(env.get("BENCH_GP_POINTS", "128"))
    sizes = dict(horizon=int(env.get("BENCH_HORIZON", "25")), gp_points=gp_points,
                 gp_inducing=int(env.get("BENCH_GP_INDUCING", "40")),
                 gp_data=int(env.get("BENCH_GP_DATA", str(min(gp_points, 5000)))))
    family = env.get("BENCH_MODEL", "quadrotor")
    prob = build_problem(family, device=device, **sizes)
    gp = prob.gp
    if env.get("BENCH_REAL_GP", "0") == "1":
        progress("BENCH_REAL_GP=1: prior rollout + GP training on the host CPU")
        gp, _ = real_gp(family, sizes, int(env.get("BENCH_REAL_GP_STEPS", "120")), device,
                        progress)
    B = int(env.get("BENCH_BATCH", "1024"))
    n_timed_steps = int(env.get("BENCH_STEPS", str(max(60, (60 * 1024) // max(B, 1)))))
    cfg = configure(prob.ctrl.cfg, env)
    var_backend = env.get("BENCH_VAR_BACKEND", "auto")
    var_bf16 = env.get("BENCH_VAR_BF16", "0") == "1"
    T, nx, nu = sizes["horizon"], prob.model.nx, prob.model.nu

    progress("building initial state")
    env_states, obs = prob.env_mod.env_reset(prob.env_p, B,
                                             torch.Generator(device=device).manual_seed(0), device)
    ctrl_states = mpc_mod.init_state(B, T, nx, nu, device=device)
    last = None

    def step():
        nonlocal env_states, ctrl_states, obs, last
        last = (ctrl_states, obs)
        env_states, ctrl_states, obs, u = closed_loop_step(prob, cfg, gp, env_states, ctrl_states,
                                                           obs, backend, var_backend, var_bf16)
        return u

    # two warm-up steps, past the cold start into the warm-started regime
    progress("first step (the kernel library's build or load shows here)")
    step()
    sync()
    progress("first step done; second warmup step")
    u = step()
    sync()
    progress("warmup done; provisional window starts")

    metric = ("gpmpc_torch_solves_per_sec_" + ("1gpu" if device.type == "cuda" else device.type)
              + ("" if family == "quadrotor" else f"_{family}"))
    records = []

    def emit(sps, provisional=False):
        payload = {"metric": metric, "value": round(sps, 2), "unit": "solves/s",
                   "vs_baseline": round(sps / NORTH_STAR, 4),
                   "device": card if card is not None else str(device)}
        if provisional:
            payload["provisional"] = True
        records.append(payload)
        print(json.dumps(payload), flush=True)
        if provisional:
            progress("provisional JSON emitted (superseded by the final line if it lands)")

    def window(n):
        nonlocal u
        t0 = time.perf_counter()
        for _ in range(n):
            u = step()
        sync()
        return time.perf_counter() - t0

    def result():
        return BenchRun(records, last[0], last[1], u, prob, cfg, gp, backend, var_backend,
                        var_bf16)

    prov_steps = int(env.get("BENCH_PROV_STEPS", "8"))
    if prov_steps > 0:
        emit(B * prov_steps / window(prov_steps), provisional=True)

    budget_s = float(env.get("BENCH_BUDGET_S", "480"))
    if time.perf_counter() - t_start > budget_s:
        progress(f"over budget ({budget_s:.0f}s); keeping provisional result")
        return result()
    progress("timing window starts")
    dt_total = window(n_timed_steps)
    progress(f"timing window done ({dt_total:.3f}s); printing result")
    emit(B * n_timed_steps / dt_total)
    return result()


if __name__ == "__main__":
    main()

"""Time the port's plain-torch `xla` path on the card: one JSON line per
configuration.

    python3 scripts/bench_xla_step_torch.py [--long]

Quadrotor at bench.py's controller configuration (6 SQP and 10 Mehrotra IP
iterations, the committed GP with 40 FITC points, prob 0.95), the plant on
the card: the GP-MPC step through `batched_gpmpc_step(backend="xla")` and
the nominal MPC (`control/mpc.py::select_action`) at T=25, B=1024, and the
GP-MPC step at T=100, B=256 with soft bounds; with `--long` also one step at
T=800, B=256 with soft bounds. Each line has every
step's synchronized wall ms and their median, the SQP iterations, and the
card's name and power limit. Then one T=25 step under torch.profiler (host
and card): its launches, the card's busy ms and the top rows of each side.
Needs one CUDA card; imports no JAX."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpmpc_tpu_torch import convert  # noqa: E402
from gpmpc_tpu_torch.control import gpmpc as gpmpc_mod  # noqa: E402
from gpmpc_tpu_torch.control import mpc as mpc_mod  # noqa: E402
from gpmpc_tpu_torch.envs import drone  # noqa: E402
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS  # noqa: E402
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude  # noqa: E402
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step  # noqa: E402

Q_MPC = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
R_MPC = [3, 3, 3, 0.1]


def setup(dev, T: int, B: int, soft):
    env_p = drone.EnvParams.default()
    model = symbolic_attitude(dt=0.02, params=PRIOR_PARAMS._asdict())
    ctrl = gpmpc_mod.GPMPC(model, drone.make_trajectory(env_p, dev).cpu().numpy(),
                           PRIOR_PARAMS._asdict(), horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC, prob=0.95,
                           sqp_iters=6, qp_iters=10, device=dev, soft_constraints=soft)
    cfg = ctrl.cfg._replace(qp_mehrotra=True)
    es, obs = drone.env_reset(env_p, B, torch.Generator(device=dev).manual_seed(1), dev)
    st = mpc_mod.init_state(B, T, device=dev)
    return env_p, model, ctrl, cfg, convert.load_bench_gp(dev), es, obs, st


def run(dev, smi: str, T: int, B: int, soft, steps: int, nominal: bool = False) -> None:
    env_p, model, ctrl, cfg, gp, es, obs, st = setup(dev, T, B, soft)
    ms, iters = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # past the lanes caps: the dispatch warning
            if nominal:
                u, st, info = mpc_mod.select_action(model, cfg, ctrl.consts.mpc, st, obs)
            else:
                u, st, info = batched_gpmpc_step(model, cfg, ctrl.consts, gp, st, obs,
                                                 backend="xla")
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        iters.append(float(info.n_iters.float().mean()))
        if not bool(torch.isfinite(u).all()):
            raise RuntimeError(f"T={T}: non-finite actions")
        es, obs, *_ = drone.env_step(env_p, es, u)
    print(json.dumps({"path": "nominal" if nominal else "xla", "T": T, "B": B, "soft": soft,
                      "step_ms": ms, "median_ms": statistics.median(ms),
                      "sqp_iters_mean": iters, "card": smi}), flush=True)


def profile_step(dev, smi: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    env_p, model, ctrl, cfg, gp, es, obs, st = setup(dev, 25, 1024, None)
    u, st, _ = batched_gpmpc_step(model, cfg, ctrl.consts, gp, st, obs, backend="xla")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batched_gpmpc_step(model, cfg, ctrl.consts, gp, st, obs, backend="xla")
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    card = [e for e in events if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    print(json.dumps({
        "profiled": "xla T=25 B=1024", "wall_ms": wall, "launches": sum(e.count for e in card),
        "busy_ms": sum(e.device_time_total for e in card) / 1e3,
        "card_top": [[e.key[:60], e.device_time_total / 1e3, e.count]
                     for e in sorted(card, key=lambda e: -e.device_time_total)[:8]],
        "host_top": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in host],
        "card": smi}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_xla_step_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    run(dev, smi, 25, 1024, None, 4)
    run(dev, smi, 25, 1024, None, 3, nominal=True)
    run(dev, smi, 100, 256, 50.0, 2)
    if "--long" in sys.argv[1:]:
        run(dev, smi, 800, 256, 50.0, 1)
    profile_step(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

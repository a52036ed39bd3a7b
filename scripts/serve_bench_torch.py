"""Serving throughput of the PyTorch port's micro-batching control server
(`gpmpc_tpu_torch/runtime/server.py::ControlServer`), beside
`scripts/serve_bench.py`, which measures the JAX package's.

C client threads, each its own control session, replay observation streams
recorded from one batched closed-loop episode (`batched_episode` on the
serving backend; at most 64 streams, later clients replay one modulo) and
the served actions/s are measured end to end through the dispatcher.

The controller is the reference script's (quadrotor, T = 25, 40 FITC points,
6 SQP and 10 IP iterations) at bench.py's step settings (`bench.py:213-225`:
kernel linearization, Mehrotra, the IP exit at gap 1e-6), so that the
`lanes` backend serves through the lanes-fused path, kernels 1-4. The
reference's script keeps `SqpConfig`'s defaults, which take the `lanes`
path with forward-mode linearization in plain torch (about 15x slower a
dispatch on the card).

Prints one JSON line under the metric name `served_actions_per_sec_torch`,
with the controller's settings (`controller`: horizon, SQP and IP
iterations, the IP tolerance, kernel linearization, Mehrotra), the mean
batch size, the request latencies and, on the card, its name and power
limit (nvidia-smi). The settings are in the line because the number is
not comparable with `served_actions_per_sec`, which serves another solver.

Usage:
  python scripts/serve_bench_torch.py [--clients 64] [--steps 50] [--tile 128]
      [--backend lanes|xla] [--max-wait-ms 2] [--pipeline 2]
      [--actions-per-step 1] [--device cuda:0|cpu]

The counted actions are those the clients consume: min(steps, requests x N)
per client (a last N-step reply may carry actions past the episode).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))
HORIZON = 25


def card_line(device) -> str | None:
    """nvidia-smi's name and power limit of the card, None on the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="default: the card (cuda:0)")
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--tile", type=int, default=128)
    p.add_argument("--backend", default="lanes")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--pipeline", type=int, default=2, help="in-flight batch depth")
    p.add_argument(
        "--actions-per-step", type=int, default=1,
        help="N-step replies: each request returns the first N actions of the plan and the "
        "client comes back after N plant steps",
    )
    args = p.parse_args()
    if args.clients > args.tile:
        p.error(f"--clients {args.clients} > --tile {args.tile}: sessions are tile slots")
    import numpy as np
    import torch

    from gpmpc_tpu_torch.control.gpmpc import GPMPC
    from gpmpc_tpu_torch.device import resolve
    from gpmpc_tpu_torch.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
    from gpmpc_tpu_torch.parallel.batch import batched_episode
    from gpmpc_tpu_torch.runtime.server import ControlServer
    from gpmpc_tpu_torch.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict, replay_sessions

    dev = resolve(args.device)
    prior = reference_prior_dict()
    env = DroneFigureEightEnv(device=dev)
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(
        model, env.trajectory.cpu().numpy(), prior, horizon=HORIZON, q_mpc=Q_MPC, r_mpc=R_MPC,
        sparse_gp=True, max_gp_samples=40, seed=1, sqp_iters=6, qp_iters=10, device=dev,
    )
    rng = np.random.default_rng(0)
    ctrl.train_gp(
        rng.normal(0, 0.3, (40, 7)).astype(np.float32),
        rng.normal(0, 0.3, (40, 3)).astype(np.float32),
        lr=0.05, iterations=50,
    )
    cfg = ctrl.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
    n_streams = min(args.clients, 64)
    ep = batched_episode(model, cfg, env.p, ctrl.consts, ctrl.gp_model,
                         torch.Generator(device=dev).manual_seed(0), args.steps, n_streams,
                         backend=args.backend)
    obs_streams = ep.obs.cpu().numpy()  # (n_streams, steps + 1, 12)

    n_act = args.actions_per_step
    server = ControlServer(
        model, cfg, ctrl.consts, ctrl.gp_model, tile=args.tile, backend=args.backend,
        max_wait_ms=args.max_wait_ms, pipeline_depth=args.pipeline, actions_per_step=n_act,
    )
    try:
        run = replay_sessions(server, obs_streams, args.steps, args.clients)
    finally:
        server.close()
    lat = run["latencies_ms"]
    pct = lambda q: round(float(np.percentile(lat, q)), 3)  # noqa: E731
    out = {
        "metric": "served_actions_per_sec_torch",
        "value": round(run["actions"] / run["wall_s"], 1),
        "unit": "actions/s",
        "clients": args.clients,
        "steps": args.steps,
        "tile": args.tile,
        "backend": args.backend,
        "actions_per_step": n_act,
        "pipeline_depth": args.pipeline,
        "max_wait_ms": args.max_wait_ms,
        # the solver served: bench.py's step settings, not scripts/serve_bench.py's defaults
        "controller": {"horizon": HORIZON, "sqp_iters": cfg.sqp_iters,
                       "qp_iters": cfg.qp_iters, "qp_tol": cfg.qp_tol,
                       "kernel_linearize": cfg.kernel_linearize, "qp_mehrotra": cfg.qp_mehrotra},
        "mean_batch_size": round(run["n_requests"] / run["n_batches"], 2),
        "n_batches": run["n_batches"],
        "mean_dispatch_ms": round(1e3 * run["wall_s"] / run["n_batches"], 3),
        # each request's latency, enqueue to reply: what a control loop budgets
        "latency_p50_ms": pct(50),
        "latency_p95_ms": pct(95),
        "latency_p99_ms": pct(99),
        "device": str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev),
        "card": card_line(dev),
    }
    if n_act > 1:
        # one round trip buys N actions
        out["effective_action_latency_p50_ms"] = round(pct(50) / n_act, 3)
        out["effective_action_latency_p95_ms"] = round(pct(95) / n_act, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Scaling measurements of the PyTorch port, the counterpart of
`scripts/bench_scaling.py`:

  * config 3: 1k+ domain-randomized scenarios (every scenario its own plant
    coefficients, scale 0.1), the closed-loop GP-MPC step at T = 25;
  * config 4: a 5k-point GP (5,120 padded, 128 FITC points) at T = 50, B = 256;
  * lanes against xla at several batch sizes;
  * the weak-scaling table of the sharded step (`make_batched_controller_step`
    with a mesh, on `xla` as the reference's table) over this host's cards,
    or over `--devices cpu,cpu,...`.

Prints one JSON line per measurement with the device and, on a card, its
name and power limit. On the card:
    python scripts/bench_scaling_torch.py [--quick]
Smallest settings, on the CPU:
    python scripts/bench_scaling_torch.py --device cpu --steps 1 --batches 4 \
        --backends lanes --gp5k-batch 0 --devices cpu,cpu --per-device 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="3 timed steps and B = 1024 alone")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=None, help="timed steps (default 10, 3 quick)")
    ap.add_argument("--batches", default=None,
                    help="config 3's batch sizes (default 1024,4096; 1024 quick)")
    ap.add_argument("--backends", default="lanes,xla")
    ap.add_argument("--gp5k-batch", type=int, default=256, help="config 4's batch; 0 skips it")
    ap.add_argument("--devices", default=None,
                    help="the weak-scaling table's devices, comma-separated (default: the "
                    "cards, or the CPU)")
    ap.add_argument("--per-device", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=10, help="the weak-scaling table's horizon")
    ap.add_argument("--out", default=None, help="write the weak-scaling table here as JSON")
    return ap.parse_args(argv)


def _controller(dev, horizon, max_gp_samples, max_gp_points, sqp_iters=6, qp_iters=10):
    from gpmpc_tpu_torch.control.gpmpc import GPMPC
    from gpmpc_tpu_torch.envs import drone
    from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
    from gpmpc_tpu_torch.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict

    prior = reference_prior_dict()
    env_p = drone.EnvParams.default()
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(model, drone.make_trajectory(env_p, "cpu").numpy(), prior, horizon=horizon,
                 q_mpc=Q_MPC, r_mpc=R_MPC, sparse_gp=True, max_gp_samples=max_gp_samples, seed=1,
                 max_gp_points=max_gp_points, sqp_iters=sqp_iters, qp_iters=qp_iters, device=dev)
    return env_p, model, ctrl


def run_case(name, env_p, model, ctrl, gp, B, backend, steps, dev, card, randomized=True):
    """Closed-loop steps of B scenarios (each with its own randomized plant):
    2 warm-up steps, then `steps` timed ones; one JSON line."""
    import torch

    from gpmpc_tpu_torch.control import mpc as mpc_mod
    from gpmpc_tpu_torch.control.gpmpc import gp_is_batched, model_spec
    from gpmpc_tpu_torch.envs import drone
    from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step, dispatch_decision

    T = ctrl.consts.mpc.uref.shape[0]
    path = dispatch_decision(ctrl.cfg, model_spec(model), T, gp_is_batched(gp), backend).path
    if backend == "lanes" and path == "xla":
        name = name.replace("lanes", "xla_fallback")  # label the path that runs
    gen = torch.Generator(device=dev).manual_seed(1)
    es, obs = drone.env_reset(env_p, B, gen, dev)
    plant = (drone.randomize_params(gen, env_p.params, 0.1, B) if randomized
             else drone.params_to_array(env_p.params, dev))
    st = mpc_mod.init_state(B, T, 12, 4, device=dev)

    def step(es, st, obs):
        u, st, _ = batched_gpmpc_step(model, ctrl.cfg, ctrl.consts, gp, st, obs, backend=backend)
        es, obs, *_ = drone.env_step_dynamic(env_p, plant, es, u)
        return es, st, obs, u

    for _ in range(2):
        es, st, obs, u = step(es, st, obs)
    u.cpu()
    t0 = time.perf_counter()
    for _ in range(steps):
        es, st, obs, u = step(es, st, obs)
    finite = bool(torch.isfinite(u).all())  # a host read: the barrier
    dt = time.perf_counter() - t0
    sps = B * steps / dt
    print(json.dumps({"metric": f"torch_solves_per_sec[{name}]", "value": round(sps, 1),
                      "unit": "solves/s", "vs_baseline": round(sps / 1e4, 4), "path": path,
                      "plant": "randomized, scale 0.1" if randomized else "nominal",
                      "ms_per_step": round(1e3 * dt / steps, 3), "finite": finite,
                      "device": str(dev), "card": card}), flush=True)
    if not finite:
        raise RuntimeError(f"{name}: non-finite actions")
    return sps


def weak_scaling(args, card):
    """The sharded closed-loop step at a fixed batch per device on the first
    1, 2, 4, ... of the devices; the efficiency against one device."""
    import torch

    from gpmpc_tpu_torch.control import mpc as mpc_mod
    from gpmpc_tpu_torch.envs import drone
    from gpmpc_tpu_torch.parallel.batch import make_batched_controller_step
    from gpmpc_tpu_torch.parallel.mesh import Sharded, gather, make_mesh, shard_leading_axis
    from gpmpc_tpu_torch.utils.benchkit import synthetic_gp_model

    if args.devices:
        devices = [torch.device(d) for d in args.devices.split(",")]
    elif args.device == "cpu":
        devices = [torch.device("cpu")]
    else:
        devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    home = devices[0]
    env_p, model, ctrl = _controller(home, args.horizon, 16, 32, sqp_iters=3, qp_iters=5)
    gp = synthetic_gp_model(max_points=32, max_inducing=16, n_data=24, n_train=10, device=home)
    steps = args.steps if args.steps is not None else 3
    counts = [n for n in (1, 2, 4, 8, 16) if n <= len(devices)]
    rows = []
    for n in counts:
        mesh = make_mesh(n, devices=devices[:n])
        step = make_batched_controller_step(model, ctrl.cfg, mesh=mesh)
        B = n * args.per_device
        gen = torch.Generator(device=home).manual_seed(0)
        es0, obs0 = drone.env_reset(env_p, B, gen, home)
        es, st, obs = (shard_leading_axis(t, mesh) for t in
                       (es0, mpc_mod.init_state(B, args.horizon, 12, 4, device=home), obs0))

        def closed_loop(es, st, obs):
            u, st, _ = step(ctrl.consts, gp, st, obs, backend="xla")
            nxt = [drone.env_step(env_p, e, a)[:2] for e, a in zip(es.shards, u.shards)]
            part = lambda i: Sharded([x[i] for x in nxt], u.index, u.count, u.devices)  # noqa: E731
            return part(0), st, part(1), u

        es, st, obs, u = closed_loop(es, st, obs)
        gather(u, mesh).cpu()
        t0 = time.perf_counter()
        for _ in range(steps):
            es, st, obs, u = closed_loop(es, st, obs)
        gather(u, mesh).cpu()  # a host read of every shard: the barrier
        dt = time.perf_counter() - t0
        row = {"metric": f"torch_mesh_{n}dev", "value": round(B * steps / dt, 1), "unit": "solves/s",
               "n_devices": n, "batch": B, "devices": [str(d) for d in devices[:n]],
               "backend": "xla", "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    base = rows[0]["value"] / rows[0]["n_devices"]
    table = {"metric": "torch_mesh_weak_scaling", "per_device_batch": args.per_device, "rows": rows,
             "efficiency": {str(r["n_devices"]): round(r["value"] / r["n_devices"] / base, 3)
                            for r in rows}}
    if args.out:
        Path(args.out).write_text(json.dumps(table, indent=2))
    print(json.dumps({"metric": table["metric"], "efficiency": table["efficiency"], "card": card}),
          flush=True)
    return table


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from gpmpc_tpu_torch.utils.benchkit import card_line, synthetic_gp_model

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False; pass --device cpu")
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    card = card_line(dev)
    steps = args.steps if args.steps is not None else (3 if args.quick else 10)
    batches = ([int(b) for b in args.batches.split(",")] if args.batches
               else [1024] if args.quick else [1024, 4096])

    # config 3: the default problem over 1k+ domain-randomized scenarios
    env_p, model, ctrl = _controller(dev, 25, 40, 128)
    gp = synthetic_gp_model(max_points=128, max_inducing=40, n_data=60, n_train=20, device=dev)
    for backend in args.backends.split(","):
        for B in batches:
            run_case(f"T25_gp128_{backend}_B{B}", env_p, model, ctrl, gp, B, backend, steps, dev,
                     card)

    # config 4: a 5k-point GP (padded to 5,120) at twice the horizon
    if args.gp5k_batch:
        env_p, model, ctrl50 = _controller(dev, 50, 128, 5120)
        gp_big = synthetic_gp_model(max_points=5120, max_inducing=128, n_data=5000, n_train=20,
                                    device=dev)
        run_case(f"T50_gp5k_lanes_B{args.gp5k_batch}", env_p, model, ctrl50, gp_big,
                 args.gp5k_batch, "lanes", steps, dev, card)

    weak_scaling(args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

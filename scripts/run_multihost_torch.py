"""Multi-process scale-out driver of the PyTorch port: a scenario batch sharded
over every process's device, closed-loop GP-MPC steps on each shard, the
tracking error reduced across processes. The port's counterpart of
`scripts/run_multihost.py`, on `torch.distributed`.

Run modes:
  * one process per card on one host (torchrun sets the environment):
        torchrun --nproc-per-node 4 scripts/run_multihost_torch.py --distributed
  * one process over this host's cards (or `--device cpu`):
        python scripts/run_multihost_torch.py
  * N local processes standing in for N hosts (a coordinator on 127.0.0.1):
        python scripts/run_multihost_torch.py --virtual-hosts 2 --device cuda \
            --collectives gloo --scenarios 1024 --steps 5 --parity
    On one card two ranks need `--collectives gloo` (NCCL refuses two ranks
    on one card); gloo's collectives then go through the host. On the CPU:
        python scripts/run_multihost_torch.py --virtual-hosts 2 --device cpu \
            --scenarios 8 --steps 1 --horizon 5 --parity

`--parity` recomputes the run unsharded in every process and compares the
gathered actions and the reduced tracking error (both within 1e-4). With
`--sweep N_SEEDS` the processes run a learning sweep with the seed axis
sharded instead (`parallel/sweep.py::seed_sweep(mesh=)`): every rank prints
the whole cost matrix (`SWEEP-COSTS pid=...`), and `--parity` compares it
with an unsharded one (1e-3 relative). Rank 0
prints one JSON line, `torch_solves_per_sec[multihost_{P}proc_{D}dev_B{B}_
{backend}]` (`_fused` appended with `--fused`) or `torch_sweep[...]`, with the
collectives' backend and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--backend", default="lanes", choices=["lanes", "xla"])
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--gp-points", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="each process's device: its card (cuda:{LOCAL_RANK %% cards}) or the CPU")
    ap.add_argument("--collectives", default=None, choices=["nccl", "gloo"],
                    help="the process group's backend (default: nccl on cards, gloo on the CPU)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun describes in the environment")
    ap.add_argument("--virtual-hosts", type=int, default=0,
                    help="spawn N local processes as hosts around a coordinator on 127.0.0.1")
    ap.add_argument("--parity", action="store_true",
                    help="recompute unsharded in every process and compare")
    ap.add_argument("--idle", action="store_true",
                    help="profile one more window of --steps on the card: each rank's kernel "
                    "time, summed over the ranks, and the card's idle share")
    ap.add_argument("--fused", action="store_true",
                    help="the step at bench.py's settings (in-kernel linearization, Mehrotra, "
                    "IP exit at gap 1e-6: the lanes-fused path) in place of the controller's "
                    "defaults (forward-mode linearization on lanes)")
    ap.add_argument("--sweep", type=int, default=0, metavar="N_SEEDS",
                    help="run an N_SEEDS learning sweep with the seed axis sharded instead")
    ap.add_argument("--worker-timeout", type=float, default=600.0,
                    help="the shared deadline of the --virtual-hosts workers; keep it below any "
                    "outer timeout, so that a hung worker is reaped here with its siblings")
    # worker plumbing, set by the --virtual-hosts orchestrator
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def orchestrate_virtual_hosts(args) -> int:
    """Spawn N copies of this script as local hosts sharing one coordinator;
    one shared deadline, and on the first failure or timeout every sibling
    is killed, so that no worker outlives the orchestrator in a collective.
    Workers write to temporary files (a full pipe would block a worker
    while another waits in a collective)."""
    import socket
    import tempfile

    n = args.virtual_hosts
    # the probe socket stays bound until just before the spawn (no window for
    # another process to take the port); the store binds with SO_REUSEADDR
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    base = [
        sys.executable, os.path.abspath(__file__),
        "--scenarios", str(args.scenarios), "--steps", str(args.steps),
        "--backend", args.backend, "--horizon", str(args.horizon),
        "--gp-points", str(args.gp_points), "--device", args.device,
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
        "--sweep", str(args.sweep),
    ]
    if args.collectives:
        base += ["--collectives", args.collectives]
    for flag in ("parity", "idle", "fused"):
        if getattr(args, flag):
            base.append(f"--{flag}")
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
    logs = [tempfile.TemporaryFile(mode="w+", prefix=f"vhost{i}_") for i in range(n)]
    s.close()
    procs = [subprocess.Popen(base + ["--process-id", str(i)], stdout=logs[i],
                              stderr=subprocess.STDOUT, text=True, env=env) for i in range(n)]
    deadline = time.monotonic() + args.worker_timeout
    rc = 0
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = rc or 1
        if rc == 0 and p.returncode not in (0, None):
            rc = p.returncode or 1
        if rc != 0:
            break
    if rc != 0:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode != 0:
            rc = rc or p.returncode or 1
    for i, f in enumerate(logs):
        f.seek(0)
        # process 0 carries the metric line; every host's output is echoed with a prefix
        for line in f.read().splitlines():
            print(line if i == 0 and not line.startswith("[") else f"[host{i}] {line}")
        f.close()
    return rc


def _setup(args, dev, max_gp_samples, max_gp_points, sqp_iters, qp_iters):
    from gpmpc_tpu_torch.control.gpmpc import GPMPC
    from gpmpc_tpu_torch.envs import drone
    from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
    from gpmpc_tpu_torch.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict

    prior = reference_prior_dict()
    env_p = drone.EnvParams.default()
    traj = drone.make_trajectory(env_p, "cpu").numpy()
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(model, traj, prior, horizon=args.horizon, q_mpc=Q_MPC, r_mpc=R_MPC,
                 sparse_gp=True, max_gp_samples=max_gp_samples, seed=1,
                 max_gp_points=max_gp_points, sqp_iters=sqp_iters, qp_iters=qp_iters, device=dev)
    return env_p, model, ctrl


def sweep_problem(args, dev):
    """The sweep of `--sweep` at the reference script's sizes (T from
    `--horizon`, 3 SQP / 6 IP, 2 epochs, 20 GP iterations): the model, the
    controller's config, the plant, the consts and `seed_sweep`'s keyword
    arguments. A caller that recomputes the sweep unsharded elsewhere takes
    them from here."""
    from gpmpc_tpu_torch.envs import drone

    n_steps = max(args.steps, 20)
    env_p, model, ctrl = _setup(args, dev, 10, 64, 3, 6)
    kw = dict(n_seeds=args.sweep, n_epochs=2, n_steps=n_steps,
              samples_per_epoch=min(16, n_steps), max_inducing=10, sparse=True, gp_iters=20,
              master_seed=0, env_mod=drone, backend=args.backend)
    return model, ctrl.cfg, env_p, ctrl.consts, kw


def run_sweep(args, mesh, dev, card, stage):
    """The seed sweep with the seed axis sharded over the processes' mesh;
    every rank prints the whole cost matrix (`SWEEP-COSTS`), and `--parity`
    recomputes it unsharded in every process and compares."""
    import torch

    from gpmpc_tpu_torch.parallel.sweep import seed_sweep

    S = args.sweep
    model, cfg, env_p, consts, kw = sweep_problem(args, dev)
    t0 = time.perf_counter()
    costs = seed_sweep(model, cfg, env_p, consts, mesh=mesh, **kw).costs.cpu()
    dt = time.perf_counter() - t0
    stage("the sharded sweep")
    print(f"SWEEP-COSTS pid={mesh.rank} {json.dumps(costs.tolist())}", flush=True)
    if args.parity:
        local = seed_sweep(model, cfg, env_p, consts, **kw).costs.cpu()
        stage("the unsharded sweep")
        dcost = float((costs - local).abs().max())
        rel = dcost / max(1e-9, float(costs.abs().max()))
        ok = rel < 1e-3
        print(f"SWEEP-PARITY pid={mesh.rank} max|dcost|={dcost:.3e} rel={rel:.3e} ok={ok}",
              flush=True)
        if not ok:
            sys.exit(3)
    if mesh.rank == 0:
        print(json.dumps({
            "metric": f"torch_sweep[multihost_{mesh.world_size}proc_{mesh.size}dev_S{S}_"
                      f"{args.backend}]",
            "seeds_improved": int(torch.sum(costs[-1] < costs[0])), "n_seeds": S,
            "wall_s": round(dt, 1),
            "mean_cost_prior": round(float(costs[0].mean()), 4),
            "mean_cost_final": round(float(costs[-1].mean()), 4),
            "collectives": mesh.backend, "device": str(dev), "card": card,
        }), flush=True)


def run_steps(args, mesh, dev, card, stage):
    """Closed-loop steps of the sharded batch; the tracking error is an
    all_reduce. Returns the metric line's dict on rank 0."""
    import torch

    from gpmpc_tpu_torch.control import mpc as mpc_mod
    from gpmpc_tpu_torch.envs import drone
    from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step, make_batched_controller_step
    from gpmpc_tpu_torch.parallel.mesh import Sharded, all_reduce, gather, shard_leading_axis
    from gpmpc_tpu_torch.utils.benchkit import synthetic_gp_model

    n_dev = mesh.size
    B = args.scenarios - (args.scenarios % n_dev) or n_dev
    gp_inducing = min(40, args.gp_points)
    env_p, model, ctrl = _setup(args, dev, gp_inducing, args.gp_points, 6, 10)
    cfg = ctrl.cfg
    if args.fused:
        cfg = cfg._replace(kernel_linearize=True, qp_mehrotra=True, qp_tol=1e-6)
    gp = synthetic_gp_model(max_points=args.gp_points, max_inducing=gp_inducing,
                            n_data=args.gp_points, n_train=20, device=dev)
    traj = drone.make_trajectory(env_p, dev)
    trajs = {d: traj.to(d) for d in {dev, *mesh.local_devices}}  # one a shard's device
    step = make_batched_controller_step(model, cfg, mesh=mesh)

    def tracking_err_sum(obs, ctrl_states):
        t = trajs[obs.device]
        ref = t[torch.remainder(ctrl_states.traj_step[0].long(), t.shape[0])]
        return torch.sqrt((obs[:, 0] - ref[0]) ** 2 + (obs[:, 2] - ref[2]) ** 2
                          + (obs[:, 4] - ref[4]) ** 2).sum()

    def closed_loop(env_states, ctrl_states, obs):
        u, ctrl_states, _ = step(ctrl.consts, gp, ctrl_states, obs, backend=args.backend)
        shards, err = [], 0.0
        for es, a, cs in zip(env_states.shards, u.shards, ctrl_states.shards):
            es, ob, *_ = drone.env_step(env_p, es, a)
            shards.append((es, ob))
            err = err + tracking_err_sum(ob, cs).to(dev)
        # the cross-process reduction of the sharded scenario axis
        err = all_reduce(torch.as_tensor(err, device=dev).reshape(1), mesh) / B
        part = lambda i: Sharded([s[i] for s in shards], u.index, u.count, u.devices)  # noqa: E731
        return part(0), ctrl_states, part(1), u, err

    # every process draws the whole batch's initial states, then keeps its shards
    gen = torch.Generator(device=dev).manual_seed(1)
    env_states0, obs0 = drone.env_reset(env_p, B, gen, dev)
    ctrl_states0 = mpc_mod.init_state(B, args.horizon, 12, 4, device=dev)
    env_states, ctrl_states, obs = (shard_leading_axis(t, mesh)
                                    for t in (env_states0, ctrl_states0, obs0))
    for _ in range(2):
        env_states, ctrl_states, obs, u, err = closed_loop(env_states, ctrl_states, obs)
    float(err)
    stage("set-up and 2 warm-up steps")
    t0 = time.perf_counter()
    for _ in range(args.steps):
        env_states, ctrl_states, obs, u, err = closed_loop(env_states, ctrl_states, obs)
    err = float(err)  # a host read after the reduction: the barrier
    dt = time.perf_counter() - t0
    sps = B * args.steps / dt
    stage(f"{args.steps} timed steps")
    idle = {}
    if args.idle and dev.type == "cuda":
        # one more window of as many steps, its card activity profiled (the
        # profiler slows the host, so the timed window above is not profiled)
        from torch.profiler import ProfilerActivity, profile

        state = (env_states, ctrl_states, obs)
        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                *state, _, e = closed_loop(*state)
            float(e)
        window_ms = 1e3 * (time.perf_counter() - t1)
        busy_ms = sum(ev.device_time_total for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        # without MPS a card runs one process's kernels at a time, so the
        # kernel times of the ranks on this rank's card add up (the ranks of
        # one host: a device name is one card)
        per_rank = torch.zeros(mesh.world_size, dtype=torch.float64, device=dev)
        per_rank[mesh.rank] = busy_ms
        per_rank = all_reduce(per_rank, mesh).tolist()
        cards = set(mesh.local_devices)
        if len(cards) > 1:  # one process over several cards: their mean idle share
            card_busy = busy_ms / len(cards)
        else:
            card_busy = sum(per_rank[int(r)] for r, d in
                            zip(mesh.ranks.ravel(), mesh.devices.ravel()) if d == dev)
        share = 1 - card_busy / window_ms
        idle = dict(window_ms=round(window_ms, 1), rank_busy_ms=round(busy_ms, 1),
                    card_busy_ms=round(card_busy, 1), idle_share=round(share, 3))
        of_card = (f"a card's mean over its {len(cards)}" if len(cards) > 1
                   else f"the kernels of the ranks on {dev}")
        print(f"IDLE pid={mesh.rank} window {window_ms:.1f} ms, this rank's kernels {busy_ms:.1f} "
              f"ms, {of_card} {card_busy:.1f} ms: idle share {share:.3f} (profiled window, "
              "slower than the timed one: an upper estimate)", flush=True)
        stage(f"{args.steps} profiled steps")
    if args.parity:
        # the same 2 + steps window unsharded in this process, against the gathered actions
        es, cs, ob = env_states0, ctrl_states0, obs0
        for _ in range(2 + args.steps):
            u_loc, cs, _ = batched_gpmpc_step(model, cfg, ctrl.consts, gp, cs, ob,
                                              backend=args.backend)
            es, ob, *_ = drone.env_step(env_p, es, u_loc)
        err_loc = float(tracking_err_sum(ob, cs)) / B
        u_glob = gather(u, mesh)
        du = float((u_glob.to(dev) - u_loc).abs().max())
        derr = abs(err - err_loc)
        ok = du < 1e-4 and derr < 1e-4
        print(f"PARITY pid={mesh.rank} max|du|={du:.3e} |derr|={derr:.3e} ok={ok}", flush=True)
        stage("the unsharded recomputation")
        if not ok:
            sys.exit(3)
    line = {
        "metric": f"torch_solves_per_sec[multihost_{mesh.world_size}proc_{n_dev}dev_B{B}_"
                  f"{args.backend}{'_fused' if args.fused else ''}]",
        "value": round(sps, 1), "unit": "solves/s", "vs_baseline": round(sps / 1e4, 4),
        "mean_tracking_err_m": round(err, 4), "collectives": mesh.backend,
        "fused": args.fused, "device": str(dev), "card": card, **idle,
    }
    print(f"RANK pid={mesh.rank} solves_per_sec={sps:.1f} (its {B // mesh.world_size} scenarios: "
          f"{sps / mesh.world_size:.1f})", flush=True)
    if mesh.rank == 0:
        print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.virtual_hosts and args.process_id is None:
        return orchestrate_virtual_hosts(args)
    t_start, t_last = time.perf_counter(), [time.perf_counter()]

    def stage(what: str) -> None:
        now = time.perf_counter()
        print(f"STAGE {what}: {now - t_last[0]:.1f} s ({now - t_start:.1f} s in this process)",
              flush=True)
        t_last[0] = now

    import torch

    from gpmpc_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown_distributed
    from gpmpc_tpu_torch.utils.benchkit import card_line

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False; pass --device cpu")
    joined = args.distributed or args.coordinator is not None
    if joined:
        st = init_distributed(args.coordinator, args.num_processes, args.process_id,
                              backend=args.collectives,
                              device="cpu" if args.device == "cpu" else None)
        dev = st.device
        mesh = make_mesh()
        print(f"[rank {st.rank}/{st.world_size}] device {dev}, collectives {st.backend}, mesh "
              f"{[str(d) for d in mesh.devices.ravel()]}", flush=True)
    else:
        dev = torch.device("cpu" if args.device == "cpu" else "cuda:0")
        mesh = make_mesh(devices=["cpu"] if args.device == "cpu" else None)
    card = card_line(dev)
    stage("torch import, process group, card")
    try:
        if args.sweep:
            run_sweep(args, mesh, dev, card, stage)
        else:
            run_steps(args, mesh, dev, card, stage)
    finally:
        if joined:
            shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The `xla` step's actions beside the `lanes-fused` step's on the same
observations: one JSON line per seed and step.

    python3 scripts/compare_xla_lanes_torch.py [--device cpu|cuda] [--seeds 1 2 3 4]

Quadrotor at bench.py's configuration (T=25, the committed GP with 40 FITC
points, prob 0.95, 6 SQP and 10 Mehrotra IP iterations), B=128 scenarios
(one lane tile) drawn from each seed's generator, five closed-loop steps
driven by the lanes-fused step with the IP exit at gap 1e-6 (bench.py's
`qp_tol`). At each step the xla step (always the fixed IP count) and the
lanes-fused step at the fixed count (`qp_tol=None`) solve the same
observations from their own warm starts. Each line has the largest
|u_xla - u_lanes| at the fixed count and against the gap-1e-6 run, with
the worst scenario's SQP iterations and convergence on both sides. On the
CPU the kernels' plain versions run; imports no JAX."""

from __future__ import annotations

import argparse
import json
import sys
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
T, B, STEPS = 25, 128, 5


def compare(dev, seed: int) -> None:
    env_p = drone.EnvParams.default()
    model = symbolic_attitude(dt=0.02, params=PRIOR_PARAMS._asdict())
    ctrl = gpmpc_mod.GPMPC(model, drone.make_trajectory(env_p, dev).cpu().numpy(),
                           PRIOR_PARAMS._asdict(), horizon=T, q_mpc=Q_MPC, r_mpc=R_MPC, prob=0.95,
                           sqp_iters=6, qp_iters=10, device=dev)
    cfg = ctrl.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
    fixed = cfg._replace(qp_tol=None)
    gp = convert.load_bench_gp(dev)
    es, obs = drone.env_reset(env_p, B, torch.Generator(device=dev).manual_seed(seed), dev)
    st_exit, st_fixed, st_xla = (mpc_mod.init_state(B, T, device=dev) for _ in range(3))
    for k in range(STEPS):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            u, st_exit, i_exit = batched_gpmpc_step(model, cfg, ctrl.consts, gp, st_exit, obs,
                                                    backend="lanes")
            u_f, st_fixed, _ = batched_gpmpc_step(model, fixed, ctrl.consts, gp, st_fixed, obs,
                                                  backend="lanes")
            u_x, st_xla, i_xla = batched_gpmpc_step(model, cfg, ctrl.consts, gp, st_xla, obs,
                                                    backend="xla")
        d_exit = (u_x - u).abs().amax(dim=1)
        w = int(d_exit.argmax())
        print(json.dumps({
            "seed": seed, "step": k, "device": str(dev),
            "max_abs_vs_fixed_count": float((u_x - u_f).abs().max()),
            "max_abs_vs_gap_exit": float(d_exit.max()),
            "worst": {"scenario": w, "lanes_sqp_iters": int(i_exit.n_iters[w]),
                      "lanes_converged": bool(i_exit.converged[w]),
                      "xla_sqp_iters": int(i_xla.n_iters[w]),
                      "xla_converged": bool(i_xla.converged[w])}}), flush=True)
        es, obs, *_ = drone.env_step(env_p, es, u)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)  # small ops: intra-op threads cost more than they give
    for seed in args.seeds:
        compare(torch.device(args.device), seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The headline closed-loop GP-MPC step of the PyTorch/CUDA port, taken apart
into its parts on the card; the counterpart of `scripts/bench_step_breakdown.py`.

The quadrotor problem of `bench_torch.py` at its GP defaults (the JAX
package's fixture GP), with the breakdown's own step settings: IP exit at gap
1e-7, in-kernel linearization, Mehrotra. After 3 warm-up steps it times, in
this order:

  step        the full closed-loop step (controller + plant), bench_torch.py's
  prepare     control/gpmpc.py::batched_prepare_step: GP variances (kernel 1)
              + the tightening (kernel 2) + boxes and warm starts
  sqp         ops/sqp_lanes.py::sqp_solve_batch_lanes_fused alone (kernels 3
              and 4, the early-exit loop) on the warm inputs of the loop
  lin1        ONE launch of the linearize kernel (kernel 3) on the first tile
  qp1_warm    ONE launch of the resident QP kernel (kernel 4) on the first
              tile's QP at the warm iterate (the adaptive exit active)
  qp1_cold    the same with the cost gradient qx = 1 (a cold iterate)
  env         the plant's step alone

Each segment's calls are data-chained (each call's input depends on the one
before) and closed by `torch.cuda.synchronize()`; one call runs before the
clock starts. Prints one JSON line per segment: {"segment", "ms_per_call",
"calls", "device"} (the card's name and power limit from nvidia-smi, or
"cpu").

    python3 scripts/bench_step_breakdown_torch.py

Knobs (environment): BENCH_BATCH (1024; a multiple of the 128-scenario tile),
BENCH_HORIZON (25), BENCH_CALLS (30), BENCH_DEVICE (unset: the card, and
`NoCudaDeviceError` without one; `cpu` for the plain versions).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

SEGMENTS = ("step", "prepare", "sqp", "lin1", "qp1_warm", "qp1_cold", "env")


def emit(row: dict) -> None:
    """One segment's JSON line."""
    print(json.dumps(row), flush=True)


def main(env=os.environ) -> list[dict]:
    """Prints and returns one row per segment, in `SEGMENTS` order."""
    import torch

    import bench_torch
    from gpmpc_tpu_torch.control import gpmpc as gpmpc_mod
    from gpmpc_tpu_torch.control import mpc as mpc_mod
    from gpmpc_tpu_torch.device import resolve, strict_float32
    from gpmpc_tpu_torch.ops import sqp_lanes
    from gpmpc_tpu_torch.ops.cuda_linearize import linearize_ocp_lanes
    from gpmpc_tpu_torch.ops.cuda_ocp import LanesQp, solve_ocp_qp_lanes
    from gpmpc_tpu_torch.ops.sqp import BOUND_INF, OcpCost
    from gpmpc_tpu_torch.utils.benchkit import card_line

    B = int(env.get("BENCH_BATCH", "1024"))
    horizon = int(env.get("BENCH_HORIZON", "25"))
    n_calls = int(env.get("BENCH_CALLS", "30"))
    dev = resolve(env.get("BENCH_DEVICE") or None)
    card = card_line(dev)
    lanes = sqp_lanes.LANES
    if B < lanes or B % lanes:
        raise ValueError(f"BENCH_BATCH must be a positive multiple of the {lanes}-scenario tile, "
                         f"got {B}")

    def progress(msg):
        print(f"[breakdown] {msg}", file=sys.stderr, flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prob = bench_torch.build_problem("quadrotor", device=dev, horizon=horizon,
                                     **bench_torch.FIXTURE_GP)
    model, gp, consts = prob.model, prob.gp, prob.ctrl.consts
    cfg = prob.ctrl.cfg._replace(qp_tol=1e-7, kernel_linearize=True, qp_mehrotra=True)
    env_mod, env_p = prob.env_mod, prob.env_p

    es, obs = env_mod.env_reset(env_p, B, torch.Generator(device=dev).manual_seed(0), dev)
    st = mpc_mod.init_state(B, horizon, model.nx, model.nu, device=dev)

    def step(es, st, obs):
        return bench_torch.closed_loop_step(prob, cfg, gp, es, st, obs, backend="lanes")

    progress("warmup (the kernel library's build or load + 3 steps into the warm-started "
             "regime)")
    for _ in range(3):
        es, st, obs, u = step(es, st, obs)
    sync()
    rows = []

    def timed(segment, fn, carry):
        """One call of fn(carry) -> carry, then `n_calls` chained ones on the
        clock; one row."""
        progress(f"timing: {segment}")
        carry = fn(carry)
        sync()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            carry = fn(carry)
        sync()
        ms = (time.perf_counter() - t0) / n_calls * 1e3
        row = {"segment": segment, "ms_per_call": round(ms, 4), "calls": n_calls,
               "device": card if card is not None else str(dev)}
        rows.append(row)
        emit(row)
        return carry

    # ---- step: the full closed-loop step ----
    timed("step", lambda c: step(*c[:3]), (es, st, obs, u))

    # ---- prepare: GP variances + tightening + boxes and warm starts ----
    soft = cfg.soft_x_penalty is not None

    def prep(ob):
        with strict_float32():
            xref, bounds, X_init, U_init, _ = gpmpc_mod.batched_prepare_step(
                model, consts, gp, st, ob, soft=soft)
        return ob + 0.0 * X_init[:, 0]

    timed("prepare", prep, obs)
    with strict_float32():
        xref, bounds, X_init, U_init, _ = gpmpc_mod.batched_prepare_step(
            model, consts, gp, st, obs, soft=soft)

    # ---- sqp: the fused SQP solve alone, on the loop's warm inputs ----
    spec = gpmpc_mod.model_spec(model)
    ell = torch.nn.functional.softplus(gp.hypers.raw_lengthscale)
    sf2 = torch.nn.functional.softplus(gp.hypers.raw_outputscale)
    G, _, D = gp.Zs.shape
    lin = sqp_lanes.LanesLinearizer(
        params8=spec.kernel_params(model.params).to(dev),
        hyp=torch.cat([sf2[:, None], (1.0 / (ell * ell)).reshape(G, -1).expand(G, D)],
                      dim=1).contiguous(),
        Zs=gp.Zs, alpha=gp.alpha_s, use_gp=True, family=spec.name,
    )
    c = consts.mpc
    cost = OcpCost(xref=xref, uref=c.uref, Q=c.Q, R=c.R, Qe=c.Q, scale=c.scale)

    def sqp_only(x0):
        with strict_float32():
            sol = sqp_lanes.sqp_solve_batch_lanes_fused(lin, model.dt, cost, bounds, x0, X_init,
                                                        U_init, cfg)
        return x0 + 0.0 * sol.X[:, 0]

    timed("sqp", sqp_only, obs)

    # ---- lin1 / qp1: one kernel launch each on the first tile ----
    first = lambda x: sqp_lanes._to_lane_tiles(x, B // lanes, lanes)[:1]  # noqa: E731
    X_l, U_l, xref_l = first(X_init), first(U_init), first(xref)
    lx_l, ux_l, lu_l, uu_l = (first(b) for b in (bounds.lx, bounds.ux, bounds.lu, bounds.uu))
    qdiag, rdiag = sqp_lanes._cost_diagonals(cost)
    qdiag_l = qdiag[None, :, :, None].expand(1, horizon + 1, model.nx, lanes).contiguous()
    rdiag_l = rdiag[None, :, :, None].expand(1, horizon, model.nu, lanes).contiguous()
    uref_l = c.uref[None, :, :, None].expand(1, horizon, model.nu, lanes)

    def lin1(X):
        fnext, A, Bm = linearize_ocp_lanes(lin.params8, lin.hyp, lin.Zs, lin.alpha, X, U_l,
                                           dt=model.dt, use_gp=True, family=lin.family)
        return X + 0.0 * torch.cat([fnext[:, :1], fnext], dim=1)

    timed("lin1", lin1, X_l)
    fnext, A_l, B_l = linearize_ocp_lanes(lin.params8, lin.hyp, lin.Zs, lin.alpha, X_l, U_l,
                                          dt=model.dt, use_gp=True, family=lin.family)
    qx = (qdiag_l * (X_l - xref_l)).contiguous()
    lx, ux = lx_l - X_l, ux_l - X_l
    lx[:, 0], ux[:, 0] = -BOUND_INF, BOUND_INF
    qp = LanesQp(A=A_l, B=B_l, r=(fnext - X_l[:, 1:]).contiguous(), qdiag=qdiag_l, qx=qx,
                 rdiag=rdiag_l, ru=(rdiag_l * (U_l - uref_l)).contiguous(), lx=lx, ux=ux,
                 lu=(lu_l - U_l).contiguous(), uu=(uu_l - U_l).contiguous())

    def qp1(q):
        dx, du, gap = solve_ocp_qp_lanes(q, n_ip=cfg.qp_iters, adaptive_tol=cfg.qp_tol,
                                         mehrotra=cfg.qp_mehrotra, soft_rho=cfg.soft_x_penalty)
        return q._replace(qx=q.qx + 0.0 * dx)

    timed("qp1_warm", qp1, qp)
    # the cold iterate: bounds far from the solution (the first SQP iteration's shape)
    timed("qp1_cold", qp1, qp._replace(qx=torch.ones_like(qx)))

    # ---- env: the plant alone ----
    def env_only(carry):
        es, u = carry
        es, ob, *_ = env_mod.env_step(env_p, es, u)
        return es, u + 0.0 * ob[:, :model.nu]

    timed("env", env_only, (es, u))
    return rows


if __name__ == "__main__":
    main()

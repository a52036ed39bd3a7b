"""Whether the timed path's outputs are right: the plain reference
(`benchmark/reference/`) steps again each checked step of the window and the
program's outputs are held against its.

The window's first step starts from the benchmark's own initial state, which
the reference builds itself; every later checked step starts from the
program's carry before it (its controller state is the program's previous
solution), so the reference follows the program step by step there. Per
step the reference computes the tightened boxes, the SQP solution and the
plant's next two states under its own actions; the family's dynamics, plant
and GP features are `benchmark/reference/<family>.py`. The numbers compared,
each the largest over the checked steps and scenarios:

- `action_err`: |u - u_ref| as a share of each input's box width;
- `state_err`: the plant's state after the step that follows (the entries
  the family names in `PLANT_COMPARED`: the quadrotor's position, attitude
  and rates, as shares of each state's box width, and its actuators' lagged
  commands, as shares of each input's box width): with one step of
  actuation delay, that is the first state the step's actions move;
- `plan_err`: the whole solution (the next step's warm start), X and U, as
  shares of their box widths;
- `tighten_err`: the tightened boxes that the timed step's first stage
  (kernels 1 and 2) formed, as the captured graph wrote them out, against the
  reference's, as a share of the largest tightening of the step (steps that
  tighten nothing are skipped);
- `non_finite`: the scenarios of the whole window whose action or next state
  was not finite (limit 0).

With `precision="tf32"` the reference in TF32 takes the program's place: the
precision control, which these numbers must fail.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import controller as rc


class Reading(NamedTuple):
    numbers: dict  # name -> value
    # the reference's QP iterations, summed over tiles and SQP iterations, a step: the mean over
    # the checked steps inside episodes (the window's first step, an episode's start with a
    # cold warm start, is left out), 0.0 without one
    tile_iterations: float


class Checked(NamedTuple):
    """One checked step as the program ran it."""

    step: int
    episode: int
    before: tuple  # (plant state, controller state, observations)
    after: tuple
    u: torch.Tensor
    plant_next: tuple  # the plant state after the step that follows
    boxes: tuple  # the tightened boxes (lx, ux, lu, uu) the step formed


def _worse(a: float, b: float) -> float:
    """The larger, or NaN if either is."""
    return float("nan") if a != a or b != b else max(a, b)


def _side(c, gp, solver, plant, chk: Checked, x0, params, precision):
    """The reference's inputs for the step (its own initial state at the
    window's first step) and its outputs."""
    env, ctrl, obs = chk.before
    if chk.step == 0:
        (B, nx), T = x0.shape, c.uref.shape[0]
        pstate = plant.initial(x0)
        traj_step = torch.zeros(B, dtype=torch.int32, device=x0.device)
        X_warm = torch.zeros(B, T + 1, nx, device=x0.device)
        U_warm = c.uref.expand(B, -1, -1).clone()
        obs = x0
    else:
        pstate = env._asdict()
        traj_step, X_warm, U_warm = ctrl.traj_step, ctrl.X_warm, ctrl.U_warm
    out = rc.gpmpc_step(c, gp, solver, traj_step, X_warm, U_warm, obs, precision)
    # the step's actions enter the plant's actuators one step later
    nxt = plant.step(plant.step(pstate, params, out.u), params, out.u)
    return out, nxt, traj_step


def compare(config: dict, gp_arrays: dict, eps, checked: list, non_finite: int, device,
            precision: str = "float32") -> Reading:
    """The numbers of `checked` against the float32 reference; with
    `precision` "tf32" the TF32 reference's outputs stand in for the
    program's."""
    c = rc.make_consts(config, device)
    gp = rc.gp_set(config, gp_arrays, device)
    plant = c.fam.Plant(dict(config["plant"], dt=config["dt"]), device)
    solver = config["solver"]
    wx, wu = c.ux - c.lx, c.uu - c.lu
    width = dict(state=wx, input=wu)
    worst = dict(action_err=0.0, state_err=0.0, plan_err=0.0)
    t_err = t_scale = 0.0
    iters = []
    for chk in checked:
        x0, params = eps.x0[chk.episode], eps.params[chk.episode]
        ref, nxt, traj_step = _side(c, gp, solver, plant, chk, x0, params, "float32")
        if chk.step != 0:
            iters.append(float(sum(int(i.sum()) for i in ref.ip_iters)))
        if precision == "float32":
            u, X, U = chk.u, chk.after[1].X_warm, chk.after[1].U_warm
            p_next, boxes = chk.plant_next._asdict(), chk.boxes
        else:
            alt, p_next, _ = _side(c, gp, solver, plant, chk, x0, params, precision)
            u, X, U, boxes = alt.u, alt.X, alt.U, alt.boxes
        state_err = 0.0
        for k, w in c.fam.PLANT_COMPARED:
            state_err = _worse(state_err, float(((p_next[k] - nxt[k]).abs() / width[w]).max()))
        got = dict(action_err=((u - ref.u).abs() / wu).max(), state_err=state_err,
                   plan_err=torch.maximum(((X - ref.X).abs() / wx).max(),
                                          ((U - ref.U).abs() / wu).max()))
        for k, v in got.items():
            worst[k] = _worse(worst[k], float(v))
        if bool((traj_step > 0).any()):
            tight = max(float((c.ux - ref.boxes.ux).abs().max()),
                        float((c.uu - ref.boxes.uu).abs().max()))
            for a, b in zip(boxes, ref.boxes):
                t_err = _worse(t_err, float((a - b).abs().max()))
            t_scale = max(t_scale, tight)
    numbers = dict(worst, tighten_err=t_err / t_scale if t_scale > 0 else 0.0,
                   non_finite=float(non_finite))
    return Reading(numbers, sum(iters) / len(iters) if iters else 0.0)


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN never is)."""
    return all(numbers[k] <= limits[k] for k in limits)

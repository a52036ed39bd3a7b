"""`correct` comes out false when the timed path is broken underneath: a run
of the tiny checkout on the CPU (the harness's look for a card skipped) with
one fault planted in the program's step, once for each fault the cells can
have. The cells run on one card, so there is no exchange between chips to
leave out. The precision control, the plain reference in TF32 in the
program's place, fails the cells' limits too."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import check, run, spec
from benchmark.tests import tiny
from gpmpc_tpu_torch.control import gpmpc
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.parallel import batch

REAL_STEP, REAL_BOUNDS = batch.batched_gpmpc_step, gpmpc._bounds_from_tightening


def state_unchanged(model, cfg, consts, gp, states, obs, **kw):
    """The controller returns its state as it came, and the warm start's
    first action."""
    return states.U_warm[:, 0].clone(), states, None


def half_the_batch(model, cfg, consts, gp, states, obs, **kw):
    """Only the first half of the scenarios solved; the rest get their mean."""
    h = obs.shape[0] // 2
    first = type(states)(*[t[:h] for t in states])
    u, new, info = REAL_STEP(model, cfg, consts, gp, first, obs[:h], **dict(kw, lanes=h))
    rest = type(states)(*[t[h:] for t in states])
    return torch.cat([u, u.mean(0, keepdim=True).expand(h, -1)]), type(states)(
        *[torch.cat([a, b]) for a, b in zip(new, rest)]), info


def answer_altered(*args, **kw):
    """One scenario's thrust command off by 1e-3 where it is produced."""
    u, new, info = REAL_STEP(*args, **kw)
    u = u.clone()
    u[3, 0] += 1e-3
    return u, new, info


def tightening_left_out(consts, gp, states, obs, t_x, t_u, soft=False):
    """The step's first stage forms its boxes without the tightening."""
    return REAL_BOUNDS(consts, gp, states, obs, 0 * t_x, 0 * t_u, soft=soft)


def plant_unchanged(env_p, params, state, action, generator=None):
    """The plant returns its state as it came (the clock still advances)."""
    return state._replace(t=state.t + 1), state.x, None, None, None


FAULTS = {"controller_state_unchanged": (batch, "batched_gpmpc_step", state_unchanged),
          "half_the_batch_left_out": (batch, "batched_gpmpc_step", half_the_batch),
          "an_answer_altered": (batch, "batched_gpmpc_step", answer_altered),
          "tightening_left_out": (gpmpc, "_bounds_from_tightening", tightening_left_out),
          "plant_state_unchanged": (drone, "env_step_dynamic", plant_unchanged)}


@pytest.mark.parametrize("config", ["quadrotor-fig8", "quadrotor-gp5k"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, config, fault):
    module, where, fn = FAULTS[fault]
    monkeypatch.setattr(module, where, fn)
    root = tiny.make_checkout(tmp_path, config)
    out = run.run_cell(tiny.CELL, 2**31 + 41, 1.0, False, "cpu", time.perf_counter(), root)
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("config", ["quadrotor-fig8", "quadrotor-gp5k"])
def test_sound_run_and_precision_control(tmp_path, config):
    root = tiny.make_checkout(tmp_path, config)
    out = run.run_cell(tiny.CELL, 2**31 + 42, 1.0, False, "cpu", time.perf_counter(), root,
                       controls=("tf32",))
    limits = spec.load_cell(tiny.CELL, root).limits
    assert out["correct"] is True, out["check"]
    assert not check.verdict(out["controls"]["tf32"], limits), out["controls"]

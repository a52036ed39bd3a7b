"""The traffic generator: a batch of scenarios driven through episodes in
lockstep, every episode from fresh initial states and fresh plant
coefficients drawn from the run's seed (domain randomization), and the steps
whose outputs the run checks.

A mix is a JSON file of `benchmark/traffic/` with these keys:

- `scenarios`: B, the batch every step solves;
- `episode_steps`: the steps of an episode; at each boundary every scenario
  starts again at the reference's start;
- `init_noise`: the standard deviation of the initial state around the
  reference's first point (the family's `start_state`);
- `param_scale`, `param_truncation`: each plant coefficient is its nominal
  value times 1 + param_scale * a standard normal truncated to
  +-param_truncation, per scenario and episode;
- `checks`: how many steps the run compares with the reference: the
  window's first step and one step drawn from the seed in each episode after
  it, while the window lasts;
- `trace_seconds`: the length of the traced window of a `--trace 1` run.

The draws are made on the device in blocks of `BLOCK` episodes, each from a
`torch.Generator` seeded with `--seed` and the block's index, so that the
same seed gives the same inputs, whatever the window's length.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import torch

from benchmark.reference.controller import family

BLOCK = 16  # episodes a draw


class Episodes(NamedTuple):
    x0: torch.Tensor  # (E, B, nx) initial states
    params: torch.Tensor  # (E, B, n_params) plant coefficients


def episodes_for(seconds: float, traffic: dict) -> int:
    """Episodes to draw for a window of `seconds`: enough at a step of 1 ms,
    faster than any the card runs at these sizes, plus the warm-up's."""
    return int(seconds * 1000 // traffic["episode_steps"]) + 2


def draw_episodes(traffic: dict, config: dict, seed: int, n_episodes: int, device) -> Episodes:
    """The first `n_episodes` episodes' initial states and coefficients, two
    draws a block of `BLOCK` episodes."""
    B = int(traffic["scenarios"])
    fam = family(config)
    ref0 = fam.start_state(config, device)
    base = fam.params_tensor(config["plant"]["params"], device)
    cut = float(traffic["param_truncation"])
    noise, factors = [], []
    for k in range(-(-n_episodes // BLOCK)):
        gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + k) % 2**64)
        noise.append(torch.randn(BLOCK, B, ref0.shape[0], generator=gen, dtype=torch.float32,
                                 device=device))
        factors.append(torch.nn.init.trunc_normal_(torch.empty(BLOCK, B, base.shape[0],
                                                               device=device),
                                                   0.0, 1.0, -cut, cut, generator=gen))
    noise = torch.cat(noise)[:n_episodes]
    factors = torch.cat(factors)[:n_episodes]
    return Episodes(x0=ref0 + float(traffic["init_noise"]) * noise,
                    params=base * (1.0 + float(traffic["param_scale"]) * factors))


def check_steps(traffic: dict, seed: int) -> list[int]:
    """The steps of the window whose outputs are compared: step 0 (from the
    benchmark's own initial state) and, in each episode e = 0, 1, ..., one
    step at an offset drawn from the seed (never the episode's first or
    last), up to `checks` in all."""
    rng = random.Random(seed)
    L = int(traffic["episode_steps"])
    steps = [0]
    e = 0
    while len(steps) < int(traffic["checks"]):
        steps.append(e * L + rng.randrange(1, L - 1))
        e += 1
    return steps

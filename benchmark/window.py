"""The measured window: closed-loop steps, one replay of the fused window's
one-step CUDA graph each (`FusedWindow.run(1)`), until `seconds` have passed
on the host's clock, with every scenario reset at each episode boundary by
copies into the window's static buffers between replays.

Each step's time is read from a pair of CUDA events recorded just before and
just after its replay, all read once the window has closed. The host keeps at
most `LAG_STEPS` steps queued ahead of the card (it waits on the end event of
the step that many back), so the card always has work and the window closes
no more than that many steps after `seconds`. Before and after each checked
step the carry, and after it the step's actions and tightened boxes (the
system's static buffers that the graph writes), are copied into buffers of
their own, on the card, between replays. On the CPU the same loop runs the
steps eagerly and times them by the host's clock.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

LAG_STEPS = 3  # steps the host may enqueue ahead of the card


def tree_map(fn, tree, *rest):
    """fn over the tensors of a tree of tuples and named tuples (and of the
    trees `rest` of the same shape)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    parts = [tree_map(fn, t, *[r[i] for r in rest]) for i, t in enumerate(tree)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


class Snapshot(NamedTuple):
    step: int  # in the window
    episode: int  # whose initial states and plant coefficients the step ran on
    before: tuple  # (plant state, controller state, observations) before the step
    after: tuple  # the same after it
    u: torch.Tensor  # (B, nu) its actions
    boxes: tuple  # (lx, ux, lu, uu) the tightened boxes the step formed
    plant_next: tuple  # the plant state after the step that follows


class WindowResult(NamedTuple):
    steps: int
    wall_s: float  # first replay to the closing synchronize
    step_ms: list  # each step's replay, by its CUDA events (the host's clock on the CPU)
    snapshots: list


class Driver:
    """Runs steps of a `FusedWindow` `win` of the system `s` from episode
    draws `eps`, `episode_steps` a step."""

    def __init__(self, win, s, eps, episode_steps: int, initial_carry):
        self.win, self.s, self.eps, self.L = win, s, eps, int(episode_steps)
        # an episode's start but for its initial states, built once on the device
        self.start = initial_carry(s, eps.x0[0])
        self.cuda = win.device.type == "cuda"
        self.step_index = 0  # steps since the last `reset(0)`

    def reset(self, episode: int) -> None:
        """Every scenario to the start of `episode`: device-to-device
        copies, enqueued."""
        if episode >= self.eps.x0.shape[0]:
            raise RuntimeError(f"the window outran its {self.eps.x0.shape[0]} drawn episodes")
        env, _, obs = self.win.carry
        tree_map(lambda dst, src: dst.copy_(src), self.win.carry, self.start)
        env.x.copy_(self.eps.x0[episode])
        obs.copy_(self.eps.x0[episode])
        self.s.params.copy_(self.eps.params[episode])

    def step(self) -> None:
        """One step (after a reset at an episode boundary)."""
        if self.step_index and self.step_index % self.L == 0:
            self.reset(self.step_index // self.L)
        self.win.run(1)
        self.step_index += 1

    def warm(self, n: int) -> None:
        """n steps (the first captures the graph), then back to episode 0."""
        self.step_index = 0
        for _ in range(n):
            self.step()
        self.reset(0)
        self.s.fails.zero_()
        self.step_index = 0
        if self.cuda:
            torch.cuda.synchronize(self.win.device)

    def _snapshot_buffers(self, n: int) -> list:
        carry = self.win.carry
        return [dict(before=tree_map(torch.empty_like, carry),
                     after=tree_map(torch.empty_like, carry),
                     u=torch.empty_like(self.win.u),
                     boxes=tree_map(torch.empty_like, self.s.boxes),
                     plant_next=tree_map(torch.empty_like, carry[0])) for _ in range(n)]

    def window(self, seconds: float, checks: list[int]) -> WindowResult:
        """Steps from the current carry until `seconds` have passed (and the
        step after a checked one has run); the carry before and after each
        step in `checks`, and the plant state after the step that follows
        it, are kept. A checked step is never an episode's last."""
        bufs = self._snapshot_buffers(len(checks))
        slot = {step: i for i, step in enumerate(checks)}
        kept = {}
        copy = lambda dst, src: tree_map(lambda d, t: d.copy_(t), dst, src)  # noqa: E731
        events, host_ms = [], []
        first = self.step_index
        if self.cuda:
            torch.cuda.synchronize(self.win.device)
        t0 = time.perf_counter()
        while True:
            i = self.step_index - first
            if self.step_index and self.step_index % self.L == 0:
                self.reset(self.step_index // self.L)
            if i in slot:
                copy(bufs[slot[i]]["before"], self.win.carry)
            if self.cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                self.win.run(1)
                ev[1].record()
                events.append(ev)
            else:
                h0 = time.perf_counter()
                self.win.run(1)
                host_ms.append(1e3 * (time.perf_counter() - h0))
            self.step_index += 1
            if i in slot:
                b = bufs[slot[i]]
                copy(b["after"], self.win.carry)
                b["u"].copy_(self.win.u)
                copy(b["boxes"], self.s.boxes)
            if i - 1 in slot:
                b = bufs[slot[i - 1]]
                copy(b["plant_next"], self.win.carry[0])
                kept[i - 1] = Snapshot(i - 1, (self.step_index - 2) // self.L, b["before"],
                                       b["after"], b["u"], b["boxes"], b["plant_next"])
            if self.cuda and len(events) > LAG_STEPS:
                events[-1 - LAG_STEPS][1].synchronize()
            if time.perf_counter() - t0 >= seconds and i not in slot:
                break
        if self.cuda:
            torch.cuda.synchronize(self.win.device)
        wall = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in events] if self.cuda else host_ms
        return WindowResult(len(step_ms), wall, step_ms, [kept[k] for k in sorted(kept)])

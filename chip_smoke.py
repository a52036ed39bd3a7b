"""On-card smoke run of the PyTorch/CUDA port (`gpmpc_tpu_torch`).

    python3 chip_smoke.py [--profile]

Needs one CUDA card and `nvcc`; there is no CPU path. It drives the roofline
probe (`gpmpc_tpu_torch/roofline.py`: the three lane-chain kernels beside two
library mappings) and the closed loop on the paths of `PATHS`: nine, six on the
`lanes-fused` dispatch path and three on `lanes`: each model family at
`bench.py`'s configuration for it (`BENCH_MODEL=quadrotor|cartpole|twolink`:
T=25, B=1024, the family's GPs with capacity 128 and 40 FITC inducing points,
prob 0.95, 6 SQP / 10 Mehrotra IP iterations, IP exit at gap 1e-6, in-kernel
linearization, the family's cost weights, boxes and `lm_reg`, the plant on the
card), and the quadrotor with soft state bounds (`quadrotor-soft`,
soft_constraints=50: the resident QP kernel's soft mode), at T=100, B=256
(`quadrotor-T100`: the tier-1 streamed QP kernel) and at T=360, B=256 with
soft bounds (`quadrotor-soft-T360`: the tier-2 QP kernel, soft); then,
linearized in plain torch with only the QP, the tightening and (for a shared
GP) the GP variances in kernels, the quadrotor with `kernel_linearize=False`
(`quadrotor-jacfwd`, bench.py's BENCH_KERNEL_LIN=0, followed by a short run
with `analytic_jac=True`, BENCH_ANALYTIC_JAC=1, whose actions must agree
within 1e-4), at T=512, B=256 past the fused path's cap (`quadrotor-T512`:
the tier-2 QP kernel with hard bounds, one dispatch warning) and with
a per-scenario GP population (`quadrotor-population`: the benchmark GP per
scenario with `alpha_s` and the raw hyperparameters perturbed from a seeded
generator). Then three paths on the `xla` dispatch path, plain torch by design
(the reference's XLA code; no kernel, and every kernel wrapper must stay at
0 launches): `quadrotor-xla` (bench.py's configuration through
`batched_gpmpc_step(backend="xla")`, the reference's default backend; its
actions on the `quadrotor` path's recorded observations within 2e-3 of the
lanes-fused step's with the same fixed IP count, the reference's lanes-vs-xla
bar), `quadrotor-nominal`
(the nominal MPC, `control/mpc.py::select_action`, at B=1024, T=25, and its
entry point `batched_episode(use_gp=False, backend="xla")`, whose first
actions must equal the step's) and `quadrotor-soft-T800` (one step at T=800,
B=256 with soft bounds: past the lanes soft cap of 768, so requested on
lanes it dispatches to xla, degraded, with one warning; the only path for
such horizons). Their phase 2 prints ms/step as the median of synchronized
steps. After the learned paths, the step's variance and tightening options
on the `quadrotor` path's recorded observations (`STEP_OPTIONS`: each
launches exactly its kernels; the bf16 variances on the card against the
CPU's, beside their distance from the float32 ones) and `quadrotor-server`:
`runtime/server.py::ControlServer(tile=128, backend="lanes")` on that
path's controller, 64 client threads replaying 20 recorded steps each
(`utils/benchkit.py::replay_sessions`), kernels 1-4 each launched and held
against their plain versions at B=128 and every other wrapper at 0, a
dispatch against `batched_gpmpc_step` on the same tile buffers, a GP hot
swap, a snapshot restored into a fresh server, then 4-action replies
(`SERVER`). Then the port's headline bench in-process (`[bench]` and
`[breakdown]` lines, `BENCH_RUNS`): `bench_torch.py::main` at bench.py's
defaults (quadrotor, T=25, B=1024, a 60-step window), for the cartpole and
the two-link arm (10 steps), at T=100, B=256 (5 steps) and with
`BENCH_REAL_GP=1` (15 prior steps collected and the GP trained on the CPU;
10 steps),
each run's two JSON lines under the card's metric name, kernels 1-4 launched
at phase 2's rates a step (kernel 5 in kernel 4's place at T=100) and every
other wrapper at 0; `scripts/bench_step_breakdown_torch.py::main` at
`BREAKDOWN_CALLS` calls a segment, its seven segments in order, `lin1`
launching kernel 3 and `qp1_warm` and `qp1_cold` kernel 4 once a call; and
the default run's last step for its first tile of 128 scenarios solved again
by the plain path on the CPU from the same states and observations (control
RMSE bar); the real-GP run reuses the default run's problem. Then the fused
window (`[fused]` lines, `FUSED_RUNS`, `fused_window_check`):
`bench_torch.py::main` with BENCH_FUSED=1 on the default run's and the T=100
run's problems, each CUDA-graph capture launching kernels 1 and 2 once a step
and kernels 3 and 4 (5 at T=100) six times; `FUSED_STEPS` steps from the
default run's last carry, chained and as `FusedWindow`s of 1 and 3 steps a
graph built and captured under sync-debug "error", whose trace, actions and
carries must equal the chained loop's (`FUSED_TOL`); each mode's solves/s and
its busy and idle share in a window traced by torch.profiler. Then the fused
window off the lanes-fused defaults (`fused_path_check`): BENCH_FUSED=1 with
BENCH_BACKEND=xla (2 steps, every kernel wrapper at 0 in the capture), with
BENCH_KERNEL_LIN=0 (5 steps; kernels 1, 2 and 4 at 1, 1 and 6 a captured
step) and at BENCH_HORIZON=512, BENCH_BATCH=256 (2 steps; kernels 1, 2 and 6
at 1, 1 and 6), each run's own one-step graph replayed from its last carry
against its chained loop from the same carry (`FUSED_TOL`), its solves/s and
its busy and idle share over a traced window of one step. Last, the
experiment entry points in-process, each with its launches counted from 0
(`[driver]`, `[eval_seeds]`, `[gp_fit]` lines): `scripts/run_gp_mpc_torch.py` (`DRIVER`: one epoch of 10 steps at 6 SQP / 10 IP
iterations and 100 GP iterations, `--profile`, on a copy of the shipped
config; kernels 1, 2 and 4 held against their plain versions on the last
step's inputs; the trace must name them; the CSV table, every run finite,
the last evaluation's first steps on the CPU within the control RMSE bar;
the phase times, and a projection of the default run from steps timed at
the YAML's own iterations), `scripts/eval_seeds_torch.py` (`EVAL_SEEDS_ARGS`:
cartpole, 4 seeds on lanes) and `scripts/bench_gp_fit_torch.py` (its default
sizes, `GP_FIT_ITERS` iterations; the smallest fit against the CPU's).
Then scale-out (`[mesh]`, `[multihost]`, `[multihost-sweep]`, `[dryrun]`
lines): the `quadrotor` path's step at B=1024 through
`make_batched_controller_step(mesh=)` as two shards of 512 (on two cards
where the machine has them, else both on cuda:0), 3 closed-loop steps
equal bit for bit to the unsharded step's actions, states and info,
kernels 1-2 launched once a shard a step and 3-4 once a shard an SQP
iteration, each held against its plain version on the last shard's inputs
(`MESH`), and one xla step with `parallel_scan=True` against the sequential
Riccati's (control RMSE bar); `scripts/run_multihost_torch.py` with two
gloo ranks on the card and then one NCCL rank (the script's worker mode in
this process, with its coordinator on 127.0.0.1), the lanes-fused step at
B=1024, parity in every rank, solves/s and idle shares (`MULTIHOST`); the
seed sweep sharded over two gloo ranks at the reference script's sizes,
each rank's cost matrix against the unsharded sweep that this process runs
meanwhile, after `parallel/dryrun.py::dryrun_multichip(2)` on two shards of
the card (`MULTIHOST_SWEEP`).
Phases, each printing its own lines:

  0. the card's name and power limit (nvidia-smi), then the kernel build:
     one nvcc per source in parallel, each source's time and ptxas's
     register and spill report for every instantiation (kernels 7, 8 and
     9's and kernel 1's tiled kernels' on lines of their own; a stack frame
     or a spill of kernel 7 or 8, which keep their whole matrix in
     registers, fails the run); kernel 1's tiled shared memory a block
     against `cuda_gp.TILED_SHARED_BYTES` (a difference fails the run); the
     resident QP kernel's launch geometry at
     each width (team, scenarios per block, cluster, shared memory, blocks
     at B=1024 and B=256), which all three QP tiers share; the workspace the
     QP wrappers allocate at each horizon cap;
  1. per path, each kernel of the path against its plain PyTorch version on
     the card, on inputs captured from the path's first warm-started step and
     on seeded random inputs at the path's shapes (soft QPs with boxes tight
     enough to force violations): max abs difference beside the stated
     tolerance, the median time of each (CUDA events around one call), the
     kernel's device time with calls back to back (`device_ms`), the least
     time the card could take (`bound_ms`, see `Bound`) and, for kernel 2,
     one torch.matmul that gives the same variances (`library_ms`, see
     `tighten_library_ms`), for kernel 1 one torch.matmul of its kernel rows
     by W (`gp_library_ms`); for the QP kernels the IP iterations each tile
     ran, which for kernels 5 and 6 must equal the plain version's. The GP entry of
     a path is the multi-GP wrapper (all of a step's GPs in one launch).
     First of all the three chain
     kernels against their plain versions on the reference's data after 4
     rounds (the chain leaves float32 after some ten) and, after 200 rounds, in
     where they are non-finite; the five roofline rows as their JSON lines;
     each chain kernel's time beside its bound, its plain version and one
     `torch.matmul` a round on the same data, and kernels 7 and 8's share
     of the bound beside the ceiling their instruction mix allows
     (`chain_ceiling`); after the paths, the chain's rate per SM against the
     resident QP kernel's (`chain_share`). Then the QP instantiations no
     path of this script reaches, on random inputs: the narrow widths (4, 1)
     and (4, 2) of every new kernel, tier 1 at 12x4 and B=1024 at T=200,
     at its cap T=400 and at T=320 soft (its workspace beside the card's
     free memory), the other horizon caps at 12x4 (the resident kernel at
     T=50 hard and soft, tier 2 at T=1024 and at T=768 soft), kernels 1-3
     at T=400,
     kernel 2 at T=512 and T=1024 (12x4, B=256, beside its yardstick), the
     multi-GP kernel at G = 2 and 3, D = 3 and 6, N = 25,637, on GPs whose
     live points are not a prefix, and past 128 live points (F7: the
     tiled instantiation at M = 136, 304, 512 and 2,048, on leaves at their
     own lengthscales and at 40 points' density, held against the float64
     value within 1e-4 + the plain version's own distance, with planted
     faults that must fall outside that bar, `gp_f64_check`; each case
     called twice more must give the same bits), the tiled kernel's DMMA
     fragment layout (`dmma_layout_check`), the tiled kernel's float64 sums
     on the learned paths' register-bucket GPs (`f64_sums_on_bucket_gps`),
     the resident kernel on the quadrotor
     path's captured QP cut to two tiles (B=256) beside the whole one, the
     resident kernel called directly on the T=100 path's QP beside tier 1
     (the same solution bit for bit and the same per-tile counts, or the
     run fails), and kernel 4 beside kernel 6 on the T=512 path's QP
     (printed);
  2. per path, the closed loop: warm-up and timed steps with every kernel's
     launch count (counts set to 0 just before the path's run and read just
     after: the path's QP wrapper must have launched, the other two not; a
     `lanes` path must not launch the linearize kernel, nor the population
     path the GP kernel; a shared-GP path launches it once a step), the
     dispatch decision and its one-time warning,
     finite actions, clamp fraction, soft violation, SQP iterations and QP
     gaps; then five `quadrotor-soft` steps with the GP's raw_outputscale at
     30, which must report soft violations and stay finite;
  3. per path, the same observations for the first scenarios solved by the
     port's plain path on the CPU: control RMSE against the card's actions
     <= 1e-3. Phase 3 (and the [bench] phase's CPU check) runs in a spawned
     worker process beside the card's phases (`CpuWorker`: its torch
     threads pinned to all but two cores), fed each path's recorded steps as
     soon as phase 2 has them and joined before the final lines; a failed
     comparison there fails the run.

`--profile` adds a torch.profiler pass over one step of each path and
prints the card's busy time with the idle share against the profiled step
and against phase 2's unprofiled steps.

Prints a JSON line of per-kernel results (`kernels`: one entry per path and
kernel, with the launches of that path's run, and the three chain kernels
with the launches of the roofline rows' run; `kernel_level_only`: the
instantiations held in phase 1 alone; each entry with the contract's keys
and `device_ms`), the nvidia-smi line, then as its last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
import warnings
from functools import partial
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_torch  # noqa: E402
from gpmpc_tpu_torch import _build, convert, roofline  # noqa: E402
from gpmpc_tpu_torch import gp as gp_mod  # noqa: E402
from gpmpc_tpu_torch.control import gpmpc as gpmpc_mod  # noqa: E402
from gpmpc_tpu_torch.control import mpc as mpc_mod  # noqa: E402
from gpmpc_tpu_torch.envs import cartpole_env, drone, twolink_env  # noqa: E402
from gpmpc_tpu_torch.models import cartpole, twolink  # noqa: E402
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS  # noqa: E402
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude  # noqa: E402
from gpmpc_tpu_torch.ops import (  # noqa: E402
    cuda_chain,
    cuda_gp,
    cuda_linearize,
    cuda_ocp,
    cuda_tighten,
    sqp_lanes,
)
from gpmpc_tpu_torch.parallel import batch as batch_mod  # noqa: E402
from gpmpc_tpu_torch.parallel.batch import (  # noqa: E402
    batched_gpmpc_step,
    dispatch_decision,
    make_batched_controller_step,
)
from gpmpc_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from gpmpc_tpu_torch.parallel.fused import FusedWindow  # noqa: E402
from gpmpc_tpu_torch.parallel.mesh import (  # noqa: E402
    Sharded,
    gather,
    make_mesh,
    shard_leading_axis,
    tree_leaves,
    tree_map,
)
from gpmpc_tpu_torch.parallel.sweep import seed_sweep  # noqa: E402
from gpmpc_tpu_torch.runtime.server import DIAG_FIELDS, ControlServer  # noqa: E402
from gpmpc_tpu_torch.utils.benchkit import replay_sessions  # noqa: E402

LANES = 128
RMSE_BAR = 1e-3
SOFT_PENALTY = 50.0  # tests/test_pallas_ocp.py's soft_constraints
STRESS_OUTPUTSCALE = 30.0
ANALYTIC_BAR = 1e-4  # actions of the analytic-Jacobian run against the forward-mode run's

# bench.py:94-151: each family's controller configuration.
FAMILIES = {
    "quadrotor": dict(
        env=drone, model=lambda: symbolic_attitude(dt=0.02, params=PRIOR_PARAMS._asdict()),
        prior=PRIOR_PARAMS._asdict(),
        q_mpc=[8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001], r_mpc=[3, 3, 3, 0.1],
        bounds=None, lm_reg=0.0,
    ),
    "cartpole": dict(
        env=cartpole_env, model=lambda: cartpole.symbolic_cartpole(dt=0.02), prior=None,
        q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05],
        bounds=(cartpole.state_bounds(), cartpole.input_bounds()), lm_reg=0.0,
    ),
    "twolink": dict(
        env=twolink_env, model=lambda: twolink.symbolic_twolink(dt=0.02), prior=None,
        q_mpc=[20.0, 20.0, 0.5, 0.5], r_mpc=[0.1, 0.1],
        bounds=(twolink.state_bounds(), twolink.input_bounds()), lm_reg=0.5,
    ),
}


class SmokePath(NamedTuple):
    """One driven configuration. `qp` names the QP wrapper the path must
    reach; (`n_cpu`, `cpu_steps`) is the size of phase 3."""

    family: str
    T: int
    B: int
    soft: float | None
    qp: str
    n_warmup: int
    n_timed: int
    n_cpu: int
    cpu_steps: int
    tag: str | None  # suffix of the path's entries in the JSON line
    dispatch: str = "lanes-fused"  # the decision `dispatch_decision` must take
    degraded: bool = False  # whether that decision must warn (once)
    kernel_linearize: bool = True
    population: bool = False  # a per-scenario GP population
    learned: bool = False  # the GP is trained in this run (`learned_gp`), not the fixture
    backend: str = "lanes"  # the `backend` argument of batched_gpmpc_step
    nominal: bool = False  # the nominal MPC (control/mpc.py::select_action), no GP

    @property
    def kernels(self) -> tuple:
        """The kernels the path must launch ('qp' is the wrapper named by
        `qp`); every other wrapper must stay at 0 launches. The `xla` path
        and the nominal MPC launch none."""
        if self.dispatch == "xla":
            return ()
        names = () if self.population else ("gp_posterior",)
        names += ("tighten",) + (("linearize",) if self.dispatch == "lanes-fused" else ())
        return names + ("qp",)


PATHS = {
    "quadrotor": SmokePath("quadrotor", 25, 1024, None, "ocp_ip", 2, 10, 128, 5, None),
    "cartpole": SmokePath("cartpole", 25, 1024, None, "ocp_ip", 2, 10, 128, 5, None),
    "twolink": SmokePath("twolink", 25, 1024, None, "ocp_ip", 2, 10, 128, 5, None),
    "quadrotor-soft": SmokePath("quadrotor", 25, 1024, SOFT_PENALTY, "ocp_ip", 2, 10, 128, 5, "soft"),
    "quadrotor-T100": SmokePath("quadrotor", 100, 256, None, "ocp_ip_streamed", 1, 5, 32, 1, "T100"),
    "quadrotor-soft-T360": SmokePath("quadrotor", 360, 256, SOFT_PENALTY, "ocp_ip_streamed2", 1, 2, 32,
                                 1, "soft-T360"),
    "quadrotor-jacfwd": SmokePath("quadrotor", 25, 1024, None, "ocp_ip", 2, 10, 128, 1, "jacfwd",
                                  dispatch="lanes", kernel_linearize=False),
    "quadrotor-T512": SmokePath("quadrotor", 512, 256, None, "ocp_ip_streamed2", 1, 2, 32, 1, "T512",
                                dispatch="lanes", degraded=True),
    "quadrotor-population": SmokePath("quadrotor", 25, 1024, None, "ocp_ip", 2, 10, 128, 1,
                                      "population", dispatch="lanes", degraded=True, population=True),
    # BASELINE configs 2 and 4 (bench.py:81-82,120-128): GPs learned on the card from the
    # untrained controller's episodes (`learned_gp`), then the fused step
    "quadrotor-learned": SmokePath("quadrotor", 25, 1024, None, "ocp_ip", 2, 10, 128, 5, "learned",
                                   learned=True),
    "quadrotor-gp5k": SmokePath("quadrotor", 50, 1024, None, "ocp_ip", 1, 5, 32, 2, "gp5k",
                                learned=True),
    # the xla path (the reference's default backend: plain torch, no kernel) at bench.py's
    # configuration; the nominal MPC through batched_episode(use_gp=False); and the only path
    # past the lanes soft cap (768), requested on lanes and dispatched to xla with a warning
    "quadrotor-xla": SmokePath("quadrotor", 25, 1024, None, "", 1, 3, 32, 2, "xla",
                               dispatch="xla", backend="xla"),
    "quadrotor-nominal": SmokePath("quadrotor", 25, 1024, None, "", 1, 3, 32, 2, "nominal",
                                   dispatch="xla", backend="xla", nominal=True),
    "quadrotor-soft-T800": SmokePath("quadrotor", 800, 256, SOFT_PENALTY, "", 0, 1, 2, 1,
                                     "soft-T800", dispatch="xla", degraded=True),
}
# the bar of the xla path's actions against the lanes-fused path's on the same observations
# and IP settings: the reference's own lanes-vs-xla bar (tests/test_parallel.py:137-141)
XLA_LANES_BAR = 2e-3
# The learned paths' controllers and fits: (inducing points, capacity, episode steps collected
# at B, transitions kept, Adam iterations).
LEARNED = {"quadrotor-learned": (40, 128, 8, 128, 100), "quadrotor-gp5k": (128, 5120, 5, 5120, 50)}
# tests/test_learning_loop.py:64-68's two-link controller (exact ARD GP, capacity 512) and its bar
TWOLINK_EXACT = dict(T=20, steps=150, episodes=2, iterations=500, max_ratio=0.6)
# The initial states of that test's episodes: envs/twolink_env.py's `env.reset(seed=0)` and
# `(seed=1)`, drawn by JAX's PRNG, which the port cannot reproduce (held equal to JAX's by
# tests/test_torch_episode.py::test_twolink_learning_starts_are_the_reference_tests). The bar
# belongs to these starts: on the port's own draws (torch seeds 0 and 1) the reference's
# pipeline itself misses it (tests/test_torch_twolink_starts.py, slow, on the CPU).
TWOLINK_STARTS = (
    (-1.6196454763412476, 1.0787038803100586, 0.4753497838973999, 0.16368605196475983),
    (-1.5756747722625732, 1.1218749284744263, 0.45597270131111145, 0.15213492512702942),
)
# scripts/eval_seeds.py's quadrotor sweep (16 seeds) at scripts/gp_mpc_config.yaml's settings,
# the episode cut from 300 steps to 30
SWEEP = dict(n_seeds=16, T=25, sqp_iters=12, qp_iters=12, n_epochs=2, samples_per_epoch=15,
             max_inducing=40, gp_iters=500, gp_lr=0.001, n_steps=30)
# F7: the multi-GP kernel past 128 live points (the tiled instantiation): (G, D, live, N)
F7_CASES = [(G, D, m, 25_637) for m in (136, 304, 512) for G, D in ((2, 6), (3, 3))] + [
    (2, 6, 2048, 4096), (3, 3, 2048, 4096)]
# the leaves at their own lengthscales, and scaled as if 40 points (random_gp_leaves' density)
F7_DENSITIES = (None, 40)

# Kernel-vs-plain tolerances. GP: the repo's Pallas GP test bar (float32 sums
# of ~1e2-size terms in another order). Tighten: relative, since the kernel
# uses (A+BK) cov (A+BK)^T where the plain version expands the four products.
# Linearize: the repo's kernel-vs-jacfwd bars. OCP, hard and soft: two float32
# runs of the same IP whose Mehrotra centering cubes rounding differences; the
# exit at gap 1e-6 bounds how far one extra iteration moves a solution. With
# soft bounds the fused barrier weights reach 1e6 before that exit and amplify
# the same differences on weakly determined states, so the soft readings lie
# nearer the bar than the hard ones.
TOL = {"gp": 1e-4, "tighten": 1e-5, "linearize_fnext": 2e-5, "linearize_jac": 2e-4, "ocp": 5e-4}
TOL["ocp_soft"] = TOL["ocp"]
# The chain kernels, relative to max(1, |plain|) after 4 rounds: float32 sums
# with FMAs in another order than the plain version; in bf16 both round every
# product and every partial sum in the same order, so they should agree
# exactly, and 2 bf16 ulps (2^-8 each in [1, 2)) is the bar.
TOL["chain"] = 1e-5
TOL["chain_bf16"] = 2 * 2.0**-8
CHAIN_ROUNDS = 4
TOL_TEXT = {
    "gp_posterior": "1e-4 on mean and var",
    "gp_posterior_f64": "per output, from the float64 value, 1e-4 + the distance of the plain "
                        "version (float32 sums) or of k's rounding alone (tiled, float64 sums); "
                        "planted faults outside it",
    "tighten": "1e-5 x max(1, max|t|)",
    "linearize": "2e-5 on fnext, 2e-4 on A and B",
    "ocp": "5e-4 on dx and du",
    "ocp_soft": "5e-4 on dx and du",
}

# QP wrapper name -> (wrapper, plain version, TPU kernel it replaces)
QP_WRAPPERS = {
    "ocp_ip": (cuda_ocp.solve_ocp_qp_lanes, cuda_ocp.solve_ocp_qp_lanes_plain,
               "gpmpc_tpu/ops/pallas_ocp.py:1807"),
    "ocp_ip_streamed": (cuda_ocp.solve_ocp_qp_lanes_streamed,
                        cuda_ocp.solve_ocp_qp_lanes_streamed_plain,
                        "gpmpc_tpu/ops/pallas_ocp.py:1711"),
    "ocp_ip_streamed2": (cuda_ocp.solve_ocp_qp_lanes_streamed2,
                         cuda_ocp.solve_ocp_qp_lanes_streamed2_plain,
                         "gpmpc_tpu/ops/pallas_ocp.py:1607"),
}
# The QP wrappers whose per-tile IP counts must equal their plain version's:
# the streamed tiers, whose plain versions keep the TPU kernels' arithmetic.
COUNTS_GATED = (cuda_ocp.solve_ocp_qp_lanes_streamed, cuda_ocp.solve_ocp_qp_lanes_streamed2)
# kernel -> (wrapper, plain version, source, TPU kernel it replaces)
KERNELS = {
    "gp_posterior": (cuda_gp.gp_mean_var_multi, cuda_gp.gp_mean_var_multi_plain,
                     "gpmpc_tpu_torch/csrc/gp_posterior.cu", "gpmpc_tpu/ops/pallas_gp.py:64"),
    "tighten": (cuda_tighten.tighten_lanes, cuda_tighten.tighten_lanes_plain,
                "gpmpc_tpu_torch/csrc/tighten.cu", "gpmpc_tpu/ops/pallas_tighten.py:93"),
    "linearize": (cuda_linearize.linearize_ocp_lanes, cuda_linearize.linearize_ocp_lanes_plain,
                  "gpmpc_tpu_torch/csrc/linearize.cu", "gpmpc_tpu/ops/pallas_linearize.py:407"),
}
LINEARIZE_CLOSURES = {"cartpole": "gpmpc_tpu/ops/pallas_linearize.py:170",
                      "twolink": "gpmpc_tpu/ops/pallas_linearize.py:235"}


def chain_ceiling(dtype) -> float:
    """Share of the peak that kernel 7's or 8's instruction mix allows: the
    N^3 terms of a round against every instruction of the round on the FMA
    pipe. In float32 a term is one FFMA (the first of a row an FMUL) and the
    blend an FMUL and an FFMA an entry; in packed bf16 the first product of a
    row is one HMUL2, every other term an HMUL2 and an HADD2 (each rounds, as
    the reference does), and the blend two HMUL2 and an HADD2 an entry.
    scripts/bench_chain_geometry_torch.py counts them in the SASS."""
    n = 12
    per_term, blend = (2, 3) if dtype == torch.bfloat16 else (1, 2)
    return n**3 / (n * n + n * n * (n - 1) * per_term + n * n * blend)


# chain kernel -> (wrapper, plain version, TPU kernel it replaces, roofline row,
# scenarios per tile, stages, matrix width, dtype, peak operations/s)
PEAK_FLOPS_BF16X2 = 133.8e12  # H100 SXM packed bf16 outside the tensor cores (NVIDIA H100
# Tensor Core GPU Architecture white paper, "Peak BF16 TFLOPS (non-Tensor)")
CHAINS = {
    "lanes_chain": (cuda_chain.lanes_chain, cuda_chain.lanes_chain_plain,
                    "scripts/bench_roofline.py:145", "cuda_lanes", 128, roofline.T, 12,
                    torch.float32, 67e12),
    "lanes_chain_bf16": (cuda_chain.lanes_chain_bf16, cuda_chain.lanes_chain_bf16_plain,
                         "scripts/bench_roofline.py:184", "cuda_lanes_bf16_pair", 256, roofline.T,
                         12, torch.bfloat16, PEAK_FLOPS_BF16X2),
    "lanes_chain_16": (cuda_chain.lanes_chain_16, cuda_chain.lanes_chain_16_plain,
                       "scripts/bench_roofline.py:222", "cuda_lanes_pad16", 128, roofline.T_PAD, 16,
                       torch.float32, 67e12),
}
# The three earlier paths keep the entry names they had.
OLD_NAMES = {
    ("quadrotor", "gp_posterior"): "gp_posterior", ("quadrotor", "tighten"): "tighten",
    ("quadrotor", "linearize"): "linearize", ("quadrotor", "qp"): "ocp_ip",
    ("cartpole", "gp_posterior"): "gp_posterior[cartpole]", ("cartpole", "tighten"): "tighten[4x1]",
    ("cartpole", "linearize"): "linearize[cartpole]", ("cartpole", "qp"): "ocp_ip[4x1]",
    ("twolink", "gp_posterior"): "gp_posterior[D6]", ("twolink", "tighten"): "tighten[4x2]",
    ("twolink", "linearize"): "linearize[twolink]", ("twolink", "qp"): "ocp_ip[4x2]",
}


def say(msg: str) -> None:
    print(msg, flush=True)


def ptxas_entries(log: str) -> list[dict]:
    """ptxas's report of each kernel in the build's log: source, mangled
    entry, registers, stack frame and spill bytes."""
    entries, source = [], None
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif m := re.search(r"Compiling entry function '(\S+)'", line):
            entries.append(dict(source=source, entry=m.group(1), registers=None, stack=0,
                                spill_stores=0, spill_loads=0))
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads", line)) and entries:
            entries[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entries:
            entries[-1]["registers"] = int(m.group(1))
    return entries


def chain_kernel_number(entry: str) -> int | None:
    """7, 8 or 9 for the mangled name of a lane chain kernel, else None."""
    if "team_chain16_kernel" in entry:
        return 9
    if "chain_kernel" in entry:
        return 8 if "Bf16x2" in entry else 7
    return None


def qp_source(wrapper_name: str, soft: bool) -> str:
    return f"gpmpc_tpu_torch/csrc/{wrapper_name}{'_soft' if soft else ''}.cu"


# the paths whose QP entry is named after its wrapper alone (the first to reach it)
QP_NAMED_BY_WRAPPER = ("soft", "T100", "soft-T360")


def entry_name(path_name: str, kernel: str) -> str:
    """Name of the JSON entry of `kernel` ('gp_posterior', 'tighten',
    'linearize' or 'qp') on a path."""
    p = PATHS[path_name]
    if p.tag is None:
        return OLD_NAMES[(path_name, kernel)]
    if kernel == "qp" and p.tag in QP_NAMED_BY_WRAPPER:
        return f"{p.qp}{'_soft' if p.soft else ''}"
    return f"{p.qp if kernel == 'qp' else kernel}[{p.tag}]"


# ---- the least time the card could take ----------------------------------------

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


class Bound(NamedTuple):
    """max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) of one call: every
    input read once and every output written once, and the float32
    operations of the call's matrix and vector products (an FMA is two;
    elementwise barrier terms, square roots and exponentials beyond one per
    kernel evaluation are left out, so the bound stays a lower one)."""

    ms: float
    by: str
    bytes: int
    flops: int
    counted: str = ""  # which formulation's operations, where a function has two


def bound(n_bytes: int, flops: int, counted: str = "") -> Bound:
    t_b, t_f = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS
    return Bound(1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations", int(n_bytes),
                 int(flops), counted)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def bound_gp(args, out) -> Bound:
    """Per GP of the launch, N queries against its M live points in D dims:
    the kernel vector (3 D + 2 per pair), the mean (2 M) and the variance's
    quadratic form (2 M^2 + 2 M). The packed form pads each GP's points to
    a multiple of 8 with a zero mask; padded, masked points are no work, so
    both operations and bytes count the live ones (Z, alpha and the M x M
    form at their live size, the queries, the hyperparameters, mean and
    variance)."""
    z, form = args[:2]
    g, n, d = z.shape
    n_bytes, flops = 0, 0
    for m in (int((form.mask[i] != 0).sum()) for i in range(g)):
        n_bytes += 4 * (n * d + m * d + m + m * m + d + 2 + 2 * n)
        flops += n * (2 * m * m + m * (3 * d + 6))
    return bound(n_bytes, flops)


def bound_tighten(args, out) -> Bound:
    """The operations of whichever formulation of the same function is
    cheaper at the shape. The recursion, per scenario and stage: Acl cov as
    one nx^3 product (Acl = A + B K is shared and not counted), the upper
    triangle of the symmetric (Acl cov) Acl^T (nx^2 (nx+1) / 2 FMAs), the
    diagonal of K cov K^T from cov's upper triangle (nx (nx+1) / 2 FMAs per
    input, the products of K's entries shared) and the nd disturbance terms.
    The direct form, per scenario: the triangular sums over (j, q) of the nx
    state rows at k = 0..T and of the nu input rows at k = 0..T-1 (the
    weights are shared by all scenarios and not counted). An FMA is two
    operations."""
    b, t, nd = args[0].shape
    nx, nu = args[2].shape
    recursion = b * t * (2 * nx**3 + nx * nx * (nx + 1) + nu * nx * (nx + 1) + nd)
    direct = b * nd * (nx * t * (t + 1) + nu * t * (t - 1))
    flops, counted = (direct, "direct form") if direct <= recursion else (recursion, "recursion")
    return bound(tensor_bytes(*args, *out), flops, counted)


def tighten_library_ms(args) -> float:
    """The yardstick of kernel 2: one torch.matmul (float32, TF32 off) of the
    diagonals (B, T nd) by the direct form's expanded weight matrix
    (T nd, (T+1) nx + T nu), which gives the same variances; timed at the
    call's shapes, the matrix formed beforehand. The port never calls it."""
    cov_dn, Ad, Bd_in, lqr_gain, Bd = args[:5]
    b, t, nd = cov_dn.shape
    nx = Ad.shape[0]
    M = cuda_tighten.expanded_weights(cuda_tighten.tighten_weights_plain(Ad, Bd_in, lqr_gain, Bd, t))
    M = M[:, : t * (nx + Bd_in.shape[1]) + nx].contiguous()  # no input columns at k = T
    D = cov_dn.reshape(b, t * nd)
    return timed(lambda: torch.matmul(D, M))[0]


def gp_library_ms(args, tiled: bool | None = None) -> float:
    """The yardstick of kernel 1: one torch.matmul of the kernel rows k
    (G, N, M) by W (G, M, M), k formed beforehand, which gives the quadratic
    form's products; in float64 (cuBLAS DGEMM, the tiled kernel's
    precision) where the call takes the tiled kernel (`tiled`, by default
    as the wrapper picks it by M), else in float32 with TF32 off. The port
    never calls it."""
    z, form = args[:2]
    G, _, D = z.shape
    if tiled is None:
        tiled = cuda_gp.gp_geometry(form.Z.shape[1], D).bucket == 0
    dtype = torch.float64 if tiled else torch.float32
    k = torch.stack([gp_mod.se_kernel(z[g], form.Z[g], form.lengthscale[g], form.outputscale[g])
                     * form.mask[g] for g in range(G)]).to(dtype)
    W = form.W.to(dtype)
    return timed(lambda: torch.matmul(k, W))[0]


# nonzeros of the continuous-time Jacobians (Jx, Ju) of each family's closure
JAC_NNZ = {"quadrotor": (18, 5), "cartpole": (7, 2), "twolink": (10, 4)}


def bound_linearize(args, kw, out) -> Bound:
    """Per scenario and stage, four closure evaluations (G GPs x Ms points:
    6 D + 4 each for the mean and its gradient) and three chain products of
    the sparse closure Jacobian with an nx x (nx + nu) block."""
    _, hyp, zs, _, x, u = args
    n, tp1, nx, lanes = x.shape
    nu = u.shape[2]
    g, ms, d = zs.shape
    jx, _ = JAC_NNZ[kw["family"]]
    per_stage = 4 * g * ms * (6 * d + 4) * bool(kw["use_gp"]) + 3 * 2 * jx * (nx + nu)
    return bound(tensor_bytes(*args, *out), n * lanes * (tp1 - 1) * per_stage)


def bound_ocp(qp, kw, out, iterations: torch.Tensor) -> Bound:
    """Per scenario, stage and interior-point iteration the tile really ran
    (`iterations`, (n_tiles,), from the kernel): one Riccati factorization
    (W = P [A|B]; of [A|B]^T W the upper triangles of the symmetric Gxx and
    Guu, and Gxu; the nu x nu Cholesky; the gains; the upper triangle of the
    symmetric P + Gxu K; P r and the gradients; the dynamics residual) and
    one rollout; Mehrotra adds the corrector's vector sweep and rollout. The
    second factorization of the streamed kernels is their design's cost, not
    the function's, and is not counted."""
    n, t, nx, _, lanes = qp.A.shape
    nu = qp.B.shape[3]
    rollout = 2 * nx * (nx + nu) + 2 * nu * nx
    factor = (2 * nx * nx * (nx + nu)  # W
              + nx * nx * (nx + 1) + 2 * nx * nx * nu + nx * nu * (nu + 1)  # Gxx, Gxu, Guu
              + nu**3 // 3 + 2 * nu * nu * nx  # Cholesky, gains
              + nx * (nx + 1) * nu  # P + Gxu K
              + 2 * nx * nx + 2 * nx * (nx + nu) + 2 * nx * nu  # P r, gradients
              + 2 * nx * (nx + nu))  # dynamics residual
    vector = 2 * nx * (nx + nu) + 2 * nu * nu + 2 * nx * nu
    per_stage = factor + rollout + (vector + rollout if kw.get("mehrotra") else 0)
    return bound(tensor_bytes(*qp, *out), int(iterations.sum()) * lanes * t * per_stage)


# ---- the paths -------------------------------------------------------------------


class Problem:
    """One path's controller, GP and plant."""

    def __init__(self, path_name: str, device, gp_edit=None, analytic_jac=False, batch=None):
        self.path_name, self.path = path_name, PATHS[path_name]
        p, c = self.path, FAMILIES[PATHS[path_name].family]
        self.family, self.env = p.family, c["env"]
        self.env_p = self.env.EnvParams.default()
        self.model = c["model"]()
        gp_kw = {}
        if p.learned:
            n_ind, cap = LEARNED[path_name][:2]
            gp_kw = dict(sparse_gp=True, max_gp_samples=n_ind, max_gp_points=cap, seed=1)
        ctrl = gpmpc_mod.GPMPC(
            self.model, self.env.make_trajectory(self.env_p, device).cpu().numpy(), c["prior"],
            horizon=p.T, q_mpc=c["q_mpc"], r_mpc=c["r_mpc"], prob=0.95, sqp_iters=6, qp_iters=10,
            device=device, bounds=c["bounds"], lm_reg=c["lm_reg"], soft_constraints=p.soft, **gp_kw,
        )
        self.consts, self.ctrl = ctrl.consts, ctrl
        self.cfg = ctrl.cfg._replace(qp_tol=1e-6, kernel_linearize=p.kernel_linearize,
                                     qp_mehrotra=True, analytic_jac=analytic_jac)
        self.device = device
        if not p.learned:
            self.gp = convert.load_bench_gp(device, p.family)
        elif device.type == "cuda":
            self.gp = learned_gp(self, ctrl)
        else:  # phase 3 of a learned path: the card's trained GP, on the CPU
            self.gp = bench_torch.gp_to(TRAINED[path_name], device)
        if gp_edit is not None:
            self.gp = gp_edit(self.gp)
        if p.population:
            self.gp = population_gp(self.gp, p.B, batch or p.B)
        self.rates = {}
        self.decision = dispatch_decision(self.cfg, self.model.residual_spec, p.T, p.population,
                                          p.backend)
        if (self.decision.path, self.decision.degraded) != (p.dispatch, p.degraded):
            raise RuntimeError(f"{path_name}: dispatch decision {self.decision}, expected "
                               f"{p.dispatch} (degraded={p.degraded})")

    def reset(self, batch: int, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        es, obs = self.env.env_reset(self.env_p, batch, gen, self.device)
        st = mpc_mod.init_state(batch, self.path.T, self.model.nx, self.model.nu, device=self.device)
        return es, obs, st

    def step(self, st, obs, lanes=None):
        if self.path.nominal:
            return mpc_mod.select_action(self.model, self.cfg, self.consts.mpc, st, obs)
        return batched_gpmpc_step(self.model, self.cfg, self.consts, self.gp, st, obs,
                                  backend=self.path.backend, lanes=lanes or LANES)


TRAINED: dict = {}  # the learned paths' GPs, trained on the card


def cuda_timed(fn):
    """(seconds between CUDA events around one call of fn, its result)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def learned_gp(prob: Problem, ctrl):
    """The GP of a learned path, trained on the card: episodes of the untrained
    controller (zero GP mean, no tightening: the prior controller) through
    `batched_episode` at the path's B, a sample of their transitions,
    `preprocess_data`, `train_gp`. Prints the fit's time, its Adam
    iterations and freeze steps, and (at 128 points or fewer) the largest
    raw-hyperparameter difference from a float32 fit of the same data on the
    CPU with its freeze steps."""
    name, path, dev = prob.path_name, prob.path, prob.device
    n_ind, cap, steps, keep, iters = LEARNED[name]
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    ep = batch_mod.batched_episode(prob.model, prob.cfg, prob.env_p, prob.consts, ctrl.gp_model, gen,
                                   steps, path.B, env_mod=prob.env, backend="lanes")
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    x = ep.obs[:, :-1].reshape(-1, prob.model.nx)
    u = ep.actions.reshape(-1, prob.model.nu)
    x_next = ep.obs[:, 1:].reshape(-1, prob.model.nx)
    pick = torch.randperm(x.shape[0], generator=gen, device=dev)[:keep]
    xi, ti = ctrl.preprocess_data(x[pick].cpu().numpy(), u[pick].cpu().numpy(),
                                  x_next[pick].cpu().numpy())
    fit_s, _ = cuda_timed(lambda: ctrl.train_gp(xi, ti, lr=0.05, iterations=iters))
    info = ctrl.last_fit_info
    say(f"[learn] {name}: {steps} steps of the untrained controller at B={path.B} in "
        f"{collect_s:.2f} s, {keep} of {x.shape[0]} transitions kept; train_gp(lr=0.05, "
        f"iterations={iters}) on {keep} points (capacity {cap}, {n_ind} FITC points): "
        f"{fit_s:.3f} s, {info.iterations} Adam iterations until every GP froze (freeze steps "
        f"{info.freeze_step.tolist()}), {1e3 * fit_s / info.iterations:.2f} ms an iteration "
        "(CUDA events, the FITC posterior included)")
    if keep <= 128:
        cpu = torch.device("cpu")
        data = gpmpc_mod.pack_training_data(torch.as_tensor(xi), torch.as_tensor(ti), cap,
                                            prob.model.residual_spec)
        h_cpu, _, info_cpu = gp_mod.fit_gp(
            data, gp_mod.init_hypers(device=cpu, batch_shape=(data.y.shape[0],)), iters, 0.05,
            return_info=True)
        diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(ctrl.gp_model.hypers, h_cpu))
        say(f"[learn] {name}: max |raw hyper, card - CPU float32 fit of the same data| = "
            f"{diff:.3e}; freeze steps card {info.freeze_step.tolist()}, CPU "
            f"{info_cpu.freeze_step.tolist()}")
    gp = ctrl.gp_model
    if not all(bool(torch.isfinite(t).all()) for t in (gp.alpha_s, gp.var_mat, *gp.hypers)):
        raise RuntimeError(f"{name}: the trained GP is not finite")
    TRAINED[name] = gp
    return gp


def population_gp(gp, n_scenarios: int, n_keep: int, seed: int = 0):
    """The first `n_keep` scenarios of a population of `n_scenarios` GPs on
    `gp`'s device: every leaf gets a leading scenario axis, and each
    scenario's `alpha_s` (x (1 + 0.1 n)) and raw hyperparameters (+ 0.02 n)
    are perturbed from a seeded generator, so the scenarios differ. The
    factors are drawn on the host (a few thousand numbers, the same for the
    card's run and the CPU's), the leaves are expanded on the device."""
    gen = torch.Generator().manual_seed(seed)
    dev = gp.Zs.device
    noise = lambda t, s: (s * torch.randn((n_scenarios,) + tuple(t.shape), generator=gen))[  # noqa: E731
        :n_keep].to(dev)
    rep = lambda t: t[None].expand((n_keep,) + tuple(t.shape)).contiguous()  # noqa: E731
    alpha = rep(gp.alpha_s) * (1.0 + noise(gp.alpha_s, 0.1))
    hypers = type(gp.hypers)(*[rep(h) + noise(h, 0.02) for h in gp.hypers])
    leaves = {k: rep(v) for k, v in gp._asdict().items() if k != "hypers"}
    return gp._replace(**dict(leaves, alpha_s=alpha), hypers=hypers)


def timed(fn, plain: bool = False):
    """(median ms of single calls each bracketed by CUDA events, number of
    timed runs, the last call's outputs). A warm-up call comes first; the
    number of runs follows its time: 21 below 50 ms, 5 below 1 s, else 1.
    A plain version (`plain`), whose time is no yardstick, runs 5 times
    below 50 ms, once more below 1 s, and past 1 s its warm-up call is the
    time (0 runs)."""

    def once():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    warm, out = once()
    if plain:
        runs = 5 if warm < 50 else 1 if warm < 1000 else 0
    else:
        runs = 21 if warm < 50 else 5 if warm < 1000 else 1
    times = [] if runs else [warm]
    for _ in range(runs):
        ms, out = once()
        times.append(ms)
    return statistics.median(times), runs, out


def runs_text(runs: int) -> str:
    return f"median of {runs}" if runs else "its warm-up call"


def device_ms(fn, runs: int = 10) -> float:
    """Device time of one call of `fn`: CUDA events around `runs` calls that
    the card runs back to back, divided by `runs`. A spin kernel
    (`torch.cuda._sleep`) keeps the card busy while the host enqueues the
    calls, so the events hold the kernels and the gaps between them but not
    the host's work around each launch, which a pair of events around a
    single call also holds (`timed`: the card waits for the host there once
    a kernel is short). The spin lasts 1.5x the host's time to enqueue the
    calls (measured on a warm call), at most 50 ms, plus 1 ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (min(1.5 * runs * enqueue_s, 0.05) + 1e-3)))  # ~2 GHz clock
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


class Capture:
    """Records the arguments of the first call of each kernel wrapper while
    enabled (of the last call with `last=True`), by wrapping the names the
    consumer modules call."""

    def __init__(self, path: SmokePath, last: bool = False):
        qp_attr = QP_WRAPPERS[path.qp][0].__name__
        sites = {
            "gp_posterior": (gpmpc_mod, "gp_mean_var_multi"),
            "tighten": (gpmpc_mod, "tighten_lanes"),
            "linearize": (sqp_lanes, "linearize_ocp_lanes"),
            "qp": (sqp_lanes, qp_attr),
        }
        self.sites = [sites[name] + (name,) for name in path.kernels]
        self.args = {}
        self.last = last
        self._orig = []

    def __enter__(self):
        for mod, attr, name in self.sites:
            orig = getattr(mod, attr)
            self._orig.append((mod, attr, orig))

            def wrapper(*a, _orig=orig, _name=name, **k):
                if self.last or _name not in self.args:
                    clone = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
                    a_c = tuple(
                        type(v)(*map(clone, v)) if isinstance(v, tuple) and hasattr(v, "_fields")
                        else clone(v) for v in a
                    )
                    self.args[_name] = (a_c, dict(k))
                return _orig(*a, **k)

            setattr(mod, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._orig:
            setattr(mod, attr, orig)


def tolerance_check(kind, out_k, out_p) -> tuple[float, bool]:
    """Max abs difference over the outputs that carry the kernel's result
    (for the QP kernels the solution; the gap is a diagnostic), and whether
    it is within the tolerance of `kind` (a TOL_TEXT key)."""
    if kind in ("ocp", "ocp_soft"):
        out_k, out_p = out_k[:2], out_p[:2]
    err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    if not all(bool(torch.isfinite(o).all()) for o in out_k):
        return float("nan"), False
    if kind == "linearize":
        ok = (float((out_k[0] - out_p[0]).abs().max()) <= TOL["linearize_fnext"]
              and max(float((a - b).abs().max()) for a, b in zip(out_k[1:], out_p[1:]))
              <= TOL["linearize_jac"])
        return err, ok
    if kind == "tighten":
        scale = max(float(o.abs().max()) for o in out_p)
        return err, err <= TOL["tighten"] * max(scale, 1.0)
    return err, err <= TOL["gp" if kind == "gp_posterior" else kind]


def _tile_drops(kk, W, alpha):
    """The largest effect of dropping one piece of a GP's form, per piece, in
    float64: for each TILE_ROWS x TILE_COLS tile of W (the tiled kernel's
    tile) max over queries |sum over the tile of k_i W_ij k_j|, and for each
    TILE_ROWS block of alpha max over queries |sum over the block of k_i
    alpha_i|. kk (N, M), W (M, M), alpha (M,): (W tiles (M/TI, M/TJ), alpha
    blocks (M/TI,)), M padded with zeros to whole tiles."""
    TI, TJ = cuda_gp.TILE_ROWS, cuda_gp.TILE_COLS
    n, M = kk.shape
    P = -(-M // TJ) * TJ
    kp = torch.nn.functional.pad(kk, (0, P - M))
    Wp = torch.nn.functional.pad(W, (0, P - M, 0, P - M))
    kI = kp.view(n, P // TI, TI)
    tiles = torch.stack([
        (torch.einsum("nIi,Iij->nIj", kI, Wp.view(P // TI, TI, P)[:, :, j0:j0 + TJ])
         * kp[:, None, j0:j0 + TJ]).sum(-1).abs().amax(0)
        for j0 in range(0, P, TJ)], dim=1)
    blocks = (kI * torch.nn.functional.pad(alpha, (0, P - M)).view(P // TI, TI)).sum(-1).abs().amax(0)
    return tiles, blocks


def _k32_f64_sums(z, form, include_noise=False):
    """`gp_mean_var_multi_plain` with k in float32, as the plain version and
    the kernels compute it, and every sum in float64: the float32 rounding
    of k alone, which any evaluation from float32 k carries. Float64
    (mean (G, N), var (G, N))."""
    means, vars_ = [], []
    for g in range(z.shape[0]):
        kk = (gp_mod.se_kernel(z[g], form.Z[g], form.lengthscale[g], form.outputscale[g])
              * form.mask[g]).double()
        means.append(kk @ form.alpha[g].double())
        v = torch.clamp_min(form.outputscale[g].double() - ((kk @ form.W[g].double()) * kk).sum(-1),
                            1e-12)
        vars_.append(v + form.noise[g].double() if include_noise else v)
    return torch.stack(means), torch.stack(vars_)


def gp_f64_check(entry, label, a, k, out_k, out_p) -> tuple[float, bool]:
    """Kernel 1 against the float64 value of its own float32 inputs, where
    float32 sums cancel past what 1e-4 from the plain version can hold: the
    tiled instantiation (F7) and GPs trained here, whose W at the noise
    floor (entries ~1/noise) cancels in k W k^T. Per output (mean,
    variance), the kernel lies within 1e-4 + d of the float64 value, with d
    the largest distance from it of the evaluation in the instantiation's
    own arithmetic: for the register instantiations (float32 sums) the plain
    version's (tests/test_torch_kernels_gpu.py's rule), for the tiled one
    (float64 sums) `_k32_f64_sums`'s, the rounding of k alone, since the
    plain version's float32 sums can be off by the whole variance there. The
    bar's power on the same inputs: planted faults, evaluated in float64,
    must fall outside it (the variance with the whole k W k^T term dropped
    and with the W tile of the largest effect dropped, the mean with the
    alpha block of the largest effect dropped, in each GP; the least reading
    over the GPs counts), or the run fails; the share of all single W-tile
    drops the bar rejects is printed. (max |kernel - plain|, ok)."""
    z, form = a[:2]
    G, _, D = z.shape
    tiled = cuda_gp.gp_geometry(form.Z.shape[1], D).bucket == 0
    f64 = cuda_gp.GpForm(*[t.double() for t in form])
    z64 = z.double()
    evaluate = lambda f: cuda_gp.gp_mean_var_multi_plain(z64, f, **k)  # noqa: E731
    out_64 = evaluate(f64)
    dist = lambda x, y: float((x.double() - y.double()).abs().max())  # noqa: E731
    d_plain = [dist(p, r) for p, r in zip(out_p, out_64)]
    d_k32 = [dist(p, r) for p, r in zip(_k32_f64_sums(z, form, **k), out_64)]
    bars = [1e-4 + d for d in (d_k32 if tiled else d_plain)]
    errs = [dist(x, r) for x, r in zip(out_k, out_64)]
    # planted faults, each GP's own
    W_tile, alpha_block = f64.W.clone(), f64.alpha.clone()
    rejected, tiles_n = 0, 0
    TI, TJ = cuda_gp.TILE_ROWS, cuda_gp.TILE_COLS
    for g in range(G):
        kk = gp_mod.se_kernel(z64[g], f64.Z[g], f64.lengthscale[g], f64.outputscale[g]) * f64.mask[g]
        tiles, blocks = _tile_drops(kk, f64.W[g], f64.alpha[g])
        live = tiles > 0
        tiles_n += int(live.sum())
        rejected += int((tiles[live] > bars[1]).sum())
        I, J = divmod(int(tiles.argmax()), tiles.shape[1])
        W_tile[g, I * TI:(I + 1) * TI, J * TJ:(J + 1) * TJ] = 0.0
        alpha_block[g, int(blocks.argmax()) * TI:(int(blocks.argmax()) + 1) * TI] = 0.0
    # each GP's fault shows in its own outputs: the least of the GPs' readings
    least = lambda x, y: min(float((x[g] - y[g]).abs().max()) for g in range(G))  # noqa: E731
    faults = {
        "k W k^T dropped": least(evaluate(f64._replace(W=torch.zeros_like(f64.W)))[1], out_64[1]),
        "largest W tile dropped": least(evaluate(f64._replace(W=W_tile))[1], out_64[1]),
        "largest alpha block dropped": least(evaluate(f64._replace(alpha=alpha_block))[0],
                                             out_64[0]),
    }
    fault_bars = {"k W k^T dropped": bars[1], "largest W tile dropped": bars[1],
                  "largest alpha block dropped": bars[0]}
    err = max(dist(x, p) for x, p in zip(out_k, out_p))
    say(f"[phase 1] {entry:28s} {label:12s}: max|kernel - float64| mean {errs[0]:.3e}, var "
        f"{errs[1]:.3e}; the plain version's own mean {d_plain[0]:.3e}, var {d_plain[1]:.3e}; "
        f"k's rounding alone mean {d_k32[0]:.3e}, var {d_k32[1]:.3e}; bar 1e-4 + the "
        f"{'latter' if tiled else 'former'}: mean {bars[0]:.3e}, var {bars[1]:.3e}; planted "
        "faults read "
        + ", ".join(f"{name} {v:.3e} ({v / fault_bars[name]:.3g} bars)" for name, v in faults.items())
        + f"; single W-tile drops rejected: {rejected} of {tiles_n}")
    accepted = [name for name, v in faults.items() if not v > fault_bars[name]]
    if accepted:
        say(f"[phase 1] {entry:28s} {label:12s}: the bar accepts the planted faults {accepted}")
    ok = (all(bool(torch.isfinite(o).all()) for o in out_k)
          and all(e <= b for e, b in zip(errs, bars)) and not accepted)
    return err, ok


def random_qp(dev, n_tiles, T, nx, nu, seed, box=1.5, scale=1.0) -> cuda_ocp.LanesQp:
    """QP data as in tests/test_pallas_ocp.py::make_batch: `scale` contracts
    the dynamics perturbation (long horizons), `box` bounds stages 1..T."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"), device=dev)  # noqa: E731
    shp = lambda *s: (n_tiles, T) + s + (LANES,)  # noqa: E731
    A = (np.eye(nx, dtype=np.float32)[None, None, :, :, None]
         + 0.1 * scale * rng.normal(size=shp(nx, nx)))
    lx = np.full((n_tiles, T + 1, nx, LANES), -box, np.float32)
    lx[:, 0] = -1e8
    return cuda_ocp.LanesQp(
        A=t(A), B=t(0.4 * rng.normal(size=shp(nx, nu))), r=t(0.05 * rng.normal(size=shp(nx))),
        qdiag=t(rng.uniform(0.5, 2.0, (n_tiles, T + 1, nx, LANES))),
        qx=t(0.5 * rng.normal(size=(n_tiles, T + 1, nx, LANES))),
        rdiag=t(rng.uniform(0.5, 2.0, shp(nu))), ru=t(0.5 * rng.normal(size=shp(nu))),
        lx=t(lx), ux=t(-lx), lu=t(np.full(shp(nu), -0.3)), uu=t(np.full(shp(nu), 0.3)),
    )


def random_qp_call(dev, n_tiles, T, nx, nu, soft: bool, seed=0):
    """(args, kwargs) of a QP wrapper on random data at the main path's
    solver settings. Soft: boxes of +-0.15 and a penalty below the hard
    multipliers (2 at 12x4, 0.5 at the narrow widths) force violations."""
    scale = 1.0 if T <= 50 else 0.3 if T <= 100 else 0.1 if T <= 400 else 0.05
    kw = {"n_ip": 10, "adaptive_tol": 1e-6, "mehrotra": True}
    if soft:
        kw["soft_rho"] = 2.0 if nx == 12 else 0.5
    return (random_qp(dev, n_tiles, T, nx, nu, seed, 0.15 if soft else 1.5, scale),), kw


def random_inputs(prob: Problem, T: int):
    """Seeded random inputs of the path's kernels at the path's shapes and
    horizon T (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    dev, B = prob.device, prob.path.B
    t = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"), device=dev)  # noqa: E731
    gp, consts, model = prob.gp, prob.consts, prob.model
    nx, nu = model.nx, model.nu
    n_tiles = B // LANES
    inputs = {}
    # kernel 2: disturbance diagonals in the range a trained GP produces
    inputs["tighten"] = (
        (t(rng.uniform(1e-6, 4e-4, (B, T, consts.Bd.shape[1]))), consts.Ad, consts.Bd_in,
         consts.lqr_gain, consts.Bd, consts.inverse_cdf),
        {},
    )
    inputs["qp"] = random_qp_call(dev, n_tiles, T, nx, nu, prob.path.soft is not None)
    if prob.path.population:
        return inputs
    G, _, D = gp.Zs.shape
    # kernel 1: N = B*T queries per GP against the GPs' packed variance forms
    inputs["gp_posterior"] = ((t(rng.normal(0, 0.4, (G, B * T, D))), gpmpc_mod.variance_form(gp)),
                              {})
    # kernel 3: states and inputs as tests/test_pallas_linearize.py draws them
    xs, us = (n_tiles, T + 1, LANES), (n_tiles, T, LANES)
    if prob.family == "quadrotor":
        X = rng.normal(0, 0.3, (n_tiles, T + 1, nx, LANES))
        U = np.stack([rng.uniform(0.15, 0.55, us)] + [rng.uniform(-0.3, 0.3, us) for _ in range(3)],
                     axis=2)
    elif prob.family == "cartpole":
        X = rng.normal(0, 0.3, (n_tiles, T + 1, nx, LANES))
        U = rng.uniform(-5.0, 5.0, (n_tiles, T, nu, LANES))
    else:
        X = np.stack([rng.uniform(-2.0, 0.2, xs), rng.uniform(-0.4, 1.8, xs),
                      rng.normal(0, 0.8, xs), rng.normal(0, 0.8, xs)], axis=2)
        U = rng.uniform(-12.0, 12.0, (n_tiles, T, nu, LANES))
    ell = gpmpc_mod.softplus(gp.hypers.raw_lengthscale)
    sf2 = gpmpc_mod.softplus(gp.hypers.raw_outputscale)
    hyp = torch.cat([sf2[:, None], (1.0 / ell**2)[:, None].expand(G, D)], dim=1).contiguous()
    par8 = model.residual_spec.kernel_params(model.params).to(dev)
    inputs["linearize"] = ((par8, hyp, gp.Zs, gp.alpha_s, t(X), t(U)),
                           {"dt": 0.02, "use_gp": True, "family": prob.family})
    return inputs


def compare(entry, label, kind, fn, plain, a, k, time_plain=True, live_lanes=None):
    """One kernel-vs-plain comparison on the card; raises on disagreement.
    Returns (max abs err, kernel ms, plain ms or None, kernel outputs, the
    kernel's device ms or None); the times when `time_plain`. With
    `live_lanes`, a QP's solution is compared on its first lanes only: the
    lanes past a batch (zero-padded scenarios, whose boxes are [0, 0]) carry
    no solution on either side."""
    ms_k, runs_k, out_k = timed(lambda: fn(*a, **k))
    if time_plain:
        ms_p, runs_p, out_p = timed(lambda: plain(*a, **k), plain=True)
        dev_ms = device_ms(lambda: fn(*a, **k), runs=10 if ms_k < 50 else 2)
    else:
        ms_p, runs_p, out_p, dev_ms = None, 0, plain(*a, **k), None
        torch.cuda.synchronize()
    if kind == "gp_posterior_f64":
        err, ok = gp_f64_check(entry, label, a, k, out_k, out_p)
    elif live_lanes is not None:
        err, ok = tolerance_check(kind, [o[..., :live_lanes] for o in out_k[:2]],
                                  [o[..., :live_lanes] for o in out_p[:2]])
    else:
        err, ok = tolerance_check(kind, out_k, out_p)
    if kind in ("ocp", "ocp_soft"):
        # per-tile IP iterations; kernels 5 and 6 must run exactly the plain version's
        its_k, its_p = fn.last_iterations.tolist(), plain.last_iterations.tolist()
        say(f"[phase 1] {entry:28s} {label:12s}: IP iterations per tile, kernel {its_k}, plain "
            f"{its_p}")
        if fn in COUNTS_GATED and its_k != its_p:
            raise RuntimeError(f"{entry}: per-tile IP iterations differ from the plain version's")
    times = f"kernel {ms_k:.4f} ms (median of {runs_k})"
    if time_plain:
        times += f", on the device {dev_ms:.4f} ms, plain {ms_p:.4f} ms ({runs_text(runs_p)})"
    say(f"[phase 1] {entry:28s} {label:12s}: max|kernel - plain| = {err:.3e} "
        f"(tolerance {TOL_TEXT[kind]}) {'ok' if ok else 'FAIL'}; {times}")
    if not ok:
        raise RuntimeError(f"{entry}: kernel disagrees with its plain version ({label})")
    return err, ms_k, ms_p, out_k, dev_ms


def kernel_bound(name, fn, a, k, out) -> Bound:
    if name == "gp_posterior":
        return bound_gp(a, out)
    if name == "tighten":
        return bound_tighten(a, out)
    if name == "linearize":
        return bound_linearize(a, k, out)
    return bound_ocp(a[0], k, out, fn.last_iterations)


def result_entry(entry, source, replaces, err, ms_k, ms_p, bnd: Bound, launches=0,
                 library_ms=None, dev_ms=None):
    """The entry of the JSON line: `ms` is the CUDA-event time of a call (as
    in every earlier run), `device_ms` its kernels' time on the card with
    the calls back to back (`device_ms`)."""
    counted = f", the {bnd.counted}'s" if bnd.counted else ""
    library = "" if library_ms is None else f"; one library call {library_ms:.4f} ms"
    on_device = "" if dev_ms is None else f" ({100 * bnd.ms / dev_ms:.2f} % of its device time)"
    say(f"[phase 1] {entry:28s} bound {bnd.ms:.5f} ms by {bnd.by} ({bnd.bytes} bytes, "
        f"{bnd.flops} operations{counted}): the kernel reaches {100 * bnd.ms / ms_k:.2f} % of "
        f"it{on_device}{library}")
    return dict(name=entry, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=bnd.ms, bound_by=bnd.by,
                library_ms=library_ms, device_ms=dev_ms)


def check_kernels(prob: Problem, results: dict, captured: dict) -> None:
    """Phase 1 for one path: every kernel of the path against its plain
    version, on the first warm-started step's inputs and on random ones."""
    path = prob.path
    es, obs, st = prob.reset(path.B, seed=0)
    u, st, _ = prob.step(st, obs)
    es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    with Capture(path) as cap:  # the first warm-started step
        prob.step(st, obs)
    torch.cuda.synchronize()
    missing = set(path.kernels) - set(cap.args)
    if missing:
        raise RuntimeError(f"{prob.path_name}: warm-started step launched no {sorted(missing)}")
    captured[prob.path_name] = cap.args
    soft = path.soft is not None
    random_Ts = (path.T, 400) if path.T == 360 else (path.T,)
    rand = {T: random_inputs(prob, T) for T in random_Ts}
    for name in path.kernels:
        entry = entry_name(prob.path_name, name)
        if name == "qp":
            fn, plain, replaces = QP_WRAPPERS[path.qp]
            src, kind = qp_source(path.qp, soft), "ocp_soft" if soft else "ocp"
        else:
            fn, plain, src, replaces = KERNELS[name]
            # a GP trained here sits at its noise floor, where float32 itself is off by ~1e-4
            kind = "gp_posterior_f64" if name == "gp_posterior" and path.learned else name
            if name == "linearize":
                replaces = LINEARIZE_CLOSURES.get(prob.family, replaces)
        a, k = cap.args[name]
        worst, ms_k, ms_p, out_k, dev_ms = compare(entry, "real step", kind, fn, plain, a, k)
        bnd = kernel_bound(name, fn, a, k, out_k)
        for T in random_Ts:
            if name == "qp" and (T != path.T or path.T > sqp_lanes.MAX_FUSED_HORIZON):
                continue  # the QP kernels' caps have their own checks (T=512: the T=1024 one)
            a_r, k_r = rand[T][name]
            label = "random" if T == path.T else f"random T={T}"
            worst = max(worst, compare(entry, label, kind, fn, plain, a_r, k_r, time_plain=False)[0])
        # kernels 1 and 2's yardsticks; no single PyTorch call computes kernel 3 or the QP
        library_ms = (tighten_library_ms(a) if name == "tighten" else gp_library_ms(a)
                      if name == "gp_posterior" else None)
        results[entry] = result_entry(entry, src, replaces, worst, ms_k, ms_p, bnd,
                                      library_ms=library_ms, dev_ms=dev_ms)
        prob.rates[name] = bnd.flops / (1e-3 * ms_k)  # operations/s the kernel reached


def random_gp_leaves(G: int, D: int, seed: int, m: int = 128, n_live: int = 40,
                     density: int | None = None):
    """G GPs of m padded points, `n_live` live ones each (fewer for later GPs)
    at scattered positions, so the live points are not a prefix; the masked
    points keep nonzero inputs and W entries (tests/test_torch_gp.py's
    make_multi). With `density`, the lengthscales shrink by
    (density / n_live)^(1/D), so that as many points lie within a
    lengthscale as `density` points would at the unscaled ones (W = K^-1 of
    a denser GP cancels more of the variance in every float32 sum). numpy,
    float32: (Z, alpha, W, lengthscale, outputscale, noise, mask)."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(G, m, D)).astype(np.float32)
    mask = np.zeros((G, m), np.float32)
    W = np.zeros((G, m, m), np.float32)
    alpha = np.zeros((G, m), np.float32)
    ell = np.linspace(0.7, 1.6, G * D).reshape(G, D)
    if density is not None:
        ell = ell * (density / n_live) ** (1.0 / D)
    ell = ell.astype(np.float32)
    sf2 = np.linspace(0.8, 1.5, G).astype(np.float32)
    noise = np.linspace(0.03, 0.08, G).astype(np.float32)
    for g in range(G):
        mask[g, np.sort(rng.choice(m, size=n_live - 3 * g, replace=False))] = 1.0
        diff = (Z[g][:, None, :] - Z[g][None, :, :]) / ell[g]
        K = sf2[g] * np.exp(-0.5 * (diff**2).sum(-1)) * np.outer(mask[g], mask[g])
        K += np.diag(noise[g] * mask[g] + (1 - mask[g]))
        W[g] = np.linalg.inv(K).astype(np.float32)
        alpha[g] = (W[g] @ (rng.normal(size=m) * mask[g])).astype(np.float32)
    return Z, alpha, W, ell, sf2, noise, mask


def check_gp_kernel_level(dev, extra: list, captured: dict) -> None:
    """Phase 1 for kernel 1 beyond the paths: the multi-GP kernel against its
    plain version at G = 2 and 3, D = 3 and 6, N = 25,637 (not a multiple of
    the 128-query tile), on GPs whose live points are not a prefix; the
    tiled kernel's DMMA fragment layout (`dmma_layout_check`); F7, past 128
    live points, where every case is also called once more and must give
    the same bits (its partials are summed in a fixed order, no atomics);
    then the tiled kernel on the learned paths' register-bucket GPs
    (`f64_sums_on_bucket_gps`). Prints the seconds each of the last four
    checks and the library yardsticks took."""
    fn, plain, src, replaces = KERNELS["gp_posterior"]
    n = 25_637
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    t_start = time.perf_counter()
    spent = dict.fromkeys(("library yardsticks", "DMMA layout", "second calls",
                           "float64 sums on the buckets' GPs"), 0.0)

    def lap(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[key] += time.perf_counter() - t0
        return out

    for G in (2, 3):
        for D in (3, 6):
            leaves = [t(a) for a in random_gp_leaves(G, D, seed=10 * G + D)]
            form = cuda_gp.pack_form(*leaves)
            z = t(np.random.default_rng(G + D).normal(0, 0.6, (G, n, D)).astype(np.float32))
            entry = f"gp_posterior_multi[G={G},D={D}]"
            a, k = (z, form), {"include_noise": True}
            err, ms_k, ms_p, out_k, dev_ms = compare(entry, f"M={form.Z.shape[1]}", "gp_posterior",
                                                     fn, plain, a, k)
            extra.append(result_entry(entry, src, replaces, err, ms_k, ms_p, bound_gp(a, out_k),
                                      library_ms=lap("library yardsticks", gp_library_ms, a),
                                      dev_ms=dev_ms))
    lap("DMMA layout", dmma_layout_check, dev)
    # F7: past 128 live points, the tiled instantiation (any M)
    for density in F7_DENSITIES:
        for G, D, m, n in F7_CASES:
            leaves = [t(a) for a in random_gp_leaves(G, D, seed=m + 10 * G + D, m=m + 16,
                                                     n_live=m, density=density)]
            form = cuda_gp.pack_form(*leaves)
            geometry = cuda_gp.gp_geometry(form.Z.shape[1], D)
            if geometry.bucket != 0:
                raise RuntimeError(f"M={form.Z.shape[1]}: expected the tiled instantiation, got "
                                   f"{geometry}")
            z = t(np.random.default_rng(m + G + D).normal(0, 0.6, (G, n, D)).astype(np.float32))
            scaled = "" if density is None else f",density={density}"
            entry = f"gp_posterior_tiled[G={G},D={D},M={m},N={n}{scaled}]"
            a, k = (z, form), {"include_noise": True}
            err, ms_k, ms_p, out_k, dev_ms = compare(entry, f"M={form.Z.shape[1]}",
                                                     "gp_posterior_f64", fn, plain, a, k)
            again = lap("second calls", lambda: fn(*a, **k))
            if not all(torch.equal(x, y) for x, y in zip(again, out_k)):
                raise RuntimeError(f"{entry}: two calls on the same inputs gave different bits")
            extra.append(result_entry(entry, src, replaces, err, ms_k, ms_p, bound_gp(a, out_k),
                                      library_ms=lap("library yardsticks", gp_library_ms, a),
                                      dev_ms=dev_ms))
    plan = cuda_gp.gp_tiled_plan(3, 4096, 2048, 3, cuda_gp.sm_count(dev))
    say(f"[phase 1] gp_posterior_tiled: every F7 case gave the same bits in two calls "
        f"(plan {plan} at M=2,048, N=4,096, G=3)")
    lap("float64 sums on the buckets' GPs", f64_sums_on_bucket_gps, captured, extra)
    say(f"[time] kernel 1's kernel-level checks took {time.perf_counter() - t_start:.1f} s, of "
        "which " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))


def dmma_layout_check(dev) -> None:
    """The tiled kernel's FP64 tensor-core fragments (`cuda_gp.dmma_probe`,
    one warp through the kernel's own fragment loads, K-slab columns and
    accumulator layout): exact products of identity and permutation blocks,
    which name the lane whose register lands anywhere else; a random
    product within 1e-13."""
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=dev)  # noqa: E731
    wrong = 0
    for a, b in cuda_gp.dmma_probe_cases():
        got, want = cuda_gp.dmma_probe(f64(a), f64(b)), f64(a @ b)
        wrong += int((got != want).sum())
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(32, cuda_gp.PROBE_K)), rng.normal(size=(cuda_gp.PROBE_K, cuda_gp.PROBE_N))
    err = float((cuda_gp.dmma_probe(f64(a), f64(b)) - f64(a @ b)).abs().max())
    say(f"[phase 1] gp_posterior_tiled DMMA layout: {wrong} entries of {3 * 32 * cuda_gp.PROBE_N} "
        f"wrong in the identity and permutation products (32 x {cuda_gp.PROBE_K} by "
        f"{cuda_gp.PROBE_K} x {cuda_gp.PROBE_N}); a random product {err:.3e} off (bar 1e-13)")
    if wrong or not err <= 1e-13:
        raise RuntimeError("the tiled GP kernel's DMMA fragments land in the wrong places")


def f64_sums_on_bucket_gps(captured: dict, extra: list) -> None:
    """The float64 sums of the tiled kernel on the register buckets' GPs,
    measured at kernel level only (no path switches): on `quadrotor-learned`'s
    and `quadrotor-gp5k`'s captured forms, each instantiation's distance from
    the float64 value of the same float32 inputs and its device ms, and the
    planted fault k W k^T dropped in bars of each."""
    fn, plain, src, replaces = KERNELS["gp_posterior"]
    for path_name in ("quadrotor-learned", "quadrotor-gp5k"):
        if "gp_posterior" not in captured.get(path_name, {}):
            continue
        (z, form), k = captured[path_name]["gp_posterior"][0][:2], captured[path_name]["gp_posterior"][1]
        f64 = cuda_gp.GpForm(*[x.double() for x in form])
        out_64 = cuda_gp.gp_mean_var_multi_plain(z.double(), f64, **k)
        no_quad = cuda_gp.gp_mean_var_multi_plain(z.double(), f64._replace(W=torch.zeros_like(f64.W)),
                                                  **k)[1]
        fault = min(float((no_quad[g] - out_64[1][g]).abs().max()) for g in range(z.shape[0]))
        dist = lambda o: [float((x.double() - y).abs().max()) for x, y in zip(o, out_64)]  # noqa: E731
        bucket = cuda_gp.gp_geometry(form.Z.shape[1], z.shape[2]).bucket
        rows = []
        for name, call in ((f"bucket {bucket}", lambda: fn(z, form, **k)),
                           ("tiled", lambda: fn(z, form, tiled=True, **k))):
            out = call()
            d = dist(out)
            ms = device_ms(call)
            rows.append((name, d, ms))
            say(f"[phase 1] {path_name} GP (G={z.shape[0]}, N={z.shape[1]}, M={form.Z.shape[1]}) "
                f"{name}: max|out - float64| mean {d[0]:.3e}, var {d[1]:.3e}; the dropped k W k^T "
                f"fault {fault:.3e} reads {fault / (1e-4 + d[1]):.3g} bars (1e-4 + its distance) "
                f"out; device {ms:.4f} ms")
            if name == "tiled":
                extra.append(result_entry(
                    f"gp_posterior_tiled[{path_name}]", src, replaces, max(d), timed(call)[0], None,
                    bound_gp((z, form), out), library_ms=gp_library_ms((z, form), tiled=True),
                    dev_ms=ms))
        say(f"[phase 1] {path_name} GP: float64 sums cost {rows[1][2] - rows[0][2]:+.4f} ms a launch "
            f"({rows[1][2] / rows[0][2]:.2f}x) and move the variance's distance from float64 from "
            f"{rows[0][1][1]:.3e} to {rows[1][1][1]:.3e}")


def check_kernel_level_only(dev, captured: dict, extra: list) -> None:
    """Phase 1 for the QP instantiations no path of this script reaches, on
    random inputs; tier 1 at B=1024 up to its caps; the other horizon caps;
    the resident kernel at B=256 on the quadrotor path's QP; the resident
    kernel beside tier 1 at T=100; the tightening kernel at T=512 and
    T=1024 (12x4, B=256)."""
    # kernel 2 at long horizons: the quadrotor path's matrices, random diagonals
    fn, plain, src, replaces = KERNELS["tighten"]
    mats = captured["quadrotor"]["tighten"][0][1:]
    for T in (512, 1024):
        rng = np.random.default_rng(T)
        cov_dn = torch.as_tensor(rng.uniform(1e-6, 4e-4, (256, T, mats[3].shape[1])),
                                 dtype=torch.float32, device=dev)
        a = (cov_dn,) + tuple(mats)
        entry = f"tighten[12x4,T={T}]"
        err, ms_k, ms_p, out_k, dev_ms = compare(entry, "random", "tighten", fn, plain, a, {})
        extra.append(result_entry(entry, src, replaces, err, ms_k, ms_p, bound_tighten(a, out_k),
                                  library_ms=tighten_library_ms(a), dev_ms=dev_ms))
    # every new kernel at the narrow widths; the 12x4 variants without a path
    cases = [("ocp_ip", True, 4, 1, 8, 25), ("ocp_ip", True, 4, 2, 8, 25)]
    for name in ("ocp_ip_streamed", "ocp_ip_streamed2"):
        for soft in (False, True):
            for nx, nu in ((4, 1), (4, 2), (12, 4)):
                on_a_path = (nx == 12 and PATHS["quadrotor-T100"].qp == name and not soft) or (
                    nx == 12 and PATHS["quadrotor-soft-T360"].qp == name and soft)
                if not on_a_path:
                    cases.append((name, soft, nx, nu, 2, 100))
    for name, soft, nx, nu, n_tiles, T in cases:
        fn, plain, replaces = QP_WRAPPERS[name]
        entry = f"{name}{'_soft' if soft else ''}[{nx}x{nu}]"
        a, k = random_qp_call(dev, n_tiles, T, nx, nu, soft)
        kind = "ocp_soft" if soft else "ocp"
        err, ms_k, ms_p, out_k, dev_ms = compare(entry, f"random T={T}", kind, fn, plain, a, k)
        extra.append(result_entry(entry, qp_source(name, soft), replaces, err, ms_k, ms_p,
                                  bound_ocp(a[0], k, out_k, fn.last_iterations), dev_ms=dev_ms))
    # the resident kernel on two tiles (B=256) of the quadrotor path's first
    # warm-started QP, beside its time on all eight (the path's own entry)
    fn, plain, replaces = QP_WRAPPERS["ocp_ip"]
    a, k = captured["quadrotor"]["qp"]
    a = (cuda_ocp.LanesQp(*(f[:2].contiguous() for f in a[0])),) + tuple(a[1:])
    err, ms_k, ms_p, out_k, dev_ms = compare("ocp_ip[B=256]", "real step", "ocp", fn, plain, a, k)
    extra.append(result_entry("ocp_ip[B=256]", qp_source("ocp_ip", False), replaces, err, ms_k, ms_p,
                              bound_ocp(a[0], k, out_k, fn.last_iterations), dev_ms=dev_ms))
    # tier 1 at 12x4, B=1024, up to its caps: the workspace beside the card's
    # free memory, the kernel beside its plain version
    fn, plain, replaces = QP_WRAPPERS["ocp_ip_streamed"]
    for soft, T in ((False, 200), (False, sqp_lanes.MAX_STREAM_HORIZON),
                    (True, sqp_lanes.MAX_STREAM_HORIZON_SOFT)):
        name = "ocp_ip_streamed" + ("_soft" if soft else "")
        ws = 4 * 1024 * getattr(_build.load_library(), name + "_workspace_floats")(T, 12, 4)
        say(f"[phase 1] {name} at T={T}, B=1024: workspace {ws} bytes, the card has "
            f"{torch.cuda.mem_get_info(dev)[0]} free")
        entry = f"{name}[T={T},B=1024]"
        a, k = random_qp_call(dev, 1024 // LANES, T, 12, 4, soft)
        kind = "ocp_soft" if soft else "ocp"
        err, ms_k, ms_p, out_k, dev_ms = compare(entry, "random", kind, fn, plain, a, k)
        extra.append(result_entry(entry, qp_source("ocp_ip_streamed", soft), replaces, err, ms_k,
                                  ms_p, bound_ocp(a[0], k, out_k, fn.last_iterations),
                                  dev_ms=dev_ms))
    # the other horizon caps at 12x4, one tile each, one comparison call each
    for name, soft, T in (("ocp_ip", False, sqp_lanes.MAX_LANES_HORIZON),
                          ("ocp_ip", True, sqp_lanes.MAX_LANES_HORIZON),
                          ("ocp_ip_streamed2", False, sqp_lanes.MAX_STREAM2_HORIZON),
                          ("ocp_ip_streamed2", True, sqp_lanes.MAX_STREAM2_HORIZON_SOFT)):
        fn, plain, _ = QP_WRAPPERS[name]
        a, k = random_qp_call(dev, 1, T, 12, 4, soft)
        compare(f"{name}{'_soft' if soft else ''}[12x4]", f"cap T={T}", "ocp_soft" if soft else "ocp",
                fn, plain, a, k, time_plain=False)
    # tier 1 is the resident kernel under its own names: on the QP of the
    # T=100 path's first warm-started step both give the same solution bit for
    # bit and the same per-tile counts; timed in turns
    a, k = captured["quadrotor-T100"]["qp"]
    res, stre = cuda_ocp.solve_ocp_qp_lanes, cuda_ocp.solve_ocp_qp_lanes_streamed
    ms = [timed(lambda f=f: f(*a, **k))[0] for f in (res, stre, stre, res)]
    out_r = res(*a, **k)
    out_s = stre(*a, **k)
    same = all(torch.equal(x, y) for x, y in zip(out_r, out_s))
    its = (res.last_iterations.tolist(), stre.last_iterations.tolist())
    say(f"[phase 1] T=100, B=256 real-step QP: resident kernel {ms[0]:.3f} / {ms[3]:.3f} ms, tier-1 "
        f"kernel {ms[1]:.3f} / {ms[2]:.3f} ms (resident, tier 1, tier 1, resident); solutions "
        f"{'the same bit for bit' if same else 'DIFFERENT'}, IP iterations per tile {its[0]} / "
        f"{its[1]}")
    if not same or its[0] != its[1]:
        raise RuntimeError("the resident kernel and tier 1 disagree on the T=100 QP")
    # kernel 4 beside kernel 6 (the same code under tier 2's names) on the QP
    # of the T=512 path's first warm-started step, in turns; printed, not gated
    a, k = captured["quadrotor-T512"]["qp"]
    t2 = cuda_ocp.solve_ocp_qp_lanes_streamed2
    ms = [timed(lambda f=f: f(*a, **k))[0] for f in (res, t2, t2, res)]
    dev_ms = [device_ms(lambda f=f: f(*a, **k), runs=2) for f in (res, t2)]
    d = max(float((x - y).abs().max()) for x, y in zip(res(*a, **k)[:2], t2(*a, **k)[:2]))
    say(f"[phase 1] T=512, B=256 real-step QP: kernel 4 {ms[0]:.3f} / {ms[3]:.3f} ms (device "
        f"{dev_ms[0]:.3f}), kernel 6 {ms[1]:.3f} / {ms[2]:.3f} ms (device {dev_ms[1]:.3f}) "
        f"(4, 6, 6, 4); max|kernel 4 - kernel 6| = {d:.3e}")


def closed_loop(prob: Problem, results: dict, stress=False):
    """Phase 2 for one path: the closed loop on the card, launch counts read
    over exactly this run. Returns the first steps' observations and actions
    of the first scenarios for phase 3."""
    path, name = prob.path, prob.path_name + (" (stress GP)" if stress else "")
    B, T = path.B, path.T
    n_warmup, n_timed = (1, 4) if stress else (path.n_warmup, path.n_timed)
    es, obs, st = prob.reset(B, seed=1)
    wrappers = {k: v[0] for k, v in KERNELS.items()}
    wrappers.update({k: v[0] for k, v in QP_WRAPPERS.items()})
    for fn in wrappers.values():
        fn.launches = 0
    rec_obs, rec_u = [], []
    worst_viol = 0.0
    step_ms = []  # each timed step of a path without kernels, synchronized
    batch_mod._DISPATCH_WARNED.clear()  # phase 1's steps have used the once-only warnings up
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(n_warmup + n_timed):
            if i == n_warmup:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            t_step = time.perf_counter()
            u, st, info = prob.step(st, obs)
            if not path.kernels and i >= n_warmup:
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t_step))
            if i < path.cpu_steps:
                rec_obs.append(obs[:path.n_cpu].clone())
                rec_u.append(u[:path.n_cpu].clone())
            worst_viol = max(worst_viol, float(info.soft_viol.max()))
            es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k: fn.launches for k, fn in wrappers.items()}
    dispatch_warnings = [str(w.message) for w in caught if "gpmpc dispatch" in str(w.message)]
    say(f"[phase 2] {name}: dispatch '{prob.decision.path}' (degraded={prob.decision.degraded}: "
        f"{prob.decision.reason}); {len(dispatch_warnings)} dispatch warning(s) over the run; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if len(dispatch_warnings) != int(path.degraded):
        raise RuntimeError(f"{name}: expected {int(path.degraded)} dispatch warning(s), got "
                           f"{dispatch_warnings}")
    say(f"[phase 2] {name}: {n_timed} timed steps at B={B}, T={T}: {n_timed / wall:.3f} steps/s, "
        f"{B * n_timed / wall:.1f} solves/s (wall {wall:.3f} s, {1e3 * wall / n_timed:.1f} ms/step, "
        "plant on the card)")
    say(f"[phase 2] {name}: kernel launches over {n_warmup + n_timed} steps: {launches}")
    expected = {path.qp if k == "qp" else k for k in path.kernels}
    if (min((launches[k] for k in expected), default=1) <= 0
            or any(n for k, n in launches.items() if k not in expected)):
        raise RuntimeError(f"{name}: expected exactly {sorted(expected)} to have launched: "
                           f"{launches}")
    if not bool(torch.isfinite(u).all()) or not bool(torch.isfinite(st.X_warm).all()):
        raise RuntimeError(f"{name}: non-finite actions or trajectories")
    it = info.n_iters.float()
    say(f"[phase 2] {name}: last step: clamp_frac max {float(info.clamp_frac.max()):.3e}, soft_viol "
        f"max {float(info.soft_viol.max()):.3e} (run max {worst_viol:.3e}), SQP iters mean "
        f"{float(it.mean()):.2f} max {int(it.max())}, QP gap median "
        f"{float(info.qp_gap.median()):.3e} max {float(info.qp_gap.max()):.3e}, converged "
        f"{int(info.converged.sum())}/{B}")
    if stress:
        if not worst_viol > 0:
            raise RuntimeError(f"{name}: the stress GP produced no soft violation")
        return None
    if not path.kernels:
        prob.ms_per_step = statistics.median(step_ms)
        say(f"[phase 2] {name}: no kernel launched, as the path has none; ms/step "
            f"{prob.ms_per_step:.1f} (median of {n_timed} synchronized steps: "
            f"{', '.join(f'{t:.1f}' for t in step_ms)}), plant on the card")
        return rec_obs, rec_u
    for k in path.kernels:
        results[entry_name(prob.path_name, k)]["launches"] = launches[path.qp if k == "qp" else k]
    qp_entry = results[entry_name(prob.path_name, "qp")]
    steps = n_warmup + n_timed
    prob.ms_per_step = 1e3 * wall / n_timed
    in_qp = qp_entry["ms"] * launches[path.qp] / steps
    say(f"[phase 2] {name}: QP kernel launches per step {launches[path.qp] / steps:.2f}; at its "
        f"phase-1 time that is {in_qp:.1f} ms of the {1e3 * wall / n_timed:.1f} ms step")
    return rec_obs, rec_u


def cpu_parity(path_name: str, rec_obs, rec_u, trained_gp=None) -> None:
    """Phase 3 for one path: the plain path on the CPU, same observations
    (`trained_gp`: a learned path's GP, trained on the card, on the CPU)."""
    cpu = torch.device("cpu")
    if trained_gp is not None:
        TRAINED[path_name] = trained_gp
    path = PATHS[path_name]
    prob = Problem(path_name, cpu, batch=path.n_cpu)
    st = mpc_mod.init_state(path.n_cpu, path.T, prob.model.nx, prob.model.nu, device=cpu)
    u_cpu, u_card = [], []
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the dispatch warnings were counted in phase 2
        for o, u_k in zip(rec_obs, rec_u):
            u_c, st, _ = prob.step(st, o.cpu(), lanes=min(LANES, path.n_cpu))
            u_cpu.append(u_c)
            u_card.append(u_k.cpu())
    err = torch.stack(u_cpu) - torch.stack(u_card)
    rmse = float(torch.sqrt(torch.mean(err**2)))
    say(f"[phase 3] {path_name}: {len(u_cpu)} steps x {path.n_cpu} scenarios, plain path on the CPU "
        f"({time.perf_counter() - t0:.1f} s): control RMSE vs the card {rmse:.3e} "
        f"(bar {RMSE_BAR}), max abs {float(err.abs().max()):.3e}")
    if not rmse <= RMSE_BAR:
        raise RuntimeError(f"{path_name}: control RMSE {rmse} exceeds {RMSE_BAR}")


WORKER_POLL_S = 5.0  # how often a wait for the CPU worker looks whether it is still alive
WORKER_SPARE_CORES = 2  # cores left to this process, whose host thread paces the card


def cpu_worker_main(jobs, done, cores: list) -> None:
    """The CPU worker's loop (a spawned process): each job (a function of
    this module by name, its arguments) is run and answered on `done` with
    (name, None) or (name, the traceback); None ends the loop. Its torch
    threads are pinned to `cores`."""
    import traceback

    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))
    while (job := jobs.get()) is not None:
        name, args = job
        try:
            globals()[name](*args)
            done.put((name, None))
        except BaseException:  # noqa: BLE001 - reported to the main process, which raises
            done.put((name, traceback.format_exc()))


class CpuWorker:
    """Phase 3 and the bench's CPU check in a spawned process, beside the
    card phases: the card's run hands each job over as soon as it has its
    inputs (every tensor on the CPU) and goes on. The worker's torch threads
    are pinned to all but `WORKER_SPARE_CORES` of this process's cores, the
    host-paced card phases keep those. A job that fails fails the run, at
    the next `poll` or at `join`, which waits for every job before the
    final line; the worker is a daemon, so it ends with this process."""

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        cores = sorted(os.sched_getaffinity(0))
        self.cores = cores[WORKER_SPARE_CORES:] if len(cores) > 2 * WORKER_SPARE_CORES else cores
        self.jobs, self.done = ctx.Queue(), ctx.Queue()
        self.proc = ctx.Process(target=cpu_worker_main, args=(self.jobs, self.done, self.cores),
                                daemon=True)
        self.proc.start()
        self.pending = 0

    def submit(self, fn, *args) -> None:
        self.jobs.put((fn.__name__, args))
        self.pending += 1
        self.poll()

    def _answer(self, name: str, error) -> None:
        self.pending -= 1
        if error is not None:
            raise RuntimeError(f"the CPU worker's {name} failed:\n{error}")

    def poll(self) -> None:
        """Raises for a job that has failed so far."""
        import queue

        while True:
            try:
                self._answer(*self.done.get_nowait())
            except queue.Empty:
                return

    def join(self) -> float:
        """Waits for every job (raising for one that failed, or if the
        worker died) and ends the worker; returns the seconds waited."""
        import queue

        t0 = time.perf_counter()
        self.jobs.put(None)
        while self.pending:
            try:
                self._answer(*self.done.get(timeout=WORKER_POLL_S))
            except queue.Empty:
                if not self.proc.is_alive():
                    raise RuntimeError(f"the CPU worker died (exit code {self.proc.exitcode}) "
                                       f"with {self.pending} job(s) open") from None
        self.proc.join(timeout=60)
        if self.proc.exitcode != 0:
            raise RuntimeError(f"the CPU worker ended with exit code {self.proc.exitcode}")
        return time.perf_counter() - t0


def analytic_jacobian_run(dev, rec_u) -> None:
    """`quadrotor-jacfwd` once more with `analytic_jac=True`, from the same
    seed: the first scenarios' actions of the first steps against the
    forward-mode run's (`rec_u`), and its steps/s over five steps."""
    prob = Problem("quadrotor-jacfwd", dev, analytic_jac=True)
    path = prob.path
    es, obs, st = prob.reset(path.B, seed=1)
    worst, n_timed = 0.0, 5
    for i in range(path.n_warmup + n_timed):
        if i == path.n_warmup:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        u, st, _ = prob.step(st, obs)
        if i < len(rec_u):
            worst = max(worst, float((u[:path.n_cpu] - rec_u[i]).abs().max()))
        es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    say(f"[phase 2] quadrotor-jacfwd with analytic_jac=True: {n_timed} timed steps: "
        f"{n_timed / wall:.3f} steps/s ({1e3 * wall / n_timed:.1f} ms/step); max|u - forward-mode "
        f"run's u| over {len(rec_u)} steps x {path.n_cpu} scenarios = {worst:.3e} "
        f"(bar {ANALYTIC_BAR})")
    if not worst <= ANALYTIC_BAR:
        raise RuntimeError("the analytic-Jacobian run disagrees with the forward-mode run")


def xla_against_lanes(prob: Problem, lanes_prob: Problem, rec_obs, rec_u) -> None:
    """`quadrotor-xla` on the observations the `quadrotor` (lanes-fused)
    path recorded in phase 2 (its first scenarios, its first steps), from a
    fresh controller state as that run began, against the lanes-fused step
    on the same observations with the same IP settings: the xla path always
    runs the fixed IP count, so the lanes step runs it too (`qp_tol=None`),
    as the reference's bar compares them (tests/test_parallel.py:124-141).
    Gate: each step's actions within XLA_LANES_BAR. Printed beside it, not
    gated: the difference from the recorded run, whose IP stops at gap 1e-6,
    which moves the iterate of a scenario whose SQP has not converged."""
    n = rec_obs[0].shape[0]
    new = lambda: mpc_mod.init_state(n, prob.path.T, prob.model.nx, prob.model.nu,  # noqa: E731
                                     device=prob.device)
    st, st_l = new(), new()
    cfg_l = lanes_prob.cfg._replace(qp_tol=None)
    worst, worst_rec = 0.0, 0.0
    for o, u_rec in zip(rec_obs, rec_u):
        u, st, _ = prob.step(st, o)
        u_l, st_l, _ = batched_gpmpc_step(lanes_prob.model, cfg_l, lanes_prob.consts, lanes_prob.gp,
                                          st_l, o, backend="lanes", lanes=LANES)
        worst = max(worst, float((u - u_l).abs().max()))
        worst_rec = max(worst_rec, float((u - u_rec).abs().max()))
    say(f"[phase 2] {prob.path_name}: on the quadrotor path's observations ({len(rec_obs)} steps x "
        f"{n} scenarios): max|u - the lanes-fused u, fixed IP count| = {worst:.3e} (bar "
        f"{XLA_LANES_BAR}, the reference's lanes-vs-xla bar); max|u - the recorded lanes-fused "
        f"u, IP exit at gap 1e-6| = {worst_rec:.3e} (not gated)")
    if not worst <= XLA_LANES_BAR:
        raise RuntimeError(f"{prob.path_name}: actions disagree with the lanes-fused path's")


def nominal_episode(prob: Problem, rec_u) -> None:
    """The nominal MPC through its entry point, `batched_episode(use_gp=False,
    backend="xla")`, at the path's B from phase 2's seed: its first actions
    equal phase 2's first step's (the same draw, the same controller), and
    its time per step (plant included, synchronized at the end)."""
    path = prob.path
    gen = torch.Generator(device=prob.device).manual_seed(1)
    n_steps = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = batch_mod.batched_episode(prob.model, prob.cfg, prob.env_p, prob.consts, prob.gp, gen,
                                   n_steps, path.B, use_gp=False, backend="xla", env_mod=prob.env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    diff = float((ep.actions[:path.n_cpu, 0] - rec_u[0]).abs().max())
    say(f"[phase 2] {prob.path_name}: batched_episode(use_gp=False, backend='xla'), {n_steps} "
        f"steps at B={path.B}: {1e3 * wall / n_steps:.1f} ms/step (the first step cold); "
        f"max|first actions - phase 2's first step's| = {diff:.3e}")
    if not (diff <= 1e-6 and bool(torch.isfinite(ep.obs).all())):
        raise RuntimeError(f"{prob.path_name}: the episode's actions differ from the step's")


def reset_launches() -> dict:
    """Every kernel wrapper of the paths by name, its launch count set to 0."""
    wrappers = {k: v[0] for k, v in KERNELS.items()}
    wrappers.update({k: v[0] for k, v in QP_WRAPPERS.items()})
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def check_captured(path: SmokePath, path_name: str, cap, launches: dict, results: dict,
                   gp_kind: str = "gp_posterior") -> None:
    """Phase 1 on a run's captured inputs (`Capture`): each kernel of the
    path against its plain version, with the launches of the path's run."""
    soft = path.soft is not None
    for name in path.kernels:
        if name == "qp":
            fn, plain, replaces = QP_WRAPPERS[path.qp]
            src, kind = qp_source(path.qp, soft), "ocp_soft" if soft else "ocp"
        else:
            fn, plain, src, replaces = KERNELS[name]
            kind = gp_kind if name == "gp_posterior" else name
            if name == "linearize":
                replaces = LINEARIZE_CLOSURES.get(path.family, replaces)
        a, k = cap.args[name]
        entry = entry_name(path_name, name)
        live = path.B if name == "qp" and path.B % LANES else None
        err, ms_k, ms_p, out_k, dev_ms = compare(entry, "real step", kind, fn, plain, a, k,
                                                 live_lanes=live)
        library_ms = (tighten_library_ms(a) if name == "tighten" else gp_library_ms(a)
                      if name == "gp_posterior" else None)
        results[entry] = result_entry(entry, src, replaces, err, ms_k, ms_p,
                                      kernel_bound(name, fn, a, k, out_k), library_ms=library_ms,
                                      dev_ms=dev_ms)
        results[entry]["launches"] = launches[path.qp if name == "qp" else name]
        if results[entry]["launches"] <= 0:
            raise RuntimeError(f"{entry}: launched no time on {path_name}'s run")


def twolink_exact_learned(dev, results: dict) -> None:
    """tests/test_learning_loop.py's two-link controller on the card (T=20,
    exact ARD GPs of capacity 512, 8 SQP and 10 IP iterations, lm_reg 0.5,
    kernel linearization), from that test's initial states (`TWOLINK_STARTS`):
    two 150-step episodes of the untrained controller through the stateful
    `select_action`, `train_gp(lr=0.05, iterations=500)` on their 300
    transitions, 150 steps of the trained controller from the first
    episode's start. Kernel 1 runs at 304 live points (the tiled
    instantiation, F7). Gate: the tail-cost ratio against the untrained
    controller's first episode < 0.6 (the JAX test's bar), clamp_frac 0."""
    c, cfg = FAMILIES["twolink"], TWOLINK_EXACT
    env_p = twolink_env.EnvParams.default()
    ctrl = gpmpc_mod.GPMPC(
        c["model"](), twolink_env.make_trajectory(env_p, dev).cpu().numpy(), None, horizon=cfg["T"],
        q_mpc=c["q_mpc"], r_mpc=c["r_mpc"], sparse_gp=False, max_gp_samples=40, seed=1,
        sqp_iters=8, qp_iters=10, max_gp_points=512, ard_gp=True, lm_reg=0.5,
        bounds=c["bounds"], device=dev,
    )
    # the fused path (kernel 3 at Ms = 512, the exact GP's capacity); the
    # stateful controller's default linearizes with forward-mode torch.func,
    # which costs ~0.48 s a B = 1 step on the host of an NVIDIA H100 80GB HBM3 machine
    ctrl.cfg = ctrl.cfg._replace(kernel_linearize=True)
    n = cfg["steps"]

    def rollout(seed):
        es, _ = twolink_env.env_reset(env_p, 1, torch.Generator(device=dev), dev)
        es = es._replace(x=torch.tensor([TWOLINK_STARTS[seed]], dtype=torch.float32, device=dev))
        obs = es.x
        ctrl.reset()
        X, U, costs = [obs[0].cpu().numpy()], [], []
        for _ in range(n):
            u = ctrl.select_action(X[-1])
            es, obs, reward, *_ = twolink_env.env_step(env_p, es, torch.as_tensor(u, device=dev)[None])
            X.append(obs[0].cpu().numpy())
            U.append(u)
            costs.append(-float(reward[0]))
        return np.asarray(X), np.asarray(U), np.asarray(costs)

    t0 = time.perf_counter()
    eps = [rollout(seed) for seed in range(cfg["episodes"])]
    collect_s = time.perf_counter() - t0
    cost_prior = eps[0][2]
    xi, ti = ctrl.preprocess_data(np.concatenate([e[0][:-1] for e in eps]),
                                  np.concatenate([e[1] for e in eps]),
                                  np.concatenate([e[0][1:] for e in eps]))
    fit_s, _ = cuda_timed(lambda: ctrl.train_gp(xi, ti, lr=0.05, iterations=cfg["iterations"]))
    info = ctrl.last_fit_info
    form = gpmpc_mod.variance_form(ctrl.gp_model)
    say(f"[learn] twolink-exact-learned: {cfg['episodes']} x {n} steps of the untrained controller "
        f"({collect_s:.1f} s, {1e3 * collect_s / (cfg['episodes'] * n):.1f} ms a select_action); "
        f"train_gp(lr=0.05, iterations={cfg['iterations']}) on {xi.shape[0]} points (exact ARD, "
        f"capacity 512): {fit_s:.3f} s, {info.iterations} Adam iterations (freeze steps "
        f"{info.freeze_step.tolist()}), {1e3 * fit_s / max(info.iterations, 1):.2f} ms an "
        f"iteration; kernel 1's form holds {form.Z.shape[1]} points (instantiation "
        f"{cuda_gp.gp_geometry(form.Z.shape[1], form.Z.shape[2])})")
    path = SmokePath("twolink", cfg["T"], 1, None, "ocp_ip", 0, n, 0, 0, "exact-learned",
                     learned=True)
    wrappers = reset_launches()
    with Capture(path) as cap:
        t0 = time.perf_counter()
        _, _, cost_gp = rollout(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    tail = slice(-max(n // 3, 10), None)
    ratio = float(cost_gp[tail].mean() / cost_prior[tail].mean())
    clamp = float(ctrl._last_info.clamp_frac)
    say(f"[learn] twolink-exact-learned: {n} trained steps, {1e3 * wall / n:.1f} ms a select_action "
        f"(B=1); kernel launches {launches}; tail-cost ratio {ratio:.4f} (prior "
        f"{cost_prior[tail].mean():.5f} -> GP {cost_gp[tail].mean():.5f}; bar < "
        f"{cfg['max_ratio']}), clamp_frac {clamp}")
    PATHS["twolink-exact-learned"] = path
    z_cap, form_cap = cap.args["gp_posterior"][0][:2]
    G, n_q, D = z_cap.shape
    say(f"[learn] twolink-exact-learned: kernel 1's captured launch has z {tuple(z_cap.shape)} "
        f"(G, N, D) against M={form_cap.Z.shape[1]} points; "
        f"{cuda_gp.gp_tiled_plan(G, n_q, form_cap.Z.shape[1], D, cuda_gp.sm_count(dev))}")
    check_captured(path, "twolink-exact-learned", cap, launches, results, gp_kind="gp_posterior_f64")
    if not ratio < cfg["max_ratio"] or clamp != 0.0:
        raise RuntimeError(f"twolink-exact-learned: tail-cost ratio {ratio} or clamp_frac {clamp}")


def quadrotor_sweep(dev, results: dict) -> None:
    """`seed_sweep(backend="lanes")` at scripts/eval_seeds.py's quadrotor
    settings (`SWEEP`; the episode cut from 300 steps to 30): every epoch's
    episodes run the 16 seeds as one GP population (kernels 2 and 4). The
    cost matrix, each epoch's wall and fit time; the kernels on the first
    step's captured inputs."""
    c, cfg = FAMILIES["quadrotor"], SWEEP
    env_p = drone.EnvParams.default()
    model = c["model"]()
    ctrl = gpmpc_mod.GPMPC(model, drone.make_trajectory(env_p, dev).cpu().numpy(), c["prior"],
                           horizon=cfg["T"], q_mpc=c["q_mpc"], r_mpc=c["r_mpc"],
                           sqp_iters=cfg["sqp_iters"], qp_iters=cfg["qp_iters"], device=dev)
    path = SmokePath("quadrotor", cfg["T"], cfg["n_seeds"], None, "ocp_ip", 0, cfg["n_steps"], 0, 0,
                     "sweep", dispatch="lanes", degraded=True, population=True)
    wrappers = reset_launches()
    with Capture(path) as cap, warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the population path's dispatch warning
        t0 = time.perf_counter()
        res, epochs = seed_sweep(model, ctrl.cfg, env_p, ctrl.consts, n_seeds=cfg["n_seeds"],
                                 n_epochs=cfg["n_epochs"], n_steps=cfg["n_steps"],
                                 samples_per_epoch=cfg["samples_per_epoch"],
                                 max_inducing=cfg["max_inducing"], sparse=True,
                                 gp_iters=cfg["gp_iters"], gp_lr=cfg["gp_lr"], master_seed=0,
                                 backend="lanes", return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    costs = res.costs.cpu().numpy()
    say(f"[sweep] quadrotor-sweep: {cfg['n_seeds']} seeds x {cfg['n_epochs']} epochs x "
        f"{cfg['samples_per_epoch']} samples, T={cfg['T']}, {cfg['n_steps']}-step episodes (cut "
        f"from 300), {cfg['gp_iters']} Adam iterations at lr {cfg['gp_lr']} over "
        f"{cfg['n_seeds']} x 3 GPs: {wall:.1f} s in all; kernel launches {launches}")
    for e in epochs:
        say(f"[sweep] epoch {e.epoch}: wall {e.wall_s:.3f} s, of which the fit "
            f"{e.fit_s:.3f} s ({e.fit_iterations} Adam iterations until every GP froze, "
            f"{1e3 * e.fit_s / max(e.fit_iterations, 1):.2f} ms an iteration)")
    say("[sweep] cost matrix (rows: prior, epoch 1..; columns: seeds): "
        + json.dumps(np.round(costs, 6).tolist()))
    say(f"[sweep] mean cost per row {np.round(costs.mean(axis=1), 6).tolist()}, points per row "
        f"{res.n_points.tolist()}")
    if not np.isfinite(costs).all() or costs.shape != (cfg["n_epochs"] + 1, cfg["n_seeds"]):
        raise RuntimeError("quadrotor-sweep: the cost matrix is not finite or misshapen")
    PATHS["quadrotor-sweep"] = path
    check_captured(path, "quadrotor-sweep", cap, launches, results)


# The serving path (scripts/serve_bench_torch.py's defaults): one tile of 128 sessions on the
# lanes-fused step at the quadrotor path's configuration, 64 clients replaying 20 recorded
# steps each, then once more with 4-action replies.
SERVER = dict(tile=128, clients=64, steps=20, max_wait_ms=2.0, n_act=4)
SERVER_BAR = 1e-6  # a dispatch against batched_gpmpc_step on the same tile buffers
# The variance and tightening options of the step on the quadrotor path's recorded
# observations: (var_backend, var_bf16, tighten_backend) -> the kernels it launches.
STEP_OPTIONS = {
    ("auto", False, "auto"): ("gp_posterior", "tighten", "linearize", "ocp_ip"),
    ("xla", False, "auto"): ("tighten", "linearize", "ocp_ip"),
    ("xla", True, "auto"): ("tighten", "linearize", "ocp_ip"),
    ("auto", True, "auto"): ("gp_posterior", "tighten", "linearize", "ocp_ip"),
    ("auto", False, "xla"): ("gp_posterior", "linearize", "ocp_ip"),
}


def serve_report(name: str, run: dict) -> None:
    lat = run["latencies_ms"]
    say(f"[server] {name}: {run['actions']} actions in {run['wall_s']:.3f} s: "
        f"{run['actions'] / run['wall_s']:.1f} served actions/s; {run['n_requests']} requests in "
        f"{run['n_batches']} dispatches (mean batch {run['n_requests'] / run['n_batches']:.2f}, "
        f"{1e3 * run['wall_s'] / run['n_batches']:.1f} ms a dispatch); request latency p50 "
        f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms")


def quadrotor_server(prob: Problem, results: dict) -> None:
    """`quadrotor-server`: `ControlServer(tile=128, backend="lanes")` on the
    quadrotor path's controller and committed GP, driven by `SERVER`'s
    clients (`replay_sessions`) on observations recorded from one
    `batched_episode`. Launch counts over the clients' run: kernels 1-4
    each, every other wrapper 0; each kernel against its plain version on
    the first dispatch's inputs (B = 128). Then: one dispatch against
    `batched_gpmpc_step` on the same tile buffers (SERVER_BAR); `update_gp`
    with a same-shape GP changes the actions; a snapshot restored into a
    fresh server gives the running server's next actions; every
    `DIAG_FIELDS` value finite; the run once more with 4-action replies."""
    cfg = SERVER
    path = SmokePath("quadrotor", prob.path.T, cfg["tile"], None, "ocp_ip", 0, cfg["steps"], 0, 0,
                     "server")
    PATHS["quadrotor-server"] = path
    dev = prob.device
    gen = torch.Generator(device=dev).manual_seed(0)
    ep = batch_mod.batched_episode(prob.model, prob.cfg, prob.env_p, prob.consts, prob.gp, gen,
                                   cfg["steps"], cfg["clients"], backend="lanes")
    streams = ep.obs.cpu().numpy()
    make = lambda gp, **kw: ControlServer(  # noqa: E731
        prob.model, prob.cfg, prob.consts, gp, tile=cfg["tile"], backend="lanes",
        max_wait_ms=cfg["max_wait_ms"], **kw)
    wrappers = reset_launches()
    server = make(prob.gp)
    try:
        with Capture(path) as cap:
            run = replay_sessions(server, streams, cfg["steps"], cfg["clients"])
        launches = {k: fn.launches for k, fn in wrappers.items()}
        serve_report(f"quadrotor-server ({cfg['clients']} clients x {cfg['steps']} steps, "
                     f"tile {cfg['tile']}, pipeline_depth 2)", run)
        say(f"[server] quadrotor-server: kernel launches over the run {launches}")
        if any(n <= 0 for k, n in launches.items() if k in ("gp_posterior", "tighten", "linearize",
                                                             "ocp_ip")) or any(
                n for k, n in launches.items() if k in ("ocp_ip_streamed", "ocp_ip_streamed2")):
            raise RuntimeError(f"quadrotor-server: expected exactly kernels 1-4 to launch: {launches}")
        check_captured(path, "quadrotor-server", cap, launches, results)

        # one dispatch against batched_gpmpc_step on the same tile buffers
        obs0 = streams[0, 3]
        sid = server.open_session()
        states, _ = server.tile_buffers()
        u, diag = server.step_with_diag(sid, obs0)
        _, obs_buf = server.tile_buffers()
        u_ref, _, _ = batched_gpmpc_step(prob.model, prob.cfg, prob.consts, prob.gp, states, obs_buf,
                                         backend="lanes", lanes=server.lanes)
        err = float(np.abs(u - u_ref[sid].cpu().numpy()).max())
        say(f"[server] one dispatch against batched_gpmpc_step on the same tile buffers: max|u - "
            f"u_ref| = {err:.3e} (bar {SERVER_BAR}); diagnostics {diag}")
        if not err <= SERVER_BAR:
            raise RuntimeError("quadrotor-server: a dispatch differs from batched_gpmpc_step")
        if not all(np.isfinite(float(diag[f])) for f in DIAG_FIELDS):
            raise RuntimeError(f"quadrotor-server: non-finite diagnostics {diag}")

        # update_gp with a same-shape GP: the actions of a fresh session change
        gp2 = prob.gp._replace(alpha_s=prob.gp.alpha_s * 1.5)
        server.close_session(sid)
        sid = server.open_session()
        u_before = server.step(sid, obs0)
        server.update_gp(gp2)
        server.close_session(sid)
        sid = server.open_session()
        u_after = server.step(sid, obs0)
        moved = float(np.abs(u_after - u_before).max())
        say(f"[server] update_gp (alpha_s x 1.5): a fresh session's action moved by {moved:.3e}")
        if not (moved > 1e-6 and np.isfinite(u_after).all()):
            raise RuntimeError("quadrotor-server: update_gp did not change the actions")

        # a snapshot restored into a fresh server gives the same next actions
        s_b = server.open_session()
        for k in range(3):
            server.step(sid, streams[1, k])
            server.step(s_b, streams[2, k])
        snap = Path(__file__).resolve().parent / "build" / "chip_smoke" / "sessions"
        server.save_sessions(snap)
        u_next = [server.step(sid, streams[1, 3]), server.step(s_b, streams[2, 3])]
        if "--profile" in sys.argv[1:]:
            profile_request(server, sid, streams[1, 4], run)
    finally:
        server.close()
    fresh = make(prob.gp)
    try:
        fresh.restore_sessions(snap)
        u_rest = [fresh.step(sid, streams[1, 3]), fresh.step(s_b, streams[2, 3])]
    finally:
        fresh.close()
    err = max(float(np.abs(a - b).max()) for a, b in zip(u_next, u_rest))
    say(f"[server] save_sessions -> restore_sessions into a fresh server: max|next actions - the "
        f"running server's| = {err:.3e} (bar {SERVER_BAR})")
    if not err <= SERVER_BAR:
        raise RuntimeError("quadrotor-server: the restored sessions act otherwise")

    server = make(prob.gp, actions_per_step=cfg["n_act"])
    try:
        run = replay_sessions(server, streams, cfg["steps"], cfg["clients"])
    finally:
        server.close()
    serve_report(f"quadrotor-server, actions_per_step={cfg['n_act']}", run)


def profile_request(server, sid: int, obs, run: dict) -> None:
    """Device time of one request's dispatch (the whole tile re-solved, as
    at any occupancy; torch.profiler on the card alone), with the idle share
    against the profiled request's latency (upper estimate) and against the
    clients' run's wall time a dispatch (lower)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        server.step(sid, obs)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
    busy_ms = sum(e.device_time_total for e in rows) / 1e3
    mean_ms = 1e3 * run["wall_s"] / run["n_batches"]
    top = sorted(rows, key=lambda e: -e.device_time_total)[:4]
    say(f"[profile] quadrotor-server: card busy {busy_ms:.1f} ms a dispatch; the profiled request "
        f"took {wall_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}, upper estimate), the "
        f"clients' run {mean_ms:.1f} ms a dispatch (idle share {1 - busy_ms / mean_ms:.3f}, lower "
        "estimate); top: " + ", ".join(
            f"{e.key[:40]} {e.device_time_total / 1e3:.2f} ms x{e.count}" for e in top))


def step_options(prob: Problem, rec_obs) -> None:
    """The step's variance and tightening options (`STEP_OPTIONS`) on the
    quadrotor path's recorded observations, from a fresh state: each launches
    exactly its kernels; the default's options again with `var_bf16` (which
    the kernel branch ignores) give its actions bit for bit; each one's
    distance from the default's actions and its ms a step (CUDA events, the
    median of the recorded steps). Then the bf16 variances along the last
    step's solution on the card against the plain bf16 variances on the CPU,
    at the GP bar, beside their distance from the float32 variances."""
    n = rec_obs[0].shape[0]
    runs = {}
    for (var_backend, bf16, tighten), kernels in STEP_OPTIONS.items():
        wrappers = reset_launches()
        st = mpc_mod.init_state(n, prob.path.T, prob.model.nx, prob.model.nu, device=prob.device)
        us, ms = [], []
        for o in rec_obs:
            t, (u, st, _) = cuda_timed(lambda: batched_gpmpc_step(  # noqa: B023
                prob.model, prob.cfg, prob.consts, prob.gp, st, o, backend="lanes", lanes=LANES,
                var_backend=var_backend, var_bf16=bf16, tighten_backend=tighten))
            us.append(u)
            ms.append(1e3 * t)
        launched = tuple(k for k, fn in wrappers.items() if fn.launches)
        runs[(var_backend, bf16, tighten)] = (torch.stack(us), st)
        diff = float((torch.stack(us) - runs[("auto", False, "auto")][0]).abs().max())
        say(f"[options] var_backend={var_backend!r}, var_bf16={bf16}, tighten_backend={tighten!r}: "
            f"{statistics.median(ms):.2f} ms a step (median of {len(ms)}, B={n}); launched "
            f"{launched}; max|u - the default options' u| = {diff:.3e}")
        if launched != kernels:
            raise RuntimeError(f"step options {var_backend, bf16, tighten}: launched {launched}, "
                               f"expected {kernels}")
        if (var_backend, tighten) == ("auto", "auto") and diff != 0.0:
            raise RuntimeError("var_bf16 changed the kernel branch's actions")
    st = runs[("xla", True, "auto")][1]
    spec = prob.model.residual_spec
    z = gpmpc_mod.slice_gp_inputs(spec.gp_input(st.X_warm[:, :-1], st.U_warm), spec)
    cpu = lambda t: t.cpu()  # noqa: E731
    gp_cpu = type(prob.gp)(*[type(v)(*map(cpu, v)) if isinstance(v, tuple) else cpu(v)
                             for v in prob.gp])
    card = gpmpc_mod.batched_variances(prob.gp, z, backend="xla", bf16=True)
    plain = gpmpc_mod.batched_variances(gp_cpu, z.cpu(), backend="xla", bf16=True)
    f32 = gpmpc_mod.batched_variances(prob.gp, z, backend="xla")
    err = float((card.cpu() - plain).abs().max())
    say(f"[options] bf16 variances (G, B, T) = {tuple(card.shape)}: max|card - CPU plain| = "
        f"{err:.3e} (bar {TOL['gp']}); max|bf16 - float32| = {float((card - f32).abs().max()):.3e}, "
        f"{float((card - f32).abs().max() / f32.abs().max()):.3e} of the largest variance")
    if not err <= TOL["gp"]:
        raise RuntimeError("the bf16 variances on the card disagree with the CPU's")


# ---- the experiment entry points (scripts/*_torch.py), run in-process ------------------

REPO = Path(__file__).resolve().parent
EXPERIMENT_DIR = REPO / "build" / "chip_smoke" / "experiment"
# scripts/run_gp_mpc_torch.py --epochs 1 --steps 10 --profile on a copy of the shipped
# config with these SQP, IP and GP iterations (the YAML's are 12, 12 and 500); the default
# run (3 epochs x 300 steps, 500 iterations) is projected from the steps timed at the YAML's
# own settings (`DEFAULT_PROBE_STEPS` of each controller after one warm-up step)
DRIVER = dict(epochs=1, steps=10, sqp_iters=6, qp_iters=10, iterations=100)
DEFAULT_RUN = dict(epochs=3, steps=300, iterations=500)
DEFAULT_PROBE_STEPS = 2
DRIVER_CPU_STEPS = 2  # the last evaluation's first steps, solved again on the CPU
# scripts/eval_seeds_torch.py's arguments: the cartpole family's population on lanes
EVAL_SEEDS_ARGS = ["--model", "cartpole", "--fast", "--seeds", "4", "--epochs", "1",
                   "--backend", "lanes"]
GP_FIT_ITERS = 5  # scripts/bench_gp_fit_torch.py at its default sizes
GP_FIT_BAR = 1e-4  # the card's raw hypers against the CPU's after GP_FIT_ITERS Adam steps
# each kernel's names in a torch.profiler trace (kernel 1: the register buckets, or the tiled
# kernel and its reduction past 128 points; the resident QP kernel is a template in
# namespace gpmpc::ocp::resident)
TRACE_NAMES = {"gp_posterior": ("gp_posterior_kernel", "gp_posterior_tiled_kernel",
                                "gp_tiled_reduce_kernel"),
               "tighten": ("tighten_sums_kernel",), "qp": ("resident::kernel",)}


def load_script(name: str):
    """scripts/<name>.py as a module (the scripts are not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


# bench_torch.py's runs in [bench]: (tag, knobs over bench.py's defaults); and the breakdown's
# calls a segment. A GP trained on 15 transitions holds the quadrotor on its reference for some
# 25 steps: from there its thrust saturates, and from step ~60 scenarios leave the plant's range
# and go non-finite, in the JAX package's closed loop as in the port's plain path on the CPU
# (PERF.md, PR 16). The real-GP run's window stops at 20 steps, before that.
BENCH_RUNS = (
    ("quadrotor", {}),
    ("cartpole", {"BENCH_MODEL": "cartpole", "BENCH_STEPS": "10"}),
    ("twolink", {"BENCH_MODEL": "twolink", "BENCH_STEPS": "10"}),
    ("T100", {"BENCH_HORIZON": "100", "BENCH_BATCH": "256", "BENCH_STEPS": "5"}),
    ("real-gp", {"BENCH_REAL_GP": "1", "BENCH_REAL_GP_STEPS": "15", "BENCH_STEPS": "10"}),
)
# A run that reuses an earlier run's problem (the same family, horizon and GP sizes; the real-GP
# run replaces the GP): tag -> the earlier run's tag.
BENCH_REUSE = {"real-gp": "quadrotor"}
FUSED_STEPS = 20  # the window held against the chained loop
FUSED_TRACED = 5  # the steps of a window traced by torch.profiler (its busy share is a step's)
FUSED_UNROLLS = (1, 3)  # steps a graph
FUSED_TOL = 1e-6  # bit for bit expected
# bench_torch.py's BENCH_FUSED=1 runs: tag -> (the bench run or smoke path whose problem it
# reuses, knobs). The runs of `FUSED_PATH_RUNS`, off the lanes-fused defaults, are each held
# against their chained loop from the run's own carry over the run's steps (`fused_path_check`);
# the defaults' window is held by `fused_window_check`.
FUSED_RUNS = {
    "quadrotor-fused": ("quadrotor", {"BENCH_FUSED": "1"}),
    "T100-fused": ("T100", {"BENCH_FUSED": "1", "BENCH_HORIZON": "100", "BENCH_BATCH": "256",
                            "BENCH_STEPS": "5"}),
    "xla-fused": ("quadrotor", {"BENCH_FUSED": "1", "BENCH_BACKEND": "xla", "BENCH_STEPS": "2",
                                "BENCH_PROV_STEPS": "1"}),
    "jacfwd-fused": ("quadrotor", {"BENCH_FUSED": "1", "BENCH_KERNEL_LIN": "0", "BENCH_STEPS": "5",
                                   "BENCH_PROV_STEPS": "1"}),
    "T512-fused": ("quadrotor-T512", {"BENCH_FUSED": "1", "BENCH_HORIZON": "512",
                                      "BENCH_BATCH": "256", "BENCH_STEPS": "2",
                                      "BENCH_PROV_STEPS": "1"}),
}
FUSED_PATH_RUNS = ("xla-fused", "jacfwd-fused", "T512-fused")
FUSED_PATH_TRACED = 1  # the steps of those runs' traced windows (an xla step is 134,014 nodes)
BREAKDOWN_CALLS = 10
# kernel launches a closed-loop step on the lanes-fused path (phase 2): one GP and one tightening
# launch, one linearize and one QP launch an SQP iteration (6 at most; an early exit gives fewer)
BENCH_RATES = {"gp_posterior": (1, 1), "tighten": (1, 1), "linearize": (1, 6), "qp": (1, 6)}
# the same on the lanes path (linearized in torch); the xla backend launches no kernel
BENCH_RATES_LANES = {"gp_posterior": (1, 1), "tighten": (1, 1), "qp": (1, 6)}


def step_rates(knobs: dict) -> dict:
    """The (least, most) launches a closed-loop step of each kernel on the
    path bench.py's `knobs` take ('qp': the horizon's QP kernel)."""
    if knobs.get("BENCH_BACKEND") == "xla":
        return {}
    lanes = (knobs.get("BENCH_KERNEL_LIN") == "0"
             or int(knobs.get("BENCH_HORIZON", "25")) > sqp_lanes.MAX_FUSED_HORIZON)
    return BENCH_RATES_LANES if lanes else BENCH_RATES


def fused_rates(knobs: dict) -> dict:
    """The launches a captured step: the early exit is off, so all six SQP
    iterations run and each kernel launches its most."""
    return {k: hi for k, (_, hi) in step_rates(knobs).items()}


def bench_qp(T: int) -> str:
    """The QP wrapper `_solve_qp_lanes` sends a hard-bounded horizon T to."""
    return ("ocp_ip" if T <= sqp_lanes.MAX_LANES_HORIZON else "ocp_ip_streamed"
            if T <= sqp_lanes.MAX_STREAM_HORIZON else "ocp_ip_streamed2")


def bench_problem(prob: Problem) -> "bench_torch.Problem":
    """A smoke path's problem as `bench_torch.build_problem` makes it for the
    same family and horizon (bench.py's controller, the fixture GP)."""
    return bench_torch.Problem(prob.family, prob.env, prob.env_p, prob.model, prob.ctrl, prob.gp)


@contextlib.contextmanager
def counting_captures(wrappers: dict, log: list):
    """Inside the block, every graph a `FusedWindow` captures (the one-step
    graph a larger graph's projection captures first among them) appends
    (its steps, each wrapper's launches during the capture) to `log`."""
    capture = FusedWindow._capture

    def counted(window, n):
        before = {k: fn.launches for k, fn in wrappers.items()}
        stats = capture(window, n)
        log.append((n, {k: fn.launches - before[k] for k, fn in wrappers.items()}))
        return stats

    FusedWindow._capture = counted
    try:
        yield
    finally:
        FusedWindow._capture = capture


def check_captures(tag: str, captures: list, qp: str, rates: dict) -> None:
    """Each capture of n steps launched each kernel n times its `rates`
    (`fused_rates`; 'qp' is the QP kernel `qp`), and no other wrapper."""
    for n, launches in captures:
        want = {k: n * rates.get("qp" if k == qp else k, 0) for k in launches}
        say(f"[fused] {tag}: the capture of {n} step(s) launched {launches}")
        if launches != want:
            raise RuntimeError(f"fused {tag}: a capture of {n} steps launched {launches}, "
                               f"expected {want}")


def bench_run(smi: str, tag: str, knobs: dict, problem=None):
    """`bench_torch.py::main` with `knobs` on the card, launch counts from 0
    (on `problem`, an earlier run's, when given): its two JSON lines under
    the card's metric name, the kernels of its path at phase 2's rates a
    step (the lanes-fused step: kernels 1-4, the QP kernel of the horizon's
    tier; the lanes path: kernels 1, 2 and the QP kernel; the xla backend:
    none) and every other wrapper at 0. Under BENCH_FUSED=1 the window's
    step (its warm-up) and each capture count as steps, and each capture
    launches exactly `fused_rates` a step. Returns the run."""
    import io

    wrappers = reset_launches()
    chains = {k: v[0].launches for k, v in CHAINS.items()}
    out = io.StringIO()
    captures = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), counting_captures(wrappers, captures), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # T = 512's one dispatch warning
        run = bench_torch.main(knobs, problem)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    fused = knobs.get("BENCH_FUSED") == "1"
    for line in lines:
        say(f"[{'fused' if fused else 'bench'}] {tag}: {json.dumps(line)}")
    T = int(knobs.get("BENCH_HORIZON", "25"))
    B = int(knobs.get("BENCH_BATCH", "1024"))
    steps = 2 + int(knobs.get("BENCH_PROV_STEPS", "8")) + (
        1 + sum(n for n, _ in captures) if fused else
        int(knobs.get("BENCH_STEPS", str(max(60, (60 * 1024) // B)))))
    qp, rates = bench_qp(T), step_rates(knobs)
    say(f"[bench] {tag}: {wall:.1f} s, {steps} steps{' launched' if fused else ''}; kernel "
        f"launches {launches}")
    if fused != bool(captures) or fused != (run.window is not None):
        raise RuntimeError(f"bench {tag}: BENCH_FUSED={knobs.get('BENCH_FUSED')}, captures "
                           f"{captures}")
    check_captures(tag, captures, qp, fused_rates(knobs))
    if fused:
        for st in run.window.stats.values():
            say(f"[fused] {tag}: graph of {st.steps} step(s): captured in {st.capture_s:.3f} s, "
                f"instantiated in {st.instantiate_s:.3f} s, {st.nodes or 'uncounted'} nodes, its "
                f"pool {st.pool_bytes / 2**20:.1f} MiB and {st.graph_bytes / 2**20:.1f} MiB more "
                "of card memory")
    family = knobs.get("BENCH_MODEL", "quadrotor")
    metric = "gpmpc_torch_solves_per_sec_1gpu" + ("" if family == "quadrotor" else f"_{family}")
    if (lines != run.records or len(lines) != 2 or [r.get("provisional") for r in lines]
            != [True, None] or any(r["metric"] != metric or not r["value"] > 0
                                   or r["device"] != smi for r in lines)):
        raise RuntimeError(f"bench {tag}: expected two lines of {metric} on {smi}: {lines}")
    for k, (lo, hi) in rates.items():
        n = launches[qp if k == "qp" else k]
        if not lo * steps <= n <= hi * steps:
            raise RuntimeError(f"bench {tag}: {n} launches of {k} over {steps} steps, not "
                               f"{lo}-{hi} a step")
    if "linearize" in rates and launches["linearize"] != launches[qp]:
        raise RuntimeError(f"bench {tag}: linearize and QP launches differ: {launches}")
    on_path = {qp if k == "qp" else k for k in rates}
    off = {k: n for k, n in launches.items() if n and k not in on_path}
    off.update({k: v[0].launches - chains[k] for k, v in CHAINS.items()
                if v[0].launches != chains[k]})
    if off:
        raise RuntimeError(f"bench {tag}: kernels off its path launched: {off}")
    if not bool(torch.isfinite(run.u).all()):
        raise RuntimeError(f"bench {tag}: non-finite actions")
    return run


def bench_cpu_parity_args(run, n: int = LANES) -> tuple:
    """`bench_cpu_parity`'s arguments for a run's last step, its first `n`
    scenarios on the CPU."""
    states = type(run.states)(*[v[:n].cpu() for v in run.states])
    return (run.problem.family, run.states.X_warm.shape[1] - 1, states, run.obs[:n].cpu(),
            run.u[:n].cpu(), run.cfg, run.backend, run.var_backend, run.var_bf16)


def bench_cpu_parity(family, T, states, obs, u, cfg, backend, var_backend, var_bf16) -> None:
    """The default run's last step solved again on the CPU by the plain
    path for its first tile of 128 scenarios (the tile-wide IP exit sees the
    same tile), from the same controller states and observations
    (`bench_cpu_parity_args`): control RMSE <= `RMSE_BAR`."""
    cpu = torch.device("cpu")
    n = obs.shape[0]
    prob = bench_torch.build_problem(family, T, device=cpu, **bench_torch.FIXTURE_GP)
    t0 = time.perf_counter()
    u_cpu, _, _ = batched_gpmpc_step(prob.model, cfg, prob.ctrl.consts, prob.gp, states, obs,
                                     backend=backend, var_backend=var_backend, var_bf16=var_bf16)
    err = u_cpu - u
    rmse = float(torch.sqrt(torch.mean(err**2)))
    say(f"[bench] {family}: the last step's first {n} scenarios on the CPU's plain path "
        f"({time.perf_counter() - t0:.1f} s): control RMSE vs the card {rmse:.3e} (bar "
        f"{RMSE_BAR}), max abs {float(err.abs().max()):.3e}")
    if not rmse <= RMSE_BAR:
        raise RuntimeError(f"bench: control RMSE {rmse} exceeds {RMSE_BAR}")


def bench_breakdown(smi: str) -> None:
    """`scripts/bench_step_breakdown_torch.py::main` at `BREAKDOWN_CALLS`
    calls a segment: its seven segments in order on the card, the launches
    of each segment counted (between its line and the one before): `lin1`
    launches kernel 3 and no QP, `qp1_warm` and `qp1_cold` kernel 4, once a
    call (and once before the clock), and no linearize but the one that
    makes the QP."""
    import contextlib
    import io

    bd = load_script("bench_step_breakdown_torch")
    wrappers = reset_launches()
    seen = {}

    def snapshot(row, _emit=bd.emit):
        _emit(row)
        seen[row["segment"]] = {k: fn.launches for k, fn in wrappers.items()}

    bd.emit = snapshot
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rows = bd.main({"BENCH_CALLS": str(BREAKDOWN_CALLS)})
    wall = time.perf_counter() - t0
    prev = None
    for row in rows:
        now = seen[row["segment"]]
        delta = {k: n - (prev[k] if prev else 0) for k, n in now.items()}
        prev = now
        say(f"[breakdown] {json.dumps(row)}; launches {delta}")
        # qp1_warm's one linearize launch is its QP's own A and B, made after lin1's line
        want = {"lin1": {"linearize": BREAKDOWN_CALLS + 1, "ocp_ip": 0},
                "qp1_warm": {"linearize": 1, "ocp_ip": BREAKDOWN_CALLS + 1},
                "qp1_cold": {"linearize": 0, "ocp_ip": BREAKDOWN_CALLS + 1}}.get(row["segment"], {})
        if any(delta[k] != n for k, n in want.items()):
            raise RuntimeError(f"breakdown {row['segment']}: launches {delta}, expected {want}")
    say(f"[breakdown] {wall:.1f} s")
    if ([r["segment"] for r in rows] != list(bd.SEGMENTS) or len(bd.SEGMENTS) != 7
            or any(not r["ms_per_call"] > 0 or r["device"] != smi for r in rows)
            or [json.loads(ln) for ln in out.getvalue().splitlines()] != rows):
        raise RuntimeError(f"breakdown: expected the seven segments on {smi}: {rows}")


def profiled_window(fn) -> tuple[float, float]:
    """(busy ms, wall ms) of `fn` on the card, traced by torch.profiler on
    the card alone (as `profile_step` traces the `xla` paths): busy is the
    device time of its kernels, wall the host clock to a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = sum(e.device_time_total for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy_ms, wall_ms


def fused_window_check(smi: str, run) -> None:
    """[fused]: `FUSED_STEPS` closed-loop steps from the default run's last
    carry, chained (`bench_torch.closed_loop_step`, the early exit on) and
    as a `FusedWindow` of each `FUSED_UNROLLS` steps a graph (the early exit
    off), built and captured under `torch.cuda.set_sync_debug_mode("error")`:
    the trace of u[0, 0], the last step's actions and the carries before and
    after it against the chained loop's (bit for bit expected; above
    `FUSED_TOL` fails), each capture's launches; then each mode's solves/s
    over a window of the same steps, and the card's busy time in a window of
    `FUSED_TRACED` steps traced by torch.profiler, with the idle share as
    `--profile` reads it: against the traced window's wall (upper: tracing
    slows the host, and the replay of every graph node) and against the
    untraced window's, step for step (lower)."""
    B = run.u.shape[0]
    step = lambda cfg: partial(bench_torch.closed_loop_step, run.problem, cfg, run.gp,  # noqa: E731
                               backend=run.backend, var_backend=run.var_backend,
                               var_bf16=run.var_bf16)
    chained_step = step(run.cfg)
    state = {"carry": run.carry}

    def chained(n=FUSED_STEPS):
        carry, us = state["carry"], []
        for _ in range(n):
            before = carry
            *carry, u = chained_step(*carry)
            us.append(u)
        state["carry"] = tuple(carry)
        return before, tuple(carry), us

    t0 = time.perf_counter()
    before, final, us = chained()
    torch.cuda.synchronize()
    wall = {"chained": 1e3 * (time.perf_counter() - t0)}
    u00 = torch.stack([u[0, 0] for u in us])
    traced = {"chained": profiled_window(lambda: chained(FUSED_TRACED))}
    wrappers = reset_launches()
    for k in FUSED_UNROLLS:
        captures = []
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with counting_captures(wrappers, captures):
                window = FusedWindow(step(run.cfg._replace(early_exit=False)), run.carry, k,
                                     max_steps=FUSED_STEPS)
                trace = window.run(FUSED_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        diffs = {"trace": (trace - u00).abs().max(), "u": (window.u - us[-1]).abs().max()}
        for name, got, want in (("last", window.last, before), ("carry", window.carry, final)):
            diffs[name] = max((a.double() - b.double()).abs().max()
                              for a, b in zip(tree_leaves(got), tree_leaves(want)))
        diffs = {name: float(d) for name, d in diffs.items()}
        say(f"[fused] quadrotor, {FUSED_STEPS} steps from the default run's last carry, {k} "
            f"step(s) a graph (graphs of {sorted(window.graphs)} steps), captured under "
            f"sync-debug 'error': max |fused - chained| {max(diffs.values()):.3e} ({diffs}; "
            f"bar {FUSED_TOL})")
        check_captures(f"quadrotor window, {k} a graph", captures, "ocp_ip", fused_rates({}))
        if not max(diffs.values()) <= FUSED_TOL:
            raise RuntimeError(f"fused window ({k} a graph) differs from the chained loop: {diffs}")
        mode = f"fused, {k} a graph"
        t0 = time.perf_counter()
        window.run(FUSED_STEPS).cpu()
        wall[mode] = 1e3 * (time.perf_counter() - t0)
        traced[mode] = profiled_window(lambda: window.run(FUSED_TRACED))
    say(f"[fused] quadrotor, B={B}, solves/s over {FUSED_STEPS} steps: " + ", ".join(
        f"{mode} {1e3 * B * FUSED_STEPS / ms:.2f}" for mode, ms in wall.items()) + f" on {smi}")
    for mode, (busy, traced_ms) in traced.items():
        step_ms = wall[mode] / FUSED_STEPS
        say(f"[fused] quadrotor, {mode}: card busy {busy:.2f} ms in a traced window of "
            f"{FUSED_TRACED} steps, {traced_ms:.2f} ms (idle share {1 - busy / traced_ms:.3f}, "
            f"upper); {busy / FUSED_TRACED:.3f} ms a step against {step_ms:.3f} ms a step "
            f"untraced (idle share {1 - busy / FUSED_TRACED / step_ms:.3f}, lower) on {smi}")
        if not busy > 0:
            raise RuntimeError(f"fused: the traced {mode} window shows no device time")


def fused_path_check(smi: str, tag: str, run) -> None:
    """[fused] for a BENCH_FUSED=1 run off the lanes-fused defaults (the
    xla backend, the lanes path, tier 2): the run's own window (its graph
    of one step, captured in the run) replayed from the run's last carry
    against the chained loop (`bench_torch.closed_loop_step`, the early exit
    on) from a copy of that carry, over the run's steps: the trace of
    u[0, 0], the last actions and the carries before and after the last step
    within `FUSED_TOL`, no graph captured anew; then the chained loop's
    solves/s beside the run's final line (its fused window over as many
    steps), and the card's busy time in a window of `FUSED_PATH_TRACED`
    steps traced by torch.profiler, with the idle share against the traced
    window (upper) and against the run's untraced window (lower)."""
    window, B = run.window, run.u.shape[0]
    n = window.max_steps
    step = partial(bench_torch.closed_loop_step, run.problem, run.cfg, run.gp,
                   backend=run.backend, var_backend=run.var_backend, var_bf16=run.var_bf16)
    carry, us = tree_map(torch.clone, window.carry), []
    graphs = sorted(window.graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # T = 512's one dispatch warning
        for _ in range(n):
            before = carry
            *carry, u = step(*carry)
            us.append(u)
    torch.cuda.synchronize()
    chained_ms = 1e3 * (time.perf_counter() - t0)
    trace = window.run(n)
    diffs = {"trace": (trace - torch.stack([u[0, 0] for u in us])).abs().max(),
             "u": (window.u - us[-1]).abs().max()}
    for name, got, want in (("last", window.last, before), ("carry", window.carry, tuple(carry))):
        diffs[name] = max((a.double() - b.double()).abs().max()
                          for a, b in zip(tree_leaves(got), tree_leaves(want)))
    diffs = {name: float(d) for name, d in diffs.items()}
    say(f"[fused] {tag}, {n} steps from the run's last carry, the run's window (graphs of "
        f"{graphs} steps): max |fused - chained| {max(diffs.values()):.3e} ({diffs}; bar "
        f"{FUSED_TOL})")
    if not max(diffs.values()) <= FUSED_TOL or sorted(window.graphs) != graphs:
        raise RuntimeError(f"fused {tag}: the window differs from the chained loop ({diffs}) or "
                           f"captured anew ({sorted(window.graphs)} against {graphs})")
    fused_sps = run.records[-1]["value"]
    busy, traced_ms = profiled_window(lambda: window.run(FUSED_PATH_TRACED))
    step_ms = 1e3 * B / fused_sps
    say(f"[fused] {tag}, B={B}, solves/s over {n} steps: chained {1e3 * B * n / chained_ms:.2f}, "
        f"fused {fused_sps:.2f} (the run's final line) on {smi}")
    say(f"[fused] {tag}, fused: card busy {busy:.2f} ms in a traced window of "
        f"{FUSED_PATH_TRACED} step(s), {traced_ms:.2f} ms (idle share {1 - busy / traced_ms:.3f}, "
        f"upper); {busy / FUSED_PATH_TRACED:.3f} ms a step against {step_ms:.3f} ms a step "
        f"untraced (idle share {1 - busy / FUSED_PATH_TRACED / step_ms:.3f}, lower) on {smi}")
    if not busy > 0:
        raise RuntimeError(f"fused {tag}: the traced window shows no device time")


def bench_phase(smi: str, worker: CpuWorker, problems: dict) -> None:
    """[bench]: the port's headline bench and its breakdown in-process (see
    `BENCH_RUNS`), then the default run's last step against the CPU (a job
    of the CPU worker); and [fused]: the bench with BENCH_FUSED=1 on the
    problems of earlier bench runs and smoke paths (`FUSED_RUNS`), the fused
    window held against the chained loop from the default run's carry
    (`fused_window_check`), and each run off the lanes-fused defaults held
    against its own chained loop (`fused_path_check`)."""
    t0 = time.perf_counter()
    runs = {}
    for tag, knobs in BENCH_RUNS:
        base = runs.get(BENCH_REUSE.get(tag))
        runs[tag] = bench_run(smi, tag, knobs, base.problem if base else None)
    bench_breakdown(smi)
    worker.submit(bench_cpu_parity, *bench_cpu_parity_args(runs["quadrotor"]))
    t_fused = time.perf_counter()
    t_paths = 0.0
    for tag, (base, knobs) in FUSED_RUNS.items():
        t_run = time.perf_counter()
        problem = runs[base].problem if base in runs else bench_problem(problems[base])
        run = bench_run(smi, tag, knobs, problem)
        if tag in FUSED_PATH_RUNS:
            fused_path_check(smi, tag, run)
            t_paths += time.perf_counter() - t_run
    fused_window_check(smi, runs["quadrotor"])
    say(f"[time] the [bench] phase took {time.perf_counter() - t0:.1f} s, its [fused] part "
        f"{time.perf_counter() - t_fused:.1f} s, of which the runs off the lanes-fused defaults "
        f"({', '.join(FUSED_PATH_RUNS)}) {t_paths:.1f} s")


def config_copy(out_dir: Path, **overrides) -> Path:
    """scripts/gp_mpc_config.yaml copied into `out_dir` with its save dir there
    and each of `overrides` (a key of the file) set; read back through the
    port's loader."""
    from gpmpc_tpu_torch.config import load_config

    text = (REPO / "scripts" / "gp_mpc_config.yaml").read_text()
    for key, val in dict(overrides, save_dir=f'"{out_dir}/saves/"').items():
        text, n = re.subn(rf"^(\s*{key}:).*$", rf"\g<1> {val}", text, flags=re.M)
        if n != 1:
            raise RuntimeError(f"scripts/gp_mpc_config.yaml has {n} lines of {key!r}")
    path = out_dir / "gp_mpc_config.yaml"
    path.write_text(text)
    cfg = load_config(path, make_save_dir=False)
    got = dict(sqp_iters=cfg.gpmpc.sqp_iters, qp_iters=cfg.gpmpc.qp_iters,
               iterations=cfg.train.iterations)
    if any(got[k] != v for k, v in overrides.items()):
        raise RuntimeError(f"the config copy reads {got}, not {overrides}")
    return path


def trace_kernels(trace_file: Path) -> tuple[dict, float]:
    """({kernel name: launches} of a Chrome trace's kernel events, the
    device's busy ms: the kernels', copies' and sets' durations summed). The
    trace of a profiled driver run holds millions of host events, so the
    device's events are found by their category's text (torch.profiler writes
    one key a line, each event closing at an indent of two) instead of
    parsing the whole file."""
    text = trace_file.read_text()
    names: dict = {}
    busy_us = 0.0
    for cat in ("kernel", "gpu_memcpy", "gpu_memset"):
        key = f'"cat": "{cat}"'
        i = text.find(key)
        while i >= 0:
            end = text.find("\n  }", i)
            event = text[i:end]
            if cat == "kernel":
                name = re.search(r'"name": "([^"]*)"', event).group(1)
                names[name] = names.get(name, 0) + 1
            dur = re.search(r'"dur": ([0-9.eE+-]+)', event)
            busy_us += float(dur.group(1)) if dur else 0.0
            i = text.find(key, end)
    return names, busy_us / 1e3


def default_settings_probe(drv, cfg, gp) -> tuple[float, float]:
    """ms a step of the prior controller and of the GP-MPC step (with `gp`)
    at the shipped YAML's own SQP and IP iterations on the card: one warm-up
    step, then the mean of `DEFAULT_PROBE_STEPS` on the figure-eight plant."""
    from gpmpc_tpu_torch.envs.drone import DroneFigureEightEnv

    dev = torch.device("cuda:0")
    traj = drone.make_trajectory(drone.EnvParams.default(), dev).cpu().numpy()
    ctrl = drv.build_controller(cfg, traj, dev)
    ctrl.gp_model = gp
    env = DroneFigureEightEnv(device=dev)
    out = []
    for c in (ctrl.prior_ctrl, ctrl):
        c.reset()
        obs = env.reset(seed=3)[0].cpu().numpy()
        times = []
        for _ in range(1 + DEFAULT_PROBE_STEPS):
            t0 = time.perf_counter()
            u = c.select_action(obs)
            times.append(time.perf_counter() - t0)
            obs = env.step(u)[0].cpu().numpy()
        out.append(1e3 * float(np.mean(times[1:])))
    return out[0], out[1]


def experiment_driver(results: dict) -> None:
    """[driver]: `scripts/run_gp_mpc_torch.py::main` on the card (no --device:
    the config's "tpu" is the card) at `DRIVER`'s settings with `--profile`.
    The GP-MPC steps (`GPMPC.select_action` on `lanes`: kernels 1, 2 and 4,
    forward-mode linearization in plain torch) each launch kernels 1 and 2
    once and kernel 4 once an SQP iteration; the three are held against
    their plain versions on the last step's inputs; the trace must name
    them, the CSV table must be there, every run finite, and the last
    evaluation's first steps solved again on the CPU (plain versions) within
    the control RMSE bar. Prints the phase times, the card's busy time from
    the trace and a projection of the default run."""
    from gpmpc_tpu_torch.config import load_config

    out_dir = EXPERIMENT_DIR / "driver"
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cfg_path = config_copy(out_dir, sqp_iters=DRIVER["sqp_iters"], qp_iters=DRIVER["qp_iters"],
                           iterations=DRIVER["iterations"])
    drv = load_script("run_gp_mpc_torch")
    path = SmokePath("quadrotor", 25, 1, None, "ocp_ip", 0, DRIVER["steps"], 0, 0, "driver",
                     dispatch="lanes", kernel_linearize=False)
    PATHS["quadrotor-driver"] = path
    wrappers = reset_launches()
    with Capture(path, last=True) as cap:
        t0 = time.perf_counter()
        run = drv.main(["--config", str(cfg_path), "--epochs", str(DRIVER["epochs"]),
                        "--steps", str(DRIVER["steps"]), "--profile"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    ctrl, save_dir = run["ctrl"], run["save_dir"]
    gp_runs = [run["test_runs"][e] for e in run["test_runs"] if e > 0]
    gp_runs += [run["train_runs"][e] for e in run["train_runs"] if e > 0] + [run["eval_run"]]
    n_gp_steps = sum(len(r["action"]) for r in gp_runs)
    sqp_its = sum(int(np.sum(r["controller_data"]["n_iters"])) for r in gp_runs)
    say(f"[driver] scripts/run_gp_mpc_torch.py --epochs {DRIVER['epochs']} --steps "
        f"{DRIVER['steps']} --profile ({DRIVER['sqp_iters']} SQP / {DRIVER['qp_iters']} IP "
        f"iterations, {DRIVER['iterations']} GP iterations) on {ctrl.device}, "
        f"{ctrl._resolve_step_backend()} step: {wall:.1f} s; {n_gp_steps} GP-MPC steps "
        f"({sqp_its} SQP iterations); kernel launches {launches}")
    if ctrl.device.type != "cuda" or ctrl._resolve_step_backend() != "lanes":
        raise RuntimeError("driver: the GP-MPC step did not run on the card's lanes path")
    for k, want in (("gp_posterior", n_gp_steps), ("tighten", n_gp_steps), ("ocp_ip", sqp_its)):
        if launches[k] != want:
            raise RuntimeError(f"driver: kernel {k} launched {launches[k]} times in {n_gp_steps} "
                               f"GP-MPC steps of {sqp_its} SQP iterations, not {want}")
    extra = {k: n for k, n in launches.items()
             if n and k not in ("gp_posterior", "tighten", "ocp_ip")}
    if extra:
        raise RuntimeError(f"driver: kernels off its path launched: {extra}")
    check_captured(path, "quadrotor-driver", cap, launches, results, gp_kind="gp_posterior_f64")
    # the trace of the last evaluation names each kernel
    t0 = time.perf_counter()
    trace_file = save_dir / "trace" / "trace.json"
    names, busy_ms = trace_kernels(trace_file)
    ev = run["eval_run"]
    n_ev = len(ev["action"])
    profiled_ms = 1e3 * run["timer"].samples["Final evaluation"][-1]
    unprofiled_ms = 1e3 * float(np.mean([t for r in gp_runs[:-1]
                                         for t in r["inference_time_data"][1:]]))
    say(f"[driver] trace: {trace_file.stat().st_size} bytes, read in "
        f"{time.perf_counter() - t0:.1f} s; the card busy {busy_ms / n_ev:.2f} ms a GP-MPC step "
        f"(kernels, copies and sets of the {n_ev} profiled steps); idle share "
        f"{1 - busy_ms / profiled_ms:.3f} against the profiled evaluation's "
        f"{profiled_ms / n_ev:.1f} ms a step (upper estimate), "
        f"{1 - busy_ms / n_ev / unprofiled_ms:.3f} against the unprofiled steps' "
        f"{unprofiled_ms:.1f} ms (lower)")
    for k, subs in TRACE_NAMES.items():
        hits = {n: c for n, c in names.items() if any(sub in n for sub in subs)}
        say(f"[driver] trace: {k}: {sum(hits.values())} kernel events "
            f"({', '.join(n[:60] for n in hits)})")
        if not hits:
            raise RuntimeError(f"driver: the trace names no {' or '.join(subs)} kernel")
    # the artifacts and the runs
    table = np.loadtxt(save_dir / "figs" / "runtime.csv", delimiter=",", ndmin=2)
    if table.shape != (DRIVER["epochs"] + 1, 4) or not np.isfinite(table).all():
        raise RuntimeError(f"driver: runtime.csv is {table.shape} or not finite")
    figs = sorted(p.name for p in (save_dir / "figs").iterdir())
    say(f"[driver] artifacts in figs/: {figs} (figures {'drawn' if run['figures'] else 'skipped'})")
    runs = list(run["test_runs"].values()) + list(run["train_runs"].values()) + [run["eval_run"]]
    for r in runs:
        if r["obs"].shape != (DRIVER["steps"] + 1, 12) or not np.isfinite(r["obs"]).all():
            raise RuntimeError(f"driver: a run's observations are {r['obs'].shape} or not finite")
    clamp = max(float(np.max(r["controller_data"]["tightening_clamp_frac"])) for r in gp_runs)
    if not np.isfinite(list(run["position_error"].values())).all():
        raise RuntimeError("driver: a position error is not finite")
    # the last evaluation's first steps, solved again by the plain versions on the CPU
    cfg = load_config(cfg_path, make_save_dir=False)
    cpu_ctrl = drv.build_controller(cfg, ctrl.traj.numpy(), torch.device("cpu"),
                                    step_backend="lanes")
    cpu_ctrl.gp_model = bench_torch.gp_to(ctrl.gp_model, "cpu")
    ev = run["eval_run"]
    u_cpu = np.stack([cpu_ctrl.select_action(ev["obs"][k]) for k in range(DRIVER_CPU_STEPS)])
    err = u_cpu - ev["action"][:DRIVER_CPU_STEPS]
    rmse = float(np.sqrt(np.mean(err**2)))
    say(f"[driver] the last evaluation's first {DRIVER_CPU_STEPS} steps on the CPU (plain "
        f"versions): control RMSE vs the card {rmse:.3e} (bar {RMSE_BAR}); clamp_frac max {clamp}")
    if not rmse <= RMSE_BAR:
        raise RuntimeError(f"driver: control RMSE {rmse} against the CPU exceeds {RMSE_BAR}")
    # the numbers of the run
    timer = run["timer"]
    phase_s = {name: sum(v) for name, v in timer.samples.items()}
    prior_ms = 1e3 * float(np.mean([t for e in (run["train_runs"][0], run["test_runs"][0])
                                    for t in e["inference_time_data"][1:]]))
    fit_s = phase_s["Train GP"]
    fit_its = ctrl.last_fit_info.iterations
    say("[driver] phase wall times (s): " + ", ".join(f"{k} {v:.3f}" for k, v in phase_s.items()))
    say(f"[driver] prior MPC select_action {prior_ms:.1f} ms a step; GP-MPC select_action from "
        f"runtime.csv, epoch 1: mean {1e3 * table[1, 1]:.1f} ms, max {1e3 * table[1, 3]:.1f} ms; "
        f"Train GP {fit_s:.3f} s ({fit_its} Adam iterations until every GP froze, "
        f"{1e3 * fit_s / max(fit_its, 1):.2f} ms an iteration); mean position error by epoch "
        + ", ".join(f"{e}: {v:.4f} m" for e, v in run["position_error"].items()))
    cfg_default = load_config(REPO / "scripts" / "gp_mpc_config.yaml", make_save_dir=False)
    t0 = time.perf_counter()
    prior_def, gp_def = default_settings_probe(drv, cfg_default, ctrl.gp_model)
    d = DEFAULT_RUN
    projected = (2 * d["steps"] * prior_def + (2 * d["epochs"] + 1) * d["steps"] * gp_def) / 1e3 \
        + d["epochs"] * d["iterations"] * fit_s / max(fit_its, 1)
    say(f"[driver] at the YAML's {cfg_default.gpmpc.sqp_iters} SQP / {cfg_default.gpmpc.qp_iters} "
        f"IP iterations ({time.perf_counter() - t0:.1f} s): prior MPC {prior_def:.1f} ms a step, "
        f"GP-MPC {gp_def:.1f} ms a step; projected default run ({d['epochs']} epochs x "
        f"{d['steps']} steps, {d['iterations']} GP iterations at most, plots left out): "
        f"{projected:.0f} s, of which the prior's two episodes "
        f"{2 * d['steps'] * prior_def / 1e3:.0f} s")


def experiment_eval_seeds(results: dict) -> None:
    """[eval_seeds]: `scripts/eval_seeds_torch.py::main` with `EVAL_SEEDS_ARGS`:
    the cartpole family's 4 seeds on `lanes`: the prior's baseline episode
    with the shared untrained GP (kernels 1, 2 and 4 at 4x1), then the
    seeds' GP population (kernels 2 and 4, its GP algebra in plain torch);
    each kernel held against its plain version on its last call's inputs;
    the cost matrix finite and of its shape, the CSV table written."""
    out_dir = EXPERIMENT_DIR / "eval_seeds"
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    ev = load_script("eval_seeds_torch")
    # kernels 1, 2 and 4 (kernel 1 on the shared-GP baseline episode alone)
    path = SmokePath("cartpole", 20, 4, None, "ocp_ip", 0, 60, 0, 0, "eval-seeds",
                     dispatch="lanes", degraded=True, kernel_linearize=False)
    PATHS["cartpole-eval-seeds"] = path
    wrappers = reset_launches()
    with Capture(path, last=True) as cap, warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the population path's dispatch warning
        t0 = time.perf_counter()
        res = ev.main(["--config", str(config_copy(out_dir))] + EVAL_SEEDS_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    say(f"[eval_seeds] scripts/eval_seeds_torch.py {' '.join(EVAL_SEEDS_ARGS)}: {wall:.1f} s, "
        f"backend {res['backend']}; kernel launches {launches}; cost matrix "
        + json.dumps(np.round(res["costs"], 6).tolist()))
    extra = {k: n for k, n in launches.items()
             if n and k not in ("gp_posterior", "tighten", "ocp_ip")}
    if extra or res["backend"] != "lanes":
        raise RuntimeError(f"eval_seeds: backend {res['backend']}, kernels off its path: {extra}")
    if res["costs"].shape != (2, 4) or not np.isfinite(res["costs"]).all():
        raise RuntimeError(f"eval_seeds: the cost matrix is {res['costs'].shape} or not finite")
    if not res["stem"].with_suffix(".csv").exists():
        raise RuntimeError("eval_seeds: no CSV table")
    check_captured(path, "cartpole-eval-seeds", cap, launches, results)


def experiment_gp_fit() -> None:
    """[gp_fit]: `scripts/bench_gp_fit_torch.py::main` at its default sizes and
    `GP_FIT_ITERS` iterations (plain torch.linalg, no kernel), and the fit at
    the smallest size against the same fit on the CPU."""
    bf = load_script("bench_gp_fit_torch")
    t0 = time.perf_counter()
    rows = bf.main(["--iters", str(GP_FIT_ITERS)])
    wall = time.perf_counter() - t0
    for r in rows:
        say(f"[gp_fit] {r['metric']}: {r['value']} ms an Adam iteration ({r['iters_run']} run), "
            f"first call {r['compile_plus_first_s']} s, projected 500 iterations "
            f"{r['projected_500_iter_s']} s, final loss {r['final_loss']}")
    if len(rows) != 3 or not all(r["finite"] for r in rows):
        raise RuntimeError("gp_fit: a fit's loss is not finite")
    n = int(rows[0]["metric"].split("=")[1].rstrip("]"))
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 0.5, (n, 7)).astype(np.float32)
    y = (np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.normal(size=n)).astype(np.float32)
    fits = []
    for dev in ("cuda:0", "cpu"):
        data = gp_mod.GPData(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
                             torch.ones(n, device=dev))
        fits.append(gp_mod.fit_gp(data, n_train=GP_FIT_ITERS, lr=0.01)[0])
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(*fits))
    say(f"[gp_fit] {wall:.1f} s; N={n}: max |raw hyper, card - CPU| after {GP_FIT_ITERS} "
        f"iterations {diff:.3e} (bar {GP_FIT_BAR})")
    if not diff <= GP_FIT_BAR:
        raise RuntimeError(f"gp_fit: the card's fit is {diff} from the CPU's")


# ---- scale-out: the sharded step, the multi-process driver, the dry run ------------------
MESH = dict(B=1024, shards=2, steps=3, xla_B=128)
MULTIHOST = dict(scenarios=1024, steps=5, timeout=300)
# scripts/run_multihost.py:156-200's sweep: T = 10, 3 SQP / 6 IP, 2 epochs, 20 GP iterations
MULTIHOST_SWEEP = dict(seeds=4, horizon=10, steps=20, timeout=300)


def mesh_devices(n: int) -> list[str]:
    """n shards on distinct cards where the machine has them, else shared."""
    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b.to(a.device))


def quadrotor_mesh(prob: Problem, xla_prob: Problem, results: dict) -> None:
    """[mesh]: the quadrotor's lanes-fused step at B = 1024 as two shards of
    512 (whole tiles of 128) through `make_batched_controller_step(mesh=)`,
    3 closed-loop steps against the unsharded step from the same states:
    actions, states and info equal bit for bit. Kernels 1 and 2 launch once
    per shard a step, kernels 3 and 4 once per shard an SQP iteration (each
    shard's loop ends when its own scenarios converge), and each is held
    against its plain version on the last shard's inputs. Then one xla step
    with `parallel_scan=True` against the sequential Riccati's."""
    cfg = MESH
    devices = mesh_devices(cfg["shards"])
    mesh = make_mesh(cfg["shards"], devices=devices)
    n = cfg["B"] // cfg["shards"]
    say(f"[mesh] make_mesh({cfg['shards']}, devices={devices}) on {torch.cuda.device_count()} "
        f"card(s): {'distinct cards' if len(set(devices)) == len(devices) else 'shards share a card'}")
    path = SmokePath("quadrotor", prob.path.T, n, None, "ocp_ip", 0, cfg["steps"], 0, 0, "mesh")
    PATHS["quadrotor-mesh"] = path
    es0, obs0, st0 = prob.reset(cfg["B"], seed=11)

    wrappers = reset_launches()
    ref, es, obs, st = [], es0, obs0, st0
    t0 = time.perf_counter()
    for _ in range(cfg["steps"]):
        u, st, info = prob.step(st, obs)
        ref.append((u, st, info))
        es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    torch.cuda.synchronize()
    wall_1 = time.perf_counter() - t0
    base = {k: fn.launches for k, fn in wrappers.items()}

    step = make_batched_controller_step(prob.model, prob.cfg, mesh=mesh)
    wrappers = reset_launches()
    es, obs, st = (shard_leading_axis(t, mesh) for t in (es0, obs0, st0))
    shard_iters = 0
    t0 = time.perf_counter()
    with Capture(path, last=True) as cap:
        for k in range(cfg["steps"]):
            u, st, info = step(prob.consts, prob.gp, st, obs, backend="lanes")
            shard_iters += sum(int(i.n_iters.max()) for i in info.shards)
            nxt = [prob.env.env_step(prob.env_p, e, a)[:2] for e, a in zip(es.shards, u.shards)]
            es, obs = (Sharded([x[j] for x in nxt], u.index, u.count, u.devices) for j in (0, 1))
            for what, got, want in (("actions", u, ref[k][0]), ("states", st, ref[k][1]),
                                    ("info", info, ref[k][2])):
                pairs = list(zip(tree_leaves(gather(got, mesh)), tree_leaves(want)))
                if not pairs or not all(bits_equal(a, b) for a, b in pairs):
                    raise RuntimeError(f"[mesh] step {k}: the sharded {what} differ from the "
                                       "unsharded step's")
    torch.cuda.synchronize()
    wall_2 = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    want = dict(base, gp_posterior=2 * base["gp_posterior"], tighten=2 * base["tighten"],
                linearize=shard_iters, ocp_ip=shard_iters)
    say(f"[mesh] {cfg['steps']} steps at B={cfg['B']}: actions, states and info equal bit for bit "
        f"to the unsharded step's; launches unsharded {base}, sharded {launches} (kernels 1-2: "
        f"twice the unsharded; kernels 3-4: the shards' SQP iterations {shard_iters}, twice the "
        f"unsharded would be {2 * base['ocp_ip']}); wall {1e3 * wall_1 / cfg['steps']:.1f} ms a "
        f"step unsharded, {1e3 * wall_2 / cfg['steps']:.1f} ms sharded (the comparisons "
        "included)")
    if launches != want:
        raise RuntimeError(f"[mesh] launches {launches}, expected {want}")
    check_captured(path, "quadrotor-mesh", cap, launches, results)

    # the associative-scan Riccati on the xla path against the sequential one
    es, obs, st = xla_prob.reset(cfg["xla_B"], seed=12)
    outs = []
    for scan in (False, True):
        c = xla_prob.cfg._replace(parallel_scan=scan)
        t, (u, _, _) = cuda_timed(lambda c=c: batched_gpmpc_step(  # noqa: B023
            xla_prob.model, c, xla_prob.consts, xla_prob.gp, st, obs, backend="xla"))
        outs.append((u, t))
    rmse = float(torch.sqrt(torch.mean((outs[1][0] - outs[0][0]) ** 2)))
    say(f"[mesh] quadrotor xla step at B={cfg['xla_B']}, parallel_scan=True against False: "
        f"control RMSE {rmse:.3e} (bar {RMSE_BAR}), max abs "
        f"{float((outs[1][0] - outs[0][0]).abs().max()):.3e}; {1e3 * outs[1][1]:.1f} ms against "
        f"{1e3 * outs[0][1]:.1f} ms a step")
    if not (rmse <= RMSE_BAR and bool(torch.isfinite(outs[1][0]).all())):
        raise RuntimeError("[mesh] the associative-scan Riccati's actions miss the sequential's")


def start_multihost(tag: str, extra: list, timeout: int):
    """`scripts/run_multihost_torch.py` started in a process group of its own
    (its workers join the group, so `finish_multihost` can stop them all)."""
    cmd = [sys.executable, str(REPO / "scripts" / "run_multihost_torch.py"), "--device", "cuda",
           "--worker-timeout", str(timeout - 30)] + extra
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    return tag, cmd, proc, time.perf_counter(), timeout


def finish_multihost(started, kill: bool = False) -> str:
    """Wait for a `start_multihost` run (or stop it and its workers with
    `kill`); its output, or a raise on a non-zero exit."""
    tag, cmd, proc, t0, timeout = started
    try:
        if kill:
            raise subprocess.TimeoutExpired(cmd, 0)
        out, err = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        if kill:
            return ""
        raise RuntimeError(f"[{tag}] still running after {timeout} s; stopped") from None
    say(f"[{tag}] {' '.join(cmd[1:])}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "socket.cpp" not in line:
            say(f"[{tag}]   {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"[{tag}] exit {proc.returncode}: {err[-3000:]}")
    return out


def run_multihost(tag: str, extra: list, timeout: int) -> str:
    return finish_multihost(start_multihost(tag, extra, timeout))


def run_multihost_here(tag: str, extra: list) -> str:
    """`scripts/run_multihost_torch.py`'s worker mode as the one rank of a
    group in this process (its coordinator on 127.0.0.1): the script's
    `main`, its output captured; a raise on a non-zero exit."""
    import contextlib
    import io
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["--device", "cuda", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
            "--process-id", "0"] + extra
    buf, t0 = io.StringIO(), time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = load_script("run_multihost_torch").main(argv)
    except SystemExit as e:
        rc = e.code
    out = buf.getvalue()
    say(f"[{tag}] scripts/run_multihost_torch.py {' '.join(argv)} (in this process): exit {rc} "
        f"in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        say(f"[{tag}]   {line}")
    if rc not in (0, None):
        raise RuntimeError(f"[{tag}] exit {rc}")
    return out


def metric_line(out: str, prefix: str) -> dict:
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{") and prefix in x]
    if len(lines) != 1:
        raise RuntimeError(f"expected one {prefix} line, got {len(lines)}")
    return lines[0]


def multihost() -> None:
    """[multihost]: two gloo ranks on the card at B = 1024 (shards of 512) on
    the lanes-fused step (`--fused`: the main path, whose host work two
    processes may overlap), each checking parity against its own unsharded
    run; then one NCCL rank in this process (no process start-up to pay),
    which builds a communicator and gathers on the card; the solves/s and
    idle shares of both, on the same card."""
    cfg = MULTIHOST
    common = ["--scenarios", str(cfg["scenarios"]), "--steps", str(cfg["steps"]), "--backend",
              "lanes", "--fused", "--parity", "--idle"]
    two = run_multihost("multihost", ["--virtual-hosts", "2", "--collectives", "gloo"] + common,
                        cfg["timeout"])
    one = run_multihost_here("multihost", ["--collectives", "nccl"] + common)
    for out, ranks in ((two, (0, 1)), (one, (0,))):
        for pid in ranks:
            if not re.search(rf"PARITY pid={pid} .* ok=True", out):
                raise RuntimeError(f"[multihost] rank {pid} reports no parity")
        if "ok=False" in out:
            raise RuntimeError("[multihost] a rank failed parity")
    m2, m1 = (metric_line(o, "torch_solves_per_sec") for o in (two, one))
    say(f"[multihost] at B={cfg['scenarios']} on one card ({m1['card']}): two gloo processes "
        f"{m2['value']} solves/s (idle share {m2.get('idle_share')}), one NCCL process "
        f"{m1['value']} solves/s (idle share {m1.get('idle_share')})")


def multihost_sweep_args() -> list:
    cfg = MULTIHOST_SWEEP
    return ["--sweep", str(cfg["seeds"]), "--horizon", str(cfg["horizon"]), "--steps",
            str(cfg["steps"])]


def multihost_sweep_start():
    """[multihost-sweep]: the seed sweep sharded over two gloo ranks on the
    card at the reference script's sizes. It runs beside `dryrun` (whose
    table times nothing that is kept) and `multihost_sweep_reference`."""
    return start_multihost("multihost-sweep", ["--virtual-hosts", "2", "--collectives", "gloo"]
                           + multihost_sweep_args(), MULTIHOST_SWEEP["timeout"])


def multihost_sweep_reference() -> torch.Tensor:
    """The same sweep unsharded in this process, on the script's own set-up
    (`sweep_problem`), while the ranks run theirs: the reference that
    `multihost_sweep_check` holds each rank's cost matrix against."""
    mod = load_script("run_multihost_torch")
    t0 = time.perf_counter()
    model, cfg, env_p, consts, kw = mod.sweep_problem(mod.parse_args(multihost_sweep_args()),
                                                      torch.device("cuda:0"))
    costs = seed_sweep(model, cfg, env_p, consts, **kw).costs.cpu()
    say(f"[multihost-sweep] the unsharded sweep in this process: {time.perf_counter() - t0:.1f} s")
    return costs


def multihost_sweep_check(started, want: torch.Tensor) -> None:
    """Each rank's whole cost matrix within 1e-3 relative of the unsharded
    sweep's (scripts/run_multihost.py's bar)."""
    out = finish_multihost(started)
    for pid in (0, 1):
        m = re.search(rf"SWEEP-COSTS pid={pid} (\[.*\])", out)
        if m is None:
            raise RuntimeError(f"[multihost-sweep] rank {pid} printed no cost matrix")
        got = torch.tensor(json.loads(m.group(1)), dtype=want.dtype)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"[multihost-sweep] rank {pid}: cost matrix {tuple(got.shape)}, "
                               f"want {tuple(want.shape)}, finite")
        dcost = float((got - want).abs().max())
        rel = dcost / max(1e-9, float(want.abs().max()))
        say(f"[multihost-sweep] rank {pid} against the unsharded sweep: max|dcost| {dcost:.3e}, "
            f"relative {rel:.3e} (bar 1e-3)")
        if not rel < 1e-3:
            raise RuntimeError(f"[multihost-sweep] rank {pid}: relative {rel:.3e} >= 1e-3")
    metric_line(out, "torch_sweep")


def dryrun() -> None:
    """[dryrun]: `parallel/dryrun.py::dryrun_multichip` over two shards of
    the card (its four bars, the weak-scaling table, the sharded sweep)."""
    t0 = time.perf_counter()
    r = dryrun_multichip(2, devices=mesh_devices(2))
    say(f"[dryrun] dryrun_multichip(2, devices={mesh_devices(2)}): {time.perf_counter() - t0:.1f} "
        f"s, deltas {r['deltas']}, table {[(d, b, round(v, 1)) for d, b, v in r['table']]}")


def chain_inputs(dev):
    """Each chain kernel's input at the reference's sizes and on its data,
    in lanes layout and as (B, T, n, n) for the library call."""
    mats = roofline.reference_mats()
    by_width = {12: torch.as_tensor(mats, device=dev),
                16: torch.as_tensor(roofline.pad16_mats(mats), device=dev)}
    inputs = {}
    for name, (_, _, _, _, lanes, stages, n, dtype, _) in CHAINS.items():
        flat = by_width[n][:, :stages].to(dtype).contiguous()
        inputs[name] = (roofline.to_lanes(flat, lanes), flat)
    return inputs


def check_chains(dev, results: dict) -> dict:
    """Phase 1 for kernels 7-9 and the roofline rows. Returns the rows'
    GFLOP/s by name."""
    inputs = chain_inputs(dev)
    for name, (fn, plain, *_rest) in CHAINS.items():
        x, _ = inputs[name]
        kind = "chain_bf16" if x.dtype == torch.bfloat16 else "chain"
        out_k, out_p = fn(x, CHAIN_ROUNDS).float(), plain(x, CHAIN_ROUNDS).float()
        rel = float(((out_k - out_p).abs() / out_p.abs().clamp_min(1.0)).max())
        err = float((out_k - out_p).abs().max())
        ok = bool(torch.isfinite(out_k).all()) and rel <= TOL[kind]
        fin_k = torch.isfinite(fn(x, roofline.N_CHAIN).float())
        fin_p = torch.isfinite(plain(x, roofline.N_CHAIN).float())
        same = bool(torch.equal(fin_k, fin_p))
        say(f"[phase 1] {name:28s} {CHAIN_ROUNDS} rounds, x {tuple(x.shape)} {x.dtype}: max|kernel - "
            f"plain| = {err:.3e}, relative to max(1, |plain|) {rel:.3e} (tolerance {TOL[kind]:.3e}) "
            f"{'ok' if ok else 'FAIL'}; after {roofline.N_CHAIN} rounds {float(fin_p.float().mean()):.4f}"
            f" of the plain entries are finite, the kernel's pattern is "
            f"{'the same' if same else 'DIFFERENT'}")
        if not (ok and same):
            raise RuntimeError(f"{name}: kernel disagrees with its plain version")
        results[name] = dict(max_abs_err=err)
    # the roofline entry point is these kernels' main path
    for fn, *_rest in CHAINS.values():
        fn.launches = 0
    gflops = {}
    for rec in roofline.iter_rows(dev):
        say(json.dumps(rec))
        gflops[rec["metric"].split("[")[1][:-1]] = rec["value"]
    launches = {name: fn.launches for name, (fn, *_rest) in CHAINS.items()}  # of the rows' run alone
    for name, (fn, plain, replaces, row, lanes, stages, n, dtype, peak) in CHAINS.items():
        if launches[name] <= 0:
            raise RuntimeError(f"{name}: the roofline rows did not launch it")
        x, flat = inputs[name]
        ms_k, runs_k, _ = timed(lambda: fn(x, roofline.N_CHAIN))
        ms_p, runs_p, _ = timed(lambda: plain(x, roofline.N_CHAIN), plain=True)
        ms_l, runs_l, _ = timed(lambda: roofline.torch_batched_chain(flat, roofline.N_CHAIN))
        flops = roofline.useful_flops(stages, roofline.N_CHAIN)
        t_b, t_f = 2 * tensor_bytes(x) / PEAK_BYTES_PER_S, flops / peak
        bnd = Bound(1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations",
                    2 * tensor_bytes(x), int(flops))
        dev_ms = device_ms(lambda: fn(x, roofline.N_CHAIN))
        ceiling = "" if n == 16 else (
            f", the instruction mix's ceiling {100 * chain_ceiling(dtype):.1f} %")
        say(f"[phase 1] {name:28s} {roofline.N_CHAIN} rounds: kernel {ms_k:.4f} ms (median of "
            f"{runs_k}), plain {ms_p:.4f} ms ({runs_text(runs_p)}), one torch.matmul a round "
            f"{ms_l:.4f} ms (median of {runs_l}); on the device {dev_ms:.4f} ms, "
            f"{100 * bnd.ms / dev_ms:.1f} % of its bound {bnd.ms:.5f} ms at "
            f"{peak / 1e12:.1f} TFLOP/s{ceiling}")
        results[name] = result_entry(
            name, "gpmpc_tpu_torch/csrc/lanes_chain.cu", replaces, results[name]["max_abs_err"],
            ms_k, ms_p, bnd, launches=launches[name], library_ms=ms_l, dev_ms=dev_ms)
    return gflops


def chain_share(prob: Problem, gflops: dict) -> None:
    """What share of the measured lane-chain rate the resident QP kernel's
    products reach, per SM at work. The chain (kernel 7) launches the blocks
    `cuda_chain.chain_geometry` gives its tiles of 128 lanes; at the probe's
    size they are more than the card has SMs and few enough for one wave
    (1,000 warps), so every SM works. The QP kernel runs a cluster of blocks a
    tile (`cuda_ocp.resident_geometry`), at B=1024 fewer blocks than SMs, so
    the rates are compared per SM that holds a block."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cg = cuda_chain.chain_geometry("f32", roofline.LANES)
    chain_blocks = cg.blocks(roofline.B // roofline.LANES * roofline.T)
    chain_sms = min(sms, chain_blocks)
    chain_rate = gflops["cuda_lanes"] / chain_sms
    g = cuda_ocp.resident_geometry(prob.model.nx, prob.model.nu, LANES)
    qp_blocks = min(sms, (prob.path.B // LANES) * g.cluster)
    qp_rate = prob.rates["qp"] / 1e9 / qp_blocks
    say(f"[phase 1] per SM at work: the lane chain reaches {chain_rate:.2f} GFLOP/s "
        f"({gflops['cuda_lanes']:.1f} over {chain_sms} SMs: {chain_blocks} blocks of "
        f"{cg.slots_per_block} threads), the resident QP kernel on "
        f"{prob.path_name} {qp_rate:.3f} GFLOP/s ({prob.rates['qp'] / 1e9:.2f} over {qp_blocks} SMs, "
        f"one block of {g.threads} threads each): {100 * qp_rate / chain_rate:.2f} % of the chain's "
        "rate")


def profile_step(prob: Problem) -> None:
    """Device time of one warm step's kernels (torch.profiler), with two
    readings of the idle share. Against the profiled step's own wall time
    both numbers come from the same step, but the profiler slows the host and
    not the kernels, so that reading is an upper estimate. Against phase 2's
    mean unprofiled step the host runs at its own speed, but busy time and
    step time come from different steps (another seed's warm step), and that
    reading is the lower estimate. A path without kernels (the `xla` paths:
    some 10^5 launches a step at T=25, 10^6 at T=800) is traced on the card
    alone, without the host's operator events, and after one warm step."""
    from torch.profiler import ProfilerActivity, profile

    es, obs, st = prob.reset(prob.path.B, seed=2)
    for _ in range(2 if prob.path.kernels else 1):
        u, st, _ = prob.step(st, obs)
        es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if prob.path.kernels:
        activities.insert(0, ProfilerActivity.CPU)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        prob.step(st, obs)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.device_time_total)[:4]
    say(f"[profile] {prob.path_name}: card busy {busy_ms:.1f} ms; the profiled step took "
        f"{wall_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}, upper estimate), phase 2's "
        f"unprofiled steps {prob.ms_per_step:.1f} ms each (idle share "
        f"{1 - busy_ms / prob.ms_per_step:.3f}, lower estimate); top: " + ", ".join(
            f"{e.key[:40]} {e.device_time_total / 1e3:.2f} ms x{e.count}" for e in top))
    tighten = [e for e in rows if "tighten" in e.key]  # the two kernels of kernel 2, apart
    say(f"[profile] {prob.path_name}: kernel 2's launches: " + ", ".join(
        f"{e.key[:40]} {e.device_time_total / 1e3:.4f} ms x{e.count}" for e in tighten))


def main() -> int:
    # ---- phase 0: card, build ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[phase 0] card: {smi}")
    say(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    worker = CpuWorker()  # phase 3 beside the card's phases
    say(f"[phase 0] CPU worker for phase 3: pid {worker.proc.pid}, torch threads pinned to cores "
        f"{worker.cores} of {sorted(os.sched_getaffinity(0))}")
    t0 = time.perf_counter()
    _build.load_library()
    per_source = ", ".join(f"{k} {v:.1f} s" for k, v in _build.BuildInfo.per_source.items())
    say(f"[phase 0] kernel build: {time.perf_counter() - t0:.1f} s (nvcc in parallel "
        f"{_build.BuildInfo.seconds:.1f} s: {per_source}; cached={_build.BuildInfo.cached})")
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[phase 0] ptxas: {line.strip()}")
    for e in ptxas_entries(_build.BuildInfo.log):
        if any(k in e["entry"] for k in ("tiled_kernel", "tiled_reduce", "dmma_probe")):
            say(f"[phase 0] ptxas, kernel 1 tiled ({e['entry']}): {e['registers']} registers, "
                f"{e['stack']} bytes stack frame, {e['spill_stores']} / {e['spill_loads']} bytes "
                "spill stores / loads")
        if (kernel := chain_kernel_number(e["entry"])) is None:
            continue
        say(f"[phase 0] ptxas, kernel {kernel} ({e['entry']}): {e['registers']} registers, "
            f"{e['stack']} bytes stack frame, {e['spill_stores']} / {e['spill_loads']} bytes "
            "spill stores / loads")
        if kernel in (7, 8) and (e["stack"] or e["spill_stores"] or e["spill_loads"]):
            raise RuntimeError(f"kernel {kernel} keeps its matrix in local memory, not registers")
    lib = _build.load_library()
    sms = cuda_gp.sm_count(dev)
    say(f"[phase 0] kernel 1 tiled: {lib.gp_tiled_shared_bytes()} bytes of shared memory a block "
        f"(cuda_gp.TILED_SHARED_BYTES {cuda_gp.TILED_SHARED_BYTES}), {2 * sms} blocks "
        f"the row split aims at on {sms} SMs; plan at the two-link exact GP's B = 1 launch "
        f"{cuda_gp.gp_tiled_plan(2, 20, 304, 6, sms)}")
    if lib.gp_tiled_shared_bytes() != cuda_gp.TILED_SHARED_BYTES:
        raise RuntimeError("cuda_gp.TILED_SHARED_BYTES disagrees with the library's")
    for nx, nu in ((12, 4), (4, 1), (4, 2)):
        g = cuda_ocp.resident_geometry(nx, nu, LANES)
        lib_bytes = [getattr(lib, k + "_shared_bytes")(nx, nu, g.scenarios_per_block)
                     for k in _build.OCP_IP_KERNELS]
        say(f"[phase 0] resident QP kernel (all three tiers) at {nx}x{nu}: a team of {g.team} "
            f"threads a scenario, {g.scenarios_per_block} scenarios ({g.threads} threads) a block, "
            f"a cluster of {g.cluster} blocks a tile of {LANES}, {g.shared_bytes} bytes of shared "
            f"memory a block (the library's count for {', '.join(_build.OCP_IP_KERNELS)}: "
            f"{lib_bytes}); {8 * g.cluster} blocks at B=1024, {2 * g.cluster} at B=256")
        if lib_bytes != [g.shared_bytes] * len(lib_bytes):
            raise RuntimeError("resident_geometry's shared memory disagrees with the library's")
    for kernel, soft, T in (("ocp_ip", False, 50), ("ocp_ip", True, 50),
                            ("ocp_ip_streamed", False, 400), ("ocp_ip_streamed", True, 320),
                            ("ocp_ip_streamed2", False, 1024), ("ocp_ip_streamed2", True, 768)):
        name = kernel + ("_soft" if soft else "")
        per_tile = 4 * LANES * getattr(_build.load_library(), name + "_workspace_floats")(T, 12, 4)
        say(f"[phase 0] workspace of {name} at its cap T={T}, 12x4: "
            f"{per_tile} bytes per tile of {LANES}, {8 * per_tile} bytes at B=1024")

    results, extra, captured, problems = {}, [], {}, {}
    t_run = time.perf_counter()
    gflops = check_chains(dev, results)  # phase 1, kernels 7-9 and the roofline rows
    say(f"[time] roofline probe done at {time.perf_counter() - t_run:.0f} s")
    recorded = {}
    for path_name in list(PATHS):
        prob = problems[path_name] = Problem(path_name, dev)
        if prob.path.kernels:
            check_kernels(prob, results, captured)  # phase 1
        rec_obs, rec_u = recorded[path_name] = closed_loop(prob, results)  # phase 2
        if path_name == "quadrotor-jacfwd":
            analytic_jacobian_run(dev, rec_u)
        if path_name == "quadrotor-xla":
            xla_against_lanes(prob, problems["quadrotor"], *recorded["quadrotor"])
        if path_name == "quadrotor-nominal":
            nominal_episode(prob, rec_u)
        trained = TRAINED.get(path_name)
        worker.submit(cpu_parity, path_name, [o.cpu() for o in rec_obs],  # phase 3
                      [u.cpu() for u in rec_u],
                      None if trained is None else bench_torch.gp_to(trained, "cpu"))
        say(f"[time] {path_name} done at {time.perf_counter() - t_run:.0f} s")
    twolink_exact_learned(dev, results)
    say(f"[time] twolink-exact-learned done at {time.perf_counter() - t_run:.0f} s")
    quadrotor_sweep(dev, results)
    say(f"[time] quadrotor-sweep done at {time.perf_counter() - t_run:.0f} s")
    step_options(problems["quadrotor"], recorded["quadrotor"][0])
    quadrotor_server(problems["quadrotor"], results)
    say(f"[time] quadrotor-server done at {time.perf_counter() - t_run:.0f} s")
    bench_phase(smi, worker, problems)
    say(f"[time] bench done at {time.perf_counter() - t_run:.0f} s")
    t_exp = time.perf_counter()
    experiment_driver(results)
    say(f"[time] driver done at {time.perf_counter() - t_run:.0f} s")
    experiment_eval_seeds(results)
    say(f"[time] eval_seeds done at {time.perf_counter() - t_run:.0f} s")
    experiment_gp_fit()
    say(f"[time] gp_fit done at {time.perf_counter() - t_run:.0f} s; the three experiment "
        f"phases took {time.perf_counter() - t_exp:.0f} s")
    t_scale = time.perf_counter()
    quadrotor_mesh(problems["quadrotor"], problems["quadrotor-xla"], results)
    say(f"[time] mesh done at {time.perf_counter() - t_run:.0f} s")
    multihost()
    say(f"[time] multihost done at {time.perf_counter() - t_run:.0f} s")
    sweep_run = multihost_sweep_start()
    try:
        dryrun()
        say(f"[time] dryrun done at {time.perf_counter() - t_run:.0f} s")
        sweep_want = multihost_sweep_reference()
    except BaseException:
        finish_multihost(sweep_run, kill=True)
        raise
    multihost_sweep_check(sweep_run, sweep_want)
    say(f"[time] multihost-sweep done at {time.perf_counter() - t_run:.0f} s; the four "
        f"scale-out phases took {time.perf_counter() - t_scale:.0f} s")
    chain_share(problems["quadrotor"], gflops)
    stress = lambda gp: gp._replace(hypers=gp.hypers._replace(  # noqa: E731
        raw_outputscale=torch.full_like(gp.hypers.raw_outputscale, STRESS_OUTPUTSCALE)))
    closed_loop(Problem("quadrotor-soft", dev, gp_edit=stress), results, stress=True)
    check_gp_kernel_level(dev, extra, captured)
    check_kernel_level_only(dev, captured, extra)
    say(f"[time] kernel-level checks done at {time.perf_counter() - t_run:.0f} s")
    say(f"[time] the CPU worker's jobs joined at {time.perf_counter() - t_run:.0f} s (waited "
        f"{worker.join():.1f} s)")
    if "--profile" in sys.argv[1:]:
        for prob in problems.values():
            profile_step(prob)

    order = [entry_name(p, k) for p, path in PATHS.items() for k in path.kernels] + list(CHAINS)
    print(json.dumps({"kernels": [results[e] for e in order], "kernel_level_only": extra}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

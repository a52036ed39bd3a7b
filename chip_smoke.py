"""On-card smoke run of the PyTorch/CUDA port (`gpmpc_tpu_torch`).

    python3 chip_smoke.py [--profile]

Needs one CUDA card and `nvcc`; there is no CPU path. It drives the
`lanes-fused` closed loop on six paths (`PATHS`): each model family at
`bench.py`'s configuration for it (`BENCH_MODEL=quadrotor|cartpole|twolink`:
T=25, B=1024, the family's GPs with capacity 128 and 40 FITC inducing points,
prob 0.95, 6 SQP / 10 Mehrotra IP iterations, IP exit at gap 1e-6, in-kernel
linearization, the family's cost weights, boxes and `lm_reg`, the plant on the
card), and the quadrotor with soft state bounds (`quadrotor-soft`,
soft_constraints=50: the resident QP kernel's soft mode), at T=100, B=256
(`quadrotor-T100`: the tier-1 streamed QP kernel) and at T=360, B=256 with
soft bounds (`quadrotor-soft-T360`: the tier-2 streamed QP kernel, soft).
Phases, each printing its own lines:

  0. the card's name and power limit (nvidia-smi), then the kernel build:
     one nvcc per source in parallel, each source's time and ptxas's
     register and spill report for every instantiation; the workspace the QP
     wrappers allocate at each horizon cap;
  1. per path, each kernel of the path against its plain PyTorch version on
     the card, on inputs captured from the path's first warm-started step and
     on seeded random inputs at the path's shapes (soft QPs with boxes tight
     enough to force violations): max abs difference beside the stated
     tolerance, the median time of each (CUDA events) and the least time the
     card could take (`bound_ms`, see `Bound`). Then the QP instantiations no
     path of this script reaches, on random inputs: the narrow widths (4, 1)
     and (4, 2) of every new kernel, the four horizon caps at 12x4 (tier 1 at
     T=400 and at T=320 soft, tier 2 at T=1024 and at T=768 soft), kernels
     1-3 at T=400, and the resident kernel called directly on the T=100 QP
     beside the streamed one;
  2. per path, the closed loop: warm-up and timed steps with every kernel's
     launch count (counts set to 0 just before the path's run and read just
     after: the path's QP wrapper must have launched, the other two not),
     finite actions, clamp fraction, soft violation, SQP iterations and QP
     gaps; then five `quadrotor-soft` steps with the GP's raw_outputscale at
     30, which must report soft violations and stay finite;
  3. per path, the same observations for the first scenarios solved by the
     port's plain path on the CPU: control RMSE against the card's actions
     <= 1e-3.

`--profile` adds a torch.profiler pass over one step of each quadrotor path
and prints the card's busy time with the idle share against the profiled
step and against phase 2's unprofiled steps.

Prints a JSON line of per-kernel results (`kernels`: one entry per path and
kernel, with the launches of that path's run; `kernel_level_only`: the
instantiations held in phase 1 alone), the nvidia-smi line, then as its last
line {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from gpmpc_tpu_torch import _build, convert  # noqa: E402
from gpmpc_tpu_torch.control import gpmpc as gpmpc_mod  # noqa: E402
from gpmpc_tpu_torch.control import mpc as mpc_mod  # noqa: E402
from gpmpc_tpu_torch.envs import cartpole_env, drone, twolink_env  # noqa: E402
from gpmpc_tpu_torch.models import cartpole, twolink  # noqa: E402
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS  # noqa: E402
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude  # noqa: E402
from gpmpc_tpu_torch.ops import cuda_gp, cuda_linearize, cuda_ocp, cuda_tighten, sqp_lanes  # noqa: E402
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step  # noqa: E402

LANES = 128
RMSE_BAR = 1e-3
SOFT_PENALTY = 50.0  # tests/test_pallas_ocp.py's soft_constraints
STRESS_OUTPUTSCALE = 30.0

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


PATHS = {
    "quadrotor": SmokePath("quadrotor", 25, 1024, None, "ocp_ip", 2, 20, 128, 10, None),
    "cartpole": SmokePath("cartpole", 25, 1024, None, "ocp_ip", 2, 20, 128, 10, None),
    "twolink": SmokePath("twolink", 25, 1024, None, "ocp_ip", 2, 20, 128, 10, None),
    "quadrotor-soft": SmokePath("quadrotor", 25, 1024, SOFT_PENALTY, "ocp_ip", 2, 20, 128, 10, "soft"),
    "quadrotor-T100": SmokePath("quadrotor", 100, 256, None, "ocp_ip_streamed", 1, 5, 32, 3, "T100"),
    "quadrotor-soft-T360": SmokePath("quadrotor", 360, 256, SOFT_PENALTY, "ocp_ip_streamed2", 1, 2, 32,
                                 2, "soft-T360"),
}

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
TOL_TEXT = {
    "gp_posterior": "1e-4 on mean and var",
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
# kernel -> (wrapper, plain version, source, TPU kernel it replaces)
KERNELS = {
    "gp_posterior": (cuda_gp.gp_mean_var, cuda_gp.gp_mean_var_plain,
                     "gpmpc_tpu_torch/csrc/gp_posterior.cu", "gpmpc_tpu/ops/pallas_gp.py:64"),
    "tighten": (cuda_tighten.tighten_lanes, cuda_tighten.tighten_lanes_plain,
                "gpmpc_tpu_torch/csrc/tighten.cu", "gpmpc_tpu/ops/pallas_tighten.py:93"),
    "linearize": (cuda_linearize.linearize_ocp_lanes, cuda_linearize.linearize_ocp_lanes_plain,
                  "gpmpc_tpu_torch/csrc/linearize.cu", "gpmpc_tpu/ops/pallas_linearize.py:407"),
}
LINEARIZE_CLOSURES = {"cartpole": "gpmpc_tpu/ops/pallas_linearize.py:170",
                      "twolink": "gpmpc_tpu/ops/pallas_linearize.py:235"}
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


def qp_source(wrapper_name: str, soft: bool) -> str:
    return f"gpmpc_tpu_torch/csrc/{wrapper_name}{'_soft' if soft else ''}.cu"


def entry_name(path_name: str, kernel: str) -> str:
    """Name of the JSON entry of `kernel` ('gp_posterior', 'tighten',
    'linearize' or 'qp') on a path."""
    p = PATHS[path_name]
    if p.tag is None:
        return OLD_NAMES[(path_name, kernel)]
    if kernel == "qp":
        return f"{p.qp}{'_soft' if p.soft else ''}"
    return f"{kernel}[{p.tag}]"


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


def bound(n_bytes: int, flops: int) -> Bound:
    t_b, t_f = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS
    return Bound(1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations", int(n_bytes),
                 int(flops))


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def bound_gp(args, out) -> Bound:
    """N queries against the M live points in D dims: the kernel vector
    (3 D + 2 per pair), the mean (2 M) and the variance's quadratic form
    (2 M^2 + 2 M). The wrapper takes the points padded to the GP's capacity
    with a mask; padded, masked points are no work, so both operations and
    bytes count the live ones (Z, alpha and the M x M form at their live
    size, the queries, the hyperparameters, mean and variance)."""
    z, _, _, _, ell = args[:5]
    n, d = z.shape
    m = int((args[7] != 0).sum())
    n_bytes = 4 * (n * d + m * d + m + m * m + ell.numel() + 2 + 2 * n)
    return bound(n_bytes, n * (2 * m * m + m * (3 * d + 6)))


def bound_tighten(args, out) -> Bound:
    """Per scenario and stage: (A+BK) cov (A+BK)^T as two nx^3 products, the
    diagonal of K cov K^T, the disturbance diagonal."""
    b, t, nd = args[0].shape
    nx, nu = args[2].shape
    return bound(tensor_bytes(*args, *out), b * t * (4 * nx**3 + 2 * nu * nx * nx + 2 * nu * nx + nd))


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

    def __init__(self, path_name: str, device, gp_edit=None):
        self.path_name, self.path = path_name, PATHS[path_name]
        p, c = self.path, FAMILIES[PATHS[path_name].family]
        self.family, self.env = p.family, c["env"]
        self.env_p = self.env.EnvParams.default()
        self.model = c["model"]()
        ctrl = gpmpc_mod.GPMPC(
            self.model, self.env.make_trajectory(self.env_p, device).cpu().numpy(), c["prior"],
            horizon=p.T, q_mpc=c["q_mpc"], r_mpc=c["r_mpc"], prob=0.95, sqp_iters=6, qp_iters=10,
            device=device, bounds=c["bounds"], lm_reg=c["lm_reg"], soft_constraints=p.soft,
        )
        self.consts = ctrl.consts
        self.cfg = ctrl.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
        self.gp = convert.load_bench_gp(device, p.family)
        if gp_edit is not None:
            self.gp = gp_edit(self.gp)
        self.device = device

    def reset(self, batch: int, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        es, obs = self.env.env_reset(self.env_p, batch, gen, self.device)
        st = mpc_mod.init_state(batch, self.path.T, self.model.nx, self.model.nu, device=self.device)
        return es, obs, st

    def step(self, st, obs, lanes=None):
        return batched_gpmpc_step(self.model, self.cfg, self.consts, self.gp, st, obs,
                                  lanes=lanes or LANES)


def timed(fn):
    """(median ms of single calls each bracketed by CUDA events, number of
    timed runs, the last call's outputs). A warm-up call comes first; the
    number of runs follows its time: 21 below 50 ms, 5 below 1 s, else 1."""

    def once():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    warm, out = once()
    runs = 21 if warm < 50 else 5 if warm < 1000 else 1
    times = []
    for _ in range(runs):
        ms, out = once()
        times.append(ms)
    return statistics.median(times), runs, out


class Capture:
    """Records the arguments of the first call of each kernel wrapper while
    enabled, by wrapping the names the consumer modules call."""

    def __init__(self, qp_name: str):
        qp_attr = QP_WRAPPERS[qp_name][0].__name__
        self.sites = [
            (gpmpc_mod, "gp_mean_var", "gp_posterior"),
            (gpmpc_mod, "tighten_lanes", "tighten"),
            (sqp_lanes, "linearize_ocp_lanes", "linearize"),
            (sqp_lanes, qp_attr, "qp"),
        ]
        self.args = {}
        self._orig = []

    def __enter__(self):
        for mod, attr, name in self.sites:
            orig = getattr(mod, attr)
            self._orig.append((mod, attr, orig))

            def wrapper(*a, _orig=orig, _name=name, **k):
                if _name not in self.args:
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
    """Seeded random inputs of kernels 1-3 and the path's QP kernel at the
    path's shapes and horizon T (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    dev, B = prob.device, prob.path.B
    t = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"), device=dev)  # noqa: E731
    gp, consts, model = prob.gp, prob.consts, prob.model
    nx, nu = model.nx, model.nu
    G, _, D = gp.Zs.shape
    n_tiles = B // LANES
    F = torch.nn.functional
    inputs = {}
    # kernel 1: N = B*T queries against GP 0's padded variance form
    pad = 128 - gp.var_Z.shape[1]
    inputs["gp_posterior"] = (
        (t(rng.normal(0, 0.4, (B * T, D))), F.pad(gp.var_Z[0], (0, 0, 0, pad)),
         F.pad(gp.alpha_s[0], (0, pad)), F.pad(gp.var_mat[0], (0, pad, 0, pad)),
         gpmpc_mod.softplus(gp.hypers.raw_lengthscale[0]),
         gpmpc_mod.softplus(gp.hypers.raw_outputscale[0]),
         gpmpc_mod.softplus(gp.hypers.raw_noise[0]) + 1e-6, F.pad(gp.var_mask[0], (0, pad))),
        {},
    )
    # kernel 2: disturbance diagonals in the range a trained GP produces
    inputs["tighten"] = (
        (t(rng.uniform(1e-6, 4e-4, (B, T, consts.Bd.shape[1]))), consts.Ad, consts.Bd_in,
         consts.lqr_gain, consts.Bd, consts.inverse_cdf),
        {},
    )
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
    inputs["qp"] = random_qp_call(dev, n_tiles, T, nx, nu, prob.path.soft is not None)
    return inputs


def compare(entry, label, kind, fn, plain, a, k, time_plain=True):
    """One kernel-vs-plain comparison on the card; raises on disagreement.
    Returns (max abs err, kernel ms, plain ms or None, kernel outputs)."""
    ms_k, runs_k, out_k = timed(lambda: fn(*a, **k))
    if time_plain:
        ms_p, runs_p, out_p = timed(lambda: plain(*a, **k))
    else:
        ms_p, runs_p, out_p = None, 0, plain(*a, **k)
        torch.cuda.synchronize()
    err, ok = tolerance_check(kind, out_k, out_p)
    times = f"kernel {ms_k:.4f} ms (median of {runs_k})"
    if time_plain:
        times += f", plain {ms_p:.4f} ms (median of {runs_p})"
    say(f"[phase 1] {entry:28s} {label:12s}: max|kernel - plain| = {err:.3e} "
        f"(tolerance {TOL_TEXT[kind]}) {'ok' if ok else 'FAIL'}; {times}")
    if not ok:
        raise RuntimeError(f"{entry}: kernel disagrees with its plain version ({label})")
    return err, ms_k, ms_p, out_k


def kernel_bound(name, fn, a, k, out) -> Bound:
    if name == "gp_posterior":
        return bound_gp(a, out)
    if name == "tighten":
        return bound_tighten(a, out)
    if name == "linearize":
        return bound_linearize(a, k, out)
    return bound_ocp(a[0], k, out, fn.last_iterations)


def result_entry(entry, source, replaces, err, ms_k, ms_p, bnd: Bound, launches=0):
    say(f"[phase 1] {entry:28s} bound {bnd.ms:.5f} ms by {bnd.by} ({bnd.bytes} bytes, "
        f"{bnd.flops} operations): the kernel reaches {100 * bnd.ms / ms_k:.2f} % of it")
    return dict(name=entry, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=bnd.ms, bound_by=bnd.by,
                library_ms=None)


def check_kernels(prob: Problem, results: dict, captured: dict) -> None:
    """Phase 1 for one path: every kernel of the path against its plain
    version, on the first warm-started step's inputs and on random ones."""
    path = prob.path
    es, obs, st = prob.reset(path.B, seed=0)
    u, st, _ = prob.step(st, obs)
    es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    with Capture(path.qp) as cap:  # the first warm-started step
        prob.step(st, obs)
    torch.cuda.synchronize()
    missing = {"gp_posterior", "tighten", "linearize", "qp"} - set(cap.args)
    if missing:
        raise RuntimeError(f"{prob.path_name}: warm-started step launched no {sorted(missing)}")
    captured[prob.path_name] = cap.args
    soft = path.soft is not None
    random_Ts = (path.T, 400) if path.T == 360 else (path.T,)
    rand = {T: random_inputs(prob, T) for T in random_Ts}
    for name in ("gp_posterior", "tighten", "linearize", "qp"):
        entry = entry_name(prob.path_name, name)
        if name == "qp":
            fn, plain, replaces = QP_WRAPPERS[path.qp]
            src, kind = qp_source(path.qp, soft), "ocp_soft" if soft else "ocp"
        else:
            fn, plain, src, replaces = KERNELS[name]
            kind = name
            if name == "linearize":
                replaces = LINEARIZE_CLOSURES.get(prob.family, replaces)
        a, k = cap.args[name]
        worst, ms_k, ms_p, out_k = compare(entry, "real step", kind, fn, plain, a, k)
        bnd = kernel_bound(name, fn, a, k, out_k)
        for T in random_Ts:
            if name == "qp" and T != path.T:
                continue  # the QP kernels' caps have their own checks
            a_r, k_r = rand[T][name]
            label = "random" if T == path.T else f"random T={T}"
            worst = max(worst, compare(entry, label, kind, fn, plain, a_r, k_r, time_plain=False)[0])
        results[entry] = result_entry(entry, src, replaces, worst, ms_k, ms_p, bnd)


def check_kernel_level_only(dev, captured: dict, extra: list) -> None:
    """Phase 1 for the QP instantiations no path of this script reaches, on
    random inputs; the horizon caps; the resident kernel beside the streamed
    one at T=100."""
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
        err, ms_k, ms_p, out_k = compare(entry, f"random T={T}", kind, fn, plain, a, k)
        extra.append(result_entry(entry, qp_source(name, soft), replaces, err, ms_k, ms_p,
                                  bound_ocp(a[0], k, out_k, fn.last_iterations)))
    # the horizon caps at 12x4, one tile each, one comparison call each
    for name, soft, T in (("ocp_ip_streamed", False, sqp_lanes.MAX_STREAM_HORIZON),
                          ("ocp_ip_streamed", True, sqp_lanes.MAX_STREAM_HORIZON_SOFT),
                          ("ocp_ip_streamed2", False, sqp_lanes.MAX_STREAM2_HORIZON),
                          ("ocp_ip_streamed2", True, sqp_lanes.MAX_STREAM2_HORIZON_SOFT)):
        fn, plain, _ = QP_WRAPPERS[name]
        a, k = random_qp_call(dev, 1, T, 12, 4, soft)
        compare(f"{name}{'_soft' if soft else ''}[12x4]", f"cap T={T}", "ocp_soft" if soft else "ocp",
                fn, plain, a, k, time_plain=False)
    # whether the tier earns its keep on this card: both kernels on the QP of
    # the T=100 path's first warm-started step, in turns
    a, k = captured["quadrotor-T100"]["qp"]
    res, stre = cuda_ocp.solve_ocp_qp_lanes, cuda_ocp.solve_ocp_qp_lanes_streamed
    ms = [timed(lambda f=f: f(*a, **k))[0] for f in (res, stre, stre, res)]
    d = max(float((x - y).abs().max()) for x, y in zip(res(*a, **k)[:2], stre(*a, **k)[:2]))
    say(f"[phase 1] T=100, B=256 real-step QP: resident kernel {ms[0]:.3f} / {ms[3]:.3f} ms, tier-1 "
        f"streamed kernel {ms[1]:.3f} / {ms[2]:.3f} ms (resident, streamed, streamed, resident); "
        f"max|resident - streamed| = {d:.3e}")
    if not d <= TOL["ocp"]:
        raise RuntimeError("the resident and the streamed kernel disagree at T=100")


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
    for i in range(n_warmup + n_timed):
        if i == n_warmup:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        u, st, info = prob.step(st, obs)
        if i < path.cpu_steps:
            rec_obs.append(obs[:path.n_cpu].clone())
            rec_u.append(u[:path.n_cpu].clone())
        worst_viol = max(worst_viol, float(info.soft_viol.max()))
        es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k: fn.launches for k, fn in wrappers.items()}
    say(f"[phase 2] {name}: {n_timed} timed steps at B={B}, T={T}: {n_timed / wall:.3f} steps/s, "
        f"{B * n_timed / wall:.1f} solves/s (wall {wall:.3f} s, {1e3 * wall / n_timed:.1f} ms/step, "
        "plant on the card)")
    say(f"[phase 2] {name}: kernel launches over {n_warmup + n_timed} steps: {launches}")
    others = [k for k in QP_WRAPPERS if k != path.qp]
    if min(launches[k] for k in (*KERNELS, path.qp)) <= 0 or any(launches[k] for k in others):
        raise RuntimeError(f"{name}: expected every kernel of the path and of the QP wrappers "
                           f"only {path.qp} to have launched: {launches}")
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
    for k in ("gp_posterior", "tighten", "linearize"):
        results[entry_name(prob.path_name, k)]["launches"] = launches[k]
    qp_entry = results[entry_name(prob.path_name, "qp")]
    qp_entry["launches"] = launches[path.qp]
    steps = n_warmup + n_timed
    prob.ms_per_step = 1e3 * wall / n_timed
    in_qp = qp_entry["ms"] * launches[path.qp] / steps
    say(f"[phase 2] {name}: QP kernel launches per step {launches[path.qp] / steps:.2f}; at its "
        f"phase-1 time that is {in_qp:.1f} ms of the {1e3 * wall / n_timed:.1f} ms step")
    return rec_obs, rec_u


def cpu_parity(path_name: str, rec_obs, rec_u) -> None:
    """Phase 3 for one path: the plain path on the CPU, same observations."""
    cpu = torch.device("cpu")
    prob = Problem(path_name, cpu)
    path = prob.path
    st = mpc_mod.init_state(path.n_cpu, path.T, prob.model.nx, prob.model.nu, device=cpu)
    u_cpu, u_card = [], []
    t0 = time.perf_counter()
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


def profile_step(prob: Problem) -> None:
    """Device time of one warm step's kernels (torch.profiler), with two
    readings of the idle share. Against the profiled step's own wall time
    both numbers come from the same step, but the profiler slows the host and
    not the kernels, so that reading is an upper estimate. Against phase 2's
    mean unprofiled step the host runs at its own speed, but busy time and
    step time come from different steps (another seed's warm step), and that
    reading is the lower estimate."""
    from torch.profiler import ProfilerActivity, profile

    es, obs, st = prob.reset(prob.path.B, seed=2)
    for _ in range(2):
        u, st, _ = prob.step(st, obs)
        es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    t0 = time.perf_counter()
    _build.load_library()
    per_source = ", ".join(f"{k} {v:.1f} s" for k, v in _build.BuildInfo.per_source.items())
    say(f"[phase 0] kernel build: {time.perf_counter() - t0:.1f} s (nvcc in parallel "
        f"{_build.BuildInfo.seconds:.1f} s: {per_source}; cached={_build.BuildInfo.cached})")
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[phase 0] ptxas: {line.strip()}")
    for kernel, soft, T in (("ocp_ip", False, 50), ("ocp_ip", True, 50),
                            ("ocp_ip_streamed", False, 400), ("ocp_ip_streamed", True, 320),
                            ("ocp_ip_streamed2", False, 1024), ("ocp_ip_streamed2", True, 768)):
        name = kernel + ("_soft" if soft else "")
        per_tile = 4 * LANES * getattr(_build.load_library(), name + "_workspace_floats")(T, 12, 4)
        say(f"[phase 0] workspace of {name} at its cap T={T}, 12x4: "
            f"{per_tile} bytes per tile of {LANES}, {8 * per_tile} bytes at B=1024")

    results, extra, captured, problems = {}, [], {}, {}
    t_run = time.perf_counter()
    for path_name in PATHS:
        prob = problems[path_name] = Problem(path_name, dev)
        check_kernels(prob, results, captured)  # phase 1
        rec_obs, rec_u = closed_loop(prob, results)  # phase 2
        cpu_parity(path_name, rec_obs, rec_u)  # phase 3
        say(f"[time] {path_name} done at {time.perf_counter() - t_run:.0f} s")
    stress = lambda gp: gp._replace(hypers=gp.hypers._replace(  # noqa: E731
        raw_outputscale=torch.full_like(gp.hypers.raw_outputscale, STRESS_OUTPUTSCALE)))
    closed_loop(Problem("quadrotor-soft", dev, gp_edit=stress), results, stress=True)
    check_kernel_level_only(dev, captured, extra)
    say(f"[time] kernel-level checks done at {time.perf_counter() - t_run:.0f} s")
    if "--profile" in sys.argv[1:]:
        for path_name, prob in problems.items():
            if prob.family == "quadrotor":
                profile_step(prob)

    order = [entry_name(p, k) for p in PATHS for k in ("gp_posterior", "tighten", "linearize", "qp")]
    print(json.dumps({"kernels": [results[e] for e in order], "kernel_level_only": extra}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

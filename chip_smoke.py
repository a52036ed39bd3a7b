"""On-card smoke run of the PyTorch/CUDA port (`gpmpc_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; there is no CPU path. It drives the
`lanes-fused` closed loop of each model family at `bench.py`'s configuration
for that family (`BENCH_MODEL=quadrotor|cartpole|twolink`): T=25, B=1024, the
family's GPs (capacity 128, 40 FITC inducing points), prob 0.95, 6 SQP / 10
Mehrotra IP iterations, IP exit at gap 1e-6, in-kernel linearization, the
family's cost weights, boxes and `lm_reg`, the plant on the card. Phases,
each printing its own lines:

  0. the card's name and power limit (nvidia-smi), then the kernel build:
     one nvcc per source in parallel, each source's time and ptxas's
     register and spill report for every instantiation;
  1. per family, each kernel instantiation of its path against its plain
     PyTorch version on the card, on inputs captured from the family's first
     warm-started step and on seeded random inputs at the path's shapes: max
     abs difference beside the stated tolerance, and the median time of each
     (CUDA events). Quadrotor: kernels 1-4 at 12x4, D=3; cartpole: 4x1, D=3;
     two-link arm: 4x2, D=6;
  2. per family, the closed loop: 2 warm-up and 20 timed steps with every
     kernel's launch count (counts set to 0 just before the family's run and
     read just after), finite actions, clamp fraction, SQP iterations and QP
     gaps;
  3. per family, the same observations for the first 128 scenarios solved by
     the port's plain path on the CPU: control RMSE against the card's
     actions <= 1e-3.

Prints a JSON line of per-kernel results, the nvidia-smi line, then as its
last line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

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

T, B, LANES = 25, 1024, 128
N_WARMUP, N_TIMED, N_CPU_STEPS = 2, 20, 10
N_TIMING_RUNS = 21
RMSE_BAR = 1e-3

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

# Kernel-vs-plain tolerances. GP: the repo's Pallas GP test bar (float32 sums
# of ~1e2-size terms in another order). Tighten: relative, since the kernel
# uses (A+BK) cov (A+BK)^T where the plain version expands the four products.
# Linearize: the repo's kernel-vs-jacfwd bars. OCP: two float32 runs of the
# same IP whose Mehrotra centering cubes rounding differences; the exit at
# gap 1e-6 bounds how far one extra iteration moves a solution.
TOL = {"gp": 1e-4, "tighten": 1e-5, "linearize_fnext": 2e-5, "linearize_jac": 2e-4, "ocp": 5e-4}
TOL_TEXT = {
    "gp_posterior": "1e-4 on mean and var",
    "tighten": "1e-5 x max(1, max|t|)",
    "linearize": "2e-5 on fnext, 2e-4 on A and B",
    "ocp_ip": "5e-4 on dx and du",
}

# kernel -> (wrapper, plain version, source, TPU kernel it replaces)
KERNELS = {
    "gp_posterior": (cuda_gp.gp_mean_var, cuda_gp.gp_mean_var_plain,
                     "gpmpc_tpu_torch/csrc/gp_posterior.cu", "gpmpc_tpu/ops/pallas_gp.py:64"),
    "tighten": (cuda_tighten.tighten_lanes, cuda_tighten.tighten_lanes_plain,
                "gpmpc_tpu_torch/csrc/tighten.cu", "gpmpc_tpu/ops/pallas_tighten.py:93"),
    "linearize": (cuda_linearize.linearize_ocp_lanes, cuda_linearize.linearize_ocp_lanes_plain,
                  "gpmpc_tpu_torch/csrc/linearize.cu", "gpmpc_tpu/ops/pallas_linearize.py:407"),
    "ocp_ip": (cuda_ocp.solve_ocp_qp_lanes, cuda_ocp.solve_ocp_qp_lanes_plain,
               "gpmpc_tpu_torch/csrc/ocp_ip.cu", "gpmpc_tpu/ops/pallas_ocp.py:1807"),
}

# (family, kernel) -> (entry name in the JSON line, the TPU kernel's line
# when it is more specific than KERNELS'). Each entry is one instantiation.
ENTRIES = {
    ("quadrotor", "gp_posterior"): ("gp_posterior", None),
    ("quadrotor", "tighten"): ("tighten", None),
    ("quadrotor", "linearize"): ("linearize", None),
    ("quadrotor", "ocp_ip"): ("ocp_ip", None),
    ("cartpole", "gp_posterior"): ("gp_posterior[cartpole]", None),
    ("cartpole", "tighten"): ("tighten[4x1]", None),
    ("cartpole", "linearize"): ("linearize[cartpole]", "gpmpc_tpu/ops/pallas_linearize.py:170"),
    ("cartpole", "ocp_ip"): ("ocp_ip[4x1]", None),
    ("twolink", "gp_posterior"): ("gp_posterior[D6]", None),
    ("twolink", "tighten"): ("tighten[4x2]", None),
    ("twolink", "linearize"): ("linearize[twolink]", "gpmpc_tpu/ops/pallas_linearize.py:235"),
    ("twolink", "ocp_ip"): ("ocp_ip[4x2]", None),
}


def say(msg: str) -> None:
    print(msg, flush=True)


class Problem:
    """One family's controller, GP and plant at bench.py's configuration."""

    def __init__(self, family: str, device):
        c = FAMILIES[family]
        self.family, self.env = family, c["env"]
        self.env_p = self.env.EnvParams.default()
        self.model = c["model"]()
        ctrl = gpmpc_mod.GPMPC(
            self.model, self.env.make_trajectory(self.env_p).numpy(), c["prior"], horizon=T,
            q_mpc=c["q_mpc"], r_mpc=c["r_mpc"], prob=0.95, sqp_iters=6, qp_iters=10,
            device=device, bounds=c["bounds"], lm_reg=c["lm_reg"],
        )
        self.consts = ctrl.consts
        self.cfg = ctrl.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
        self.gp = convert.load_bench_gp(device, family)
        self.device = device

    def reset(self, batch: int, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        es, obs = self.env.env_reset(self.env_p, batch, gen, self.device)
        return es, obs, mpc_mod.init_state(batch, T, self.model.nx, self.model.nu, device=self.device)

    def step(self, st, obs):
        return batched_gpmpc_step(self.model, self.cfg, self.consts, self.gp, st, obs)


def cuda_time_ms(fn, runs=N_TIMING_RUNS) -> float:
    """Median over `runs` single calls, each bracketed by CUDA events."""
    fn()  # warm-up
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Capture:
    """Records the arguments of the first call of each kernel wrapper while
    enabled, by wrapping the names the consumer modules call."""

    SITES = [
        (gpmpc_mod, "gp_mean_var", "gp_posterior"),
        (gpmpc_mod, "tighten_lanes", "tighten"),
        (sqp_lanes, "linearize_ocp_lanes", "linearize"),
        (sqp_lanes, "solve_ocp_qp_lanes", "ocp_ip"),
    ]

    def __init__(self):
        self.args = {}
        self._orig = []

    def __enter__(self):
        for mod, attr, name in self.SITES:
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


def tolerance_check(name, out_k, out_p) -> tuple[float, bool]:
    """Max abs difference over the outputs that carry the kernel's result
    (for ocp_ip the solution; its gap is a diagnostic), and whether it is
    within the kernel's tolerance."""
    if name == "ocp_ip":
        out_k, out_p = out_k[:2], out_p[:2]
    err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    if name == "linearize":
        ok = (float((out_k[0] - out_p[0]).abs().max()) <= TOL["linearize_fnext"]
              and max(float((a - b).abs().max()) for a, b in zip(out_k[1:], out_p[1:]))
              <= TOL["linearize_jac"])
        return err, ok
    if name == "tighten":
        scale = max(float(o.abs().max()) for o in out_p)
        return err, err <= TOL["tighten"] * max(scale, 1.0)
    return err, err <= TOL["gp" if name == "gp_posterior" else "ocp"]


def random_inputs(prob: Problem):
    """Seeded random kernel inputs at the family's path shapes (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    dev = prob.device
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
    # kernel 4: QP data as in tests/test_pallas_ocp.py::make_batch
    shp = lambda *s: (n_tiles, T) + s + (LANES,)  # noqa: E731
    A = np.eye(nx, dtype=np.float32)[None, None, :, :, None] + 0.1 * rng.normal(size=shp(nx, nx))
    lx = np.full((n_tiles, T + 1, nx, LANES), -1.5, np.float32)
    lx[:, 0] = -1e8
    qp = cuda_ocp.LanesQp(
        A=t(A), B=t(0.4 * rng.normal(size=shp(nx, nu))), r=t(0.05 * rng.normal(size=shp(nx))),
        qdiag=t(rng.uniform(0.5, 2.0, (n_tiles, T + 1, nx, LANES))),
        qx=t(0.5 * rng.normal(size=(n_tiles, T + 1, nx, LANES))),
        rdiag=t(rng.uniform(0.5, 2.0, shp(nu))), ru=t(0.5 * rng.normal(size=shp(nu))),
        lx=t(lx), ux=t(-lx), lu=t(np.full(shp(nu), -0.3)), uu=t(np.full(shp(nu), 0.3)),
    )
    inputs["ocp_ip"] = ((qp,), {"n_ip": 10, "adaptive_tol": 1e-6, "mehrotra": True})
    return inputs


def check_kernels(prob: Problem, results: dict) -> None:
    """Phase 1 for one family: every kernel of its path against its plain
    version, on the first warm-started step's inputs and on random ones."""
    es, obs, st = prob.reset(B, seed=0)
    u, st, _ = prob.step(st, obs)
    es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    with Capture() as cap:  # the first warm-started step
        prob.step(st, obs)
    torch.cuda.synchronize()
    missing = set(KERNELS) - set(cap.args)
    if missing:
        raise RuntimeError(f"{prob.family}: warm-started step launched no {sorted(missing)}")
    rand = random_inputs(prob)
    for name, (fn, plain, src, replaces) in KERNELS.items():
        entry, where = ENTRIES[(prob.family, name)]
        worst = 0.0
        for label, (a, k) in (("real step", cap.args[name]), ("random", rand[name])):
            out_k = fn(*a, **k)
            out_p = plain(*a, **k)
            torch.cuda.synchronize()
            err, ok = tolerance_check(name, out_k, out_p)
            say(f"[phase 1] {entry:22s} {label:9s}: max|kernel - plain| = {err:.3e} "
                f"(tolerance {TOL_TEXT[name]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{entry}: kernel disagrees with its plain version ({label})")
            worst = max(worst, err)
        a, k = cap.args[name]
        ms_k = cuda_time_ms(lambda: fn(*a, **k))
        ms_p = cuda_time_ms(lambda: plain(*a, **k))
        say(f"[phase 1] {entry:22s} time: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms (median of "
            f"{N_TIMING_RUNS}, real-step inputs)")
        results[entry] = dict(name=entry, route="cuda", source=src, replaces=where or replaces,
                              max_abs_err=worst, ms=ms_k, plain_ms=ms_p)


def closed_loop(prob: Problem, results: dict):
    """Phase 2 for one family: the closed loop on the card, launch counts
    read over exactly this run. Returns the first steps' observations and
    actions of the first tile for phase 3."""
    es, obs, st = prob.reset(B, seed=1)
    for fn, *_ in KERNELS.values():
        fn.launches = 0
    rec_obs, rec_u = [], []
    for i in range(N_WARMUP + N_TIMED):
        if i == N_WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        u, st, info = prob.step(st, obs)
        if i < N_CPU_STEPS:
            rec_obs.append(obs[:LANES].clone())
            rec_u.append(u[:LANES].clone())
        es, obs, *_ = prob.env.env_step(prob.env_p, es, u)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {name: fn.launches for name, (fn, *_) in KERNELS.items()}
    fam = prob.family
    say(f"[phase 2] {fam}: {N_TIMED} timed steps at B={B}, T={T}: {N_TIMED / wall:.2f} steps/s, "
        f"{B * N_TIMED / wall:.1f} solves/s (wall {wall:.3f} s, plant on the card)")
    say(f"[phase 2] {fam}: kernel launches over {N_WARMUP + N_TIMED} steps: {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"{fam}: a kernel of the path was never launched: {launches}")
    if not bool(torch.isfinite(u).all()) or not bool(torch.isfinite(st.X_warm).all()):
        raise RuntimeError(f"{fam}: non-finite actions or trajectories")
    it = info.n_iters.float()
    say(f"[phase 2] {fam}: last step: clamp_frac max {float(info.clamp_frac.max()):.3e}, SQP iters "
        f"mean {float(it.mean()):.2f} max {int(it.max())}, QP gap median "
        f"{float(info.qp_gap.median()):.3e} max {float(info.qp_gap.max()):.3e}, converged "
        f"{int(info.converged.sum())}/{B}")
    for name, n in launches.items():
        results[ENTRIES[(fam, name)][0]]["launches"] = n
    return rec_obs, rec_u


def cpu_parity(family: str, rec_obs, rec_u) -> None:
    """Phase 3 for one family: the plain path on the CPU, same observations."""
    cpu = torch.device("cpu")
    prob = Problem(family, cpu)
    st = mpc_mod.init_state(LANES, T, prob.model.nx, prob.model.nu, device=cpu)
    u_cpu, u_card = [], []
    t0 = time.perf_counter()
    for o, u_k in zip(rec_obs, rec_u):
        u_c, st, _ = prob.step(st, o.cpu())
        u_cpu.append(u_c)
        u_card.append(u_k.cpu())
    err = torch.stack(u_cpu) - torch.stack(u_card)
    rmse = float(torch.sqrt(torch.mean(err**2)))
    say(f"[phase 3] {family}: {len(u_cpu)} steps x {LANES} scenarios, plain path on the CPU "
        f"({time.perf_counter() - t0:.1f} s): control RMSE vs the card {rmse:.3e} "
        f"(bar {RMSE_BAR}), max abs {float(err.abs().max()):.3e}")
    if not rmse <= RMSE_BAR:
        raise RuntimeError(f"{family}: control RMSE {rmse} exceeds {RMSE_BAR}")


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

    results = {}
    for family in FAMILIES:
        prob = Problem(family, dev)
        check_kernels(prob, results)  # phase 1
        rec_obs, rec_u = closed_loop(prob, results)  # phase 2
        cpu_parity(family, rec_obs, rec_u)  # phase 3

    order = [entry for entry, _ in ENTRIES.values()]
    print(json.dumps({"kernels": [results[e] for e in order]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

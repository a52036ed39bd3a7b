"""On-card smoke run of the PyTorch/CUDA port (`gpmpc_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; there is no CPU path. Phases, each printing
its own lines:

  0. the card's name and power limit (nvidia-smi), then the kernel build;
  1. each of the four kernels against its plain PyTorch version on the card,
     at the slice's shapes, on inputs captured from the first warm-started
     step of the closed loop and on seeded random inputs: max abs difference
     beside the stated tolerance, and the median time of each (CUDA events);
  2. the closed loop at bench.py's default configuration (quadrotor, T=25,
     B=1024, 3 GPs with 40 FITC inducing points, 6 SQP / 10 Mehrotra IP
     iterations, IP exit at gap 1e-6, in-kernel linearization) with the plant
     on the card: 2 warm-up and 20 timed steps, every kernel's launch count,
     finite actions, clamp fraction, SQP iterations and QP gaps;
  3. the same observations for the first 128 scenarios solved by the port's
     plain path on the CPU: control RMSE against the card's actions <= 1e-3.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
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
from gpmpc_tpu_torch.envs import drone  # noqa: E402
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS  # noqa: E402
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude  # noqa: E402
from gpmpc_tpu_torch.ops import cuda_gp, cuda_linearize, cuda_ocp, cuda_tighten, sqp_lanes  # noqa: E402
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step  # noqa: E402

Q_MPC = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
R_MPC = [3, 3, 3, 0.1]
T, B, LANES = 25, 1024, 128
N_WARMUP, N_TIMED, N_CPU_STEPS = 2, 20, 10
N_TIMING_RUNS = 21
RMSE_BAR = 1e-3

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

KERNELS = [
    ("gp_posterior", cuda_gp.gp_mean_var, "gpmpc_tpu_torch/csrc/gp_posterior.cu",
     "gpmpc_tpu/ops/pallas_gp.py:64"),
    ("tighten", cuda_tighten.tighten_lanes, "gpmpc_tpu_torch/csrc/tighten.cu",
     "gpmpc_tpu/ops/pallas_tighten.py:93"),
    ("linearize", cuda_linearize.linearize_ocp_lanes, "gpmpc_tpu_torch/csrc/linearize.cu",
     "gpmpc_tpu/ops/pallas_linearize.py:407"),
    ("ocp_ip", cuda_ocp.solve_ocp_qp_lanes, "gpmpc_tpu_torch/csrc/ocp_ip.cu",
     "gpmpc_tpu/ops/pallas_ocp.py:1807"),
]


def say(msg: str) -> None:
    print(msg, flush=True)


def build_problem(device):
    prior = PRIOR_PARAMS._asdict()
    env_p = drone.EnvParams.default()
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = gpmpc_mod.GPMPC(
        model, drone.make_trajectory(env_p).numpy(), prior, horizon=T, q_mpc=Q_MPC,
        r_mpc=R_MPC, prob=0.95, sqp_iters=6, qp_iters=10, device=device,
    )
    cfg = ctrl.cfg._replace(qp_tol=1e-6, kernel_linearize=True, qp_mehrotra=True)
    gp = convert.load_bench_gp(device)
    return env_p, model, ctrl.consts, cfg, gp


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


def plain_of(name):
    return {
        "gp_posterior": cuda_gp.gp_mean_var_plain,
        "tighten": cuda_tighten.tighten_lanes_plain,
        "linearize": cuda_linearize.linearize_ocp_lanes_plain,
        "ocp_ip": cuda_ocp.solve_ocp_qp_lanes_plain,
    }[name]


def max_err(name, out_k, out_p) -> float:
    """Max abs difference over the outputs that carry the kernel's result."""
    if name == "ocp_ip":  # (dx, du, gap): the solution; the gap is a diagnostic
        out_k, out_p = out_k[:2], out_p[:2]
    return max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))


def tolerance_check(name, out_k, out_p) -> tuple[float, bool]:
    err = max_err(name, out_k, out_p)
    if name == "linearize":
        ok = (float((out_k[0] - out_p[0]).abs().max()) <= TOL["linearize_fnext"]
              and max(float((a - b).abs().max()) for a, b in zip(out_k[1:], out_p[1:]))
              <= TOL["linearize_jac"])
        return err, ok
    if name == "tighten":
        scale = max(float(o.abs().max()) for o in out_p)
        return err, err <= TOL["tighten"] * max(scale, 1.0)
    return err, err <= TOL["gp" if name == "gp_posterior" else "ocp"]


def random_inputs(device):
    """Seeded random kernel inputs at the slice's shapes (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"), device=device)  # noqa: E731
    gp = convert.load_bench_gp(device)
    n_tiles = B // LANES
    inputs = {}
    # kernel 1: N = B*T queries against the padded thrust-GP variance form
    pad = 128 - gp.var_Z.shape[1]
    F = torch.nn.functional
    inputs["gp_posterior"] = (
        (t(rng.normal(0, 0.4, (B * T, 3))), F.pad(gp.var_Z[0], (0, 0, 0, pad)),
         F.pad(gp.alpha_s[0], (0, pad)), F.pad(gp.var_mat[0], (0, pad, 0, pad)),
         gpmpc_mod.softplus(gp.hypers.raw_lengthscale[0]),
         gpmpc_mod.softplus(gp.hypers.raw_outputscale[0]),
         gpmpc_mod.softplus(gp.hypers.raw_noise[0]) + 1e-6, F.pad(gp.var_mask[0], (0, pad))),
        {},
    )
    # kernel 2: disturbance diagonals in the range a trained GP produces
    _, _, consts, _, _ = build_problem(device)
    inputs["tighten"] = (
        (t(rng.uniform(1e-6, 4e-4, (B, T, 5))), consts.Ad, consts.Bd_in, consts.lqr_gain,
         consts.Bd, consts.inverse_cdf),
        {},
    )
    # kernel 3: states/inputs as in tests/test_pallas_linearize.py
    X = t(rng.normal(0, 0.3, (n_tiles, T + 1, 12, LANES)))
    U = t(np.stack([rng.uniform(0.15, 0.55, (n_tiles, T, LANES))]
                   + [rng.uniform(-0.3, 0.3, (n_tiles, T, LANES)) for _ in range(3)], axis=2))
    ell = gpmpc_mod.softplus(gp.hypers.raw_lengthscale)
    sf2 = gpmpc_mod.softplus(gp.hypers.raw_outputscale)
    hyp = torch.cat([sf2[:, None], (1.0 / ell**2)[:, None].expand(3, 3)], dim=1).contiguous()
    par8 = torch.tensor(list(PRIOR_PARAMS), dtype=torch.float32, device=device)
    inputs["linearize"] = ((par8, hyp, gp.Zs, gp.alpha_s, X, U), {"dt": 0.02, "use_gp": True})
    # kernel 4: QP data as in tests/test_pallas_ocp.py::make_batch
    shp = lambda *s: (n_tiles, T) + s + (LANES,)  # noqa: E731
    A = np.eye(12, dtype=np.float32)[None, None, :, :, None] + 0.1 * rng.normal(size=shp(12, 12))
    lx = np.full((n_tiles, T + 1, 12, LANES), -1.5, np.float32)
    lx[:, 0] = -1e8
    qp = cuda_ocp.LanesQp(
        A=t(A), B=t(0.4 * rng.normal(size=shp(12, 4))), r=t(0.05 * rng.normal(size=shp(12))),
        qdiag=t(rng.uniform(0.5, 2.0, (n_tiles, T + 1, 12, LANES))),
        qx=t(0.5 * rng.normal(size=(n_tiles, T + 1, 12, LANES))),
        rdiag=t(rng.uniform(0.5, 2.0, shp(4))), ru=t(0.5 * rng.normal(size=shp(4))),
        lx=t(lx), ux=t(-lx), lu=t(np.full(shp(4), -0.3)), uu=t(np.full(shp(4), 0.3)),
    )
    inputs["ocp_ip"] = ((qp,), {"n_ip": 10, "adaptive_tol": 1e-6, "mehrotra": True})
    return inputs


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
    say(f"[phase 0] kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BuildInfo.seconds:.1f} s, cached={_build.BuildInfo.cached})")
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[phase 0] ptxas: {line.strip()}")

    env_p, model, consts, cfg, gp = build_problem(dev)

    # ---- phase 1: kernels vs plain versions ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    es, obs = drone.env_reset(env_p, B, gen, dev)
    st = mpc_mod.init_state(B, T, device=dev)
    u, st, _ = batched_gpmpc_step(model, cfg, consts, gp, st, obs)
    es, obs, *_ = drone.env_step(env_p, es, u)
    with Capture() as cap:  # the first warm-started step
        batched_gpmpc_step(model, cfg, consts, gp, st, obs)
    torch.cuda.synchronize()
    missing = {n for n, *_ in KERNELS} - set(cap.args)
    if missing:
        raise RuntimeError(f"warm-started step launched no {sorted(missing)}")

    results = {}
    rand = random_inputs(dev)
    for name, fn, src, replaces in KERNELS:
        plain = plain_of(name)
        worst = 0.0
        for label, (a, k) in (("real step", cap.args[name]), ("random", rand[name])):
            out_k = fn(*a, **k)
            out_p = plain(*a, **k)
            torch.cuda.synchronize()
            err, ok = tolerance_check(name, out_k, out_p)
            say(f"[phase 1] {name:12s} {label:9s}: max|kernel - plain| = {err:.3e} "
                f"(tolerance {TOL_TEXT[name]}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name}: kernel disagrees with its plain version ({label})")
            worst = max(worst, err)
        a, k = cap.args[name]
        ms_k = cuda_time_ms(lambda: fn(*a, **k))
        ms_p = cuda_time_ms(lambda: plain(*a, **k))
        say(f"[phase 1] {name:12s} time: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms (median of "
            f"{N_TIMING_RUNS}, real-step inputs)")
        results[name] = dict(name=name, route="cuda", source=src, replaces=replaces,
                             max_abs_err=worst, ms=ms_k, plain_ms=ms_p)

    # ---- phase 2: the closed loop on the card --------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    es, obs = drone.env_reset(env_p, B, gen, dev)
    st = mpc_mod.init_state(B, T, device=dev)
    for _, fn, _, _ in KERNELS:
        fn.launches = 0
    rec_obs, rec_u = [], []
    n_steps = N_WARMUP + N_TIMED
    for i in range(n_steps):
        if i == N_WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        u, st, info = batched_gpmpc_step(model, cfg, consts, gp, st, obs)
        if i < N_CPU_STEPS:
            rec_obs.append(obs[:LANES].clone())
            rec_u.append(u[:LANES].clone())
        es, obs, *_ = drone.env_step(env_p, es, u)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {name: fn.launches for name, fn, _, _ in KERNELS}
    say(f"[phase 2] {N_TIMED} timed steps at B={B}, T={T}: {N_TIMED / wall:.2f} steps/s, "
        f"{B * N_TIMED / wall:.1f} solves/s (wall {wall:.3f} s, plant on the card)")
    say(f"[phase 2] kernel launches over {n_steps} steps: {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the path was never launched: {launches}")
    if not bool(torch.isfinite(u).all()) or not bool(torch.isfinite(st.X_warm).all()):
        raise RuntimeError("non-finite actions or trajectories")
    it = info.n_iters.float()
    say(f"[phase 2] last step: clamp_frac max {float(info.clamp_frac.max()):.3e}, SQP iters "
        f"mean {float(it.mean()):.2f} max {int(it.max())}, QP gap median "
        f"{float(info.qp_gap.median()):.3e} max {float(info.qp_gap.max()):.3e}, converged "
        f"{int(info.converged.sum())}/{B}")

    # ---- phase 3: the plain path on the CPU, same observations ---------------
    cpu = torch.device("cpu")
    _, model_c, consts_c, cfg_c, gp_c = build_problem(cpu)
    st_c = mpc_mod.init_state(LANES, T, device=cpu)
    u_cpu, u_card = [], []
    t0 = time.perf_counter()
    for o, u_k in zip(rec_obs, rec_u):
        u_c, st_c, _ = batched_gpmpc_step(model_c, cfg_c, consts_c, gp_c, st_c, o.cpu())
        u_cpu.append(u_c)
        u_card.append(u_k.cpu())
    err = torch.stack(u_cpu) - torch.stack(u_card)
    rmse = float(torch.sqrt(torch.mean(err**2)))
    say(f"[phase 3] {len(u_cpu)} steps x {LANES} scenarios, plain path on the CPU "
        f"({time.perf_counter() - t0:.1f} s): control RMSE vs the card {rmse:.3e} "
        f"(bar {RMSE_BAR}), max abs {float(err.abs().max()):.3e}")
    if not rmse <= RMSE_BAR:
        raise RuntimeError(f"control RMSE {rmse} exceeds {RMSE_BAR}")

    for name, _, _, _ in KERNELS:
        results[name]["launches"] = launches[name]
    print(json.dumps({"kernels": [results[n] for n, *_ in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

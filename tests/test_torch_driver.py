"""The port's experiment driver (`scripts/run_gp_mpc_torch.py`) and its
telemetry (`gpmpc_tpu_torch/utils/profiling.py`), on the CPU.

The helpers that carry no controller are held bit for bit against the
reference script's (`scripts/run_gp_mpc.py`, imported by path: its module top
imports no JAX) and the reference's `utils/profiling.py`. `learn` runs at a
tiny configuration (T = 6, 2 SQP and 4 IP iterations, 2 epochs x 6 steps,
10 GP iterations); a run resumed from its epoch-1 checkpoint equals the
straight run bit for bit, and one restarted from that checkpoint without its
runs equals the straight run's first epoch. The slow cases run the driver as a subprocess, and
one epoch beside the reference's driver."""

import importlib.util
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gpmpc_tpu.utils import profiling as jprof
from gpmpc_tpu_torch.utils import profiling as tprof
from tests._torch_threads import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TINY = dict(horizon=6, sqp_iters=2, qp_iters=4, epochs=2, steps=6, iterations=10, lr=0.05,
            samples=6, seed=1)


def load_script(name: str, module: str):
    spec = importlib.util.spec_from_file_location(module, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    spec.loader.exec_module(mod)
    return mod


REF = load_script("run_gp_mpc", "ref_run_gp_mpc")
DRV = load_script("run_gp_mpc_torch", "run_gp_mpc_torch")


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_episode_seed_plan_bit_equal(seed):
    for n_epochs in (1, 3, 100):
        rng_j, ev_j, tab_j = REF.episode_seed_plan(seed, n_epochs)
        rng_t, ev_t, tab_t = DRV.episode_seed_plan(seed, n_epochs)
        assert ev_t == ev_j and tab_t.dtype == tab_j.dtype
        np.testing.assert_array_equal(tab_t, tab_j)
        assert rng_t.bit_generator.state == rng_j.bit_generator.state
    # epoch k's seed does not depend on the number of epochs
    np.testing.assert_array_equal(DRV.episode_seed_plan(seed, 100)[2][:4],
                                  DRV.episode_seed_plan(seed, 3)[2])


@pytest.mark.parametrize("n_samples", [4, 15, 40])
def test_sample_data_bit_equal(n_samples):
    rng = np.random.default_rng(3)
    data = {"obs": rng.normal(size=(31, 12)), "action": rng.normal(size=(30, 4))}
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):  # the generators stay in step
        for a, b in zip(DRV.sample_data(data, n_samples, rt), REF.sample_data(data, n_samples, rj)):
            np.testing.assert_array_equal(a, b)


def test_phase_timer_and_solve_counter_equal(monkeypatch):
    """The same samples through both timers (a fake clock): the same
    samples, statistics, table and solves/s."""
    timers, counters = [], []
    for mod in (jprof, tprof):
        ticks = iter(np.cumsum(np.random.default_rng(0).uniform(0.01, 0.5, 200)).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        t, c = mod.PhaseTimer(), mod.SolveCounter()
        for name in ("Train GP", "Test", "Train GP", "Collect", "Test", "Train GP"):
            with t.phase(name):
                pass
        for n in (3, 5, 7):
            with c.window(n):
                pass
        timers.append(t)
        counters.append(c)
    tj, tt = timers
    assert tt.samples == tj.samples
    for name in tj.samples:
        assert tt.stats(name) == tj.stats(name)
        assert tt.stats(name, drop_first=False) == tj.stats(name, drop_first=False)
    assert tt.table() == tj.table()
    assert counters[1].solves == counters[0].solves and counters[1].seconds == counters[0].seconds
    assert counters[1].solves_per_sec == counters[0].solves_per_sec
    assert tprof.SolveCounter().solves_per_sec == 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(tmp_path / "trace") as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof is not None
    text = (tmp_path / "trace" / tprof.TRACE_FILE).read_text()
    assert "traceEvents" in text


def _controller():
    from gpmpc_tpu_torch.config import GpMpcSection
    from gpmpc_tpu_torch.control.gpmpc import GPMPC
    from gpmpc_tpu_torch.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu_torch.models.symbolic import symbolic_attitude

    g = GpMpcSection()
    env = DroneFigureEightEnv(device="cpu")
    ctrl = GPMPC(symbolic_attitude(dt=0.02, params=g.prior_params), env.trajectory.numpy(),
                 g.prior_params, horizon=TINY["horizon"], q_mpc=g.q_mpc, r_mpc=g.r_mpc,
                 sparse_gp=True, prob=g.prob, max_gp_samples=g.max_gp_samples, seed=TINY["seed"],
                 device="cpu", sqp_iters=TINY["sqp_iters"], qp_iters=TINY["qp_iters"])
    return ctrl, env


def _learn(n_epochs, checkpoint_dir=None):
    ctrl, env = _controller()
    tr, te = DRV.learn(n_epochs, ctrl, env, lr=TINY["lr"], gp_iterations=TINY["iterations"],
                       seed=TINY["seed"], samples_per_epoch=TINY["samples"], n_steps=TINY["steps"],
                       checkpoint_dir=checkpoint_dir)
    return ctrl, tr, te


def _snapshot(ctrl, train_runs, test_runs) -> dict:
    """Everything a run computed (its timings left out)."""
    out = {f"gp.{k}": v for k, v in ctrl.gp_model._asdict().items() if k != "hypers"}
    out.update({f"gp.hypers.{k}": v for k, v in ctrl.gp_model.hypers._asdict().items()})
    out["generator"] = ctrl._gp_generator.get_state()
    for tag, runs in (("train", train_runs), ("test", test_runs)):
        for e, run in runs.items():
            for k in ("obs", "action", "reward", "done"):
                out[f"{tag}{e}.{k}"] = torch.as_tensor(np.asarray(run[k]))
            for k, v in run["controller_data"].items():
                out[f"{tag}{e}.ctrl.{k}"] = torch.as_tensor(np.asarray(v))
    return out


def _assert_bit_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The 2-epoch run, checkpointed: (ctrl, train_runs, test_runs, its
    checkpoint directory)."""
    ckpt = tmp_path_factory.mktemp("straight")
    return _learn(TINY["epochs"], checkpoint_dir=ckpt) + (ckpt,)


def _checkpointed(ckpt, epoch: int):
    """(ctrl, train_runs, test_runs) as a checkpoint holds them after `epoch`."""
    from gpmpc_tpu_torch.utils.checkpoint import ExperimentCheckpoint

    ctrl, _ = _controller()
    _, _, tr, te = ExperimentCheckpoint(ckpt).restore(epoch, ctrl)
    return ctrl, tr, te


def test_learn_runs_the_epoch_loop(straight):
    """Two epochs at the tiny configuration: the prior's episodes (epoch 0)
    and two GP-MPC epochs, each run with the reference's fields and shapes,
    finite, the GP trained on every sampled transition."""
    ctrl, tr, te, _ = straight
    assert sorted(tr) == sorted(te) == [0, 1, 2]
    for run in list(tr.values()) + list(te.values()):
        assert set(run) == {"obs", "action", "done", "reward", "length", "controller_data",
                            "inference_time_data"}
        assert run["obs"].shape == (TINY["steps"] + 1, 12)
        assert run["action"].shape == (TINY["steps"], 4)
        assert np.isfinite(run["obs"]).all() and len(run["inference_time_data"]) == TINY["steps"]
        assert set(run["controller_data"]) == {"step_norm", "qp_gap", "n_iters",
                                               "tightening_clamp_frac"}
    assert bool(ctrl.gp_model.trained)
    assert int(ctrl.gp_model.mask[0].sum()) == 2 * (TINY["steps"] - 1)  # 5 transitions an epoch
    # the test episodes start from the eval seed's state, the training ones from each epoch's
    _, eval_seed, seeds = DRV.episode_seed_plan(TINY["seed"], TINY["epochs"])
    _, env = _controller()
    np.testing.assert_array_equal(te[1]["obs"][0], env.reset(seed=eval_seed)[0].numpy())
    np.testing.assert_array_equal(tr[2]["obs"][0], env.reset(seed=int(seeds[2]))[0].numpy())


def test_resume_equals_the_straight_run(straight, tmp_path, capsys):
    """The straight run's epoch-1 checkpoint, resumed for a second epoch,
    equals the straight run bit for bit; the same checkpoint without its
    runs restarts from epoch 1, and that epoch equals the straight run's
    first (its runs, and the GP and generator its checkpoint holds: the GP,
    the generator, the dataset and the RNG reset)."""
    ckpt = straight[3]
    resume, incomplete = tmp_path / "resume", tmp_path / "incomplete"
    resume.mkdir()
    incomplete.mkdir()
    for f in ckpt.glob("*_1.*"):  # epoch 1's checkpoint, GP and runs
        shutil.copy(f, resume)
        if "_runs_" not in f.name:
            shutil.copy(f, incomplete)
    capsys.readouterr()
    _assert_bit_equal(_snapshot(*_learn(2, checkpoint_dir=resume)), _snapshot(*straight[:3]))
    assert "resumed from checkpoint epoch 1 (5 samples)" in capsys.readouterr().out
    _assert_bit_equal(_snapshot(*_learn(1, checkpoint_dir=incomplete)),
                      _snapshot(*_checkpointed(ckpt, 1)))
    assert "checkpoint incomplete; restarting from epoch 1" in capsys.readouterr().out


def _tiny_config(tmp_path: Path) -> Path:
    path = tmp_path / "config.yaml"
    path.write_text(
        f'save_dir: "{tmp_path / "saves"}/"\nseed: {TINY["seed"]}\n'
        f"gpmpc:\n  horizon: {TINY['horizon']}\n  sqp_iters: {TINY['sqp_iters']}\n"
        f"  qp_iters: {TINY['qp_iters']}\n  device: cpu\n"
        f"run:\n  num_epochs: 1\n"
        f"train:\n  iterations: {TINY['iterations']}\n  lr: {TINY['lr']}\n"
        f"  samples_per_epoch: {TINY['samples']}\n")
    return path


def test_main_without_matplotlib_writes_the_tables(tmp_path, monkeypatch, capsys):
    """The whole driver in-process, one epoch, the config's device "cpu",
    with matplotlib unimportable: the CSV table, no figure, one line saying
    so, the summary lines, exit without an error."""
    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = DRV.main(["--config", str(_tiny_config(tmp_path)), "--steps", "4"])
    text = capsys.readouterr().out
    assert "figures skipped: matplotlib cannot be imported" in text
    assert "mean position error" in text and "total experiment wall time" in text
    assert out["figures"] is False and out["ctrl"].device.type == "cpu"
    files = sorted(str(p.relative_to(out["save_dir"])) for p in out["save_dir"].rglob("*")
                   if p.is_file())
    assert files == ["figs/runtime.csv"]
    table = np.loadtxt(out["save_dir"] / "figs" / "runtime.csv", delimiter=",", ndmin=2)
    assert table.shape == (2, 4) and np.isfinite(table).all()
    assert out["eval_run"]["obs"].shape == (5, 12)
    assert set(out["position_error"]) == {0, 1}
    assert all(np.isfinite(v) for v in out["position_error"].values())


def test_default_device_is_the_card(tmp_path, monkeypatch):
    """No --device and the shipped config ("tpu"): the card, and without one
    NoCudaDeviceError, before a save dir is claimed."""
    from gpmpc_tpu_torch.device import NoCudaDeviceError

    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is runnable")
    with pytest.raises(NoCudaDeviceError):
        DRV.main([])
    assert not (tmp_path / "saves").exists()


# ---- slow: end to end ---------------------------------------------------------------------


def run_driver(tmp_path: Path, extra_args, timeout=1200):
    """scripts/run_gp_mpc_torch.py as a subprocess on the CPU, at the
    reference's own e2e test settings (tests/test_driver_e2e.py)."""
    cfg = tmp_path / "config.yaml"
    cfg.write_text(
        f'save_dir: "{tmp_path / "saves"}/"\nseed: 1\n'
        "gpmpc:\n  max_gp_points: 64\n  sqp_iters: 4\n  qp_iters: 8\n"
        "run:\n  num_epochs: 2\n"
        "train:\n  iterations: 30\n  lr: 0.05\n  samples_per_epoch: 10\n")
    (tmp_path / "saves").mkdir(exist_ok=True)
    return subprocess.run(
        [sys.executable, "scripts/run_gp_mpc_torch.py", "--device", "cpu", "--fast",
         "--steps", "25", "--config", str(cfg)] + extra_args,
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.slow
def test_driver_end_to_end_then_resume(tmp_path):
    ckpt = tmp_path / "ckpt"
    first = run_driver(tmp_path, ["--epochs", "1", "--checkpoint-dir", str(ckpt)])
    assert first.returncode == 0, first.stderr[-3000:]
    assert "mean position error" in first.stdout and "total experiment wall time" in first.stdout
    save = max((tmp_path / "saves").iterdir(), key=lambda p: p.stat().st_mtime)
    for name in (["xyz_path.png", "runtime.png", "runtime.csv"]
                 + [f"x{i}.png" for i in range(12)] + [f"u{i}.png" for i in range(4)]):
        assert (save / "figs" / name).exists(), name
    assert (save / "state_trajectories.png").exists()
    second = run_driver(tmp_path, ["--epochs", "2", "--checkpoint-dir", str(ckpt)])
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from checkpoint epoch 1" in second.stdout, second.stdout[-2000:]


@pytest.mark.slow
def test_one_epoch_beside_the_reference_driver(tmp_path, monkeypatch):
    """The reference's `learn`, one epoch on its plant at init_noise=0 (every
    episode starts on the reference path), against the port's controllers
    solving the same observations: the prior episode through
    `GPMPC.prior_ctrl`, and the GP-MPC test episode with the reference's
    trained GP copied into the port's controller. Control RMSE <= 1e-3 on
    each (the closed-loop bar, BASELINE.md)."""
    import jax.numpy as jnp

    from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
    from gpmpc_tpu.envs import drone as j_drone
    from gpmpc_tpu.models.symbolic import symbolic_attitude as j_attitude
    from gpmpc_tpu_torch import convert
    from gpmpc_tpu_torch.control.gpmpc import GPMPC as TGPMPC
    from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_attitude

    from gpmpc_tpu_torch.config import GpMpcSection

    g = GpMpcSection()
    kw = dict(horizon=25, q_mpc=g.q_mpc, r_mpc=g.r_mpc, sparse_gp=True, prob=g.prob,
              max_gp_samples=40, seed=1, sqp_iters=4, qp_iters=8, max_gp_points=64)
    env = j_drone.DroneFigureEightEnv(j_drone.EnvParams.default()._replace(init_noise=0.0))
    traj = np.asarray(env.trajectory)
    jctrl = JGPMPC(j_attitude(dt=0.02, params=g.prior_params), traj, g.prior_params, **kw)
    tctrl = TGPMPC(t_attitude(dt=0.02, params=g.prior_params), traj, g.prior_params,
                   device="cpu", step_backend="lanes", **kw)
    monkeypatch.chdir(tmp_path)
    train_runs, test_runs = REF.learn(1, jctrl, env, lr=0.05, gp_iterations=30, seed=1,
                                      samples_per_epoch=10, n_steps=25)

    def replay(ctrl, run):
        ctrl.reset()
        u = np.stack([ctrl.select_action(np.asarray(o, np.float32)) for o in run["obs"][:-1]])
        return float(np.sqrt(np.mean((u - run["action"]) ** 2)))

    rmse_prior = replay(tctrl.prior_ctrl, test_runs[0])
    jgp = jctrl.gp_model
    d = {k: np.asarray(v) for k, v in jgp._asdict().items() if k != "hypers"}
    d.update({k: np.asarray(v) for k, v in jgp.hypers._asdict().items()})
    tctrl.gp_model = convert.gp_model_from_numpy(d, device="cpu")
    rmse_gp = replay(tctrl, test_runs[1])
    print(f"control RMSE against the reference's driver: prior episode {rmse_prior:.3e}, "
          f"GP-MPC episode {rmse_gp:.3e} (bar 1e-3)")
    assert np.isfinite(jnp.asarray(test_runs[1]["obs"])).all()
    assert rmse_prior <= 1e-3 and rmse_gp <= 1e-3

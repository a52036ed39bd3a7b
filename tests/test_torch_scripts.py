"""The port's scripts `scripts/eval_seeds_torch.py` and
`scripts/bench_gp_fit_torch.py` against the reference's (`scripts/
eval_seeds.py`, `scripts/bench_gp_fit.py`, imported by path: their module
tops import no JAX), on the CPU: the FAMILIES table, what each `eval_seeds`
main passes to `seed_sweep` and prints (`seed_sweep` stubbed to one fake
result on both sides), the GP-fit timer's JSON line, and the default device.
The slow case runs `eval_seeds_torch.py --fast` as a subprocess."""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from tests._torch_threads import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SHIPPED = REPO / "scripts" / "gp_mpc_config.yaml"


def load_script(name: str, module: str):
    spec = importlib.util.spec_from_file_location(module, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod  # the scripts' dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


REF_EVAL = load_script("eval_seeds", "ref_eval_seeds")
EVAL = load_script("eval_seeds_torch", "eval_seeds_torch")
FIT = load_script("bench_gp_fit_torch", "bench_gp_fit_torch")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_value(a, b, path="", atol=0.0, rtol=0.0):
    """Nested equality: NamedTuples and dicts by field, arrays and tensors
    within `atol` + `rtol` |b|, everything else equal."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_same_value(a[k], b[k], f"{path}.{k}", atol, rtol)
    elif isinstance(b, tuple) and hasattr(b, "_fields"):
        assert a._fields == b._fields, path
        for k in b._fields:
            _assert_same_value(getattr(a, k), getattr(b, k), f"{path}.{k}", atol, rtol)
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_value(x, y, f"{path}[{i}]", atol, rtol)
    elif hasattr(b, "shape") or isinstance(a, torch.Tensor):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol, err_msg=path)
    else:
        assert a == b, path


def _configs():
    from gpmpc_tpu.config import load_config as jload
    from gpmpc_tpu_torch.config import load_config as tload

    return jload(SHIPPED, make_save_dir=False), tload(SHIPPED, make_save_dir=False)


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_families_equal_the_references(family):
    """Every field of the family's setup: the env module's name, the plant
    parameters, the trajectory (float32 sin/cos of each side: within 1e-6),
    the model's widths and step, the GP and sweep settings and the
    controller's keyword arguments (bounds as arrays)."""
    cj, ct = _configs()
    fj = REF_EVAL.FAMILIES[family](cj, types.SimpleNamespace(epochs=None, samples=None))
    ft = EVAL.FAMILIES[family](ct, types.SimpleNamespace(epochs=None, samples=None, device="cpu"))
    assert ft.env_mod.__name__.split(".")[-1] == fj.env_mod.__name__.split(".")[-1]
    assert ft.env_mod.__name__.startswith("gpmpc_tpu_torch.")
    assert ft.env_params._asdict().keys() == fj.env_params._asdict().keys()
    for k, v in fj.env_params._asdict().items():
        w = getattr(ft.env_params, k)
        if hasattr(v, "_asdict"):  # the plant's coefficients
            np.testing.assert_allclose(np.asarray(w, np.float64), np.asarray(v, np.float64),
                                       rtol=1e-7, err_msg=k)
        else:
            assert w == v, k
    np.testing.assert_allclose(_np(ft.trajectory), np.asarray(fj.trajectory), rtol=0, atol=1e-6)
    assert (ft.model.nx, ft.model.nu, ft.model.dt) == (fj.model.nx, fj.model.nu, fj.model.dt)
    for k in ("n_steps", "n_epochs", "samples_per_epoch", "sparse", "max_inducing", "ard",
              "gp_iters", "gp_lr", "master_seed"):
        assert getattr(ft, k) == getattr(fj, k), k
    _assert_same_value(ft.gpmpc_kwargs, fj.gpmpc_kwargs)


def test_eval_seeds_mains_pass_the_same_numbers_and_print_the_same_report(
        tmp_path, monkeypatch, capsys):
    """Both mains, on the reference's family (the quadrotor, from the YAML),
    with `seed_sweep` replaced by a stub that records its
    arguments and returns one fake cost matrix (a diverged seed in it):
    the same keyword arguments, SQP settings and plant parameters, the
    controllers' constants within a few float32 ulps, and the
    same report but for the wall-time line and the artifacts' directory."""
    import gpmpc_tpu.parallel.sweep as jsweep
    import gpmpc_tpu_torch.parallel.sweep as tsweep

    costs = np.array([[4.0, 3.5, 5.0, np.inf], [1.0, 2.5, 0.9, 7.0]])
    calls = {}

    def stub(tag, result):
        def seed_sweep(model, cfg, env_params, consts, **kw):
            calls[tag] = (model, cfg, env_params, consts, kw)
            return result
        return seed_sweep

    monkeypatch.setattr(jsweep, "seed_sweep", stub("ref", types.SimpleNamespace(
        costs=costs, n_points=np.array([0, 15]))))
    monkeypatch.setattr(tsweep, "seed_sweep", stub("port", types.SimpleNamespace(
        costs=torch.as_tensor(costs), n_points=torch.tensor([0, 15]))))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(SHIPPED.read_text().replace('save_dir: "saves/"', f'save_dir: "{tmp_path}/s/"'))
    args = ["--config", str(cfg), "--model", "quadrotor", "--seeds", "4", "--epochs", "1",
            "--backend", "xla", "--fast"]
    monkeypatch.setattr(sys, "argv", ["eval_seeds.py"] + args)
    REF_EVAL.main()
    out_ref = capsys.readouterr().out
    EVAL.main(args + ["--device", "cpu"])
    out_port = capsys.readouterr().out

    def report(text):
        lines = [ln for ln in text.splitlines() if not ln.startswith(("done in", "figures"))]
        return [re.sub(r"^artifacts: .*/", "artifacts: ", ln) for ln in lines]

    assert report(out_port) == report(out_ref) and "[1 diverged]" in out_port
    mj, cj, ej, kj, kwj = calls["ref"]
    mt, ct, et, kt, kwt = calls["port"]
    assert kwt.keys() == kwj.keys()
    for k in kwj:
        if k == "env_mod":
            assert kwt[k].__name__.split(".")[-1] == kwj[k].__name__.split(".")[-1]
        else:
            assert kwt[k] == kwj[k], k
    assert (mt.nx, mt.nu, mt.dt) == (mj.nx, mj.nu, mj.dt)
    for k in set(ct._fields) & set(cj._fields):
        assert getattr(ct, k) == getattr(cj, k), k
    _assert_same_value(et._replace(params=tuple(et.params)), ej._replace(params=tuple(ej.params)))
    # the constants: the reference's float32 sin/cos of the trajectory and its LQR
    # gain within a few float32 ulps (measured: 6e-8 and 3.8e-6 of a gain of 61)
    for k in kj._fields:
        _assert_same_value(getattr(kt, k), getattr(kj, k), k, atol=1e-6, rtol=1e-6)


def test_bench_gp_fit_prints_one_line_with_the_reference_keys(capsys):
    tree = ast.parse((REPO / "scripts" / "bench_gp_fit.py").read_text())
    ref_keys = next([k.value for k in node.keys] for node in ast.walk(tree)
                    if isinstance(node, ast.Dict)
                    and any(getattr(k, "value", None) == "metric" for k in node.keys))
    rows = FIT.main(["--device", "cpu", "--sizes", "16", "--iters", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == rows[0]
    row = rows[0]
    assert set(ref_keys) <= set(row) and row["metric"] == "torch_gp_fit[N=16]"
    assert row["unit"] == "ms/iteration" and row["value"] > 0 and row["finite"]
    assert row["iters_timed"] == 2 and 1 <= row["iters_run"] <= 2 and row["device"] == "cpu"


@pytest.mark.parametrize("script", ["eval_seeds", "bench_gp_fit"])
def test_default_device_is_the_card(script, tmp_path, monkeypatch):
    from gpmpc_tpu_torch.device import NoCudaDeviceError

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is runnable")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NoCudaDeviceError):
        (EVAL if script == "eval_seeds" else FIT).main([])
    assert not (tmp_path / "saves").exists()


@pytest.mark.slow
def test_eval_seeds_fast_subprocess(tmp_path):
    """scripts/eval_seeds_torch.py --fast as a subprocess on the CPU, as the
    reference's smoke test runs its own (tests/test_scripts.py), on the
    cartpole family: the quadrotor's xla steps at the YAML's 12 SQP / 12 IP
    iterations take seconds each in plain torch on a CPU. The report and
    both artifacts."""
    cfg = tmp_path / "config.yaml"
    cfg.write_text(SHIPPED.read_text().replace('save_dir: "saves/"', f'save_dir: "{tmp_path}/s/"'))
    r = subprocess.run(
        [sys.executable, "scripts/eval_seeds_torch.py", "--device", "cpu", "--config", str(cfg),
         "--model", "cartpole", "--fast", "--seeds", "2", "--epochs", "1", "--steps", "16"],
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "seeds improved over prior" in r.stdout and "backend=xla" in r.stdout, r.stdout
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("artifacts:")][0]
    stem = Path(line.split(" ", 1)[1].rsplit(".png", 1)[0])
    assert stem.name == "learning_curve_seeds_cartpole", line
    assert stem.with_suffix(".png").exists() and stem.with_suffix(".csv").exists()

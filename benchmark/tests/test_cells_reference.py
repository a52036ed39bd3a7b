"""The frozen plain reference against the port's plain path at a tiny size on
the CPU: the constants, the tightened boxes, the GP-MPC step (the plain
versions of kernels 1-4 behind `batched_gpmpc_step`), the plant, and the
benchmark's FITC posterior against the port's; and the harness's own
pieces around them: the boxes the step writes out, the checked steps' QP
iteration count, the family lookup and the traced window's reduction. These
hold the reference to the algorithm the benchmark measures; on the card the
same reference decides `correct`."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check, gpdata, spec, system, trace, traffic
from benchmark.reference import controller as rc
from benchmark.reference import quadrotor as rq
from benchmark.reference.precision import Precision, round_tf32
from benchmark.window import Driver

DEV = torch.device("cpu")
B, TILE = 8, 8


def tiny_config(name: str) -> dict:
    cfg = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    cfg.update(horizon=5)
    cfg["solver"].update(sqp_iters=3, qp_iters=6, tile=TILE)
    if cfg["gp"]["kind"] == "fitc":
        cfg["gp"].update(points=300, inducing=24, capacity=300)
    return cfg


def tiny_traffic() -> dict:
    tr = spec.load_json(spec.BENCH / "traffic" / "dr1024.json")
    tr.update(scenarios=B, episode_steps=6, checks=3)
    return tr


@pytest.fixture(scope="module", params=["quadrotor-fig8", "quadrotor-gp5k"])
def case(request):
    cfg = tiny_config(request.param)
    arrays = gpdata.gp_arrays(cfg, 11, spec.ROOT, DEV)
    s = system.build(cfg, arrays, B, DEV)
    eps = traffic.draw_episodes(tiny_traffic(), cfg, 2**33 + 5, 2, DEV)
    return cfg, arrays, s, eps


def test_consts_match_the_program(case):
    cfg, _, s, _ = case
    c = rc.make_consts(cfg, DEV)
    assert torch.allclose(c.A, s.consts.Ad, atol=1e-6)
    assert torch.allclose(c.B, s.consts.Bd_in, atol=1e-6)
    assert torch.allclose(c.K, s.consts.lqr_gain, rtol=1e-5, atol=1e-5)
    assert torch.equal(c.Bd, s.consts.Bd)
    assert c.ppf == pytest.approx(float(s.consts.inverse_cdf), rel=1e-7)
    assert torch.equal(c.traj, s.consts.mpc.traj)


def test_closed_loop_steps_match_the_program(case):
    cfg, arrays, s, eps = case
    s.params.copy_(eps.params[0])
    step = system.step_fn(s)
    carry = system.initial_carry(s, eps.x0[0])
    c, gp = rc.make_consts(cfg, DEV), rc.gp_set(cfg, arrays, DEV)
    plant = rq.Plant(dict(cfg["plant"], dt=cfg["dt"]), DEV)
    wu = c.uu - c.lu
    for _ in range(4):
        env, ctrl, obs = carry
        *carry, u = step(*carry)
        bounds = s.boxes  # what the step formed, written out by the step itself
        ref = rc.gpmpc_step(c, gp, cfg["solver"], ctrl.traj_step, ctrl.X_warm, ctrl.U_warm, obs)
        nxt = plant.step(dict(x=env.x, t=env.t, u_act=env.u_act, u_queue=env.u_queue),
                         s.params, u)
        assert float(((u - ref.u).abs() / wu).max()) < 1e-5
        assert float((carry[1].X_warm - ref.X).abs().max()) < 1e-5
        assert float((carry[1].U_warm - ref.U).abs().max()) < 1e-5
        assert float((carry[0].x - nxt["x"]).abs().max()) < 1e-6
        assert float((carry[0].u_act - nxt["u_act"]).abs().max()) < 1e-7
        for a, b in zip(bounds, ref.boxes):
            assert float((a - b).abs().max()) < 1e-5
        carry = tuple(carry)
    assert int(s.fails) == 0


def test_fitc_posterior_matches_the_program():
    from gpmpc_tpu_torch.gp.exact_gp import GPData, GPHypers
    from gpmpc_tpu_torch.gp.sparse import fitc_posterior

    cfg = tiny_config("quadrotor-gp5k")
    cfg["gp"].update(points=200, inducing=16)
    got = gpdata.fitc(cfg, 3, DEV)
    rng = np.random.default_rng(3)
    rq.residual_dataset(200, rng)
    idx = np.sort(rng.choice(200, 16, replace=False))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    data = GPData(x=t(got["Z"]), y=t(got["y"]), mask=t(got["mask"]))
    hyp = GPHypers(t(got["raw_lengthscale"]), t(got["raw_outputscale"]), t(got["raw_noise"]))
    Zs, alpha, W = fitc_posterior(hyp, data, torch.as_tensor(idx)[None, :],
                                  torch.ones(1, 16, dtype=torch.float64))
    assert np.allclose(got["Zs"], Zs.numpy(), atol=1e-7)
    assert np.allclose(got["alpha_s"], alpha.numpy(), rtol=1e-4, atol=1e-4)
    assert np.allclose(got["var_mat"], W.numpy(), rtol=1e-3, atol=1e-2 * float(np.abs(W).max()))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265, 0.0])
    r = round_tf32(x)
    assert r.tolist()[:4] == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9]  # ties to even
    assert abs(float(r[4]) + 3.14159265) < 2 ** -9 * 4
    assert float(r[5]) == 0.0
    m = torch.randn(16, 16)
    err = (Precision("tf32").mm(m, m) - Precision("float32").mm(m, m)).abs().max()
    assert 1e-5 < float(err) < 1e-1


def test_traffic_is_the_seeds_alone():
    cfg, tr = tiny_config("quadrotor-fig8"), tiny_traffic()
    a = traffic.draw_episodes(tr, cfg, 2**31 + 77, 3, DEV)
    b = traffic.draw_episodes(tr, cfg, 2**31 + 77, 3, DEV)
    c = traffic.draw_episodes(tr, cfg, 2**31 + 78, 3, DEV)
    assert torch.equal(a.x0, b.x0) and torch.equal(a.params, b.params)
    assert not torch.equal(a.x0, c.x0)
    longer = traffic.draw_episodes(tr, cfg, 2**31 + 77, traffic.BLOCK + 5, DEV)
    assert torch.equal(a.x0, longer.x0[:3]) and torch.equal(a.params, longer.params[:3])
    assert not torch.equal(longer.x0[0], longer.x0[traffic.BLOCK])
    scale = float(tr["param_scale"]) * float(tr["param_truncation"])
    base = rq.params_tensor(cfg["plant"]["params"], DEV)
    assert bool(((a.params / base - 1).abs() <= scale + 1e-6).all())
    steps = traffic.check_steps(tr, 2**31 + 77)
    assert steps == traffic.check_steps(tr, 2**31 + 77) and steps[0] == 0
    L = tr["episode_steps"]
    assert all(1 <= s % L <= L - 2 for s in steps[1:])


def test_checked_steps_carry_the_boxes_the_step_formed(case, monkeypatch):
    """The window's snapshots hold the boxes the timed step wrote out, equal
    to the program's first stage run again on the snapshot's inputs; the QP
    iteration count leaves the window's first step out. The window's clock
    reads the steps run, so that it runs 10 steps."""
    from benchmark import window
    from gpmpc_tpu_torch.control.gpmpc import batched_prepare_step
    from gpmpc_tpu_torch.device import strict_float32
    from gpmpc_tpu_torch.parallel.fused import FusedWindow

    cfg, arrays, s, eps = case
    s.params.copy_(eps.params[0])
    win = FusedWindow(system.step_fn(s), system.initial_carry(s, eps.x0[0]), 1)
    driver = Driver(win, s, eps, 6, system.initial_carry)
    driver.warm(2)
    monkeypatch.setattr(window.time, "perf_counter", lambda: float(driver.step_index))
    res = driver.window(9.5, [0, 2, 8])
    monkeypatch.undo()
    assert res.steps == 10
    assert [sn.step for sn in res.snapshots] == [0, 2, 8]
    for sn in res.snapshots:
        with torch.no_grad(), strict_float32():
            _, again, *_ = batched_prepare_step(s.model, s.consts, s.gp, sn.before[1],
                                                sn.before[2])
        for a, b in zip(sn.boxes, again):
            assert torch.equal(a, b)
    checked = [check.Checked(sn.step, sn.episode, sn.before, sn.after, sn.u, sn.plant_next,
                             sn.boxes) for sn in res.snapshots]
    first = check.compare(cfg, arrays, eps, checked[:1], 0, DEV)
    inside = check.compare(cfg, arrays, eps, checked[1:], 0, DEV)
    both = check.compare(cfg, arrays, eps, checked, 0, DEV)
    assert first.tile_iterations == 0.0
    assert both.tile_iterations == inside.tile_iterations > 0
    assert check.verdict(both.numbers, spec.load_json(
        spec.BENCH / "checks" / "quad-fig8.dr1024.json")["limits"]), both.numbers


def test_backend_and_family_come_from_the_configuration():
    cfg = tiny_config("quadrotor-fig8")
    arrays = gpdata.gp_arrays(cfg, 11, spec.ROOT, DEV)
    cfg["solver"].update(backend="xla")
    with pytest.raises(ValueError, match="dispatches to 'xla'"):
        system.build(cfg, arrays, B, DEV)
    cfg["solver"].update(path="xla")
    s = system.build(cfg, arrays, B, DEV)
    assert (s.backend, s.path, s.nx, s.nu) == ("xla", "xla", 12, 4)
    with pytest.raises(ValueError, match="no system for the family 'glider'"):
        system.build(dict(cfg, family="glider"), arrays, B, DEV)
    assert rc.family(cfg) is rq


class _Event:
    def __init__(self, name, start, end, cuda):
        self._v = (name, start, end, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU


def test_trace_reduces_the_marked_steps_on_the_device_timeline():
    """Device operations before the marked range (the spin kernel) do not
    count, nor does the range's own shadow on the device; busy time and span
    come from the device's own intervals."""
    events = [_Event("void at::cuda::spin_kernel(long)", 0, 1_900, True),
              _Event(trace.MARK, 1_000, 10_000, False),
              _Event(trace.MARK, 1_500, 9_000, True),
              _Event("cudaGraphLaunch", 1_000, 1_200, False),
              _Event("void gpmpc::ocp::resident::kernel<12, 4>(float*)", 2_000, 5_000, True),
              _Event("void elementwise(float)", 4_000, 6_000, True),
              _Event("void linearize_kernel(float)", 7_000, 8_000, True)]
    s = trace.reduce(events, 2)
    assert (s.busy_s, s.span_s) == (pytest.approx(5e-6), pytest.approx(6e-6))
    assert set(s.ops) == {"gpmpc::ocp::resident::kernel<12, 4>", "elementwise",
                          "linearize_kernel"}
    assert s.gaps == [(pytest.approx(1e-6), trace.MARK)]
    idle = spec.metric_reader("device.idle_share")(dict(summary=s))
    assert idle == pytest.approx(100 * (1 - 5 / 6))

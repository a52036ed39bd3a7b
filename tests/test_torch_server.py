"""The port's serving runtime (`runtime/server.py::ControlServer`), the
counterparts of tests/test_server.py's cases, on the CPU at tile 8 (32 for
the multi-tile case) and horizon 6 with the committed benchmark GP.

  * `xla`: each served action against the reference's `select_action` (JAX)
    on the same observation sequence, atol 1e-4 (the reference test's bar).
  * `lanes`: the QP's exit is tile-wide, so an action depends on what the idle
    slots hold; one dispatch is held against `batched_gpmpc_step` on the same
    tile buffers (the states before it, the observation buffer after the
    scatter) at 1e-6.
  * The reference's ADVICE.md findings, repaired in the port: snapshots keep
    `actions_per_step` (a mismatch raises; a reference snapshot restores only
    at N = 1), N may be the whole horizon [1, T], and the serving clients count
    the actions they consume.

Every client thread is joined with a timeout and must not be alive after it
(a deadlock fails the test), and every server is closed in `finally`.
"""

import os
import sys
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.utils import checkpoint as j_ckpt
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control.gpmpc import GPMPC
from gpmpc_tpu_torch.control.mpc import MpcInfo
from gpmpc_tpu_torch.envs.drone import DroneFigureEightEnv, EnvParams
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
from gpmpc_tpu_torch.parallel import batch as batch_mod
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step
from gpmpc_tpu_torch.runtime import server as server_mod
from gpmpc_tpu_torch.runtime.online import OnlineLearner
from gpmpc_tpu_torch.runtime.server import DIAG_FIELDS, ControlServer
from gpmpc_tpu_torch.utils.benchkit import replay_sessions
from tests._torch_threads import _one_thread  # noqa: F401

PRIOR = {
    "a": 12.1432, "b": 1.8118, "c": -72.08, "d": -7.5755,
    "e": 39.8653, "f": -72.08, "h": -7.5755, "l": 39.8653,
}
Q = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
R = [3, 3, 3, 0.1]
HORIZON = 6
JOIN_S = 120.0
ENV_PARAMS = EnvParams.default()._replace(n_steps=64, traj_amplitude=0.1)
HYPERS = ("raw_lengthscale", "raw_outputscale", "raw_noise")


def make_ctrl():
    env = DroneFigureEightEnv(ENV_PARAMS, device="cpu")
    model = symbolic_attitude(dt=0.02, params=PRIOR)
    ctrl = GPMPC(model, env.trajectory.numpy(), PRIOR, horizon=HORIZON, q_mpc=Q, r_mpc=R,
                 sparse_gp=True, max_gp_samples=40, seed=0, max_gp_points=128, sqp_iters=3,
                 qp_iters=5, device="cpu")
    return env, model, ctrl, convert.load_bench_gp("cpu")


def make_server(tile=8, max_wait_ms=50.0, backend="xla", **kw):
    env, model, ctrl, gp = make_ctrl()
    server = ControlServer(model, ctrl.cfg, ctrl.consts, gp, tile=tile, backend=backend,
                           max_wait_ms=max_wait_ms, **kw)
    return env, model, ctrl, gp, server


def run_threads(targets):
    threads = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client hung"


def test_server_matches_serial_controller_xla():
    """8 served steps of one session on `xla` against the reference's
    `select_action` consuming the same observations (from the port's plant,
    driven by the served actions)."""
    env, model, ctrl, gp, server = make_server()
    try:
        sid = server.open_session()
        obs, _ = env.reset(seed=3)
        obs_seq, act_seq = [obs.numpy()], []
        for _ in range(8):
            u = server.step(sid, obs)
            act_seq.append(u)
            obs, *_ = env.step(u)
            obs_seq.append(obs.numpy())
    finally:
        server.close()
    with np.load(convert.bench_gp_path("quadrotor")) as f:
        d = {k: np.asarray(v) for k, v in f.items()}
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    gp_j = j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"), hypers=JGPHypers(*[leaf(k) for k in HYPERS]),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(bool(d["trained"])))
    jc = j_gpmpc.GPMPC(j_sym(dt=0.02, params=PRIOR), ctrl.traj.numpy(), PRIOR, horizon=HORIZON,
                       q_mpc=Q, r_mpc=R, sparse_gp=True, max_gp_samples=40, seed=0,
                       max_gp_points=128, sqp_iters=3, qp_iters=5)
    step = jax.jit(partial(j_gpmpc.select_action, jc.model, jc.cfg))
    state = j_mpc.init_state(HORIZON, 12, 4)
    for k, o in enumerate(obs_seq[:-1]):
        u_ref, state, _ = step(jc.consts, gp_j, state, jnp.asarray(o))
        np.testing.assert_allclose(act_seq[k], np.asarray(u_ref), atol=1e-4)


def test_lanes_dispatch_equals_batched_step_on_the_tile_buffers():
    """Three sessions in one `lanes` dispatch, then one alone: each reply
    equals `batched_gpmpc_step` on the tile buffers the dispatch read (idle
    slots included), and only the requesting slots' states are committed."""
    env, model, ctrl, gp, server = make_server(backend="lanes", max_wait_ms=1000.0)
    try:
        sids = [server.open_session() for _ in range(3)]
        obs = env.trajectory[:3].numpy() + 0.01
        states, _ = server.tile_buffers()
        replies = {}
        run_threads([partial(lambda s, o: replies.__setitem__(s, server.step(s, o)), s, o)
                     for s, o in zip(sids, obs)])
        assert server.stats.n_batches == 1
        new_states, obs_buf = server.tile_buffers()
        u_ref, ref_states, _ = batched_gpmpc_step(model, ctrl.cfg, ctrl.consts, gp, states,
                                                  obs_buf, backend="lanes", lanes=server.lanes)
        for s in sids:
            assert np.abs(replies[s] - u_ref[s].numpy()).max() <= 1e-6
        idle = [i for i in range(8) if i not in sids]
        assert torch.equal(new_states.X_warm[idle], states.X_warm[idle])
        assert torch.equal(new_states.traj_step[sids], states.traj_step[sids] + 1)
        assert torch.equal(new_states.U_warm[sids], ref_states.U_warm[sids])

        states, _ = server.tile_buffers()
        u = server.step(sids[1], obs[1] - 0.02)
        _, obs_buf = server.tile_buffers()
        u_ref = batched_gpmpc_step(model, ctrl.cfg, ctrl.consts, gp, states, obs_buf,
                                   backend="lanes", lanes=server.lanes)[0]
        assert np.abs(u - u_ref[sids[1]].numpy()).max() <= 1e-6
    finally:
        server.close()


def test_server_batches_concurrent_clients():
    _, model, ctrl, gp, server = make_server(max_wait_ms=300.0)
    n_clients, n_rounds = 4, 3
    barrier = threading.Barrier(n_clients)
    failures = []

    def client(seed):
        try:
            env = DroneFigureEightEnv(ENV_PARAMS, device="cpu")
            sid = server.open_session()
            obs, _ = env.reset(seed=seed)
            for _ in range(n_rounds):
                barrier.wait(JOIN_S)  # release the round together: batchable
                u = server.step(sid, obs)
                assert np.all(np.isfinite(u))
                obs, *_ = env.step(u)
            server.close_session(sid)
        except Exception as e:  # surfaced through `failures`
            failures.append(e)

    try:
        run_threads([partial(client, s) for s in range(n_clients)])
    finally:
        server.close()
    assert not failures, failures
    stats = server.stats
    assert stats.n_requests == n_clients * n_rounds
    assert stats.mean_batch_size > 1.5, stats


def test_session_reset_on_reopen():
    env, model, ctrl, gp, server = make_server()
    try:
        obs0, _ = env.reset(seed=5)
        sid = server.open_session()
        first = server.step(sid, obs0)
        server.step(sid, obs0 + 0.01)
        server.close_session(sid)
        sid2 = server.open_session()
        assert sid2 == sid  # the slot pool is LIFO: the same slot, reset
        again = server.step(sid2, obs0)
        np.testing.assert_allclose(first, again, atol=1e-6)
        with pytest.raises(ValueError, match="not open"):
            server.close_session(7 if sid != 7 else 6)
    finally:
        server.close()


def test_gp_hotswap_changes_actions():
    env, model, ctrl, gp, server = make_server()
    try:
        obs0, _ = env.reset(seed=7)
        sid = server.open_session()
        u_before = server.step(sid, obs0)
        server.update_gp(gp._replace(alpha_s=gp.alpha_s * 1.5))
        server.close_session(sid)  # re-open: the same fresh warm state
        sid = server.open_session()
        u_after = server.step(sid, obs0)
        assert np.all(np.isfinite(u_after))
        assert not np.allclose(u_before, u_after, atol=1e-6)
    finally:
        server.close()


def test_gp_hotswap_shape_mismatch_rejected():
    """A GP of another capacity, dtype or structure is refused; the serving
    GP stays."""
    _, model, ctrl, gp, server = make_server()
    try:
        bigger = gp._replace(Z=torch.zeros(3, 256, 3))
        for bad in (bigger, gp._replace(alpha_s=gp.alpha_s.double()),
                    gp._replace(hypers=gp.hypers._replace(raw_lengthscale=torch.zeros(3, 3)))):
            with pytest.raises(ValueError, match="hot-swap"):
                server.update_gp(bad)
        assert server._gp is gp
    finally:
        server.close()


def test_slot_exhaustion_raises():
    _, model, ctrl, gp, server = make_server(tile=2)
    try:
        server.open_session()
        server.open_session()
        with pytest.raises(RuntimeError, match="slots in use"):
            server.open_session()
    finally:
        server.close()


def test_bad_obs_shape_rejected_in_caller():
    env, model, ctrl, gp, server = make_server()
    try:
        sid = server.open_session()
        with pytest.raises(ValueError, match="obs shape"):
            server.step(sid, np.zeros(13, np.float32))
        obs, _ = env.reset(seed=1)  # the server is still serving
        assert np.all(np.isfinite(server.step(sid, obs)))
    finally:
        server.close()


def test_online_learning_loop():
    """collect at the edge -> drain -> refit -> hot-swap, while serving."""
    env, model, ctrl, gp = make_ctrl()
    server = ControlServer(model, ctrl.cfg, ctrl.consts, gp, tile=8, backend="xla",
                           max_wait_ms=20.0, record_capacity=256)
    try:
        n_steps = 4
        envs = [DroneFigureEightEnv(ENV_PARAMS, device="cpu") for _ in range(2)]
        sids = [server.open_session() for _ in range(2)]
        obs = [e.reset(seed=i)[0] for i, e in enumerate(envs)]
        for _ in range(n_steps):
            for i in (0, 1):
                u = server.step(sids[i], obs[i])
                obs[i], *_ = envs[i].step(u)
        x, u_arr, x_next = server.drain_transitions()
        assert x.shape == (2 * (n_steps - 1), 12)  # one per step after a session's first
        assert u_arr.shape == (x.shape[0], 4) and x_next.shape == x.shape
        learner = OnlineLearner(model, PRIOR, capacity=gp.Z.shape[1], max_inducing=gp.Zs.shape[1],
                                n_train=3, lr=0.05, device="cpu")
        assert learner.ingest(x, u_arr, x_next) == x.shape[0]
        gp_new = learner.refit()
        assert bool(gp_new.trained)
        server.update_gp(gp_new)
        assert np.all(np.isfinite(server.step(sids[0], obs[0])))
        x2, _, _ = server.drain_transitions()
        assert x2.shape[0] <= 2  # only the new transitions
    finally:
        server.close()
    with pytest.raises(ValueError, match="recording"):
        ControlServer(model, ctrl.cfg, ctrl.consts, gp, tile=4, actions_per_step=2,
                      record_capacity=16)


def test_step_after_close_raises_not_hangs():
    _, model, ctrl, gp, server = make_server()
    sid = server.open_session()
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.step(sid, np.zeros(12, np.float32))


def test_close_fails_requests_that_raced_past_it(monkeypatch):
    """A request that reaches the queue behind the shutdown (past step()'s
    closed check) is failed by the dispatcher, not dropped."""
    env, model, ctrl, gp, server = make_server()
    entered, release = threading.Event(), threading.Event()
    step = batch_mod.batched_gpmpc_step

    def held(*a, **k):
        entered.set()
        release.wait(JOIN_S)
        return step(*a, **k)

    monkeypatch.setattr(batch_mod, "batched_gpmpc_step", held)
    sid = server.open_session()
    obs = env.trajectory[0].numpy()
    first = {}
    late = server_mod._Request(sid, obs, threading.Event(), {})
    closer = threading.Thread(target=server.close, daemon=True)
    try:
        run_first = threading.Thread(target=lambda: first.setdefault("u", server.step(sid, obs)),
                                     daemon=True)
        run_first.start()
        assert entered.wait(JOIN_S)  # the dispatcher is in the first dispatch
        closer.start()
        while not server._closed:
            threading.Event().wait(0.01)
        with server._close_lock:  # close() has queued the shutdown sentinel
            server._queue.put(late)  # behind the shutdown sentinel
        release.set()
        for t in (run_first, closer):
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        release.set()
        server.close()
    assert late.done.is_set() and "closed" in str(late.out["error"])
    assert np.all(np.isfinite(first["u"]))


def test_device_error_fails_the_batch_and_serving_goes_on(monkeypatch):
    """A dispatch that raises fails its batch's waiters with that error; the
    next request is served, and the failed dispatch committed nothing."""
    env, model, ctrl, gp, server = make_server()
    step = batch_mod.batched_gpmpc_step
    calls = []

    def fail_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return step(*a, **k)

    try:
        sid = server.open_session()
        states, obs_buf = server.tile_buffers()
        monkeypatch.setattr(batch_mod, "batched_gpmpc_step", fail_once)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            server.step(sid, env.trajectory[0].numpy())
        assert server.tile_buffers()[0] is states and server.tile_buffers()[1] is obs_buf
        assert np.all(np.isfinite(server.step(sid, env.trajectory[0].numpy())))
    finally:
        server.close()


def test_step_with_diag_reports_solver_health():
    env, model, ctrl, gp, server = make_server()
    try:
        sid = server.open_session()
        obs, _ = env.reset(seed=2)
        u, diag = server.step_with_diag(sid, obs)
        assert np.all(np.isfinite(u))
        assert tuple(diag) == DIAG_FIELDS
        assert diag["qp_gap"] >= 0.0 and np.isfinite(diag["qp_gap"])
        assert isinstance(diag["n_iters"], int) and 1 <= diag["n_iters"] <= 3
        assert diag["soft_viol"] >= 0.0
        assert isinstance(diag["converged"], bool)
        if not diag["converged"]:
            assert diag["n_iters"] == 3  # the SQP budget, reported as it is
        assert 0.0 <= diag["eq_res"] < 1.0 and np.isfinite(diag["stat_res"])
    finally:
        server.close()


def test_session_checkpoint_restore(tmp_path):
    """save_sessions -> restore_sessions into a new server: the same slots
    occupied, the same next actions; the snapshot's metadata holds the tile
    and actions_per_step."""
    env, model, ctrl, gp, server = make_server(tile=4)
    obs0, obs1 = (env.trajectory[i].numpy() for i in (0, 1))
    try:
        s_a, s_b = server.open_session(), server.open_session()
        for k, o in enumerate([obs0, obs1, obs0]):
            server.step(s_a, o + 0.01 * k)
            server.step(s_b, o - 0.01 * k)
        server.save_sessions(tmp_path / "sessions")
        u_a, u_b = server.step(s_a, obs1), server.step(s_b, obs0)
    finally:
        server.close()
    meta = j_ckpt.load_metadata(tmp_path / "sessions")  # the reference reads it too
    assert meta["tile"] == 4 and meta["actions_per_step"] == 1 and len(meta["free"]) == 2
    _, _, _, _, server2 = make_server(tile=4)
    try:
        server2.restore_sessions(tmp_path / "sessions")
        with pytest.raises(RuntimeError):
            for _ in range(3):  # the two restored slots are not free
                server2.open_session()
        np.testing.assert_allclose(server2.step(s_a, obs1), u_a, atol=1e-6)
        np.testing.assert_allclose(server2.step(s_b, obs0), u_b, atol=1e-6)
    finally:
        server2.close()


def test_session_restore_rejects_tile_mismatch(tmp_path):
    env, model, ctrl, gp, server = make_server(tile=4)
    try:
        sid = server.open_session()
        server.step(sid, env.trajectory[0].numpy())
        server.save_sessions(tmp_path / "snap")
    finally:
        server.close()
    _, _, _, _, server8 = make_server(tile=8)
    try:
        with pytest.raises(ValueError, match="tile"):
            server8.restore_sessions(tmp_path / "snap")
    finally:
        server8.close()


def test_snapshot_keeps_actions_per_step(tmp_path):
    """ADVICE.md (server.py:278), repaired: a snapshot taken at N = 2 is
    refused by a server at N = 1 and restores at N = 2; a snapshot in the
    reference's format (no actions_per_step: the reference's own
    `save_pytree` of the same tree) restores at N = 1 only."""
    env, model, ctrl, gp, server = make_server(tile=4, actions_per_step=2)
    try:
        sid = server.open_session()
        server.step(sid, env.trajectory[0].numpy())
        server.save_sessions(tmp_path / "n2")
        states, obs = server.tile_buffers()
    finally:
        server.close()
    for n_act, ok in ((1, False), (2, True)):
        _, _, _, _, other = make_server(tile=4, actions_per_step=n_act)
        try:
            if ok:
                other.restore_sessions(tmp_path / "n2")
                assert torch.equal(other.tile_buffers()[0].traj_step, states.traj_step)
            else:
                with pytest.raises(ValueError, match="actions_per_step"):
                    other.restore_sessions(tmp_path / "n2")
        finally:
            other.close()
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    tree = {"states": j_mpc.MpcState(*map(j, states)), "obs": j(obs),
            "gp": j_gpmpc.GpModel(*[JGPHypers(*map(j, v)) if isinstance(v, tuple) else j(v)
                                    for v in gp])}
    j_ckpt.save_pytree(tmp_path / "ref", tree, metadata={"free": [0, 1, 2], "tile": 4})
    for n_act, ok in ((1, True), (2, False)):
        _, _, _, _, other = make_server(tile=4, actions_per_step=n_act)
        try:
            if ok:
                other.restore_sessions(tmp_path / "ref")
                assert torch.equal(other.tile_buffers()[0].X_warm, states.X_warm)
            else:
                with pytest.raises(ValueError, match="actions_per_step"):
                    other.restore_sessions(tmp_path / "ref")
        finally:
            other.close()


def test_multi_tile_server_matches_small_tile():
    """A 32-slot server serves the same actions as an 8-slot one for the
    same session history (`xla`: every scenario solved on its own)."""
    env, model, ctrl, gp, small = make_server(tile=8)
    _, _, _, _, big = make_server(tile=32)
    try:
        obs = env.trajectory[0].numpy()
        sid_s, sid_b = small.open_session(), big.open_session()
        for k in range(2):
            np.testing.assert_allclose(big.step(sid_b, obs + 0.01 * k),
                                       small.step(sid_s, obs + 0.01 * k), atol=1e-5)
    finally:
        small.close()
        big.close()


def test_duplicate_slot_requests_do_not_block_others():
    """Two queued requests for one slot defer the second only: the other
    sessions' requests ride the same dispatch."""
    env, model, ctrl, gp, server = make_server(max_wait_ms=300.0)
    obs = env.trajectory[0].numpy()
    try:
        sids = [server.open_session() for _ in range(3)]
        results = {}
        hit = lambda slot, tag, o: results.__setitem__(tag, server.step(slot, o))  # noqa: E731
        run_threads([partial(hit, sids[0], "a1", obs), partial(hit, sids[0], "a2", obs + 0.01),
                     partial(hit, sids[1], "c1", obs), partial(hit, sids[2], "c2", obs)])
        n_batches = server.stats.n_batches
    finally:
        server.close()
    assert set(results) == {"a1", "a2", "c1", "c2"}
    assert all(np.all(np.isfinite(v)) for v in results.values())
    assert n_batches >= 2  # the duplicate forces a second dispatch


def test_actions_per_step_validation():
    """N in [1, T], and N > 1 excludes transition recording."""
    _, model, ctrl, gp = make_ctrl()
    for bad in (0, HORIZON + 1):
        with pytest.raises(ValueError, match="actions_per_step"):
            ControlServer(model, ctrl.cfg, ctrl.consts, gp, tile=4, actions_per_step=bad)


def test_nstep_reply_head_matches_single_step_and_n_may_be_the_horizon():
    """The N-step reply is the head of the plan the 1-step server solves:
    plan[0] equals the 1-step action. ADVICE.md (server.py:109-116), repaired:
    N may be the whole horizon, and the warm start then holds the plan's last
    input over the N - 1 stages shifted in, the clock advanced by N."""
    env, model, ctrl, gp = make_ctrl()
    servers = [ControlServer(model, ctrl.cfg, ctrl.consts, gp, tile=4, max_wait_ms=50.0,
                             backend="xla", actions_per_step=n) for n in (1, 3, HORIZON)]
    try:
        obs, _ = env.reset(seed=3)
        sids = [s.open_session() for s in servers]
        u1, plan3, plan_t = (s.step(i, obs) for s, i in zip(servers, sids))
        assert plan3.shape == (3, 4) and plan_t.shape == (HORIZON, 4)
        assert servers[2].action_shape == (HORIZON, 4)
        np.testing.assert_allclose(plan3[0], u1, atol=1e-5)
        np.testing.assert_allclose(plan_t[:3], plan3, atol=1e-5)
        st = servers[2].tile_buffers()[0]
        assert int(st.traj_step[sids[2]]) == HORIZON
        np.testing.assert_array_equal(st.U_warm[sids[2]].numpy(),
                                      np.repeat(plan_t[-1:], HORIZON, axis=0))
    finally:
        for s in servers:
            s.close()


def test_serving_clients_count_the_actions_they_consume():
    """ADVICE.md (serve_bench.py), repaired: with N = 2 and 5 steps, a client
    makes 3 requests (6 actions delivered) and consumes 5; the count is
    min(steps, requests x N) per client."""
    env, model, ctrl, gp, server = make_server(tile=4, actions_per_step=2, max_wait_ms=100.0)
    streams = np.stack([env.trajectory[:6].numpy() + 0.01 * i for i in range(2)])
    try:
        run = replay_sessions(server, streams, steps=5, clients=2, timeout_s=JOIN_S)
    finally:
        server.close()
    assert run["actions"] == 2 * 5
    assert run["n_requests"] == 2 * 3 and len(run["latencies_ms"]) == 6


def test_stress_sessions_keep_their_own_replies_and_clocks(monkeypatch):
    """More client threads than cores, the interpreter switching threads
    every microsecond, and a stub step (the reply is the observation's
    first four entries, the clock advances by one): every reply is its own
    request's, every session's clock counts its requests exactly (a lost or
    crossed commit would break it), and the recorded transitions and the
    request count add up."""
    n_threads, n_steps, tile = 2 * (os.cpu_count() or 8), 6, 64
    n_threads = min(n_threads, tile)

    def stub(model, cfg, consts, gp, states, obs, **kw):
        zeros = torch.zeros(obs.shape[0])
        info = MpcInfo(states.X_warm, states.U_warm, zeros, zeros, zeros.int() + 1, zeros, zeros,
                       zeros, zeros, zeros.bool())
        return obs[:, :4].clone(), states._replace(traj_step=states.traj_step + 1), info

    _, model, ctrl, gp = make_ctrl()
    monkeypatch.setattr(batch_mod, "batched_gpmpc_step", stub)
    server = ControlServer(model, ctrl.cfg, ctrl.consts, gp, tile=tile, max_wait_ms=1.0,
                           record_capacity=4096)
    failures, sids = [], {}

    def client(i):
        try:
            sid = server.open_session()
            sids[i] = sid
            for k in range(n_steps):
                obs = np.full(12, 1000.0 * i + k, np.float32)
                u = server.step(sid, obs)
                if not np.array_equal(u, obs[:4]):
                    failures.append((i, k, u))
        except Exception as e:  # surfaced through `failures`
            failures.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run_threads([partial(client, i) for i in range(n_threads)])
    finally:
        sys.setswitchinterval(interval)
        server.close()
    assert not failures, failures[:3]
    clocks = server.tile_buffers()[0].traj_step
    assert all(int(clocks[sid]) == n_steps for sid in sids.values())
    assert len(set(sids.values())) == n_threads
    assert server.stats.n_requests == n_threads * n_steps
    x, u, x_next = server.drain_transitions()
    assert x.shape[0] == n_threads * (n_steps - 1)
    np.testing.assert_array_equal(x_next[:, 0] - x[:, 0], np.ones(x.shape[0], np.float32))

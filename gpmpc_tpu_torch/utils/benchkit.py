"""Shared helpers for benchmarks and entry points. Port of
`gpmpc_tpu/utils/benchkit.py`: the bench's cost weights, the reference prior
dict, the synthetic residual dataset and the three families' synthetic GP
ensembles, trained by the port itself (`train_gp_models`); and the serving
benchmark's clients (`replay_sessions`, the loop of the reference's
`scripts/serve_bench.py`). Data comes from
numpy seeds, as in the reference; the inducing draws from a torch generator
seeded alike (JAX's draw cannot be reproduced, so a model trained here has
other inducing points than the reference's)."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS

Q_MPC = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
R_MPC = [3, 3, 3, 0.1]


def reference_prior_dict() -> dict:
    """The reference config's prior-parameter dict."""
    return dict(zip("abcdefhl", PRIOR_PARAMS))


def synthetic_residual_dataset(n: int = 60, seed: int = 0):
    """A quadrotor residual dataset at the reference's scale: a thrust-map
    deficit of ~4 m/s^2 plus small attitude-rate residuals. numpy float32
    (x7 (n, 7), y3 (n, 3))."""
    rng = np.random.default_rng(seed)
    x7 = np.zeros((n, 7), np.float32)
    x7[:, 0] = rng.uniform(0.2, 0.5, n)  # thrust command
    x7[:, 1:] = rng.normal(0, 0.2, (n, 6))
    y3 = np.stack(
        [
            4.0 + 0.5 * np.sin(5 * x7[:, 0]) + 0.01 * rng.normal(size=n),
            0.1 * x7[:, 1] + 0.01 * rng.normal(size=n),
            0.1 * x7[:, 4] + 0.01 * rng.normal(size=n),
        ],
        axis=1,
    ).astype(np.float32)
    return x7, y3


def _train(xz, y, max_points, max_inducing, n_train, seed, spec, device, ard=False):
    from gpmpc_tpu_torch.control.gpmpc import pack_training_data, train_gp_models

    device = resolve(device)
    data = pack_training_data(torch.as_tensor(xz, device=device),
                              torch.as_tensor(y, device=device), max_points, spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    return train_gp_models(data, gen, sparse=True, max_inducing=max_inducing, n_train=n_train,
                           lr=0.05, ard=ard)


def synthetic_gp_model(max_points: int = 128, max_inducing: int = 40, n_data: int = 60,
                       n_train: int = 30, seed: int = 0, ard: bool = False, device=None):
    """The quadrotor's GP ensemble (G = 3) trained on the synthetic dataset."""
    from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC

    x7, y3 = synthetic_residual_dataset(n_data, seed)
    return _train(x7, y3, max_points, max_inducing, n_train, seed, QUADROTOR_SPEC, device, ard)


def synthetic_cartpole_gp_model(max_points: int = 128, max_inducing: int = 40, n_data: int = 60,
                                n_train: int = 30, seed: int = 0, device=None):
    """The cartpole's GP ensemble (G = 2, D = 3) on synthetic acceleration residuals."""
    from gpmpc_tpu_torch.models.residual import CARTPOLE_SPEC

    rng = np.random.default_rng(seed)
    xz = np.zeros((n_data, 4), np.float32)  # z = [x_dot, theta, theta_dot, F]
    xz[:, 0] = rng.normal(0, 0.5, n_data)
    xz[:, 1] = rng.normal(0, 0.2, n_data)
    xz[:, 2] = rng.normal(0, 0.5, n_data)
    xz[:, 3] = rng.uniform(-6.0, 6.0, n_data)
    y = np.stack(
        [
            -0.4 * xz[:, 0] + 0.12 * xz[:, 3] + 0.01 * rng.normal(size=n_data),
            -0.5 * xz[:, 2] - 0.3 * xz[:, 1] + 0.01 * rng.normal(size=n_data),
        ],
        axis=1,
    ).astype(np.float32)
    return _train(xz, y, max_points, max_inducing, n_train, seed, CARTPOLE_SPEC, device)


def synthetic_twolink_gp_model(max_points: int = 128, max_inducing: int = 40, n_data: int = 60,
                               n_train: int = 30, seed: int = 0, device=None):
    """The two-link arm's GP ensemble (G = 2, D = 6) on synthetic acceleration residuals."""
    from gpmpc_tpu_torch.models.residual import TWOLINK_SPEC

    rng = np.random.default_rng(seed)
    xz = np.zeros((n_data, 6), np.float32)  # z = [q1, q2, dq1, dq2, t1/10, t2/10]
    xz[:, 0] = rng.uniform(-2.0, 0.0, n_data)
    xz[:, 1] = rng.uniform(0.0, 1.5, n_data)
    xz[:, 2:4] = rng.normal(0, 0.5, (n_data, 2))
    xz[:, 4:] = rng.uniform(-1.0, 1.0, (n_data, 2))
    y = np.stack(
        [
            1.5 + 0.4 * np.sin(xz[:, 1]) + 0.8 * xz[:, 4] + 0.01 * rng.normal(size=n_data),
            -9.0 - 0.5 * xz[:, 2] + 0.6 * xz[:, 5] + 0.01 * rng.normal(size=n_data),
        ],
        axis=1,
    ).astype(np.float32)
    return _train(xz, y, max_points, max_inducing, n_train, seed, TWOLINK_SPEC, device)


def replay_sessions(server, obs_streams: np.ndarray, steps: int, clients: int,
                    timeout_s: float = 600.0) -> dict:
    """`clients` threads, each an own session of `server` (a
    `runtime/server.py::ControlServer`) replaying the observation stream
    `obs_streams[i % len(obs_streams)]` (n_streams, >= steps, nx): with
    N-step replies (`actions_per_step` = N) a client requests every N-th
    observation and applies the returned plan head in between. One warm-up
    request first; the clients start together. Every thread is joined
    within `timeout_s` or this raises, as it does on a client's error or a
    non-finite or misshapen reply. Returns the wall time (s), each request's
    latency (ms, enqueue to reply), the requests and batches of the run and
    the actions the clients consumed, min(steps, requests x N) each."""
    n_act, want = server.actions_per_step, server.action_shape
    warm = server.open_session()
    server.step(warm, obs_streams[0, 0])
    server.close_session(warm)
    barrier = threading.Barrier(clients + 1)
    lock = threading.Lock()
    latencies: list[float] = []
    failures: list[Exception] = []

    def client(i):
        try:
            sid = server.open_session()
            stream = obs_streams[i % len(obs_streams)]
            local = []
            barrier.wait(timeout_s)
            for k in range(0, steps, n_act):
                t0 = time.perf_counter()
                u = server.step(sid, stream[k])
                local.append(1e3 * (time.perf_counter() - t0))
                if u.shape != want or not np.all(np.isfinite(u)):
                    raise RuntimeError(f"client {i}: reply of shape {u.shape}, finite "
                                       f"{bool(np.all(np.isfinite(u)))}")
            server.close_session(sid)
            with lock:
                latencies.extend(local)
        except Exception as e:  # surfaced after the join
            with lock:
                failures.append(e)
            barrier.abort()

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    try:
        barrier.wait(timeout_s)
    except threading.BrokenBarrierError:
        pass
    s0 = server.stats
    t0 = time.perf_counter()
    deadline = t0 + timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    wall = time.perf_counter() - t0
    s1 = server.stats
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"replay_sessions: a client is still waiting after {timeout_s} s")
    if failures:
        raise RuntimeError(f"replay_sessions: {len(failures)} client(s) failed") from failures[0]
    requests = len(range(0, steps, n_act))
    return dict(wall_s=wall, latencies_ms=np.asarray(latencies),
                n_requests=s1.n_requests - s0.n_requests, n_batches=s1.n_batches - s0.n_batches,
                actions=clients * min(steps, requests * n_act))

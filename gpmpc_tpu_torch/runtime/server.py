"""Micro-batching GP-MPC serving runtime. Port of
`gpmpc_tpu/runtime/server.py`: `ControlServer`, `ServerStats`, `DIAG_FIELDS`.

Many concurrent control sessions (drones, simulation workers, rigs) share
one card by packing their per-step solves into one tile: requests gathered
for up to `max_wait_ms` go to one `parallel/batch.py::batched_gpmpc_step`
over the whole tile, whatever its occupancy, and the results are scattered
back. Every dispatch runs the same code over the same tile width.

Contract (the reference's):
  * Sessions are slots of the tile. Each slot owns an `MpcState` (warm
    start and trajectory position) on the device; a dispatch commits the
    new state only for the slots that requested it. Idle slots re-solve
    their stale observation and their results are dropped.
  * The GP is swapped (`update_gp`) only between dispatches, and only for a
    GP of the same leaf shapes and dtypes.
  * Threads: clients block in `step()` on a per-request event; one
    dispatcher thread does every dispatch. Its loop runs under
    `torch.no_grad()` and `strict_float32()`, entered once there and in no
    other thread of the server (the float32 flag is process-wide). Every
    device operation of the server runs on the stream that was current
    when it was built. A fetch thread only waits for a dispatch's host
    copies of the fresh actions and diagnostics, never for a tensor that
    a later dispatch writes: the dispatch updates the tile's buffers out of
    place.
  * The lanes step reads a flag on the host once per SQP iteration, so a
    dispatch returns only when its solve has nearly finished, and
    `pipeline_depth` > 1 overlaps less than the reference's asynchronous
    dispatch did.

Fixed here against the reference (its ADVICE.md findings): snapshots store
`actions_per_step` and a restore refuses another value (a snapshot without
it, as the reference writes them, restores only at 1); the bound on N is
the enforced [1, T] (below).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.control import mpc as mpc_mod
from gpmpc_tpu_torch.control.gpmpc import GpModel, GpMpcConsts
from gpmpc_tpu_torch.control.mpc import MpcState
from gpmpc_tpu_torch.device import strict_float32
from gpmpc_tpu_torch.ops.sqp import SqpConfig
from gpmpc_tpu_torch.ops.sqp_lanes import LANES
from gpmpc_tpu_torch.parallel import batch as batch_mod
from gpmpc_tpu_torch.utils import checkpoint


class ServerStats(NamedTuple):
    n_requests: int
    n_batches: int

    @property
    def mean_batch_size(self) -> float:
        return self.n_requests / self.n_batches if self.n_batches else 0.0


class _Request(NamedTuple):
    slot: int
    obs: np.ndarray
    done: threading.Event
    out: dict


_SHUTDOWN = None  # queue sentinel

# Per-solve diagnostics, in the order a dispatch stacks them (the KKT residual
# telemetry of `ops/sqp.py::kkt_residuals` among them): a client sees a
# non-converged solve as a local caller sees MpcInfo.converged.
DIAG_FIELDS = ("qp_gap", "n_iters", "soft_viol", "eq_res", "stat_res", "converged")
_DIAG_INT = {"n_iters"}
_DIAG_BOOL = {"converged"}


def _signature(gp: GpModel) -> list:
    """The GP's structure and each leaf's shape, dtype and device."""
    leaves = checkpoint.flatten_with_paths(gp)
    return [(k, tuple(v.shape), v.dtype, v.device) for k, v in leaves]


class ControlServer:
    """Serve GP-MPC actions to concurrent control sessions with micro-batching.

    Usage:
        server = ControlServer(model, cfg, consts, gp, tile=128)
        sid = server.open_session()
        u = server.step(sid, obs)          # thread-safe, blocking
        server.update_gp(new_gp)           # hot-swap after a retrain
        server.close_session(sid); server.close()

    The tile's buffers live on the device of `consts` (the card, or the CPU
    in tests); the lanes QP tiles `LANES` scenarios on the card and the
    whole tile on the CPU (`lanes`).
    """

    def __init__(
        self,
        model,
        cfg: SqpConfig,
        consts: GpMpcConsts,
        gp: GpModel,
        tile: int = 128,
        backend: str = "lanes",
        max_wait_ms: float = 2.0,
        pipeline_depth: int = 2,
        record_capacity: int = 0,
        actions_per_step: int = 1,
    ):
        self._model, self._cfg, self._backend = model, cfg, backend
        self._consts, self._gp = consts, gp
        self._tile = tile
        self._max_wait_s = max_wait_ms / 1e3
        T, nx, nu = batch_mod.cfg_horizon(consts), model.nx, model.nu
        # N-step replies: every solve computes the whole open-loop plan U (T, nu),
        # so a reply may carry its first N actions; the client applies them
        # open-loop and comes back after N plant steps, amortizing one round
        # trip over N control steps. N may be anything in [1, T]: the plan is
        # solved afresh from each request's observation, so the last action a
        # client applies is N - 1 steps old, and the warm start then holds its
        # last input for the N - 1 stages shifted in at its end.
        if not 1 <= actions_per_step <= T:
            raise ValueError(
                f"actions_per_step={actions_per_step} must be in [1, horizon={T}]"
            )
        if actions_per_step > 1 and record_capacity > 0:
            raise ValueError(
                "transition recording requires actions_per_step=1: with N-step "
                "replies consecutive observations are N plant steps apart, which "
                "would poison the one-step residual targets the GP trains on"
            )
        self._n_act = actions_per_step
        self._nx, self._nu, self._T = nx, nu, T
        self.device = dev = consts.Ad.device
        self.lanes = LANES if dev.type == "cuda" else tile
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        with self._on_stream():
            self._state0 = mpc_mod.init_state(1, T, nx, nu, device=dev)
            self._states = mpc_mod.init_state(tile, T, nx, nu, device=dev)
            # benign placeholder observation of never-used slots: the trajectory start
            self._obs = consts.mpc.traj[0].to(torch.float32).expand(tile, nx).clone()

        self._lock = threading.Lock()  # guards the device state, the slot pool and the gp
        self._stats_lock = threading.Lock()
        self._free = list(range(tile))
        self._queue: queue.Queue = queue.Queue()
        self._n_requests = 0
        self._n_batches = 0
        self._pipeline_depth = max(1, pipeline_depth)
        self._fetch_pool = ThreadPoolExecutor(
            max_workers=self._pipeline_depth, thread_name_prefix="gpmpc-fetch"
        )
        # Online-learning hooks: with record_capacity > 0 the server keeps the most
        # recent (x, u, x_next) transitions of all sessions, the raw material of a
        # refit and an update_gp() swap (runtime/online.py::OnlineLearner).
        self._record_lock = threading.Lock()
        self._transitions: deque = deque(maxlen=record_capacity or None)
        self._record = record_capacity > 0
        self._pending_rec: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._closed = False
        self._close_lock = threading.Lock()
        self._dispatcher = threading.Thread(target=self._run, daemon=True)
        self._dispatcher.start()

    def _on_stream(self):
        """The server's stream for device work on any thread (a no-op on the CPU)."""
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    # -- session management ------------------------------------------------

    def open_session(self) -> int:
        """Claim a slot; its warm-start state is reset to a fresh controller."""
        with self._lock:
            if not self._free:
                raise RuntimeError(f"all {self._tile} session slots in use")
            slot = self._free.pop()
            with self._on_stream(), torch.no_grad():
                idx = torch.tensor([slot], device=self.device)
                self._states = MpcState(*[s.index_copy(0, idx, s0)
                                          for s, s0 in zip(self._states, self._state0)])
        with self._record_lock:
            self._pending_rec.pop(slot, None)  # no cross-session transitions
        return slot

    def close_session(self, slot: int) -> None:
        with self._lock:
            if slot in self._free:
                raise ValueError(f"session {slot} is not open")
            self._free.append(slot)
        with self._record_lock:
            self._pending_rec.pop(slot, None)

    def drain_transitions(self):
        """Pop all recorded (x, u, x_next) transitions as three stacked arrays
        (empty (0, .) arrays if none). Requires record_capacity > 0."""
        with self._record_lock:
            items = list(self._transitions)
            self._transitions.clear()
        if not items:
            nx, nu = self._nx, self._nu
            return (np.zeros((0, nx), np.float32), np.zeros((0, nu), np.float32),
                    np.zeros((0, nx), np.float32))
        x, u, x_next = (np.stack(c) for c in zip(*items))
        return x, u, x_next

    def update_gp(self, gp: GpModel) -> None:
        """Hot-swap the GP model between dispatches. The new model must have
        the serving model's structure and leaf shapes, dtypes and device
        (capacity == max_gp_points, inducing == max_gp_samples): any other
        model raises ValueError."""
        if _signature(gp) != _signature(self._gp):
            raise ValueError(
                "GP hot-swap would change the serving model's leaf shapes, dtypes or "
                "device; refit with buffers sized to the serving model "
                "(capacity == max_gp_points, inducing == max_gp_samples)"
            )
        with self._lock:
            self._gp = gp

    @property
    def actions_per_step(self) -> int:
        return self._n_act

    @property
    def action_shape(self) -> tuple:
        """The shape of a reply: (nu,), or (N, nu) with N-step replies."""
        return (self._nu,) if self._n_act == 1 else (self._n_act, self._nu)

    @property
    def stats(self) -> ServerStats:
        with self._stats_lock:  # consistent with a concurrent _deliver
            return ServerStats(self._n_requests, self._n_batches)

    def tile_buffers(self) -> tuple[MpcState, torch.Tensor]:
        """(states, obs): the tile's device buffers as the next dispatch reads
        them, every slot's controller state and last observation (idle slots
        included). A dispatch replaces them and never writes them in place."""
        with self._lock:
            return self._states, self._obs

    # -- session checkpoint and restore ---------------------------------------

    def save_sessions(self, path) -> None:
        """Persist every session's device state (warm starts, trajectory
        clocks, last observations, slot occupancy) and the serving GP with
        `utils/checkpoint.py`, in the reference's format; the metadata holds
        the tile and `actions_per_step`. Taken under the device lock, so no
        dispatch changes state mid-snapshot."""
        with self._lock:
            tree = {"states": self._states, "obs": self._obs, "gp": self._gp}
            free = list(self._free)
            with self._on_stream():
                checkpoint.save_pytree(path, tree, metadata={
                    "free": free, "tile": self._tile, "actions_per_step": self._n_act})

    def restore_sessions(self, path) -> None:
        """Restore a `save_sessions` snapshot of either package into this
        server. Its tile, its `actions_per_step` (1 where a snapshot lacks
        it, as the reference's do) and every buffer's shape must be this
        server's, or ValueError."""
        meta = checkpoint.load_metadata(path)
        if int(meta["tile"]) != self._tile:
            raise ValueError(f"snapshot tile {meta['tile']} != server tile {self._tile}")
        n_act = int(meta.get("actions_per_step", 1))
        if n_act != self._n_act:
            raise ValueError(
                f"snapshot actions_per_step {n_act} != server actions_per_step {self._n_act}: "
                "the sessions' trajectory clocks and warm starts advance by N a request")
        with self._lock:
            with self._on_stream():
                tree = checkpoint.load_pytree(
                    path, {"states": self._states, "obs": self._obs, "gp": self._gp})
            self._states, self._obs, self._gp = tree["states"], tree["obs"], tree["gp"]
            self._free = [int(s) for s in meta["free"]]

    # -- serving -----------------------------------------------------------

    def step(self, slot: int, obs) -> np.ndarray:
        """Request actions for session `slot` at observation `obs` (blocking).

        Returns one action (nu,) with the default actions_per_step=1; with
        actions_per_step=N>1, the first N actions (N, nu) of the freshly
        solved open-loop plan: apply them in order and call again after N
        plant steps."""
        return self.step_with_diag(slot, obs)[0]

    def step_with_diag(self, slot: int, obs) -> tuple[np.ndarray, dict]:
        """Like `step`, also returning the solve's health, `DIAG_FIELDS`:
        qp_gap (final complementarity gap), n_iters (SQP iterations),
        soft_viol (largest state-box violation), eq_res and stat_res (KKT
        residuals), converged. They ride the same fetch as the actions."""
        obs = np.asarray(obs, np.float32)
        if obs.shape != (self._nx,):  # fail in the caller, not the dispatcher
            raise ValueError(f"obs shape {obs.shape} != ({self._nx},)")
        req = _Request(slot, obs, threading.Event(), {})
        # The closed-check and the enqueue are one step against close(): either
        # this request precedes the shutdown sentinel in the queue (and is served
        # or failed by the dispatcher) or close() won and this raises.
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(req)
        req.done.wait()
        if "error" in req.out:
            raise req.out["error"]
        return req.out["action"], req.out["diag"]

    def close(self) -> None:
        with self._close_lock:  # atomic against step()'s check-then-enqueue
            self._closed = True
            self._queue.put(_SHUTDOWN)
        self._dispatcher.join()

    # -- dispatcher thread ---------------------------------------------------

    def _collect(self, block: bool) -> list[_Request] | None:
        """Gather a batch: the first request (blocking or not), then arrivals
        for max_wait_ms. None on shutdown, [] if non-blocking and idle."""
        try:
            first = self._queue.get() if block else self._queue.get_nowait()
        except queue.Empty:
            return []
        if first is _SHUTDOWN:
            return None
        batch = [first]
        seen = {first.slot}
        deferred: list[_Request] = []
        t_end = time.monotonic() + self._max_wait_s
        while len(batch) < self._tile:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is _SHUTDOWN:
                self._queue.put(_SHUTDOWN)  # re-posted for the outer loop
                break
            if req.slot in seen:
                # One batch never carries two requests for one slot: the second
                # waits for the next dispatch (its observation follows the first's
                # action anyway), while other sessions' requests still join this
                # one. Re-posted after the gather, so it is not picked up again.
                deferred.append(req)
                continue
            seen.add(req.slot)
            batch.append(req)
        for req in deferred:
            self._queue.put(req)
        return batch

    def _dispatch(self, slots: list[int], obs_new: np.ndarray):
        """One step over the whole tile: the requests' observations written
        into the observation buffer, `batched_gpmpc_step` on every slot, the
        new states committed for the requesting slots only (rows `slots`,
        the live part of the tile). Returns (u, diag, states, obs), all new
        tensors; with N-step replies u is the plan head (tile, N, nu)."""
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        obs_buf = self._obs.index_copy(
            0, idx, torch.as_tensor(obs_new, device=self.device))
        u, new_states, info = batch_mod.batched_gpmpc_step(
            self._model, self._cfg, self._consts, self._gp, self._states, obs_buf,
            backend=self._backend, lanes=self.lanes)
        n_act = self._n_act
        if n_act > 1:
            # The plan head U[:N] (u is U_warm[:, 0]), and the session advanced by
            # N: the trajectory clock by N, the warm start shifted by N - 1 more
            # (holding its last stage) so the next solve's guess stays aligned.
            u = new_states.U_warm[:, :n_act]
            shift = n_act - 1
            T = self._T
            idx_u = torch.clamp(torch.arange(T, device=self.device) + shift, max=T - 1)
            idx_x = torch.clamp(torch.arange(T + 1, device=self.device) + shift, max=T)
            new_states = MpcState(traj_step=new_states.traj_step + shift,
                                  X_warm=new_states.X_warm[:, idx_x],
                                  U_warm=new_states.U_warm[:, idx_u])
        diag = torch.stack([getattr(info, f).to(u.dtype) for f in DIAG_FIELDS], dim=-1)
        states = MpcState(*[old.index_copy(0, idx, new.index_select(0, idx))
                            for old, new in zip(self._states, new_states)])
        return u, diag, states, obs_buf

    def _launch(self, batch: list[_Request]):
        """Dispatch `batch` and queue the copies of its results to the host.
        Returns what `_deliver` needs: the batch, its slots, the host copies
        and the event that marks them complete (None on the CPU)."""
        slots = [r.slot for r in batch]  # unique within a batch (_collect)
        obs_new = np.stack([r.obs for r in batch])
        with self._lock, self._on_stream():
            u, diag, self._states, self._obs = self._dispatch(slots, obs_new)
            if self._stream is None:
                return batch, slots, u, diag, None
            u_host = torch.empty(u.shape, dtype=u.dtype, pin_memory=True)
            diag_host = torch.empty(diag.shape, dtype=diag.dtype, pin_memory=True)
            u_host.copy_(u, non_blocking=True)
            diag_host.copy_(diag, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._stream)
        return batch, slots, u_host, diag_host, copied

    def _deliver(self, batch: list[_Request], slots: list[int], u_host, diag_host, copied) -> None:
        """Wait for a dispatch's host copies and wake its waiters. Runs on the
        fetch pool, so the dispatcher gathers the next batch meanwhile."""
        try:
            if copied is not None:
                copied.synchronize()
            actions, diags = u_host.numpy()[slots], diag_host.numpy()[slots]
            with self._stats_lock:
                self._n_requests += len(batch)
                self._n_batches += 1
            if self._record:
                # A transition (x_k, u_k, x_{k+1}) completes when the same session's
                # next observation arrives; one request in flight per session keeps
                # each slot's requests in order.
                with self._record_lock:
                    for req, a in zip(batch, actions):
                        prev = self._pending_rec.get(req.slot)
                        if prev is not None:
                            self._transitions.append((prev[0], prev[1], req.obs))
                        self._pending_rec[req.slot] = (req.obs, np.asarray(a))
            for req, a, d in zip(batch, actions, diags):
                req.out["action"] = a
                req.out["diag"] = {
                    name: (int(v) if name in _DIAG_INT
                           else bool(v) if name in _DIAG_BOOL
                           else float(v))
                    for name, v in zip(DIAG_FIELDS, d)
                }
                req.done.set()
        except Exception as e:  # a device error reaches every waiter
            for req in batch:
                req.out["error"] = e
                req.done.set()

    def _run(self) -> None:
        with torch.no_grad(), strict_float32():
            self._serve()

    def _serve(self) -> None:
        inflight: deque = deque()
        stop = False
        while True:
            # Keep up to `pipeline_depth` batches in flight: the dispatcher gathers
            # and launches while the fetch pool waits for earlier results.
            while not stop and len(inflight) < self._pipeline_depth:
                batch = self._collect(block=not inflight and not stop)
                if batch is None:
                    stop = True
                elif not batch:
                    break
                else:
                    try:
                        launched = self._launch(batch)
                    except Exception as e:  # fail the batch, keep serving
                        for req in batch:
                            req.out["error"] = e
                            req.done.set()
                        continue
                    inflight.append(self._fetch_pool.submit(self._deliver, *launched))
            if not inflight:
                if stop:
                    self._fetch_pool.shutdown(wait=True)
                    # Fail any request that raced past the closed check: a silent
                    # drop would block its step() caller forever.
                    while True:
                        try:
                            req = self._queue.get_nowait()
                        except queue.Empty:
                            return
                        if req is not _SHUTDOWN:
                            req.out["error"] = RuntimeError("server is closed")
                            req.done.set()
                continue
            inflight.popleft().result()

"""The fused window (`gpmpc_tpu_torch/parallel/fused.py`, bench.py's
`BENCH_FUSED=1`) and what makes the lanes-fused step capturable, on the CPU:
the SQP loops without their early exit give the early exit's solution bit
for bit; the window run eagerly equals the chained closed loop bit for bit
and follows a JAX `lax.scan` of bench.py's closed-loop step; the plants read
their constants from a cache that is never stale and step as before, bit
for bit."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.envs import drone as j_drone
from gpmpc_tpu.parallel.batch import batched_gpmpc_step as j_batched_gpmpc_step
from gpmpc_tpu_torch import device as t_device
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.envs import cartpole_env, drone, twolink_env
from gpmpc_tpu_torch.ops import sqp_lanes
from gpmpc_tpu_torch.ops.sqp import sqp_solve
from gpmpc_tpu_torch.parallel.fused import MAX_STEPS, FusedWindow
from gpmpc_tpu_torch.parallel.mesh import tree_leaves
from tests._torch_threads import _one_thread  # noqa: F401
from tests.test_torch_bench import BENCH, HORIZON, jax_bench_loop, port_env_state

FAMILIES = ("quadrotor", "cartpole", "twolink")
B = 4
ENVS = {"quadrotor": drone, "cartpole": cartpole_env, "twolink": twolink_env}


def _equal_trees(a, b) -> bool:
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


class _Loop:
    """bench.py's closed loop for one family at T = 8 and `batch` on the
    CPU: the problem, bench.py's config, the initial carry, each step's
    actions, the carry before the last step and after it, and the SQP inputs
    of the loop's second step (recorded as `sqp_solve_batch_lanes_fused` was
    called)."""

    def __init__(self, family, batch, n_steps):
        self.prob = BENCH.build_problem(family, HORIZON, device="cpu", **BENCH.FIXTURE_GP)
        self.cfg = BENCH.configure(self.prob.ctrl.cfg, {})
        es, obs = self.prob.env_mod.env_reset(self.prob.env_p, batch,
                                              torch.Generator().manual_seed(0), "cpu")
        st = t_mpc.init_state(batch, HORIZON, self.prob.model.nx, self.prob.model.nu,
                              device="cpu")
        self.carry0 = (es, st, obs)
        calls = []
        solve = t_gpmpc.sqp_solve_batch_lanes_fused

        def spy(*args, **kw):
            calls.append((args, kw))
            return solve(*args, **kw)

        t_gpmpc.sqp_solve_batch_lanes_fused = spy
        try:
            self.u, carry = [], self.carry0
            for _ in range(n_steps):
                self.before_last = carry
                *carry, u = self.step(self.cfg)(*carry)
                self.u.append(u)
            self.final = tuple(carry)
        finally:
            t_gpmpc.sqp_solve_batch_lanes_fused = solve
        self.sqp_args = calls[1]

    def step(self, cfg):
        return partial(BENCH.closed_loop_step, self.prob, cfg, self.prob.gp)


_LOOPS: dict = {}


def _loop(family, batch=B, n_steps=2) -> _Loop:
    key = (family, batch, n_steps)
    if key not in _LOOPS:
        _LOOPS[key] = _Loop(family, batch, n_steps)
    return _LOOPS[key]


def _window_loop() -> _Loop:
    """The quadrotor's loop of five steps at B = 4, which the window follows."""
    return _loop("quadrotor", B, 5)


def _count_linearizations(monkeypatch):
    count = [0]
    lin = sqp_lanes.linearize_ocp_lanes

    def counted(*args, **kw):
        count[0] += 1
        return lin(*args, **kw)

    monkeypatch.setattr(sqp_lanes, "linearize_ocp_lanes", counted)
    return count


@pytest.mark.parametrize("start", ["cold", "converged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_lanes_fused_sqp_without_early_exit_equals_it(family, start, monkeypatch):
    """`sqp_solve_batch_lanes_fused` on the second closed-loop step's inputs
    at T = 8 and one whole tile, B = 128 (a padded scenario of a narrower
    batch rarely converges, and the exit waits for the whole tile), with
    bench.py's config, from the step's own start and from the solution of
    the same problem: `early_exit=False` gives every field of the
    SqpSolution bit for bit as `early_exit=True`. With the exit the loop
    linearizes max(n_iters) times, without it cfg.sqp_iters times. From the
    converged start every quadrotor and cartpole scenario converges by the
    second iteration, so the exit fires; the two-link arm's (lm_reg 0.5) run
    all six."""
    (lin, dt, cost, bounds, x0, X_init, U_init, cfg), kw = _loop(family, 128).sqp_args
    assert cfg.early_exit and cfg.sqp_iters == 6
    if start == "converged":
        first = sqp_lanes.sqp_solve_batch_lanes_fused(lin, dt, cost, bounds, x0, X_init, U_init,
                                                      cfg, **kw)
        X_init, U_init = first.X, first.U
    count = _count_linearizations(monkeypatch)
    with_exit = sqp_lanes.sqp_solve_batch_lanes_fused(lin, dt, cost, bounds, x0, X_init, U_init,
                                                      cfg, **kw)
    n_with = count[0]
    without = sqp_lanes.sqp_solve_batch_lanes_fused(lin, dt, cost, bounds, x0, X_init, U_init,
                                                    cfg._replace(early_exit=False), **kw)
    assert count[0] - n_with == cfg.sqp_iters
    assert n_with == int(with_exit.n_iters.max())
    assert (n_with < cfg.sqp_iters) == (start == "converged" and family != "twolink")
    for name in with_exit._fields:
        assert torch.equal(getattr(without, name), getattr(with_exit, name)), name


def test_xla_sqp_without_early_exit_equals_it():
    """`ops/sqp.py::sqp_solve`, the `xla` path's loop, on the quadrotor's
    second-step problem from a converged start (the solution of the same
    problem): every scenario converges at its first iteration, the early exit
    fires, and `early_exit=False` gives every SqpSolution field bit for bit."""
    loop = _window_loop()
    (lin, dt, cost, bounds, x0, X_init, U_init, cfg), _ = loop.sqp_args
    fd = partial(t_gpmpc.augmented_fd, loop.prob.model, loop.prob.gp)
    first = sqp_solve(fd, cost, bounds, x0, X_init, U_init, cfg)
    with_exit = sqp_solve(fd, cost, bounds, x0, first.X, first.U, cfg)
    without = sqp_solve(fd, cost, bounds, x0, first.X, first.U, cfg._replace(early_exit=False))
    assert bool(with_exit.converged.all()) and int(with_exit.n_iters.max()) < cfg.sqp_iters
    for name in with_exit._fields:
        assert torch.equal(getattr(without, name), getattr(with_exit, name)), name


@pytest.mark.parametrize("unroll", ["1", "3", "full"])
def test_fused_window_equals_the_chained_loop(unroll):
    """The window on the CPU (T = 8, B = 4, 5 steps; 1, 3 and all 5 steps a
    graph's worth of body, `early_exit=False`) from the chained loop's start:
    the trace of u[0, 0], the last step's actions, the carry before it and
    the final carry bit for bit the chained `closed_loop_step` loop's (with
    the early exit)."""
    loop = _window_loop()
    window = FusedWindow(loop.step(loop.cfg._replace(early_exit=False)), loop.carry0,
                         BENCH.fused_unroll(unroll, 5))
    trace = window.run(5)
    assert torch.equal(trace, torch.stack([u[0, 0] for u in loop.u]))
    assert torch.equal(window.u, loop.u[-1])
    assert _equal_trees(window.carry, loop.final)
    assert _equal_trees(window.last, loop.before_last)


_JAX_SCAN: dict = {}


def _jax_scan_of_bench_py():
    """bench.py's fused window in the JAX package (T = 8, B = 4, 3 steps of
    `closed_loop_step` in one `lax.scan`, float32 carry) from PRNGKey(0):
    (the JAX loop's settings, the carry it started from, its actions),
    compiled once for every case."""
    if not _JAX_SCAN:
        loop = jax_bench_loop(B)
        jc, env_p = loop["jc"], loop["env_p"]

        f32 = partial(jax.tree.map, lambda a: a.astype(jnp.float32)  # noqa: E731
                      if jnp.issubdtype(a.dtype, jnp.floating) else a)

        def body(carry, _):
            es, st, obs = carry
            u, st, _ = j_batched_gpmpc_step(jc.model, loop["cfg_j"], jc.consts, loop["gp_j"], st,
                                            obs, backend="xla")
            es, obs, *_ = jax.vmap(lambda s, a: j_drone.env_step(env_p, s, a))(es, u)
            return f32((es, st, obs)), u

        carry_j = f32((loop["es"], loop["st_j"], loop["obs"]))
        _, u_j = jax.jit(lambda c: jax.lax.scan(body, c, None, length=3))(carry_j)
        _JAX_SCAN.update(loop=loop, carry=carry_j, u=np.asarray(u_j, np.float32))
    return _JAX_SCAN["loop"], _JAX_SCAN["carry"], _JAX_SCAN["u"]


@pytest.mark.parametrize("backend", ["lanes", "xla"])
def test_fused_window_follows_a_jax_scan_of_bench_py(backend):
    """The window, one step a run (T = 8, B = 4, 3 steps, the fixture GP),
    on the port's lanes-fused step and on its `xla` step, against a
    `lax.scan` of bench.py's `closed_loop_step` (bench.py:247-285, the JAX
    package's `batched_gpmpc_step` on `xla` and its plant) from the same
    initial states (PRNGKey(0)), each side stepping its own plant: u within
    5e-4 at every step and control RMSE <= 1e-3 (BASELINE.md); the trace of
    each run is its u[0, 0]."""
    loop, carry_j, u_j = _jax_scan_of_bench_py()
    prob = loop["prob"]
    carry = (port_env_state(carry_j[0]), t_mpc.init_state(B, HORIZON, 12, 4, device="cpu"),
             torch.tensor(np.asarray(carry_j[2])))
    window = FusedWindow(partial(BENCH.closed_loop_step, prob,
                                 loop["cfg_t"]._replace(early_exit=False), prob.gp,
                                 backend=backend), carry)
    u_t = []
    for _ in range(3):
        trace = window.run(1)
        assert torch.equal(trace, window.u[:1, 0])
        u_t.append(window.u.numpy().copy())
    for k in range(3):
        np.testing.assert_allclose(u_t[k], u_j[k], atol=5e-4, err_msg=f"step {k}")
    assert float(np.sqrt(np.mean((np.stack(u_t) - u_j) ** 2))) <= 1e-3


def _toy_step(x, y):
    """A carry whose first output is the second input itself: the window
    must read y before it writes x."""
    return y, x + y, torch.stack([x, y], dim=-1)


@pytest.mark.parametrize("steps_per_graph,n", [(1, 7), (3, 7), (7, 7), (4, 2)])
def test_fused_window_carries_an_aliased_output(steps_per_graph, n):
    """A Fibonacci carry (x, y) -> (y, x + y) whose output aliases an input
    buffer: the trace holds x of every step, the carry the n-th pair, `last`
    the pair before it, `u` its actions, at any split into graphs; the given
    carry is left as it was."""
    x0, y0 = torch.zeros(1), torch.ones(1)
    window = FusedWindow(_toy_step, (x0, y0), steps_per_graph)
    fib = [0.0, 1.0]
    while len(fib) < n + 2:
        fib.append(fib[-1] + fib[-2])
    assert window.run(n).tolist() == fib[:n]
    assert [float(t) for t in window.carry] == fib[n:n + 2]
    assert [float(t) for t in window.last] == fib[n - 1:n + 1]
    assert window.u.tolist() == [fib[n - 1:n + 1]]
    assert (float(x0), float(y0)) == (0.0, 1.0)
    assert window.run(1).tolist() == [fib[n]]  # a second run goes on from the carry


def test_fused_window_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="steps_per_graph"):
        FusedWindow(_toy_step, (torch.zeros(1), torch.ones(1)), 0)
    window = FusedWindow(_toy_step, (torch.zeros(1), torch.ones(1)), max_steps=4)
    for n in (0, 5):
        with pytest.raises(ValueError, match="1 to 4 steps"):
            window.run(n)
    with pytest.raises(ValueError, match="BENCH_FUSED_UNROLL"):
        BENCH.fused_unroll("0", 60)
    assert (BENCH.fused_unroll("full", 60), BENCH.fused_unroll("7", 60), MAX_STEPS) == (60, 7, 4096)


def _uncached_step(env_mod, monkeypatch, p, state, u):
    """`env_step` as it was before the constants were cached: every constant
    built anew each call and, for the quadrotor, the rows taken by lists of
    indices."""
    with monkeypatch.context() as m:
        m.setattr(env_mod, "device_constant", lambda key, device, build: build(device))
        if env_mod is drone:
            m.setattr(drone, "_VEL", [1, 3, 5])
            m.setattr(drone, "_POS", [0, 2, 4])
        return env_mod.env_step(p, state, u)


@pytest.mark.parametrize("family", FAMILIES)
def test_env_step_reads_its_constants_from_a_cache_never_stale(family, monkeypatch):
    """Each plant's `env_step` over three steps with two parameter sets in
    turn (the default, then one whose trajectory, lag and friction differ,
    then the default again): every output bit for bit the uncached step's,
    and the cache holds one entry per parameter set."""
    env_mod = ENVS[family]
    p1 = env_mod.EnvParams.default()
    changed = {"quadrotor": dict(traj_amplitude=0.5, rotor_tau=0.1, drag_quad=0.2, n_steps=200),
               "cartpole": dict(traj_amplitude=0.4, friction_cart=0.5, n_steps=200),
               "twolink": dict(amp1=0.3, friction1=0.2, n_steps=200)}[family]
    p2 = p1._replace(**changed)
    monkeypatch.setattr(t_device, "_CONSTANTS", {})
    state, _ = env_mod.env_reset(p1, 3, torch.Generator().manual_seed(1), "cpu")
    u = torch.tensor(np.random.default_rng(2).normal(0, 0.1, (3, _loop_nu(family))),
                     dtype=torch.float32)
    if family == "quadrotor":
        u = u + drone.hover_input(p1.params, "cpu")
    for p in (p1, p2, p1):
        got = env_mod.env_step(p, state, u)
        want = _uncached_step(env_mod, monkeypatch, p, state, u)
        assert _equal_trees(got, want)
        state = got[0]
    assert len(t_device._CONSTANTS) == 2


def _loop_nu(family):
    return {"quadrotor": 4, "cartpole": 1, "twolink": 2}[family]

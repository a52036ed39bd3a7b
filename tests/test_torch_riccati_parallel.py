"""The port's associative-scan Riccati (`ops/riccati_parallel.py`) against
the JAX package's and the sequential recursion, with the reference's
tolerances (tests/test_riccati_parallel.py): 1e-9 in float64; in float32 at
T = 64 within 5e-3 of the float64 sequential truth. `solve_ocp_qp(
parallel_scan=True)` against JAX's in float32 (5e-4, chip_smoke.py's QP
bar), the controllers with `parallel_scan=True` within 1e-4 of the
sequential ones and of JAX's MPC (the reference's end-to-end bar), and
the stage-sharded scan on 8 CPU shards within 1e-5 of the unsharded one."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control.mpc import MPC as JMPC
from gpmpc_tpu.models.quadrotor import TRUE_PARAMS as J_TRUE_PARAMS
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_symbolic_attitude
from gpmpc_tpu.ops import boxqp as j_boxqp
from gpmpc_tpu.ops import riccati as j_riccati
from gpmpc_tpu.ops import riccati_parallel as j_riccati_parallel
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control.mpc import MPC
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.models.quadrotor import TRUE_PARAMS
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
from gpmpc_tpu_torch.ops import boxqp as t_boxqp
from gpmpc_tpu_torch.ops import riccati as t_riccati
from gpmpc_tpu_torch.ops.riccati_parallel import riccati_solve_parallel
from gpmpc_tpu_torch.parallel.mesh import make_mesh
from tests._torch_threads import _one_thread  # noqa: F401
from tests.test_ocp_solvers import NX, random_lq
from tests.test_torch_boxqp import _both, _qp

F32 = np.float32
_J_PARALLEL = jax.jit(j_riccati_parallel.riccati_solve_parallel)  # one compile per shape


def _port(lq_j, dtype=torch.float64):
    """A JAX LqProblem as the port's, batch-first with one scenario."""
    return t_riccati.LqProblem(*[torch.as_tensor(np.asarray(a), dtype=dtype)[None] for a in lq_j])


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_parallel_matches_sequential_and_jax(seed):
    """tests/test_riccati_parallel.py's float64 problems: the port's scan
    within 1e-9 of JAX's scan, of JAX's sequential recursion and of the
    port's own, on du, dx and K."""
    lq = random_lq(seed, dtype=jnp.float64)
    dx0 = np.random.default_rng(seed).normal(size=NX)
    got = riccati_solve_parallel(_port(lq), torch.as_tensor(dx0)[None])
    seq_t = t_riccati.riccati_solve(_port(lq), torch.as_tensor(dx0)[None])
    par_j = _J_PARALLEL(lq, jnp.asarray(dx0))
    seq_j = j_riccati.riccati_solve(lq, jnp.asarray(dx0))
    for name in ("du", "dx", "K"):
        mine = getattr(got, name)[0].numpy()
        assert getattr(got, name).dtype == torch.float64
        for want in (getattr(par_j, name), getattr(seq_j, name), getattr(seq_t, name)[0]):
            np.testing.assert_allclose(mine, np.asarray(want), atol=1e-9)


def _long_problem(seed, T_long=64):
    """tests/test_riccati_parallel.py's long-horizon problem (numpy)."""
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(NX), (T_long, 1, 1)) + 0.05 * rng.normal(size=(T_long, NX, NX))
    B = rng.normal(size=(T_long, NX, 2)) * 0.5
    r = rng.normal(size=(T_long, NX)) * 0.05
    Qxx = np.stack([np.diag(rng.uniform(0.5, 2, NX)) for _ in range(T_long + 1)])
    qx = rng.normal(size=(T_long + 1, NX)) * 0.3
    Ruu = np.stack([np.diag(rng.uniform(0.5, 2, 2)) for _ in range(T_long)])
    ru = rng.normal(size=(T_long, 2)) * 0.3
    return (A, B, r, Qxx, qx, Ruu, ru)


def test_parallel_long_horizon_f32():
    """T = 64 in float32 (the production dtype) against the float64
    sequential truth of JAX: du within 5e-3."""
    arrays = _long_problem(7)
    ref = j_riccati.riccati_solve(j_riccati.LqProblem(*(jnp.asarray(a, jnp.float64) for a in arrays)),
                                  jnp.zeros(NX, jnp.float64))
    lq32 = t_riccati.LqProblem(*[torch.as_tensor(a, dtype=torch.float32)[None] for a in arrays])
    got = riccati_solve_parallel(lq32, torch.zeros(1, NX))
    assert got.du.dtype == torch.float32
    np.testing.assert_allclose(got.du[0].numpy(), np.asarray(ref.du), atol=5e-3)


def test_solve_ocp_qp_parallel_scan_matches_jax():
    """`solve_ocp_qp(parallel_scan=True)` at T = 10, 12x4, B = 3, Mehrotra,
    10 IP iterations, against JAX's vmapped solver with parallel_scan: dx
    and du within 5e-4; and within 5e-4 of the port's sequential solve."""
    data = _qp(4, 3)
    qp_j, qp_t = _both(j_boxqp.OcpQpData, t_boxqp.OcpQpData, data)
    want = jax.jit(jax.vmap(partial(j_boxqp.solve_ocp_qp, n_iter=10, mehrotra=True,
                                    parallel_scan=True)))(qp_j)
    got = t_boxqp.solve_ocp_qp(qp_t, n_iter=10, mehrotra=True, parallel_scan=True)
    seq = t_boxqp.solve_ocp_qp(qp_t, n_iter=10, mehrotra=True)
    assert bool(torch.isfinite(got.dx).all())
    for name in ("dx", "du"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=5e-4)
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(seq, name).numpy(),
                                   atol=5e-4)


def test_controllers_with_parallel_scan_match_sequential():
    """tests/test_riccati_parallel.py's end-to-end check on the port: the
    nominal MPC (horizon 8, 3 SQP / 6 IP) with the associative scan gives
    the sequential controller's actions and JAX's MPC(parallel_scan=True)'s
    within 1e-4 over three closed-loop steps, and one GPMPC step on the xla
    path gives the sequential one's."""
    env = drone.DroneFigureEightEnv(device="cpu")
    model = symbolic_attitude(dt=0.02, params=TRUE_PARAMS._asdict())
    q = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
    r = [3, 3, 3, 0.1]
    traj = np.asarray(env.trajectory)
    seq, par = (MPC(model, traj, q, r, horizon=8, sqp_iters=3, qp_iters=6, parallel_scan=p,
                    device="cpu") for p in (False, True))
    j_par = JMPC(j_symbolic_attitude(dt=0.02, params=J_TRUE_PARAMS), traj, q, r, horizon=8,
                 sqp_iters=3, qp_iters=6, parallel_scan=True)
    obs, _ = env.reset(seed=0)
    seq.reset()
    par.reset()
    j_par.reset()
    for _ in range(3):
        u_s, u_p = seq.select_action(obs), par.select_action(obs)
        u_j = j_par.select_action(np.asarray(obs))
        np.testing.assert_allclose(np.asarray(u_p), np.asarray(u_s), atol=1e-4)
        np.testing.assert_allclose(np.asarray(u_p), np.asarray(u_j), atol=1e-4)
        obs, *_ = env.step(u_s)
    prior = dict(zip("abcdefhl", TRUE_PARAMS))
    g_seq, g_par = (t_gpmpc.GPMPC(model, traj, prior, horizon=6, q_mpc=q, r_mpc=r, sqp_iters=2,
                                  qp_iters=6, parallel_scan=p, step_backend="xla", device="cpu")
                    for p in (False, True))
    assert g_par.cfg.parallel_scan and not g_seq.cfg.parallel_scan
    np.testing.assert_allclose(np.asarray(g_par.select_action(traj[0])),
                               np.asarray(g_seq.select_action(traj[0])), atol=1e-4)


def test_stage_sharded_scan_matches_unsharded():
    """T = 64 in float32 with the stage axis over 8 CPU shards (a two-level
    scan: blocks of 8 stages, their totals combined): dx and du within 1e-5
    of the unsharded scan, at a horizon that does not divide (T = 61) too."""
    mesh = make_mesh(8, axis_names=("stage",), devices=["cpu"] * 8)
    arrays = [np.stack([a, b]) for a, b in zip(_long_problem(11), _long_problem(12))]
    for T in (64, 61):
        cut = [a[:, :T + 1] if i in (3, 4) else a[:, :T] for i, a in enumerate(arrays)]
        lq = t_riccati.LqProblem(*[torch.as_tensor(a, dtype=torch.float32) for a in cut])
        dx0 = torch.zeros(2, NX)
        ref = riccati_solve_parallel(lq, dx0)
        out = riccati_solve_parallel(lq, dx0, mesh=mesh)
        for name in ("du", "dx"):
            np.testing.assert_allclose(getattr(out, name).numpy(), getattr(ref, name).numpy(),
                                       atol=1e-5)

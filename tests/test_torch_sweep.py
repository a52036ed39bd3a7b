"""The port's seed sweep (`parallel/sweep.py::seed_sweep`, on lanes and on
xla) on the CPU: 3 seeds, 2 epochs of 24-step episodes (8 samples each) on
the quadrotor at T = 3, one SQP iteration a step. JAX's draws cannot be
reproduced, so the sweep is held to its contract: the shapes, row 0 equal
to the port's own held-out episode with the untrained GP, the same master
seed reproducing the sweep bit for bit, another master seed giving other
costs (its row 0, the held-out episode of that seed), and the unported
option (a mesh) raising."""

import pytest
import torch

from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
from gpmpc_tpu_torch.parallel import sweep as t_sweep
from gpmpc_tpu_torch.parallel.batch import batched_episode
from gpmpc_tpu_torch.parallel.mesh import make_mesh
from gpmpc_tpu_torch.utils.benchkit import Q_MPC, R_MPC
from tests._torch_threads import _one_thread  # noqa: F401

KW = dict(n_seeds=3, n_epochs=2, n_steps=24, samples_per_epoch=8, max_inducing=6, gp_iters=15)


def _setup():
    envp = drone.EnvParams.default()
    model = symbolic_attitude(dt=0.02, params=PRIOR_PARAMS._asdict())
    ctrl = t_gpmpc.GPMPC(model, drone.make_trajectory(envp, "cpu").numpy(), PRIOR_PARAMS._asdict(),
                         horizon=3, q_mpc=Q_MPC, r_mpc=R_MPC, sqp_iters=1, qp_iters=8, device="cpu")
    return envp, model, ctrl


def test_seed_sweep_contract():
    envp, model, ctrl = _setup()
    run = lambda seed, **kw: t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts,  # noqa: E731
                                                master_seed=seed, backend="lanes", **KW, **kw)
    res, epochs = run(0, return_info=True)
    assert res.costs.shape == (3, 3) and bool(torch.isfinite(res.costs).all())
    assert res.n_points.tolist() == [0, 8, 16]
    assert res.gp.Zs.shape == (3, 3, 6, 3) and res.gp.trained.tolist() == [True] * 3
    assert [e.epoch for e in epochs] == [0, 1]
    assert all(0 <= e.fit_s <= e.wall_s and 1 <= e.fit_iterations <= 15 for e in epochs)
    assert len(set(res.costs[0].tolist())) == 3  # each seed its own held-out episode
    # row 0: the held-out episode of the untrained controller
    gp0 = t_gpmpc.empty_gp_model(16, 6, spec=model.residual_spec, device="cpu")
    row0 = lambda seed: -batched_episode(  # noqa: E731
        model, ctrl.cfg, envp, ctrl.consts, gp0,
        t_sweep._generator(torch.device("cpu"), seed, t_sweep._EVAL), 24, 3,
        backend="lanes").rewards.sum(dim=-1)
    assert torch.equal(res.costs[0], row0(0))
    again = run(0)
    assert torch.equal(again.costs, res.costs)
    assert torch.equal(again.gp.alpha_s, res.gp.alpha_s)
    assert not torch.equal(row0(1), res.costs[0])


def test_seed_sweep_refuses_the_unported_options():
    """Every option is ported: a mesh runs (tests/test_torch_mesh.py) and
    refuses a seed count that does not divide over its devices, as the
    reference does; the xla backend runs (`test_seed_sweep_on_xla`); more
    samples than an episode's steps raise."""
    envp, model, ctrl = _setup()
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="n_seeds=3 must divide over 2 devices"):
        t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts, mesh=mesh, **KW)
    with pytest.raises(ValueError, match="samples_per_epoch"):
        t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts, **dict(KW, samples_per_epoch=30))


def test_seed_sweep_on_xla():
    """seed_sweep(backend="xla"), the reference's default, at the same size:
    the contract's shapes, row 0 equal bit for bit to the held-out episode of
    the untrained controller on xla, and within 1e-3 (relative) of the same
    episode on lanes: the same draws, two QP solvers of the same problems."""
    envp, model, ctrl = _setup()
    res = t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts, master_seed=0, backend="xla",
                             **KW)
    assert res.costs.shape == (3, 3) and bool(torch.isfinite(res.costs).all())
    assert res.n_points.tolist() == [0, 8, 16] and res.gp.trained.tolist() == [True] * 3
    gp0 = t_gpmpc.empty_gp_model(16, 6, spec=model.residual_spec, device="cpu")
    row0 = lambda backend: -batched_episode(  # noqa: E731
        model, ctrl.cfg, envp, ctrl.consts, gp0,
        t_sweep._generator(torch.device("cpu"), 0, t_sweep._EVAL), 24, 3,
        backend=backend).rewards.sum(dim=-1)
    assert torch.equal(res.costs[0], row0("xla"))
    torch.testing.assert_close(res.costs[0], row0("lanes"), rtol=1e-3, atol=0)

"""The port's seed sweep (`parallel/sweep.py::seed_sweep`, lanes) on the CPU:
3 seeds, 2 epochs of 24-step episodes (8 samples each) on the quadrotor at
T = 3, one SQP iteration a step. JAX's draws cannot be reproduced, so the
sweep is held to its contract: the shapes, row 0 equal to the port's own
held-out episode with the untrained GP, the same master seed reproducing
the sweep bit for bit, another master seed giving other costs (its row 0,
the held-out episode of that seed), and the unported options raising."""

import pytest
import torch

from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.models.quadrotor import PRIOR_PARAMS
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
from gpmpc_tpu_torch.parallel import sweep as t_sweep
from gpmpc_tpu_torch.parallel.batch import batched_episode
from gpmpc_tpu_torch.utils.benchkit import Q_MPC, R_MPC

KW = dict(n_seeds=3, n_epochs=2, n_steps=24, samples_per_epoch=8, max_inducing=6, gp_iters=15)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: torch's intra-op threads cost more than they give on a
    shared CPU. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    envp = drone.EnvParams.default()
    model = symbolic_attitude(dt=0.02, params=PRIOR_PARAMS._asdict())
    ctrl = t_gpmpc.GPMPC(model, drone.make_trajectory(envp, "cpu").numpy(), PRIOR_PARAMS._asdict(),
                         horizon=3, q_mpc=Q_MPC, r_mpc=R_MPC, sqp_iters=1, qp_iters=8, device="cpu")
    return envp, model, ctrl


def test_seed_sweep_contract():
    envp, model, ctrl = _setup()
    run = lambda seed, **kw: t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts,  # noqa: E731
                                                master_seed=seed, **KW, **kw)
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
        t_sweep._generator(torch.device("cpu"), seed, t_sweep._EVAL), 24, 3).rewards.sum(dim=-1)
    assert torch.equal(res.costs[0], row0(0))
    again = run(0)
    assert torch.equal(again.costs, res.costs)
    assert torch.equal(again.gp.alpha_s, res.gp.alpha_s)
    assert not torch.equal(row0(1), res.costs[0])


def test_seed_sweep_refuses_the_unported_options():
    envp, model, ctrl = _setup()
    for kw, match in (({"mesh": object()}, "mesh"), ({"backend": "xla"}, "xla")):
        with pytest.raises(t_gpmpc.UnsupportedPathError, match=match):
            t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts, **KW, **kw)
    with pytest.raises(ValueError, match="samples_per_epoch"):
        t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts, **dict(KW, samples_per_epoch=30))

"""Why the two-link learning gate of `chip_smoke.py` starts from the JAX
test's own initial states: tests/test_learning_loop.py's two-link pipeline,
the reference's beside the port's, on the CPU, from two sets of starts.

For each set (two episodes' initial states: the JAX test's
`env.reset(seed=0)` and `(seed=1)`, and the port's `twolink_env.env_reset`
with `torch.Generator().manual_seed(0)` and `(1)`), both pipelines collect
two 150-step episodes on the JAX plant, train the exact ARD GPs (500 Adam
iterations at lr 0.05) and run 150 trained steps from the first start: the
reference with its nominal prior controller and `GPMPC` on `xla`, the port
with its untrained `GPMPC` and then the trained one on `lanes` (plain
versions). The two pipelines' tail-cost ratios agree within 0.03 on each
set; the bar of < 0.6 belongs to the reference's starts, which both pass,
and the reference's own pipeline misses it from the port's draws. About
10 minutes a set on a CPU; `-s` shows the ratios."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
from gpmpc_tpu.envs import twolink_env as j_env
from gpmpc_tpu.models import twolink as j_two
from gpmpc_tpu_torch.control.gpmpc import GPMPC as TGPMPC
from gpmpc_tpu_torch.envs import twolink_env as t_env
from gpmpc_tpu_torch.models import twolink as t_two
from tests._torch_threads import _one_thread  # noqa: F401


N_STEPS, TAIL, MAX_RATIO, AGREE = 150, 50, 0.6, 0.03
KW = dict(horizon=20, q_mpc=[20.0, 20.0, 0.5, 0.5], r_mpc=[0.1, 0.1], sparse_gp=False,
          max_gp_samples=40, seed=1, sqp_iters=8, qp_iters=10, max_gp_points=512, ard_gp=True,
          lm_reg=0.5)


def _starts(which: str):
    if which == "reference":
        env = j_env.TwoLinkTrackEnv(j_env.EnvParams.default())
        return [np.asarray(env.reset(seed=s)[0], np.float32) for s in (0, 1)]
    p = t_env.EnvParams.default()
    return [t_env.env_reset(p, 1, torch.Generator().manual_seed(s), "cpu")[1][0].numpy()
            for s in (0, 1)]


def _rollout(env, x0, act):
    """Costs of N_STEPS steps of the JAX plant from x0, and the path."""
    env.reset(seed=0)
    env._state = env._state._replace(x=jnp.asarray(x0))
    obs, X, U, C = jnp.asarray(x0), [np.asarray(x0)], [], []
    for _ in range(N_STEPS):
        u = act(obs)
        obs, r, *_ = env.step(u)
        X.append(np.asarray(obs))
        U.append(np.asarray(u))
        C.append(-float(r))
    return np.asarray(X), np.asarray(U), np.asarray(C)


def _tail_cost_ratio(pipeline: str, x0s) -> float:
    env = j_env.TwoLinkTrackEnv(j_env.EnvParams.default())
    traj = np.asarray(env.trajectory)
    if pipeline == "reference":
        ctrl = JGPMPC(j_two.symbolic_twolink(dt=0.02), traj, None,
                      bounds=(j_two.state_bounds(), j_two.input_bounds()), **KW)
        untrained = ctrl.prior_ctrl
    else:
        ctrl = TGPMPC(t_two.symbolic_twolink(dt=0.02), traj, None, device="cpu",
                      step_backend="lanes", bounds=(t_two.state_bounds(), t_two.input_bounds()),
                      **KW)
        untrained = ctrl
    eps = []
    for x0 in x0s:
        untrained.reset()
        eps.append(_rollout(env, x0, lambda o: untrained.select_action(np.asarray(o))))
    xi, ti = ctrl.preprocess_data(np.concatenate([e[0][:-1] for e in eps]),
                                  np.concatenate([e[1] for e in eps]),
                                  np.concatenate([e[0][1:] for e in eps]))
    ctrl.train_gp(xi, ti, lr=0.05, iterations=500)
    ctrl.reset()
    _, _, cost_gp = _rollout(env, x0s[0], lambda o: ctrl.select_action(np.asarray(o)))
    return float(cost_gp[-TAIL:].mean() / eps[0][2][-TAIL:].mean())


@pytest.mark.slow
@pytest.mark.parametrize("starts", ["reference", "port"])
def test_twolink_learning_gate_belongs_to_the_reference_starts(starts):
    x0s = _starts(starts)
    ratio_ref = _tail_cost_ratio("reference", x0s)
    ratio_port = _tail_cost_ratio("port", x0s)
    print(f"starts {starts}: tail-cost ratio, reference {ratio_ref:.4f}, port {ratio_port:.4f}")
    assert abs(ratio_ref - ratio_port) <= AGREE, (ratio_ref, ratio_port)
    if starts == "reference":
        assert ratio_ref < MAX_RATIO and ratio_port < MAX_RATIO, (ratio_ref, ratio_port)
    else:
        assert ratio_ref >= MAX_RATIO, ratio_ref

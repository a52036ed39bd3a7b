"""Where the two-link learning ratios of the reference and the port part:
the JAX test's two-link pipeline (tests/test_learning_loop.py) on one set of
collected data, stage by stage, the reference's beside the port's, on the CPU.

The reference's nominal prior controller collects two 150-step episodes on
the JAX plant from the JAX test's starts. Then, on those transitions:

1. targets: the port's `preprocess_data` against the reference's;
2. the fit: the same (x, y) into both `train_gp`s (exact ARD GPs, 500 Adam
   iterations at lr 0.05, float32): raw hypers, each GP's freeze step (the
   reference's read from an instrumented copy of its fit loop, which must
   give its controller's hypers bit for bit) and the final loss; and the
   same fit in float64 on both sides;
3. the closed loop: 150 steps from the first start on the JAX plant, with
   the reference's controller and the port's, each with its own GPs and
   with the other's, and the reference's controller with each package's fit
   of the same data with its rows permuted (the fit's own spread);
   tail-cost ratio (the last 50 steps against the prior episode's).

What it showed on a CPU (ROADMAP.md Queue 3, S1): targets within
4.8e-6; the float64 fits equal to 3.4e-11 with the same freeze steps; in
float32 neither package's fit freezes in 500 iterations and their hypers
part (GP 0's outputscale -0.23 against 0.11); the two controllers give the
same ratio on one GP (0.4757 on the reference's, 0.4851 on the port's);
the reordered fits read 0.4834 and 0.4793. About 30 minutes on a CPU; `-s`
prints every stage."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
from gpmpc_tpu.control.gpmpc import GpModel as JGpModel
from gpmpc_tpu.envs import twolink_env as j_env
from gpmpc_tpu.gp import exact_gp as je
from gpmpc_tpu.models import twolink as j_two
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control.gpmpc import GPMPC as TGPMPC
from gpmpc_tpu_torch.gp import exact_gp as te
from gpmpc_tpu_torch.models import twolink as t_two
from tests._torch_threads import _one_thread  # noqa: F401

N_STEPS, TAIL, ITERS, LR = 150, 50, 500, 0.05
KW = dict(horizon=20, q_mpc=[20.0, 20.0, 0.5, 0.5], r_mpc=[0.1, 0.1], sparse_gp=False,
          max_gp_samples=40, seed=1, sqp_iters=8, qp_iters=10, max_gp_points=512, ard_gp=True,
          lm_reg=0.5)
# the two controllers on one GP: the same tail-cost ratio to this bar (they read
# equal to 4 digits on the CPU; the bar leaves room for another CPU's rounding)
CONTROLLER_BAR = 1e-3


def _rollout(env, x0, act):
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


def _jax_fit_traced(data, h0, n_train, lr):
    """The reference's `fit_gp` loop (gpmpc_tpu/gp/exact_gp.py:204-234) with
    each iteration's frozen flag as an output: (hypers, loss, freeze step)
    for one GP."""
    grad_fn = jax.value_and_grad(lambda h: -je.marginal_log_likelihood(h, data))
    zeros = jax.tree.map(jnp.zeros_like, h0)

    def body(carry, _):
        h, adam, last_loss, frozen = carry
        loss, g = grad_fn(h)
        finite = jnp.logical_and(jnp.isfinite(loss), jax.tree.reduce(
            jnp.logical_and, jax.tree.map(lambda g_: jnp.all(jnp.isfinite(g_)), g)))
        skip = jnp.logical_or(frozen, jnp.logical_not(finite))
        step, adam_new = je._adam_update(g, adam, lr)
        h_new = jax.tree.map(lambda p, s: p - s, h, step)
        converged = jnp.logical_and(finite, jnp.abs(last_loss - loss) < 1e-3)
        now_frozen = jnp.logical_or(frozen, converged)
        h_out = jax.tree.map(lambda o, n: jnp.where(skip, o, n), h, h_new)
        adam_out = jax.tree.map(lambda o, n: jnp.where(skip, o, n), adam, adam_new)
        return (h_out, adam_out, jnp.where(skip, last_loss, loss), now_frozen), now_frozen

    init = (h0, je._AdamState(m=zeros, v=zeros, t=jnp.asarray(0, jnp.int32)),
            jnp.asarray(jnp.inf, data.x.dtype), jnp.asarray(False))
    with jax.default_matmul_precision("highest"):
        (h, _, loss, _), frozen = jax.lax.scan(body, init, None, length=n_train)
    first = jnp.argmax(frozen)
    return h, loss, jnp.where(frozen[-1], first, -1)


def _packed(ctrl, xi, ti, dtype):
    """The (G, M, D) training buffers `train_gp` builds, in `dtype`."""
    G, D, M, n = ctrl.spec.num_gps, ctrl.spec.gp_input_dim, ctrl.max_gp_points, xi.shape[0]
    Z, Y, mask = np.zeros((G, M, D), dtype), np.zeros((G, M), dtype), np.zeros((G, M), dtype)
    for i, idx in enumerate(ctrl.spec.gp_idx):
        Z[i, :n, : len(idx)] = xi[:, list(idx)]
        Y[i, :n] = ti[:, i]
        mask[i, :n] = 1.0
    return Z, Y, mask


def _jax_fit(ctrl, xi, ti, dtype):
    Z, Y, mask = _packed(ctrl, xi, ti, dtype)
    h0 = je.init_hypers(jnp.dtype(dtype), Z.shape[-1])
    fit = jax.jit(jax.vmap(partial(_jax_fit_traced, h0=h0, n_train=ITERS, lr=LR)))
    h, loss, freeze = fit(je.GPData(x=jnp.asarray(Z), y=jnp.asarray(Y), mask=jnp.asarray(mask)))
    return [np.asarray(a) for a in h], np.asarray(loss), np.asarray(freeze).tolist()


def _port_fit(ctrl, xi, ti, dtype):
    Z, Y, mask = _packed(ctrl, xi, ti, dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    data = te.GPData(*[torch.as_tensor(a) for a in (Z, Y, mask)])
    h, loss, info = te.fit_gp(data, te.init_hypers(tdt, Z.shape[-1], "cpu", (Z.shape[0],)),
                              ITERS, LR, return_info=True)
    return [a.numpy() for a in h], loss.numpy(), info.freeze_step.tolist()


def _jax_gp_to_port(jgp) -> object:
    d = {k: np.asarray(v) for k, v in jgp._asdict().items() if k != "hypers"}
    d.update({k: np.asarray(v) for k, v in jgp.hypers._asdict().items()})
    return convert.gp_model_from_numpy(d, device="cpu")


def _port_gp_to_jax(tgp) -> JGpModel:
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    leaves = {k: j(v) for k, v in tgp._asdict().items() if k != "hypers"}
    return JGpModel(**leaves, hypers=je.GPHypers(*[j(h) for h in tgp.hypers]))


@pytest.mark.slow
def test_twolink_fit_and_controller_stage_by_stage():
    env = j_env.TwoLinkTrackEnv(j_env.EnvParams.default())
    traj = np.asarray(env.trajectory)
    bounds_j = (j_two.state_bounds(), j_two.input_bounds())
    jctrl = JGPMPC(j_two.symbolic_twolink(dt=0.02), traj, None, bounds=bounds_j, **KW)
    tctrl = TGPMPC(t_two.symbolic_twolink(dt=0.02), traj, None, device="cpu", step_backend="lanes",
                   bounds=(t_two.state_bounds(), t_two.input_bounds()), **KW)
    x0s = [np.asarray(env.reset(seed=s)[0], np.float32) for s in (0, 1)]
    eps = []
    for x0 in x0s:
        jctrl.prior_ctrl.reset()
        eps.append(_rollout(env, x0, lambda o: jctrl.prior_ctrl.select_action(np.asarray(o))))
    x = np.concatenate([e[0][:-1] for e in eps])
    u = np.concatenate([e[1] for e in eps])
    x_next = np.concatenate([e[0][1:] for e in eps])
    prior_tail = eps[0][2][-TAIL:].mean()

    # 1. targets
    xi, ti = jctrl.preprocess_data(x, u, x_next)
    xi_t, ti_t = tctrl.preprocess_data(x, u, x_next)
    d_in, d_tg = float(np.abs(xi_t - xi).max()), float(np.abs(ti_t - ti).max())
    print(f"\n[targets] max |port - reference|: inputs {d_in:.3e}, targets {d_tg:.3e} "
          f"(targets up to {np.abs(ti).max():.3f})")
    assert d_in == 0.0 and d_tg <= 1e-5 * max(1.0, float(np.abs(ti).max()))

    # 2. the fit, on the reference's (x, y)
    jctrl.train_gp(xi, ti, lr=LR, iterations=ITERS)
    tctrl.train_gp(xi, ti, lr=LR, iterations=ITERS)
    hj, lj, fj = _jax_fit(jctrl, xi, ti, np.float32)
    for a, b in zip(hj, jctrl.gp_model.hypers):  # the instrumented loop is the reference's
        np.testing.assert_array_equal(a, np.asarray(b))
    ht = [h.numpy() for h in tctrl.gp_model.hypers]
    ft = tctrl.last_fit_info.freeze_step.tolist()
    print(f"[fit float32] freeze steps reference {fj}, port {ft}; final loss reference "
          f"{lj.tolist()}")
    for name, a, b in zip(je.GPHypers._fields, hj, ht):
        print(f"[fit float32] {name}: reference {np.round(a, 4).tolist()}, port "
              f"{np.round(b, 4).tolist()}")
    hj64, lj64, fj64 = _jax_fit(jctrl, xi.astype(np.float64), ti.astype(np.float64), np.float64)
    ht64, lt64, ft64 = _port_fit(tctrl, xi.astype(np.float64), ti.astype(np.float64), np.float64)
    d64 = max(float(np.abs(a - b).max()) for a, b in zip(hj64, ht64))
    print(f"[fit float64] freeze steps reference {fj64}, port {ft64}; max |raw hyper "
          f"difference| {d64:.3e}; final loss reference {lj64.tolist()}, port {lt64.tolist()}")
    assert fj64 == ft64 and d64 <= 1e-6

    # 3. the closed loop
    def ratio(ctrl, gp):
        ctrl.gp_model = gp
        ctrl.reset()
        _, _, cost = _rollout(env, x0s[0], lambda o: ctrl.select_action(np.asarray(o)))
        return float(cost[-TAIL:].mean() / prior_tail)

    gp_j, gp_t = jctrl.gp_model, tctrl.gp_model
    r = {"reference ctrl, reference GP": ratio(jctrl, gp_j),
         "reference ctrl, port GP": ratio(jctrl, _port_gp_to_jax(gp_t)),
         "port ctrl, port GP": ratio(tctrl, gp_t),
         "port ctrl, reference GP": ratio(tctrl, _jax_gp_to_port(gp_j))}
    perm = np.random.default_rng(0).permutation(xi.shape[0])
    jctrl.train_gp(xi[perm], ti[perm], lr=LR, iterations=ITERS)
    r["reference ctrl, reference GP on permuted rows"] = ratio(jctrl, jctrl.gp_model)
    tctrl.train_gp(xi[perm], ti[perm], lr=LR, iterations=ITERS)
    r["reference ctrl, port GP on permuted rows"] = ratio(jctrl, _port_gp_to_jax(tctrl.gp_model))
    print("[fit float32, permuted rows] freeze steps port "
          f"{tctrl.last_fit_info.freeze_step.tolist()}")
    for k, v in r.items():
        print(f"[closed loop] tail-cost ratio, {k}: {v:.4f}")
    # on one GP the two controllers agree: the ratios part at the fit
    assert abs(r["reference ctrl, reference GP"] - r["port ctrl, reference GP"]) <= CONTROLLER_BAR
    assert abs(r["reference ctrl, port GP"] - r["port ctrl, port GP"]) <= CONTROLLER_BAR
    # and the fits part by float32 rounding alone: the two packages' ratios lie no
    # further apart than each package's own fit moves under a reordering of its rows
    gap = abs(r["port ctrl, port GP"] - r["reference ctrl, reference GP"])
    spread = (abs(r["reference ctrl, reference GP on permuted rows"]
                  - r["reference ctrl, reference GP"])
              + abs(r["reference ctrl, port GP on permuted rows"] - r["reference ctrl, port GP"]))
    print(f"[closed loop] the packages' gap {gap:.4f}, the fits' own spreads added {spread:.4f}")
    assert gap <= spread

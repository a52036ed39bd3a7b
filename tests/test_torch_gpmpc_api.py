"""The port's stateful controller (`GPMPC`: `preprocess_data`, `train_gp`,
`select_action`, `reset`, the reference surface) and `OnlineLearner`
against the JAX package's, on the CPU. The port steps on `lanes` (plain
versions), the JAX controller on `xla`; both see the same observations from
the JAX plant. Bars: u within 5e-4 at every step (as
tests/test_torch_step.py), the trained leaves at the stated tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control.gpmpc import GPMPC as JGPMPC
from gpmpc_tpu.envs import cartpole_env as j_cart_env
from gpmpc_tpu.gp import sparse as js
from gpmpc_tpu.models import cartpole as j_cart
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu.runtime.online import OnlineLearner as JOnlineLearner
from gpmpc_tpu.utils.benchkit import reference_prior_dict
from gpmpc_tpu_torch.control import gpmpc as tg
from gpmpc_tpu_torch.models import cartpole as t_cart
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.runtime.online import OnlineLearner as TOnlineLearner

CART_Q, CART_R = [5.0, 0.1, 20.0, 0.5], [0.05]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: torch's intra-op threads cost more than they give on a
    shared CPU. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cartpole(sparse: bool, step_backend="lanes", T=8, with_jax=True):
    """(JAX plant params, the JAX controller on xla (None without
    `with_jax`: its every first step compiles), the port's controller)."""
    envp = j_cart_env.EnvParams.default()._replace(n_steps=80, traj_period_steps=300)
    traj = np.asarray(j_cart_env.make_trajectory(envp))
    kw = dict(horizon=T, q_mpc=CART_Q, r_mpc=CART_R, sparse_gp=sparse, max_gp_samples=12, seed=1,
              sqp_iters=4, qp_iters=10, max_gp_points=48)
    jc = JGPMPC(j_cart.symbolic_cartpole(0.02), traj, None, step_backend="xla",
                bounds=(j_cart.state_bounds(), j_cart.input_bounds()), **kw) if with_jax else None
    tc = tg.GPMPC(t_cart.symbolic_cartpole(0.02), traj, None, step_backend=step_backend,
                  bounds=(t_cart.state_bounds(), t_cart.input_bounds()), device="cpu", **kw)
    return envp, jc, tc


def _transitions(n=40, seed=0):
    """n transitions of the JAX cartpole plant (its mismatch is what the GPs
    learn) from random states and forces."""
    rng = np.random.default_rng(seed)
    envp = j_cart_env.EnvParams.default()
    x = rng.normal(0, 0.3, (n, 4)).astype(np.float32)
    u = rng.uniform(-3.0, 3.0, (n, 1)).astype(np.float32)
    state, _ = j_cart_env.env_reset(envp, jax.random.PRNGKey(0))
    step = jax.vmap(lambda x0, u0: j_cart_env.env_step(envp, state._replace(x=x0), u0)[1])
    return x, u, np.asarray(step(jnp.asarray(x), jnp.asarray(u)), np.float32)


def _train_both(jc, tc, iterations=20, seed=0):
    x, u, xn = _transitions(seed=seed)
    xi_j, ti_j = jc.preprocess_data(x, u, xn)
    xi_t, ti_t = tc.preprocess_data(x, u, xn)
    np.testing.assert_allclose(xi_t, xi_j, atol=1e-7)
    np.testing.assert_allclose(ti_t, ti_j, atol=1e-4)
    jc.train_gp(xi_j, ti_j, lr=0.05, iterations=iterations)
    tc.train_gp(xi_j, ti_j, lr=0.05, iterations=iterations)


def _leaves_close(gt, gj, atol):
    for name in gt._fields:
        a, b = getattr(gt, name), getattr(gj, name)
        for x, z in (zip(a, b) if name == "hypers" else [(a, b)]):
            z = np.asarray(z)
            assert tuple(x.shape) == z.shape, name
            scale = max(1.0, float(np.abs(z).max()))
            np.testing.assert_allclose(x.numpy(), z, rtol=0, atol=atol * scale, err_msg=name)


def _closed_loop(envp, jc, tc, n_steps=10):
    """Both controllers from the same observations of the JAX plant: the
    largest |u_port - u_jax| over the run."""
    state, obs = j_cart_env.env_reset(envp, jax.random.PRNGKey(0))
    worst = 0.0
    for _ in range(n_steps):
        u_j = jc.select_action(obs)
        u_t = tc.select_action(np.asarray(obs))
        worst = max(worst, float(np.abs(u_t - u_j).max()))
        state, obs, *_ = j_cart_env.env_step(envp, state, jnp.asarray(u_j))
    return worst


def test_exact_train_then_closed_loop_matches_jax():
    """The reference surface (gaussian_process, gp_idx, traj_step, x_prev,
    u_prev, ref_action, lqr_gain, inverse_cdf, reference_trajectory) as
    JAX's before any step (1e-6; the gains at 1e-5, as
    tests/test_torch_setup.py). Then an exact GP (48 rows, 40 live) trained
    20 iterations (before any freeze) on both sides from the same
    preprocessed data: the leaves within 2e-4 of their scale (float32, two
    LAPACK builds); 10 closed-loop steps with u within 5e-4 of the JAX
    controller's, clamp_frac 0, and the surface after them (x_prev within
    5e-4); after `reset`, step 0 again; a dataset past capacity raises."""
    envp, jc, tc = _cartpole(sparse=False)
    assert tc.gaussian_process is None and jc.gaussian_process is None
    assert tc.gp_idx == jc.gp_idx and tc.traj_step == jc.traj_step == 0
    assert tc.x_prev is None and tc.u_prev is None
    np.testing.assert_allclose(tc.ref_action, jc.ref_action, atol=1e-6)
    np.testing.assert_allclose(tc.lqr_gain, jc.lqr_gain, rtol=1e-5, atol=1e-6)
    assert abs(tc.inverse_cdf - jc.inverse_cdf) < 1e-6
    np.testing.assert_allclose(tc.reference_trajectory(), jc.reference_trajectory(), atol=1e-6)
    _train_both(jc, tc)
    assert tc.gaussian_process is tc.gp_model and jc.gaussian_process is not None
    _leaves_close(tc.gp_model, jc.gp_model, 2e-4)
    assert tc.last_fit_info.freeze_step.tolist() == [-1, -1]
    assert _closed_loop(envp, jc, tc) <= 5e-4
    assert float(tc._last_info.clamp_frac) == 0.0 and tc.traj_step == jc.traj_step == 10
    assert tc.x_prev.shape == jc.x_prev.shape and tc.u_prev.shape == jc.u_prev.shape
    np.testing.assert_allclose(tc.x_prev, jc.x_prev, atol=5e-4)
    np.testing.assert_allclose(tc.reference_trajectory(), jc.reference_trajectory(), atol=1e-6)
    tc.reset()
    assert tc.traj_step == 0 and tc.x_prev is None
    with pytest.raises(ValueError, match="exceeds capacity"):
        tc.train_gp(np.zeros((50, 4), np.float32), np.zeros((50, 2), np.float32), lr=0.05,
                    iterations=1)


def test_sparse_train_with_jax_draw_matches_jax(monkeypatch):
    """Sparse mode with the port's inducing draw replaced by JAX's (the key
    the JAX controller splits off for its first fit): every leaf within
    2e-4 of its scale, and 3 closed-loop steps with u within 5e-4."""
    envp, jc, tc = _cartpole(sparse=True)
    _, sub = jax.random.split(jax.random.PRNGKey(1))
    mask = np.zeros(48, np.float32)
    mask[:40] = 1.0
    idx, s_mask = js.select_inducing(sub, jnp.asarray(mask), 12)
    monkeypatch.setattr(tg, "select_inducing", lambda gen, m, n: (
        torch.as_tensor(np.asarray(idx)), torch.as_tensor(np.asarray(s_mask))))
    _train_both(jc, tc)
    _leaves_close(tc.gp_model, jc.gp_model, 2e-4)
    assert _closed_loop(envp, jc, tc, n_steps=3) <= 5e-4


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_auto_and_xla_raise_on_the_cpu(backend):
    """'auto' resolves to 'xla' off the card, as in the reference, and
    'xla' runs: a step gives a finite action and advances the controller
    (tests/test_torch_step_xla.py holds the closed loop against the
    reference)."""
    _, _, tc = _cartpole(sparse=False, step_backend=backend, with_jax=False)
    assert tc._resolve_step_backend() == "xla"
    u = tc.select_action(np.zeros(4, np.float32))
    assert u.shape == (1,) and np.isfinite(u).all() and tc.traj_step == 1


def test_lanes_past_the_horizon_cap_raises():
    _, _, tc = _cartpole(sparse=False, T=1030, with_jax=False)
    with pytest.raises(ValueError, match="exceeds the lanes cap"):
        tc.select_action(np.zeros(4, np.float32))


def test_variance_form_is_not_stale_after_a_retrain(monkeypatch):
    """Train, step, train again on other data: the second model's leaves are
    new tensors (nothing written into the first's), and the next step's GP
    variances come from the second model's form."""
    _, _, tc = _cartpole(sparse=False, with_jax=False)
    x, u, xn = _transitions(seed=0)
    tc.train_gp(*tc.preprocess_data(x, u, xn), lr=0.05, iterations=5)
    first = tc.gp_model
    before = [t.clone() for t in (first.var_mat, first.alpha_s, *first.hypers)]
    tc.select_action(np.zeros(4, np.float32))
    x, u, xn = _transitions(seed=1)
    tc.train_gp(*tc.preprocess_data(x, u, xn), lr=0.05, iterations=5)
    second = tc.gp_model
    assert all(a is not b for a, b in zip(second, first))
    for t, b in zip((first.var_mat, first.alpha_s, *first.hypers), before):
        assert torch.equal(t, b)
    seen = []
    real = tg.gp_mean_var_multi
    monkeypatch.setattr(tg, "gp_mean_var_multi", lambda z, form, **k: seen.append(form) or real(z, form, **k))
    tc.select_action(np.zeros(4, np.float32))
    expected = tg.pack_form(second.var_Z, second.alpha_s, second.var_mat,
                            tg.softplus(second.hypers.raw_lengthscale),
                            tg.softplus(second.hypers.raw_outputscale),
                            tg.softplus(second.hypers.raw_noise) + 1e-6, second.var_mask)
    assert len(seen) == 1
    for a, b in zip(seen[0], expected):
        assert torch.equal(a, b)


def test_online_learner_ring_and_refit_match_jax(monkeypatch):
    """The quadrotor learner (capacity 300, prior thrust map): 200 then 260
    rows (the second ingest wraps the ring and runs in two chunks), the
    buffers, count and head as JAX's; the refit (sparse, 16 inducing points
    from JAX's draw, 15 iterations) within 2e-4 of each leaf's scale."""
    prior = reference_prior_dict()
    mj, mt = j_sym(dt=0.02, params=prior), t_sym(dt=0.02, params=prior)
    kw = dict(capacity=300, max_inducing=16, n_train=15, lr=0.05, seed=3)
    lj = JOnlineLearner(mj, prior, **kw)
    lt = TOnlineLearner(mt, prior, device="cpu", **kw)
    rng = np.random.default_rng(4)
    for n in (200, 260):
        x = rng.normal(0, 0.2, (n, 12)).astype(np.float32)
        u = np.concatenate([rng.uniform(0.2, 0.5, (n, 1)), rng.normal(0, 0.2, (n, 3))], 1).astype(np.float32)
        xn = (x + 0.02 * rng.normal(0, 1.0, x.shape)).astype(np.float32)
        assert lt.ingest(x, u, xn) == lj.ingest(x, u, xn) == n
    assert lt.n_points == lj.n_points == 300 and lt._write == lj._write
    np.testing.assert_allclose(lt._x, lj._x, atol=1e-6)
    np.testing.assert_allclose(lt._y, lj._y, atol=2e-4)
    _, sub = jax.random.split(jax.random.PRNGKey(3))
    idx, s_mask = js.select_inducing(sub, jnp.ones(300, jnp.float32), 16)
    monkeypatch.setattr(tg, "select_inducing", lambda gen, m, n: (
        torch.as_tensor(np.asarray(idx)), torch.as_tensor(np.asarray(s_mask))))
    # both fit the same buffers: the JAX learner's, so the targets' float32
    # rounding does not enter the comparison of the fits
    lt._x, lt._y = lj._x.copy(), lj._y.copy()
    gt, gj = lt.refit(), lj.refit()
    # the thrust GP's inducing inputs cluster (the known near-rank-1 K_ss of
    # FITC), so float32 alpha and W are not determined to 2e-4 in this basis:
    # they are held through the posterior mean and variance they give
    _leaves_close(gt._replace(alpha_s=gt.Zs, var_mat=gt.Zs), gj._replace(alpha_s=gj.Zs, var_mat=gj.Zs),
                  2e-4)
    z = np.random.default_rng(5).normal(0, 0.2, (3, 50, 3)).astype(np.float32)
    z[0, :, 1:] = 0.0
    z[0, :, 0] = np.linspace(0.2, 0.5, 50)
    from gpmpc_tpu.control.gpmpc import gp_variances as j_gp_variances
    var_j = np.asarray(j_gp_variances(gj, jnp.asarray(z)))
    var_t = tg.gp_variances(gt, torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(var_t, var_j, atol=2e-4)
    ell_j, ell_t = jax.nn.softplus(gj.hypers.raw_lengthscale), tg.softplus(gt.hypers.raw_lengthscale)
    for g in range(3):
        k_j = np.asarray(jax.vmap(lambda q: jnp.exp(-0.5 * jnp.sum((q - gj.Zs[g]) ** 2, -1)
                                                    / ell_j[g] ** 2))(jnp.asarray(z[g])))
        mean_j = k_j @ np.asarray(gj.alpha_s[g]) * float(jax.nn.softplus(gj.hypers.raw_outputscale[g]))
        k_t = tg.se_kernel(torch.as_tensor(z[g]), gt.Zs[g], ell_t[g], tg.softplus(gt.hypers.raw_outputscale[g]))
        np.testing.assert_allclose((k_t @ gt.alpha_s[g]).numpy(), mean_j, atol=2e-3 * max(1.0, np.abs(mean_j).max()))
    with pytest.raises(RuntimeError, match="no transitions"):
        TOnlineLearner(mt, prior, device="cpu").refit()

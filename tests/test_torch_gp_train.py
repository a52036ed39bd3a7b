"""Port GP training (`gpmpc_tpu_torch/gp/`) against the JAX package's
`gpmpc_tpu/gp/`: kernels, the masked Gram, the robust Cholesky, the
marginal likelihood, the Adam fit with its early stop, the posterior, the
FITC form, the inducing draw and the compat surface. Inputs come from numpy
seeds; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.gp import compat as j_compat
from gpmpc_tpu.gp import exact_gp as je
from gpmpc_tpu.gp import kernels as jk
from gpmpc_tpu.gp import sparse as js
from gpmpc_tpu.utils.benchkit import synthetic_residual_dataset
from gpmpc_tpu.control import gpmpc as jg
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as tg
from gpmpc_tpu_torch.gp import compat as t_compat
from gpmpc_tpu_torch.gp import exact_gp as te
from gpmpc_tpu_torch.gp import kernels as tk
from gpmpc_tpu_torch.gp import sparse as ts
from tests._torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")


def _np(t):
    return np.asarray(t)


def _data(n=40, cap=64, seed=1, dtype=np.float64):
    """The synthetic quadrotor residual set packed per GP (G = 3, D = 3):
    (JAX GPData, port GPData) in `dtype`."""
    x7, y3 = synthetic_residual_dataset(n, seed)
    dj = jg.pack_training_data(jnp.asarray(x7.astype(dtype)), jnp.asarray(y3.astype(dtype)), cap)
    dt = convert.gp_data_from_numpy({k: _np(v) for k, v in dj._asdict().items()}, CPU,
                                    torch.float64 if dtype == np.float64 else torch.float32)
    return dj, dt


def _hypers(G, D, ard, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    h = {"raw_lengthscale": rng.normal(0.3, 0.3, (G, D) if ard else (G,)),
         "raw_outputscale": rng.normal(0.0, 0.3, G), "raw_noise": rng.normal(-3.0, 0.3, G)}
    h = {k: v.astype(dtype) for k, v in h.items()}
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return je.GPHypers(**{k: jnp.asarray(v) for k, v in h.items()}), convert.hypers_from_numpy(h, CPU, tdt)


@pytest.mark.parametrize("ard", [False, True])
def test_se_kernels_match_jax(ard):
    """float64, 1e-12: the port scales the squared differences by 1/ell^2
    where JAX divides the differences by ell first."""
    rng = np.random.default_rng(0)
    x1, x2 = rng.normal(size=(7, 4)), rng.normal(size=(5, 4))
    ell = rng.uniform(0.5, 2.0, 4) if ard else np.float64(0.8)
    k_j = jk.se_kernel(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ell), jnp.asarray(1.3))
    k_t = tk.se_kernel(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(ell),
                       torch.tensor(1.3, dtype=torch.float64))
    np.testing.assert_allclose(k_t.numpy(), _np(k_j), rtol=1e-12, atol=1e-14)
    d_j = jk.se_kernel_diag(jnp.asarray(x1), jnp.asarray(1.3))
    d_t = tk.se_kernel_diag(torch.as_tensor(x1), torch.tensor(1.3, dtype=torch.float64))
    np.testing.assert_array_equal(d_t.numpy(), _np(d_j))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 2e-5)])
@pytest.mark.parametrize("ard", [False, True])
def test_masked_gram_cholesky_and_mll_match_jax(dtype, rtol, ard):
    """Per GP of a batch of 3 (40 of 64 rows active): the masked Gram, its
    Cholesky factor (no escalation: the plain factorization succeeds) and the
    MLL. float64 at 1e-12 relative; float32 at 2e-5 (the kernel's two
    roundings of the distance)."""
    dj, dt = _data(dtype=dtype)
    hj, ht = _hypers(3, 3, ard, seed=2, dtype=dtype)
    K_j = np.stack([_np(je._masked_gram(jax.tree.map(lambda l: l[g], dj),
                                        jax.tree.map(lambda l: l[g], hj))) for g in range(3)])
    np.testing.assert_allclose(te._masked_gram(dt, ht).numpy(), K_j, rtol=rtol, atol=rtol * 1e-2)
    chol_t, plain_ok = te._robust_cholesky(dt, ht)
    assert bool(plain_ok.all())
    chol_j = np.stack([_np(je._robust_cholesky(jax.tree.map(lambda l: l[g], dj),
                                               jax.tree.map(lambda l: l[g], hj))) for g in range(3)])
    np.testing.assert_allclose(chol_t.numpy(), chol_j, rtol=10 * rtol, atol=10 * rtol)
    mll_j = jax.vmap(je.marginal_log_likelihood)(hj, dj)
    np.testing.assert_allclose(te.marginal_log_likelihood(ht, dt).numpy(), _np(mll_j), rtol=10 * rtol)
    loss_t, g_t = te.marginal_log_likelihood_and_grad(ht, dt)
    loss_j, g_j = jax.vmap(jax.value_and_grad(lambda h, d: -je.marginal_log_likelihood(h, d)))(hj, dj)
    np.testing.assert_allclose(loss_t.numpy(), _np(loss_j), rtol=10 * rtol)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-8 if dtype == np.float64 else 2e-2,
                                   atol=1e-10 if dtype == np.float64 else 1e-4)


@pytest.mark.parametrize("raw_ell", [3.0, 4.0])
def test_escalation_selects_the_first_level_that_factorizes_and_poisons_the_gradient(raw_ell):
    """Near-duplicate inputs with the noise at its floor: the float32 plain
    factorization fails on both sides (LAPACK builds agree here), and both
    select the first retry, 10x the jitter. JAX's gradient is then NaN
    (the failed factor's NaNs reach the cotangents) and so is the port's;
    the loss is finite and within 1e-2 relative (two float32 factorizations
    of a matrix this ill-conditioned: 240 points in 30 clusters of 8 with
    the noise at 2e-9, where the two builds' factors already differ by
    ~1e-3; 0.8e-2 at raw lengthscale 4)."""
    rng = np.random.default_rng(0)
    x = np.repeat(rng.normal(size=(30, 3)).astype(np.float32), 8, axis=0)
    x = x + 1e-4 * rng.normal(size=x.shape).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    dj = je.GPData(jnp.asarray(x), jnp.asarray(y), jnp.ones(240, jnp.float32))
    dt = te.GPData(torch.as_tensor(x), torch.as_tensor(y), torch.ones(240))
    hj = je.GPHypers(jnp.float32(raw_ell), jnp.float32(0.0), jnp.float32(-20.0))
    ht = te.GPHypers(torch.tensor(raw_ell), torch.tensor(0.0), torch.tensor(-20.0))
    assert not bool(jnp.all(jnp.isfinite(jnp.linalg.cholesky(je._masked_gram(dj, hj)))))
    chol, plain_ok = te._robust_cholesky(dt, ht)
    assert not bool(plain_ok) and bool(torch.isfinite(chol).all())
    K1 = te._masked_gram(dt, ht) + torch.diag(1e-6 * ht.outputscale * 10.0 * dt.mask)
    np.testing.assert_array_equal(chol.numpy(), torch.linalg.cholesky(K1).numpy())
    loss_j, g_j = jax.value_and_grad(lambda h: -je.marginal_log_likelihood(h, dj))(hj)
    loss_t, g_t = te.marginal_log_likelihood_and_grad(ht, dt)
    assert all(bool(jnp.isnan(g)) for g in g_j) and all(bool(torch.isnan(g)) for g in g_t)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-2)


def _jax_fit(dj, h0, n_train, lr):
    return jax.vmap(lambda d: je.fit_gp(d, hypers=h0, n_train=n_train, lr=lr))(dj)


@pytest.mark.parametrize("ard", [False, True])
def test_float64_fit_matches_jax_with_the_same_freeze_steps(ard):
    """200 Adam iterations at lr 0.1 in float64 (every GP freezes near step
    100): the hypers within 1e-8 and the last loss within 1e-10 of JAX's.
    The per-GP freeze steps are the same: the port's fit stopped after f + 1
    iterations already has GP g's final hypers, and after f it lacks an
    update of more than 1e-6 (the freezing step's own), so JAX's hypers,
    within 1e-8 of the port's after 200, took exactly the same updates. (A
    JAX fit is compiled once per length, and the compiler is slow on a
    loaded CPU: one length is checked on JAX's side, the others on the
    port's.)"""
    dj, dt = _data()
    D = 3
    h0j = je.init_hypers(jnp.float64, D if ard else None)
    h0t = te.init_hypers(torch.float64, D if ard else None, CPU, (3,))
    hj, lj = _jax_fit(dj, h0j, 200, 0.1)
    ht, lt, info = te.fit_gp(dt, h0t, 200, 0.1, return_info=True)
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-8)
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0, atol=1e-10)
    freeze = info.freeze_step.tolist()
    assert all(0 < f < 199 for f in freeze), freeze
    for g, f in enumerate(freeze):
        at_f1, _ = te.fit_gp(dt, h0t, f + 1, 0.1)
        at_f, _ = te.fit_gp(dt, h0t, f, 0.1)
        assert all(torch.equal(a[g], b[g]) for a, b in zip(at_f1, ht)), (g, f)
        assert max(float((a[g] - b[g]).abs().max()) for a, b in zip(at_f, ht)) > 1e-6, (g, f)


def test_float32_fit_matches_jax_before_any_freeze():
    """20 iterations in float32 (no GP freezes this early): hypers within
    1e-4 and the loss within 1e-5 relative."""
    dj, dt = _data(dtype=np.float32)
    hj, lj = _jax_fit(dj, je.init_hypers(jnp.float32), 20, 0.05)
    ht, lt, info = te.fit_gp(dt, te.init_hypers(torch.float32, None, CPU, (3,)), 20, 0.05,
                             return_info=True)
    assert info.freeze_step.tolist() == [-1, -1, -1]
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=1e-5)


def test_overtrained_fit_recovers_instead_of_raising():
    """tests/test_gp.py's over-trained case on the port: exactly duplicated
    inputs and the noise at ~2e-9. The factor stays finite, the escalation
    changes nothing where the plain factorization succeeds, and the fit,
    posterior and predictions stay finite."""
    rng = np.random.default_rng(0)
    x = np.repeat(rng.normal(size=(30, 3)).astype(np.float32), 8, axis=0)
    y = np.sin(x[:, 0]).astype(np.float32)
    data = te.GPData(torch.as_tensor(x), torch.as_tensor(y), torch.ones(x.shape[0]))
    bad = te.GPHypers(torch.tensor(0.0), torch.tensor(0.0), torch.tensor(-20.0))
    chol, _ = te._robust_cholesky(data, bad)
    assert bool(torch.isfinite(chol).all())
    clean = te.GPHypers(torch.tensor(0.0), torch.tensor(0.0), torch.tensor(0.0))
    chol_c, ok = te._robust_cholesky(data, clean)
    assert bool(ok)
    np.testing.assert_array_equal(chol_c.numpy(),
                                  torch.linalg.cholesky(te._masked_gram(data, clean)).numpy())
    hypers, loss = te.fit_gp(data, hypers=bad, n_train=100, lr=0.05)
    assert np.isfinite(float(loss))
    post = te.posterior(hypers, data)
    mu = te.predict_mean(hypers, data, post, torch.as_tensor(x[:5]))
    var = te.predict_var(hypers, data, post, torch.as_tensor(x[:5]))
    assert bool(torch.isfinite(mu).all()) and bool(torch.isfinite(var).all())


@pytest.mark.parametrize("ard", [False, True])
def test_posterior_and_predictions_match_jax(ard):
    """float64 posterior (chol, alpha) and the mean and variance at 9 test
    points, with and without the noise: 1e-10."""
    dj, dt = _data()
    hj, ht = _hypers(3, 3, ard, seed=4)
    z = np.random.default_rng(5).normal(0, 0.3, (3, 9, 3))
    post_t = te.posterior(ht, dt)
    for g in range(3):
        d_g = jax.tree.map(lambda l: l[g], dj)
        h_g = jax.tree.map(lambda l: l[g], hj)
        post_j = je.posterior(h_g, d_g)
        np.testing.assert_allclose(post_t.chol[g].numpy(), _np(post_j.chol), atol=1e-10)
        np.testing.assert_allclose(post_t.alpha[g].numpy(), _np(post_j.alpha), atol=1e-10)
    mean_t = te.predict_mean(ht, dt, post_t, torch.as_tensor(z))
    for inc in (True, False):
        var_t = te.predict_var(ht, dt, post_t, torch.as_tensor(z), include_noise=inc)
        for g in range(3):
            d_g = jax.tree.map(lambda l: l[g], dj)
            h_g = jax.tree.map(lambda l: l[g], hj)
            post_j = je.posterior(h_g, d_g)
            np.testing.assert_allclose(mean_t[g].numpy(), _np(je.predict_mean(h_g, d_g, post_j, jnp.asarray(z[g]))),
                                       atol=1e-10)
            np.testing.assert_allclose(
                var_t[g].numpy(), _np(je.predict_var(h_g, d_g, post_j, jnp.asarray(z[g]), include_noise=inc)),
                atol=1e-10)


@pytest.mark.parametrize("n_active", [3, 10, 50])
def test_select_inducing_properties(n_active):
    """Distinct active rows only, active rows first when fewer than Ms are
    active (s_mask's leading entries), per batch entry; the same generator
    seed draws the same set, another seed another."""
    Ms, M = 10, 64
    rng = np.random.default_rng(n_active)
    mask = np.zeros((2, M), np.float32)
    for b in range(2):
        mask[b, rng.choice(M, n_active, replace=False)] = 1.0
    mask_t = torch.as_tensor(mask)
    idx, s_mask = ts.select_inducing(torch.Generator().manual_seed(0), mask_t, Ms)
    assert idx.shape == s_mask.shape == (2, Ms)
    k = min(n_active, Ms)
    assert s_mask[:, :k].eq(1).all() and s_mask[:, k:].eq(0).all()
    for b in range(2):
        live = idx[b, :k].tolist()
        assert len(set(live)) == k and all(mask[b, i] == 1 for i in live)
    idx2, _ = ts.select_inducing(torch.Generator().manual_seed(0), mask_t, Ms)
    assert torch.equal(idx, idx2)
    if n_active > Ms:
        idx3, _ = ts.select_inducing(torch.Generator().manual_seed(1), mask_t, Ms)
        assert not torch.equal(idx, idx3)


@pytest.mark.parametrize("n_active", [40, 7])  # 7 < Ms: the padded inducing rows
@pytest.mark.parametrize("ard", [False, True])
def test_fitc_posterior_matches_jax_on_its_indices(n_active, ard):
    """The FITC form (Zs, alpha, W) on JAX's own inducing draw, float64:
    1e-8 absolute on entries up to ~1e3."""
    dj, dt = _data(n=n_active)
    hj, ht = _hypers(3, 3, ard, seed=6)
    idx, s_mask = js.select_inducing(jax.random.PRNGKey(3), dj.mask[0], 12)
    Zs_t, alpha_t, W_t = ts.fitc_posterior(ht, dt, torch.as_tensor(_np(idx)),
                                           torch.as_tensor(_np(s_mask), dtype=torch.float64))
    Zs_j, alpha_j, W_j = jax.vmap(lambda h, d: js.fitc_posterior(h, d, idx, s_mask))(hj, dj)
    np.testing.assert_array_equal(Zs_t.numpy(), _np(Zs_j))
    np.testing.assert_allclose(alpha_t.numpy(), _np(alpha_j), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(W_t.numpy(), _np(W_j), rtol=1e-9, atol=1e-8)
    Zm, am = ts.fitc_posterior_mean(ht, dt, torch.as_tensor(_np(idx)),
                                    torch.as_tensor(_np(s_mask), dtype=torch.float64))
    assert torch.equal(Zm, Zs_t) and torch.equal(am, alpha_t)


def test_packing_and_the_empty_model_match_jax():
    """pack_training_data, pack_training_buffers (the count masks rows) and
    empty_gp_model (ARD and isotropic leaf shapes), exactly."""
    from gpmpc_tpu.models.residual import TWOLINK_SPEC as J_TWOLINK
    from gpmpc_tpu_torch.models.residual import TWOLINK_SPEC as T_TWOLINK

    rng = np.random.default_rng(7)
    xz, yg = rng.normal(size=(20, 6)).astype(np.float32), rng.normal(size=(20, 2)).astype(np.float32)
    dj = jg.pack_training_data(jnp.asarray(xz), jnp.asarray(yg), 32, J_TWOLINK)
    dt = tg.pack_training_data(torch.as_tensor(xz), torch.as_tensor(yg), 32, T_TWOLINK)
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    bx = rng.normal(size=(32, 7)).astype(np.float32)
    by = rng.normal(size=(32, 3)).astype(np.float32)
    bj = jg.pack_training_buffers(jnp.asarray(bx), jnp.asarray(by), 13)
    bt = tg.pack_training_buffers(torch.as_tensor(bx), torch.as_tensor(by), 13)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for ard in (False, True):
        ej = jg.empty_gp_model(32, 8, ard=ard, spec=J_TWOLINK)
        et = tg.empty_gp_model(32, 8, ard=ard, spec=T_TWOLINK, device="cpu")
        for name in et._fields:
            a, b = getattr(et, name), getattr(ej, name)
            for x, y in zip(a if name == "hypers" else [a], b if name == "hypers" else [b]):
                assert tuple(x.shape) == tuple(y.shape), name
                np.testing.assert_array_equal(x.numpy(), _np(y))


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_make_targets_and_preprocess_match_jax(family):
    """Each family's make_targets (and the quadrotor's preprocess_data_jnp
    with the prior's thrust map) on 30 random transitions: 1e-4 absolute on
    finite differences over dt = 0.02 (float32 rounding of x_next - x)."""
    from gpmpc_tpu.models import cartpole as j_cart, twolink as j_two
    from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
    from gpmpc_tpu_torch.models import cartpole as t_cart, twolink as t_two
    from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym

    mk = {"quadrotor": (j_sym, t_sym), "cartpole": (j_cart.symbolic_cartpole, t_cart.symbolic_cartpole),
          "twolink": (j_two.symbolic_twolink, t_two.symbolic_twolink)}[family]
    mj, mt = mk[0](dt=0.02), mk[1](dt=0.02)
    rng = np.random.default_rng(8)
    x = rng.normal(0, 0.3, (30, mt.nx)).astype(np.float32)
    u = rng.normal(0, 0.3, (30, mt.nu)).astype(np.float32)
    if family == "quadrotor":
        u[:, 0] += 0.4
    xn = (x + 0.02 * rng.normal(0, 1.0, x.shape)).astype(np.float32)
    zj, yj = mj.residual_spec.make_targets(mj, jnp.asarray(x), jnp.asarray(u), jnp.asarray(xn))
    zt, yt = mt.residual_spec.make_targets(mt, torch.as_tensor(x), torch.as_tensor(u), torch.as_tensor(xn))
    np.testing.assert_allclose(zt.numpy(), _np(zj), atol=1e-7)
    np.testing.assert_allclose(yt.numpy(), _np(yj), atol=1e-4)
    if family == "quadrotor":
        zj, yj = jg.preprocess_data_jnp(mj, 20.9, 3.6, jnp.asarray(x), jnp.asarray(u), jnp.asarray(xn))
        zt, yt = tg.preprocess_data_jnp(mt, 20.9, 3.6, torch.as_tensor(x), torch.as_tensor(u),
                                        torch.as_tensor(xn))
        np.testing.assert_allclose(zt.numpy(), _np(zj), atol=1e-7)
        np.testing.assert_allclose(yt.numpy(), _np(yj), atol=1e-4)


def test_compat_surface_matches_jax():
    """covSE_single / covSE_vectorized exactly as JAX's at 1e-6; the
    GaussianProcess fit (150 iterations, float32: hypers freeze on both
    sides within a few steps of each other) predicts within 2e-3 of JAX's
    and keeps the reference's attributes."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(15, 2)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    for ell in (1.0, [0.8, 1.3]):
        np.testing.assert_allclose(t_compat.covSE_single(x[0], x[:6].T, ell, 2.0).numpy(),
                                   _np(j_compat.covSE_single(x[0], x[:6].T, ell, 2.0)), atol=1e-6)
        np.testing.assert_allclose(t_compat.covSE_vectorized(x[0], x[:6], ell, 2.0).numpy(),
                                   _np(j_compat.covSE_vectorized(x[0], x[:6], ell, 2.0)), atol=1e-6)
    gp_t = t_compat.fit_gp(t_compat.GaussianProcess(x, y, device="cpu"), n_train=150, lr=0.05)
    gp_j = j_compat.fit_gp(j_compat.GaussianProcess(x, y), n_train=150, lr=0.05)
    assert gp_t.n_ind_points == 15 and gp_t.input_dimension == 2
    assert gp_t.K.shape == (15, 15) and gp_t.K_inv is not None
    for inc in (False, True):
        mt, vt = gp_t.predict(x[:5], include_noise=inc)
        mj, vj = gp_j.predict(x[:5], include_noise=inc)
        np.testing.assert_allclose(mt, mj, atol=2e-3)
        np.testing.assert_allclose(vt, vj, atol=2e-3)

"""The GP-augmented dynamics and the plain-torch GP variances of the port
(`models/residual.py::mean_rows`, `control/gpmpc.py::gp_residual`,
`augmented_fd`, `gp_variances`, and the population branches of
`batched_variances` and `disturbance_diagonals`) against the JAX package, for
the three model families, with a shared GP and with a per-scenario population.

Both sides get the family's benchmark GP (the committed fixture) and the same
seeded numpy states, in float32. A population is the fixture repeated per
scenario with `alpha_s` and the raw hyperparameters perturbed from a seeded
generator, so the scenarios differ. Tolerance 1e-5 absolute on values of
order one (float32 sums in another order; the port scales squared distances
by 1/ell^2 where the reference divides by ell first). The variances get 3e-5
absolute: the quadratic form cancels entries of size 1/noise down to ~1e-3, so
two float32 evaluation orders differ by up to ~1e-5 (the repo's own bar for
this quantity is 1e-4, tests/test_torch_gp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models import cartpole as j_cart
from gpmpc_tpu.models import twolink as j_twolink
from gpmpc_tpu.models.symbolic import symbolic_attitude as j_sym
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.models import cartpole as t_cart
from gpmpc_tpu_torch.models import twolink as t_twolink
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from tests._torch_threads import _one_thread  # noqa: F401


F32 = np.float32
FAMILIES = ["quadrotor", "cartpole", "twolink"]
B, T = 5, 3
HYPERS = ("raw_lengthscale", "raw_outputscale", "raw_noise")


def models(family):
    if family == "quadrotor":
        return j_sym(dt=0.02), t_sym(dt=0.02)
    if family == "cartpole":
        return j_cart.symbolic_cartpole(0.02), t_cart.symbolic_cartpole(0.02)
    return j_twolink.symbolic_twolink(0.02), t_twolink.symbolic_twolink(0.02)


def gp_leaves(family, population=0, seed=0) -> dict:
    """The family's benchmark GP as a flat dict of numpy arrays; with
    `population` > 0 every leaf gets that leading axis and the scenarios'
    `alpha_s` and raw hyperparameters differ."""
    with np.load(convert.bench_gp_path(family)) as f:
        d = {k: np.asarray(v) for k, v in f.items()}
    if not population:
        return d
    rng = np.random.default_rng(seed)
    d = {k: np.repeat(v[None], population, axis=0) for k, v in d.items()}
    d["alpha_s"] = (d["alpha_s"] * (1.0 + 0.3 * rng.normal(size=d["alpha_s"].shape))).astype(F32)
    for k in HYPERS:
        d[k] = (d[k] + 0.2 * rng.normal(size=d[k].shape)).astype(F32)
    return d


def jax_gp(d) -> j_gpmpc.GpModel:
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    return j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"), hypers=JGPHypers(*[leaf(k) for k in HYPERS]),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(d["trained"], bool),
    )


def points(family, seed=1):
    """(X (B, T, nx), U (B, T, nu)) in the range the family's controller visits."""
    rng = np.random.default_rng(seed)
    if family == "quadrotor":
        X = rng.normal(0, 0.3, (B, T, 12))
        U = np.concatenate([rng.uniform(0.15, 0.55, (B, T, 1)), rng.uniform(-0.3, 0.3, (B, T, 3))], -1)
    elif family == "cartpole":
        X, U = rng.normal(0, 0.3, (B, T, 4)), rng.uniform(-5.0, 5.0, (B, T, 1))
    else:
        X = np.stack([rng.uniform(-2.0, 0.2, (B, T)), rng.uniform(-0.4, 1.8, (B, T)),
                      rng.normal(0, 0.8, (B, T)), rng.normal(0, 0.8, (B, T))], -1)
        U = rng.uniform(-12.0, 12.0, (B, T, 2))
    return X.astype(F32), U.astype(F32)


@pytest.mark.parametrize("family", FAMILIES)
def test_mean_rows_match(family):
    model_j, model_t = models(family)
    spec_j, spec_t = model_j.residual_spec, model_t.residual_spec
    rng = np.random.default_rng(2)
    preds = rng.normal(size=(B, T, spec_j.num_gps)).astype(F32)
    z = rng.normal(0, 0.5, (B, T, spec_j.z_dim)).astype(F32)
    want = jax.vmap(jax.vmap(spec_j.mean_rows))(jnp.asarray(preds), jnp.asarray(z))
    got = spec_t.mean_rows(torch.tensor(preds), torch.tensor(z))
    assert got.shape == (B, T, spec_t.n_unc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("population", [False, True], ids=["shared", "population"])
@pytest.mark.parametrize("family", FAMILIES)
def test_gp_residual_and_augmented_fd_match(family, population):
    model_j, model_t = models(family)
    spec_j, spec_t = model_j.residual_spec, model_t.residual_spec
    d = gp_leaves(family, B if population else 0)
    gp_j, gp_t = jax_gp(d), convert.gp_model_from_numpy(d, "cpu")
    assert t_gpmpc.gp_is_batched(gp_t) == population == j_gpmpc.gp_is_batched(gp_j, spec_j)
    X, U = points(family)
    res_j = lambda g, x, u: j_gpmpc.gp_residual(g, x, u, spec_j)  # noqa: E731
    fd_j = lambda g, x, u: j_gpmpc.augmented_fd(model_j, g, x, u)  # noqa: E731
    over_t = lambda f: jax.vmap(f, in_axes=(None, 0, 0))  # noqa: E731
    over_b = lambda f: jax.vmap(over_t(f), in_axes=(0 if population else None, 0, 0))  # noqa: E731
    want_res = np.asarray(over_b(res_j)(gp_j, jnp.asarray(X), jnp.asarray(U)))
    want_fd = np.asarray(over_b(fd_j)(gp_j, jnp.asarray(X), jnp.asarray(U)))
    assert want_res.dtype == F32 and np.abs(want_res).max() > 1e-3

    Xt, Ut = torch.tensor(X), torch.tensor(U)
    if population:  # each scenario against its own GP, as the lanes step maps it
        got_res = torch.func.vmap(lambda g, x, u: t_gpmpc.gp_residual(g, x, u, spec_t))(gp_t, Xt, Ut)
        got_fd = torch.func.vmap(lambda g, x, u: t_gpmpc.augmented_fd(model_t, g, x, u))(gp_t, Xt, Ut)
    else:
        got_res = t_gpmpc.gp_residual(gp_t, Xt, Ut, spec_t)
        got_fd = t_gpmpc.augmented_fd(model_t, gp_t, Xt, Ut)
    np.testing.assert_allclose(got_res.numpy(), want_res, atol=1e-5)
    np.testing.assert_allclose(got_fd.numpy(), want_fd, atol=1e-5)
    # the residual lands on the uncertain rows only
    others = [i for i in range(model_t.nx) if i not in spec_t.uncertain_dim]
    assert float(got_res[..., others].abs().max()) == 0.0
    if population:
        assert not np.allclose(want_res[0], np.asarray(over_t(res_j)(
            jax.tree.map(lambda a: a[1], gp_j), jnp.asarray(X[0]), jnp.asarray(U[0]))), atol=1e-4)


@pytest.mark.parametrize("population", [False, True], ids=["shared", "population"])
@pytest.mark.parametrize("family", FAMILIES)
def test_gp_variances_and_disturbance_diagonals_match(family, population):
    model_j, model_t = models(family)
    spec_j, spec_t = model_j.residual_spec, model_t.residual_spec
    d = gp_leaves(family, B if population else 0)
    gp_j, gp_t = jax_gp(d), convert.gp_model_from_numpy(d, "cpu")
    X, U = points(family, seed=3)
    zq_j = spec_j.gp_input(jnp.asarray(X), jnp.asarray(U))  # (B, T, z)
    zs_j = j_gpmpc.slice_gp_inputs(zq_j, spec_j)  # (G, B, T, D)
    zq_t = spec_t.gp_input(torch.tensor(X), torch.tensor(U))
    zs_t = t_gpmpc.slice_gp_inputs(zq_t, spec_t)
    np.testing.assert_allclose(zs_t.numpy(), np.asarray(zs_j), atol=0)

    want = np.asarray(j_gpmpc.batched_variances(gp_j, zs_j, backend="xla"))
    if population:
        got = t_gpmpc.batched_variances(gp_t, zs_t)  # the population branch: no kernel wrapper
    else:
        got = t_gpmpc.gp_variances(gp_t, zs_t)
    assert got.shape == (spec_t.num_gps, B, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    assert float(got.min()) >= float(F32(1e-12))

    class Consts:  # the only field the disturbance map reads
        dt = 0.02

    want_d = j_gpmpc._gp_disturbance_batch(Consts, gp_j, zq_j, jnp.asarray(want), spec_j)
    Consts.dt = torch.tensor(0.02)
    got_d = t_gpmpc.disturbance_diagonals(Consts, gp_t, zq_t, torch.tensor(want), spec_t)
    assert got_d.shape == (B, T, spec_t.n_unc)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-12)


def test_population_variances_use_no_kernel_wrapper(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the population branch must not reach the GP kernel's wrapper")

    monkeypatch.setattr(t_gpmpc, "gp_mean_var_multi", boom)
    d = gp_leaves("quadrotor", 2)
    gp_t = convert.gp_model_from_numpy(d, "cpu")
    assert gp_t.trained.shape == (2,) and gp_t.Zs.dim() == 4
    out = t_gpmpc.batched_variances(gp_t, torch.zeros(3, 2, 4, 3))
    assert out.shape == (3, 2, 4) and bool(torch.isfinite(out).all())


def test_bf16_variances_are_not_ported():
    """Named when the bf16 variances raised; they are ported now
    (tests/test_torch_variance_options.py holds them against JAX's): the
    population branch of `batched_variances` takes them per scenario,
    through no kernel wrapper, as it takes the float32 ones."""
    def boom(*a, **k):
        raise AssertionError("the population branch must not reach the GP kernel's wrapper")

    gp_t = convert.gp_model_from_numpy(gp_leaves("quadrotor", 2), "cpu")
    z = torch.as_tensor(np.random.default_rng(0).normal(0, 0.3, (3, 2, 4, 3)).astype(F32))
    t_gpmpc.gp_mean_var_multi, orig = boom, t_gpmpc.gp_mean_var_multi
    try:
        out = t_gpmpc.batched_variances(gp_t, z, backend="pallas", bf16=True)
    finally:
        t_gpmpc.gp_mean_var_multi = orig
    want = torch.stack([t_gpmpc.gp_variances(
        type(gp_t)(*[type(v)(*[h[s] for h in v]) if isinstance(v, tuple) else v[s] for v in gp_t]),
        z[:, s], bf16=True) for s in range(2)], dim=1)
    assert out.shape == (3, 2, 4) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)

"""Port `train_gp_models` against the JAX package's: sparse (FITC) and exact,
isotropic and ARD, at G = 3, D = 3 (the quadrotor) and G = 2, D = 6 (the
two-link arm), every leaf of the GpModel held. The fits run in float64 (the
freeze of the early stop is a discrete decision that one float32 ulp of
another LAPACK build can move); the sparse draw is JAX's own, handed to the
port through `select_inducing` (JAX's PRNG cannot be reproduced)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as jg
from gpmpc_tpu.gp import sparse as js
from gpmpc_tpu.models.residual import QUADROTOR_SPEC as J_QUAD, TWOLINK_SPEC as J_TWO
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as tg
from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC as T_QUAD, TWOLINK_SPEC as T_TWO
from tests._torch_threads import _one_thread  # noqa: F401


def _dataset(family, n, seed):
    rng = np.random.default_rng(seed)
    if family == "quadrotor":
        xz = rng.normal(0, 0.2, (n, 7))
        xz[:, 0] = rng.uniform(0.2, 0.5, n)
        y = np.stack([4.0 + 0.5 * np.sin(5 * xz[:, 0]), 0.1 * xz[:, 1], 0.1 * xz[:, 4]], axis=1)
    else:
        xz = rng.normal(0, 0.5, (n, 6))
        y = np.stack([1.5 + 0.4 * np.sin(xz[:, 1]) + 0.8 * xz[:, 4], -0.5 * xz[:, 2] + 0.6 * xz[:, 5]],
                     axis=1)
    return xz, y + 0.01 * rng.normal(size=y.shape)


@pytest.mark.parametrize("family,ard,sparse", [("quadrotor", False, True), ("quadrotor", True, False),
                                               ("twolink", True, True), ("twolink", False, False)])
def test_train_gp_models_matches_jax(monkeypatch, family, ard, sparse):
    """40 points in a 64-row buffer, 60 Adam iterations at lr 0.05, float64:
    every leaf within 1e-8 relative to its scale (max(1, max|leaf|)); the
    exact W = K^-1 reaches ~1e3 here. Sparse and exact, isotropic and ARD
    each at both widths (each case compiles a JAX fit, slow on a loaded
    CPU, so the four cases pair them rather than cross them)."""
    j_spec, t_spec = (J_QUAD, T_QUAD) if family == "quadrotor" else (J_TWO, T_TWO)
    xz, y = _dataset(family, 40, seed=3)
    dj = jg.pack_training_data(jnp.asarray(xz), jnp.asarray(y), 64, j_spec)
    key = jax.random.PRNGKey(5)
    Ms = 12 if sparse else 64
    gj = jg.train_gp_models(dj, key, sparse=sparse, max_inducing=Ms, n_train=60, lr=0.05, ard=ard)
    if sparse:
        idx, s_mask = js.select_inducing(key, dj.mask[0], Ms)
        monkeypatch.setattr(tg, "select_inducing", lambda gen, mask, n: (
            torch.as_tensor(np.asarray(idx)), torch.as_tensor(np.asarray(s_mask), dtype=mask.dtype)))
    dt = tg.pack_training_data(torch.as_tensor(xz), torch.as_tensor(y), 64, t_spec)
    gt = tg.train_gp_models(dt, torch.Generator().manual_seed(0), sparse=sparse, max_inducing=Ms,
                            n_train=60, lr=0.05, ard=ard)
    assert gt.trained.shape == () and bool(gt.trained)
    for name in gt._fields:
        if name == "trained":
            continue
        a, b = getattr(gt, name), getattr(gj, name)
        pairs = zip(a, b) if name == "hypers" else [(a, b)]
        for x, z in pairs:
            z = np.asarray(z)
            assert tuple(x.shape) == z.shape, name
            scale = max(1.0, float(np.abs(z).max()))
            np.testing.assert_allclose(x.numpy(), z, rtol=0, atol=1e-8 * scale, err_msg=name)


def test_batched_over_seeds_is_each_seed_alone():
    """S = 2 seeds x G = 3 GPs in one train_gp_models: each seed's model is
    the one trained on its data alone (the same draws from the same
    generator state, exact mode: no draw), float64 bit-comparable to 1e-12."""
    xs, ys = zip(*[_dataset("quadrotor", 30, seed=s) for s in (1, 2)])
    bx = torch.as_tensor(np.stack([np.pad(x, ((0, 10), (0, 0))) for x in xs]))
    by = torch.as_tensor(np.stack([np.pad(y, ((0, 10), (0, 0))) for y in ys]))
    both = tg.train_gp_models(tg.pack_training_buffers(bx, by, 30), None, sparse=False,
                              max_inducing=40, n_train=40, lr=0.05)
    assert both.Zs.shape == (2, 3, 40, 3) and both.trained.shape == (2,)
    for s in range(2):
        one = tg.train_gp_models(tg.pack_training_buffers(bx[s], by[s], 30), None, sparse=False,
                                 max_inducing=40, n_train=40, lr=0.05)
        for name in ("alpha_s", "var_mat"):
            np.testing.assert_allclose(getattr(both, name)[s].numpy(), getattr(one, name).numpy(),
                                       rtol=1e-12, atol=1e-12)
        for a, b in zip(both.hypers, one.hypers):
            np.testing.assert_allclose(a[s].numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


def test_gp_data_and_hypers_cross_from_numpy():
    """convert.gp_data_from_numpy / hypers_from_numpy keep shapes (ARD (G, D))
    and the requested dtype."""
    d = {"x": np.zeros((2, 5, 6)), "y": np.zeros((2, 5)), "mask": np.ones((2, 5))}
    data = convert.gp_data_from_numpy(d, "cpu", torch.float64)
    assert data.x.dtype == torch.float64 and data.x.shape == (2, 5, 6)
    h = convert.hypers_from_numpy({"raw_lengthscale": np.zeros((2, 6)), "raw_outputscale": np.zeros(2),
                                   "raw_noise": np.zeros(2)}, "cpu")
    assert h.raw_lengthscale.shape == (2, 6) and h.raw_noise.dtype == torch.float32

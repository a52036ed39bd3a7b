"""Port GP posterior (kernel 1's plain version and its wrapper on CPU tensors)
against the JAX package: `gp_mean_var_reference` and the XLA
`batched_variances`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control.gpmpc import GpModel as JGpModel
from gpmpc_tpu.control.gpmpc import batched_variances as j_batched_variances
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.ops.pallas_gp import gp_mean_var_reference
from gpmpc_tpu.utils.benchkit import synthetic_gp_model
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control.gpmpc import batched_variances as t_batched_variances
from gpmpc_tpu_torch.ops import cuda_gp

F32 = np.float32


def make_problem(n=70, m=128, d=3, seed=0, ell=0.9):
    """tests/test_pallas_gp.py's problem: 50 active of m padded points."""
    rng = np.random.default_rng(seed)
    n_active = 50
    Z = np.zeros((m, d), F32)
    Z[:n_active] = rng.normal(size=(n_active, d))
    mask = np.zeros(m, F32)
    mask[:n_active] = 1.0
    y = rng.normal(size=m).astype(F32) * mask
    ell = np.asarray(ell, F32)
    sf2, noise = 1.3, 0.05
    diff = (Z[:, None, :] - Z[None, :, :]) / ell
    K = sf2 * np.exp(-0.5 * (diff**2).sum(-1)) * np.outer(mask, mask)
    K += np.diag(noise * mask + (1 - mask))
    K_inv = np.linalg.inv(K).astype(F32)
    alpha = (K_inv @ y).astype(F32)
    z = rng.normal(size=(n, d)).astype(F32)
    return [z, Z, alpha, K_inv, ell, np.asarray(sf2, F32), np.asarray(noise, F32), mask]


@pytest.mark.parametrize("n", [70, 130])  # 130: not a multiple of the 128-query tile
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("include_noise", [False, True])
@pytest.mark.parametrize("d", [3, 6])  # the quadrotor's and cartpole's GPs, the two-link arm's
def test_plain_matches_jax_reference(n, ard, include_noise, d):
    ell = np.linspace(0.7, 1.6, d).tolist() if ard else 0.9
    args = make_problem(n=n, d=d, seed=3 if ard else 0, ell=ell)
    mean_j, var_j = gp_mean_var_reference(*(jnp.asarray(a) for a in args),
                                          include_noise=include_noise)
    t_args = [torch.as_tensor(a) for a in args]
    mean_t, var_t = cuda_gp.gp_mean_var_plain(*t_args, include_noise=include_noise)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j, F32), atol=1e-4)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j, F32), atol=1e-4)
    # the wrapper takes the plain route for CPU tensors, without counting a launch
    before = cuda_gp.gp_mean_var.launches
    mean_w, var_w = cuda_gp.gp_mean_var(*t_args, include_noise=include_noise)
    assert cuda_gp.gp_mean_var.launches == before
    np.testing.assert_array_equal(mean_w.numpy(), mean_t.numpy())
    np.testing.assert_array_equal(var_w.numpy(), var_t.numpy())


@pytest.mark.parametrize("sparse", [True, False])
def test_batched_variances_matches_jax_xla(sparse):
    """Mv padded to a multiple of 128 inside the port; FITC (Mv=12) and exact
    (Mv=32) variance forms."""
    gp = synthetic_gp_model(
        max_points=32, max_inducing=12 if sparse else 32, n_data=24, n_train=10, seed=3
    )
    flat = {k: np.asarray(v) for k, v in gp._asdict().items() if k != "hypers"}
    flat.update({k: np.asarray(v) for k, v in gp.hypers._asdict().items()})
    z = np.random.default_rng(0).normal(0, 0.4, (3, 4, 5, 3)).astype(F32)
    v_j = j_batched_variances(gp, jnp.asarray(z), backend="xla")
    v_t = t_batched_variances(convert.gp_model_from_numpy(flat, device="cpu"), torch.as_tensor(z))
    assert v_t.shape == (3, 4, 5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j, F32), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("family", ["cartpole", "twolink"])
def test_batched_variances_of_family_bench_gp_matches_jax_xla(family):
    """The families' bench GPs (the committed fixtures): G = 2 at D = 3 and 6."""
    with np.load(convert.bench_gp_path(family)) as d:
        flat = dict(d)
    leaf = lambda k: jnp.asarray(flat[k])  # noqa: E731
    gp_j = JGpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"),
        hypers=JGPHypers(leaf("raw_lengthscale"), leaf("raw_outputscale"), leaf("raw_noise")),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(True),
    )
    gp_t = convert.gp_model_from_numpy(flat, device="cpu")
    G, _, D = gp_t.Zs.shape
    z = np.random.default_rng(1).normal(0, 0.5, (G, 4, 5, D)).astype(F32)
    v_j = j_batched_variances(gp_j, jnp.asarray(z), backend="xla")
    v_t = t_batched_variances(gp_t, torch.as_tensor(z))
    # these GPs sit at their noise floor: W's entries ~1/noise cancel to
    # variances ~1e-2, so two float32 summation orders differ by ~1e-5; the
    # bar is the repo's Pallas GP test's (1e-4 on var)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j, F32), atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = [torch.as_tensor(a) for a in make_problem()]
    with pytest.raises(TypeError, match="float32"):
        cuda_gp.gp_mean_var(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        cuda_gp.gp_mean_var(args[0], args[1][:, :2], *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gp.gp_mean_var(args[0], args[1], args[2], args[3].t(), *args[4:])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel and no plain route"):
        cuda_gp.gp_mean_var(*meta)

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
from tests._torch_threads import _one_thread  # noqa: F401


F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _warm_intra_op_threads():
    """One unchecked parallel op before this module's comparisons. On an
    AVX-512 virtual machine the first parallel elementwise op of a fresh
    process was seen to come out ~1.5e-4 relative off in the chunks of
    torch's intra-op worker threads (never the calling thread's), with every
    later op exact (scripts/check_first_parallel_op_torch.py measures it).
    When this module ran first in its process, that op was the first case's
    kernel row, and its variance missed the 1e-4 bar. After this op every
    worker thread has done its first vector work."""
    torch.exp(torch.zeros(1 << 20))


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
    before = cuda_gp.gp_mean_var_multi.launches
    mean_w, var_w = cuda_gp.gp_mean_var(*t_args, include_noise=include_noise)
    assert cuda_gp.gp_mean_var_multi.launches == before
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


def make_multi(G=3, n=300, d=3, m=128, n_live=50, seed=0):
    """G GPs of m padded points with n_live live ones each, scattered (the
    live points are not a prefix: the mask has holes); masked points keep
    nonzero inputs and W entries, which the posterior must ignore."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(G, m, d)).astype(F32)
    mask = np.zeros((G, m), F32)
    W = np.zeros((G, m, m), F32)
    alpha = np.zeros((G, m), F32)
    ell = np.linspace(0.7, 1.6, G * d).reshape(G, d).astype(F32)
    sf2 = np.linspace(0.8, 1.5, G).astype(F32)
    noise = np.linspace(0.03, 0.08, G).astype(F32)
    for g in range(G):
        live = np.sort(rng.choice(m, size=n_live - 3 * g, replace=False))
        mask[g, live] = 1.0
        diff = (Z[g][:, None, :] - Z[g][None, :, :]) / ell[g]
        K = sf2[g] * np.exp(-0.5 * (diff**2).sum(-1)) * np.outer(mask[g], mask[g])
        K += np.diag(noise[g] * mask[g] + (1 - mask[g]))
        W[g] = np.linalg.inv(K).astype(F32)
        alpha[g] = (W[g] @ (rng.normal(size=m) * mask[g])).astype(F32)
    z = rng.normal(size=(G, n, d)).astype(F32)
    return z, (Z, alpha, W, ell, sf2, noise, mask)


@pytest.mark.parametrize("include_noise", [False, True])
@pytest.mark.parametrize("d", [3, 6])
def test_multi_plain_matches_jax_reference_per_gp(d, include_noise):
    """The multi-GP plain version on the packed (compacted) form against
    `gp_mean_var_reference` GP by GP: G = 3, N = 300, non-prefix masks."""
    z, leaves = make_multi(d=d, seed=d)
    form = cuda_gp.pack_form(*(torch.as_tensor(a) for a in leaves))
    assert form.Z.shape[1] == 56  # the most live points (50), rounded up to a multiple of 8
    before = cuda_gp.gp_mean_var_multi.launches
    mean_t, var_t = cuda_gp.gp_mean_var_multi(torch.as_tensor(z), form, include_noise)
    assert cuda_gp.gp_mean_var_multi.launches == before  # the CPU route counts no launch
    assert mean_t.shape == var_t.shape == (3, 300)
    Z, alpha, W, ell, sf2, noise, mask = leaves
    for g in range(3):
        mean_j, var_j = gp_mean_var_reference(
            *(jnp.asarray(a) for a in (z[g], Z[g], alpha[g], W[g], ell[g], sf2[g], noise[g],
                                       mask[g])), include_noise=include_noise)
        np.testing.assert_allclose(mean_t[g].numpy(), np.asarray(mean_j, F32), atol=1e-4)
        np.testing.assert_allclose(var_t[g].numpy(), np.asarray(var_j, F32), atol=1e-4)


@pytest.mark.parametrize("d", [3, 6])
def test_compaction_changes_nothing(d):
    """The compacted form (live points only) against the form that keeps every
    point. A masked point's terms are exact zeros in both sums, so the two
    differ only by the order the float32 matrix products sum in at the two
    sizes: held to the standard bound of a float32 sum of M terms,
    M 2^-23 sum_j |term_j|, per query (here the terms reach ~1e3 where the
    results are ~1)."""
    z, leaves = make_multi(d=d, seed=10 + d)
    t = [torch.as_tensor(a) for a in leaves]
    full = cuda_gp.pack_form(*t, compact=False)
    packed = cuda_gp.pack_form(*t)
    assert full.Z.shape[1] == 128 and packed.Z.shape[1] == 56
    zt = torch.as_tensor(z)
    k = torch.stack([cuda_gp.se_kernel(zt[g], full.Z[g], full.lengthscale[g], full.outputscale[g])
                     * full.mask[g] for g in range(3)]).abs()
    terms = ((k * full.alpha.abs()[:, None, :]).sum(-1),  # of the mean, then of k W k^T
             torch.einsum("gni,gij,gnj->gn", k, full.W.abs(), k))
    for a, b, s in zip(cuda_gp.gp_mean_var_multi_plain(zt, packed),
                       cuda_gp.gp_mean_var_multi_plain(zt, full), terms):
        assert bool(((a - b).abs() <= 128 * 2.0**-23 * s).all())


def _bench_gp_pair():
    """The quadrotor bench GP (G = 3) with a non-prefix variance mask, as the
    JAX package's GpModel and the port's."""
    with np.load(convert.bench_gp_path("quadrotor")) as d:
        flat = dict(d)
    flat["var_mask"] = flat["var_mask"].copy()
    flat["var_mask"][:, [0, 7, 21]] = 0.0  # holes: the live points are not a prefix
    leaf = lambda k: jnp.asarray(flat[k])  # noqa: E731
    gp_j = JGpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"),
        hypers=JGPHypers(leaf("raw_lengthscale"), leaf("raw_outputscale"), leaf("raw_noise")),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(True),
    )
    return gp_j, convert.gp_model_from_numpy(flat, device="cpu")


def test_batched_variances_matches_jax_pallas_interpret():
    """The port's one-call `batched_variances` against the reference's
    per-GP Pallas kernel in interpret mode: G = 3, B = 4, T = 5, on the bench
    GP with holes in its variance mask (bar: the repo's Pallas GP test's)."""
    gp_j, gp_t = _bench_gp_pair()
    z = np.random.default_rng(2).normal(0, 0.5, (3, 4, 5, 3)).astype(F32)
    v_j = j_batched_variances(gp_j, jnp.asarray(z), backend="pallas", interpret=True)
    v_t = t_batched_variances(gp_t, torch.as_tensor(z))
    assert v_t.shape == (3, 4, 5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j, F32), atol=1e-4)


def test_variance_form_is_built_once_and_never_stale():
    """Two GpModels used one after the other each give their own variances;
    the same GpModel reuses its packed form; a leaf written in place gets a
    new one."""
    from gpmpc_tpu_torch.control import gpmpc as t_gpmpc

    _, gp_a = _bench_gp_pair()
    gp_b = gp_a._replace(var_mat=gp_a.var_mat * 0.5, var_Z=gp_a.var_Z + 0.1)
    z = torch.as_tensor(np.random.default_rng(3).normal(0, 0.5, (3, 2, 4, 3)).astype(F32))
    want = {id(g): t_gpmpc.gp_variances(g, z) for g in (gp_a, gp_b)}
    for g in (gp_a, gp_b, gp_a, gp_b):
        np.testing.assert_allclose(t_batched_variances(g, z).numpy(), want[id(g)].numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert t_gpmpc.variance_form(gp_a) is t_gpmpc.variance_form(gp_a)
    assert t_gpmpc.variance_form(gp_a) is not t_gpmpc.variance_form(gp_b)
    form = t_gpmpc.variance_form(gp_a)
    gp_a.var_mat.mul_(0.25)
    assert t_gpmpc.variance_form(gp_a) is not form
    np.testing.assert_allclose(t_batched_variances(gp_a, z).numpy(),
                               t_gpmpc.gp_variances(gp_a, z).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("made_in", ["inference_mode", "grad_mode"])
def test_variance_form_under_inference_mode(made_in):
    """A step taken under `torch.inference_mode`, with the GpModel loaded
    there too (its leaves then have no version counter) or loaded before:
    the shared GP's variances come out as `gp_variances` gives them, and the
    packed form is built once."""
    from gpmpc_tpu_torch.control import gpmpc as t_gpmpc

    z = torch.as_tensor(np.random.default_rng(4).normal(0, 0.5, (3, 2, 4, 3)).astype(F32))
    with torch.inference_mode(made_in == "inference_mode"):
        _, gp = _bench_gp_pair()
    with torch.inference_mode():
        got = [t_batched_variances(gp, z) for _ in range(2)]
        assert t_gpmpc.variance_form(gp) is t_gpmpc.variance_form(gp)
        want = t_gpmpc.gp_variances(gp, z)
    for v in got:
        np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_multi_wrapper_rejects_what_the_kernel_does_not_take():
    z, leaves = make_multi(G=2, n=10)
    form = cuda_gp.pack_form(*(torch.as_tensor(a) for a in leaves))
    zt = torch.as_tensor(z)
    with pytest.raises(ValueError, match="shape"):
        cuda_gp.gp_mean_var_multi(zt[:1], form)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gp.gp_mean_var_multi(zt.transpose(0, 1).contiguous().transpose(0, 1), form)
    with pytest.raises(ValueError, match="no kernel and no plain route"):
        cuda_gp.gp_mean_var_multi(zt.to("meta"), cuda_gp.GpForm(*(f.to("meta") for f in form)))


@pytest.mark.parametrize("n_live,bucket", [(40, 64), (128, 128), (136, 0), (304, 0)])
def test_wrapper_picks_the_instantiation_by_m(monkeypatch, n_live, bucket):
    """On the kernel route the wrapper hands the launcher the instantiation
    `gp_geometry` names for the packed form's M (the launch itself stubbed:
    no card here): the kernel row in registers at bucket 64 or 128 up to 128
    live points, the tiled kernel (bucket 0) past them, with no raise and no
    plain fallback; one launch counted."""
    calls = []
    monkeypatch.setattr(cuda_gp, "route", lambda device: "kernel")
    monkeypatch.setattr(cuda_gp._build, "launch", lambda entry, *a: calls.append((entry, a)))
    monkeypatch.setattr(cuda_gp._build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(cuda_gp, "gp_mean_var_multi_plain", None)  # no fallback to it
    z, leaves = make_multi(G=2, n=70, d=6, m=n_live + 8, n_live=n_live)
    form = cuda_gp.pack_form(*(torch.as_tensor(a) for a in leaves))
    m = form.Z.shape[1]
    assert m == n_live
    geometry = cuda_gp.gp_geometry(m, 6)
    assert geometry.bucket == bucket
    before = cuda_gp.gp_mean_var_multi.launches
    mean, var = cuda_gp.gp_mean_var_multi(torch.as_tensor(z), form, include_noise=True)
    assert mean.shape == var.shape == (2, 70) and cuda_gp.gp_mean_var_multi.launches == before + 1
    (entry, args), = calls
    assert entry == "gp_posterior_launch"
    assert args[6:12] == (2, 70, m, 6, 1, bucket) and args[14] == 0
    tiled = 8 * cuda_gp.TILE_ROWS * cuda_gp.TILE_COLS + 4 * (
        cuda_gp.TILE_COLS * cuda_gp.QTILE + 10 * cuda_gp.TILE_ROWS + 9 * cuda_gp.TILE_COLS)
    whole = 4 * (m * m + 8 * m + m * cuda_gp.QTILE)
    assert geometry.shared_bytes == (tiled if bucket == 0 else whole)
    assert geometry.shared_bytes <= 227 * 1024
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_gp.gp_geometry(m + 4, 6)


@pytest.mark.parametrize("m", [136, 5120, 65_536])
@pytest.mark.parametrize("d", [3, 8])
def test_tiled_kernel_shared_memory_does_not_grow_with_m(m, d):
    """The tiled instantiation streams W, the points, alpha and the mask in
    tiles: a block's shared memory is the same at any M and D (52,736
    bytes, a quarter of the 227 KB a block may hold), so an exact GP of
    BASELINE config 4's 5,120 points at D = 8 launches."""
    geometry = cuda_gp.gp_geometry(m, d)
    assert geometry == cuda_gp.GpGeometry(0, 52_736)
    assert geometry.shared_bytes <= 227 * 1024 // 4

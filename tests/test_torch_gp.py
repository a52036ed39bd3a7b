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
    live points, with no split and no workspace; the tiled kernel (bucket 0)
    past them, with `gp_tiled_plan`'s split (its ranges and their length,
    on the SMS of the default card for a tensor off the card) and a float64
    workspace of its shape; no raise and no plain fallback; one launch
    counted."""
    calls, empties = _stub_launch(monkeypatch)
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
    whole = 4 * (m * m + 8 * m + m * cuda_gp.QTILE)
    if bucket:
        assert args[6:15] == (2, 70, m, 6, 1, bucket, 0, 0, whole) and args[15] is None
        assert geometry.shared_bytes == whole and empties == [(2, 70), (2, 70)]
    else:
        plan = cuda_gp.gp_tiled_plan(2, 70, m, 6)
        assert args[6:15] == (2, 70, m, 6, 1, 0, plan.splits, plan.stages_per_split,
                              cuda_gp.TILED_SHARED_BYTES)
        assert geometry.shared_bytes == plan.shared_bytes == cuda_gp.TILED_SHARED_BYTES
        assert empties == [(2, 70), (2, 70), plan.workspace]
        assert plan.workspace == (2, plan.col_tiles * (plan.splits + 1), 70)
    assert args[18] == 0
    assert geometry.shared_bytes <= 227 * 1024
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_gp.gp_geometry(m + 4, 6)


def _stub_launch(monkeypatch):
    """The kernel route with the launch stubbed: the launches made and the
    shapes of the tensors the wrapper allocated."""
    calls, empties = [], []
    monkeypatch.setattr(cuda_gp, "route", lambda device: "kernel")
    monkeypatch.setattr(cuda_gp._build, "launch", lambda entry, *a: calls.append((entry, a)))
    monkeypatch.setattr(cuda_gp._build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(cuda_gp, "gp_mean_var_multi_plain", None)  # no fallback to it
    empty = torch.empty

    def recording_empty(*shape, **kw):
        empties.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(cuda_gp.torch, "empty", recording_empty)
    return calls, empties


def test_wrapper_takes_the_tiled_kernel_at_any_m_when_asked(monkeypatch):
    """`tiled=True` launches the tiled kernel's plan at 40 points, where the
    wrapper's own choice stays the register bucket (the launch stubbed)."""
    calls, empties = _stub_launch(monkeypatch)
    z, leaves = make_multi(G=3, n=50, d=3, m=48, n_live=40)
    form = cuda_gp.pack_form(*(torch.as_tensor(a) for a in leaves))
    assert form.Z.shape[1] == 40 and cuda_gp.gp_geometry(40, 3).bucket == 64
    cuda_gp.gp_mean_var_multi(torch.as_tensor(z), form, tiled=True)
    plan = cuda_gp.gp_tiled_plan(3, 50, 40, 3)
    (_, args), = calls
    assert args[6:15] == (3, 50, 40, 3, 0, 0, plan.splits, plan.stages_per_split,
                          cuda_gp.TILED_SHARED_BYTES)
    assert empties[-1] == plan.workspace == (3, 3, 50)  # one column tile, a row range a stage
    assert cuda_gp.sm_count(torch.device("cpu")) == cuda_gp.SMS  # the plan's card off the card


@pytest.mark.parametrize("m", [136, 5120, 65_536])
@pytest.mark.parametrize("d", [3, 8])
def test_tiled_kernel_shared_memory_does_not_grow_with_m(m, d):
    """The tiled instantiation streams W, the points, alpha and the mask in
    tiles: a block's shared memory is the same at any M, D and N (149,760
    bytes), and TILED_BLOCKS_PER_SM = 1 block fits an SM's 228 KB with the 1
    KB the card reserves for each, so an exact GP of BASELINE config 4's
    5,120 points at D = 8 launches."""
    geometry = cuda_gp.gp_geometry(m, d)
    assert geometry == cuda_gp.GpGeometry(0, 149_760)
    for n in (1, 20, 25_637):
        assert cuda_gp.gp_tiled_plan(3, n, m, d).shared_bytes == geometry.shared_bytes
    assert geometry.shared_bytes <= 227 * 1024
    assert cuda_gp.TILED_BLOCKS_PER_SM * (geometry.shared_bytes + 1024) <= 228 * 1024


# chip_smoke.py's F7 cases (G, D, M, N), and the two-link exact GP's M with a
# B = 1 step's N = 20 queries and a B = 128 tile's 2,560
PLAN_CASES = [(G, D, m, 25_637) for m in (136, 304, 512) for G, D in ((2, 6), (3, 3))] + [
    (2, 6, 2048, 4096), (3, 3, 2048, 4096), (2, 6, 304, 20), (2, 6, 304, 2560)]


@pytest.mark.parametrize("sms", [cuda_gp.SMS, 114])  # an H100 SXM's SMs, an H100 PCIe's
@pytest.mark.parametrize("G,D,m,n", PLAN_CASES)
def test_tiled_plan_covers_w_once_and_fills_the_card(G, D, m, n, sms):
    """Every (row, column) entry of W below M lies in exactly one block row
    of the grid; every column's mean share in exactly one; the partial
    indices are distinct and fill the workspace; no row range is empty; the
    grid holds two waves of a block on each of the card's `sms` SMs
    (WAVE_TARGET on an H100 SXM, the default), or every row range is one
    stage."""
    target = 2 * sms * cuda_gp.TILED_BLOCKS_PER_SM
    assert cuda_gp.WAVE_TARGET == 2 * cuda_gp.SMS * cuda_gp.TILED_BLOCKS_PER_SM
    plan = cuda_gp.gp_tiled_plan(G, n, m, D, sms)
    if sms == cuda_gp.SMS:
        assert plan == cuda_gp.gp_tiled_plan(G, n, m, D)
    assert plan.grid == (-(-n // 64), plan.col_tiles * plan.splits, G)
    assert plan.col_tiles == -(-m // 128) and plan.stages == -(-m // 32)
    assert plan.workspace == (G, plan.col_tiles * (plan.splits + 1), n)
    cover = np.zeros((m, m), np.int64)
    mean_cover = np.zeros(m, np.int64)
    partials = []
    for y in range(plan.grid[1]):
        rows, cols, p, p_mean = plan.block(y, m)
        assert len(rows) and len(cols)
        cover[rows.start:rows.stop, cols.start:cols.stop] += 1
        partials.append(p)
        if p_mean is not None:
            mean_cover[cols.start:cols.stop] += 1
            partials.append(p_mean)
    assert (cover == 1).all() and (mean_cover == 1).all()
    assert sorted(partials) == list(range(plan.workspace[1]))
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks >= target or plan.splits == plan.stages
    assert -(-plan.stages // plan.stages_per_split) == plan.splits
    # split no further than the target needs: every smaller count of ranges
    # (of equal length but the last) falls short of it
    counts = {-(-plan.stages // per) for per in range(1, plan.stages + 1)}
    fewer = max([c for c in counts if c < plan.splits], default=0)
    assert plan.grid[0] * plan.col_tiles * fewer * G < target
    if (m, n) == (304, 20):
        assert blocks == 60 and plan.splits == 10  # one stage a block
    if (m, n) == (2048, 4096):
        assert plan.splits == 1 and blocks == 64 * 16 * G


@pytest.mark.parametrize("n", [70, 700])
@pytest.mark.parametrize("m", [136, 304, 520])  # not multiples of the 32-row, 128-column tile
def test_tiled_plan_partials_sum_to_the_reference(m, n):
    """In float64: per query, the partials of k W k^T over each block's W
    tile and of the mean over the first row range's columns, summed in the
    reduction's order (the k W k^T partials by index, column tile by column
    tile and row range by row range, then the mean's), equal
    `gp_mean_var_reference` within 1e-12 (N = 700 at M = 520 cuts the rows
    into 2 ranges of 6 stages and a last of 5)."""
    G, D = 2, 3
    z, (Z, alpha, W, ell, sf2, noise, mask) = make_multi(G=G, n=n, d=D, m=m, n_live=m, seed=m)
    plan = cuda_gp.gp_tiled_plan(G, n, m, D)
    n_quad = plan.col_tiles * plan.splits
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    for g in range(G):
        diff = (f64(z[g])[:, None, :] - f64(Z[g])[None, :, :]) / f64(ell[g])
        k = f64(sf2[g]) * np.exp(-0.5 * (diff**2).sum(-1)) * f64(mask[g])
        ws = np.zeros((plan.workspace[1], n))
        for y in range(plan.grid[1]):
            rows, cols, p, p_mean = plan.block(y, m)
            kr, kc = k[:, rows.start:rows.stop], k[:, cols.start:cols.stop]
            ws[p] = ((kr @ f64(W[g])[rows.start:rows.stop, cols.start:cols.stop]) * kc).sum(-1)
            if p_mean is not None:
                ws[p_mean] = kc @ f64(alpha[g])[cols.start:cols.stop]
        quad, mean = np.zeros(n), np.zeros(n)
        for p in range(n_quad):
            quad = quad + ws[p]
        for p in range(n_quad, plan.workspace[1]):
            mean = mean + ws[p]
        var = np.maximum(f64(sf2[g]) - quad, 1e-12) + f64(noise[g])
        mean_j, var_j = gp_mean_var_reference(
            *(jnp.asarray(f64(a)) for a in (z[g], Z[g], alpha[g], W[g], ell[g], sf2[g], noise[g],
                                            mask[g])), include_noise=True)
        assert np.asarray(var_j).dtype == np.float64
        np.testing.assert_allclose(mean, np.asarray(mean_j), rtol=0, atol=1e-12)
        np.testing.assert_allclose(var, np.asarray(var_j), rtol=0, atol=1e-12)


def test_dmma_probe_cases_are_exact_and_the_cpu_takes_the_product():
    """The layout probe's cases (`cuda_gp.dmma_probe_cases`) have products
    that float64 holds exactly, whatever the summation order (integers below
    2^53), so the card's probe must match them bit for bit; on CPU tensors
    `dmma_probe` is the product itself."""
    for a, b in cuda_gp.dmma_probe_cases():
        assert a.shape == (32, cuda_gp.PROBE_K) and b.shape == (cuda_gp.PROBE_K, cuda_gp.PROBE_N)
        assert np.array_equal(a, np.round(a)) and np.array_equal(b, np.round(b))
        assert float(np.abs(a).sum(1).max() * np.abs(b).max()) < 2.0**53
        got = cuda_gp.dmma_probe(torch.as_tensor(a), torch.as_tensor(b))
        assert torch.equal(got, torch.as_tensor(a @ b))
    with pytest.raises(ValueError, match="shape"):
        cuda_gp.dmma_probe(torch.zeros(32, 4, dtype=torch.float64),
                           torch.zeros(4, 32, dtype=torch.float64))

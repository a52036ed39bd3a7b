"""Port lanes IP solver (kernel 4's plain version, via its wrapper on CPU
tensors) against the JAX package: the XLA box-QP solver scenario by scenario,
and the Pallas resident kernel (interpret mode) with Mehrotra and the
tile-wide adaptive exit. QP data as in tests/test_pallas_ocp.py, at the
quadrotor's (nx, nu) = (12, 4), the cartpole's (4, 1) and the two-link arm's
(4, 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops.boxqp import OcpQpData, solve_ocp_qp
from gpmpc_tpu.ops.pallas_ocp import LanesQp as JLanesQp
from gpmpc_tpu.ops.pallas_ocp import solve_ocp_qp_lanes as j_solve_lanes
from gpmpc_tpu_torch.ops import cuda_ocp
from gpmpc_tpu_torch.ops.sqp import SqpConfig
from gpmpc_tpu_torch.ops.sqp_lanes import MAX_LANES_HORIZON, MAX_STREAM2_HORIZON, _solve_qp_lanes

T, L = 5, 8
F32 = np.float32
WIDTHS = [(12, 4), (4, 1), (4, 2)]


def make_batch(seed=0, t=T, NX=12, NU=4):
    """tests/test_pallas_ocp.py::make_batch: (L, ...) batch-leading numpy data."""
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(NX, dtype=F32), (L, t, 1, 1)) + 0.1 * rng.normal(size=(L, t, NX, NX)).astype(F32)
    B = rng.normal(size=(L, t, NX, NU)).astype(F32) * 0.4
    r = rng.normal(size=(L, t, NX)).astype(F32) * 0.05
    qdiag = rng.uniform(0.5, 2.0, size=(L, t + 1, NX)).astype(F32)
    qx = rng.normal(size=(L, t + 1, NX)).astype(F32) * 0.5
    rdiag = rng.uniform(0.5, 2.0, size=(L, t, NU)).astype(F32)
    ru = rng.normal(size=(L, t, NU)).astype(F32) * 0.5
    lx = np.full((L, t + 1, NX), -1.5, F32)
    ux = np.full((L, t + 1, NX), 1.5, F32)
    lu = np.full((L, t, NU), -0.3, F32)
    uu = np.full((L, t, NU), 0.3, F32)
    lx[:, 0, :] = -1e8
    ux[:, 0, :] = 1e8
    return dict(A=A, B=B, r=r, qdiag=qdiag, qx=qx, rdiag=rdiag, ru=ru, lx=lx, ux=ux, lu=lu, uu=uu)


def to_port(batches):
    """List of (L, ...) batches (one per tile) -> port LanesQp (n_tiles, ..., L)."""
    return cuda_ocp.LanesQp(**{
        k: torch.as_tensor(np.stack([np.moveaxis(b[k], 0, -1) for b in batches]).copy())
        for k in cuda_ocp.LanesQp._fields
    })


@pytest.mark.parametrize("nx,nu", WIDTHS)
def test_plain_centering_matches_xla_boxqp_per_scenario(nx, nu):
    NX, NU = nx, nu
    d = make_batch(0, NX=nx, NU=nu)
    n_iter = 12
    dx, du, gap = cuda_ocp.solve_ocp_qp_lanes(to_port([d]), n_ip=n_iter)
    assert bool((gap < 1e-4).all())
    dx = np.moveaxis(dx[0].numpy(), -1, 0)  # (L, T+1, NX)
    du = np.moveaxis(du[0].numpy(), -1, 0)
    qp = OcpQpData(  # leaves lead with the scenario axis; solved one scenario per vmap lane
        A=jnp.asarray(d["A"]), B=jnp.asarray(d["B"]), r=jnp.asarray(d["r"]),
        Qxx=jnp.asarray(d["qdiag"][..., None] * np.eye(NX, dtype=F32)),
        qx=jnp.asarray(d["qx"]),
        Ruu=jnp.asarray(d["rdiag"][..., None] * np.eye(NU, dtype=F32)),
        ru=jnp.asarray(d["ru"]), lx=jnp.asarray(d["lx"]), ux=jnp.asarray(d["ux"]),
        lu=jnp.asarray(d["lu"]), uu=jnp.asarray(d["uu"]),
    )
    sol = jax.jit(jax.vmap(lambda q: solve_ocp_qp(q, n_iter=n_iter)))(qp)
    np.testing.assert_allclose(du, np.asarray(sol.du, F32), atol=2e-4)
    np.testing.assert_allclose(dx, np.asarray(sol.dx, F32), atol=2e-4)


@pytest.mark.parametrize("nx,nu,scale", [(12, 4, 5), (4, 1, 50)])
def test_mehrotra_adaptive_exit_matches_pallas_kernel_per_tile(nx, nu, scale):
    """Two tiles that converge at different IP iterations (the second has
    `scale` times larger gradients: it exits at iteration 7 at 12x4, 6 at
    4x1): each tile's tile-wide exit must match the reference kernel run on
    that tile alone."""
    hard = make_batch(5, NX=nx, NU=nu)
    hard["qx"] *= scale
    hard["ru"] *= scale
    batches = [make_batch(2, NX=nx, NU=nu), hard]
    kw = dict(n_ip=10, adaptive_tol=1e-6, mehrotra=True)
    qp = to_port(batches)
    dx, du, gap = cuda_ocp.solve_ocp_qp_lanes(qp, **kw)
    # tile 0 has exited after 4 iterations, tile 1 has not
    _, du4, _ = cuda_ocp.solve_ocp_qp_lanes(qp, **dict(kw, n_ip=4))
    np.testing.assert_array_equal(du4[0].numpy(), du[0].numpy())
    assert float((du4[1] - du[1]).abs().max()) > 1e-6
    for i, d in enumerate(batches):
        qp_j = JLanesQp(**{k: jnp.asarray(np.moveaxis(v, 0, -1)) for k, v in d.items()})
        dx_j, du_j, gap_j = j_solve_lanes(qp_j, interpret=True, **kw)
        np.testing.assert_allclose(dx[i].numpy(), np.asarray(dx_j, F32), atol=1e-5)
        np.testing.assert_allclose(du[i].numpy(), np.asarray(du_j, F32), atol=1e-5)
        np.testing.assert_allclose(gap[i].numpy(), np.asarray(gap_j, F32), rtol=1e-2, atol=1e-10)


@pytest.mark.parametrize("plain", ["solve_ocp_qp_lanes_plain", "solve_ocp_qp_lanes_streamed_plain",
                                   "solve_ocp_qp_lanes_streamed2_plain"])
def test_plain_versions_count_each_tiles_iterations(plain):
    """The plain versions count the IP iterations each tile ran as the kernels
    do (`last_iterations`, which the on-card checks hold the kernels' counts
    to): the fewest iterations after which a tile's solution is that of the
    full run, and n_ip for every tile without the adaptive exit."""
    fn = getattr(cuda_ocp, plain)
    hard = make_batch(5)
    hard["qx"] *= 5.0
    hard["ru"] *= 5.0
    qp = to_port([make_batch(2), hard])
    kw = dict(n_ip=10, adaptive_tol=1e-6, mehrotra=True)
    du = fn(qp, **kw)[1]
    counts = fn.last_iterations.tolist()
    assert counts[0] < counts[1] < 10
    for tile, m in enumerate(counts):
        assert torch.equal(fn(qp, **dict(kw, n_ip=m))[1][tile], du[tile])
        assert not torch.equal(fn(qp, **dict(kw, n_ip=m - 1))[1][tile], du[tile])
    fn(qp, n_ip=3)
    assert fn.last_iterations.tolist() == [3, 3]


def test_soft_bounds_are_not_ported_and_say_so():
    """(Named for the earlier slices, which refused both.) The SQP's QP
    dispatch now serves soft state bounds and horizons past the resident cap,
    and still refuses, by name, what no lanes kernel serves: a horizon past
    the last cap, as the reference does."""
    cfg = SqpConfig(qp_iters=2)
    dx, du, gap = _solve_qp_lanes(to_port([make_batch(0)]), cfg._replace(soft_x_penalty=2.0))
    assert dx.shape == (1, T + 1, 12, L) and bool(torch.isfinite(du).all())
    dx, _, _ = _solve_qp_lanes(to_port([make_batch(0, t=MAX_LANES_HORIZON + 1)]), cfg)
    assert dx.shape == (1, MAX_LANES_HORIZON + 2, 12, L) and bool(torch.isfinite(dx).all())
    past = cuda_ocp.LanesQp(*(torch.zeros((1, MAX_STREAM2_HORIZON + 1) + (1,) * 3)
                              for _ in cuda_ocp.LanesQp._fields))
    with pytest.raises(ValueError, match=f"up to T={MAX_STREAM2_HORIZON} .got"):
        _solve_qp_lanes(past, cfg)


@pytest.mark.parametrize("nx,nu,L,expected", [
    (12, 4, 128, (16, 8, 16, 22408)),
    (4, 1, 128, (8, 16, 8, 8456)),
    (4, 2, 128, (8, 16, 8, 8968)),
    (12, 4, 8, (16, 8, 1, 22408)),
    (12, 4, 256, (16, 16, 16, 44808)),
])
def test_resident_geometry_at_the_three_widths(nx, nu, L, expected):
    """The resident kernel's launch geometry: a team of threads per scenario
    (the power of two at or above nx + nu), a tile of L lanes spread over a
    cluster of at most 16 blocks, and the shared memory its blocks take (two
    [A_k | B_k] slabs and each scenario's team area)."""
    g = cuda_ocp.resident_geometry(nx, nu, L)
    assert (g.team, g.scenarios_per_block, g.cluster, g.shared_bytes) == expected
    assert g.cluster * g.scenarios_per_block == L and g.threads <= 256


@pytest.mark.parametrize("nx,nu,L", [(12, 4, 100), (12, 4, 1024), (4, 1, 130), (4, 3, 128)])
def test_resident_geometry_refuses_what_the_cluster_cannot_split(nx, nu, L):
    """A tile the cluster cannot split evenly, one past 16 blocks of 256
    threads, or a width with no instantiation raises before any launch."""
    with pytest.raises(ValueError, match="ocp_ip kernel"):
        cuda_ocp.resident_geometry(nx, nu, L)

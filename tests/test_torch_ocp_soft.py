"""The port's interior point with L1-soft state bounds and in its two
streamed tiers (the plain versions, via the wrappers on CPU tensors) against
the JAX package: the XLA box-QP solver scenario by scenario and the Pallas
kernels in interpret mode, on the problems of tests/test_pallas_ocp.py; and
the horizon dispatch of `_solve_qp_lanes` against the reference's caps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops import pallas_ocp as j_ocp
from gpmpc_tpu.ops import sqp_lanes as j_sqp_lanes
from gpmpc_tpu.ops.boxqp import OcpQpData, solve_ocp_qp
from gpmpc_tpu.models.residual import QUADROTOR_SPEC as J_QUADROTOR_SPEC
from gpmpc_tpu.parallel.batch import dispatch_decision as j_dispatch_decision
from gpmpc_tpu_torch.models.residual import QUADROTOR_SPEC
from gpmpc_tpu_torch.ops import cuda_ocp, sqp_lanes
from gpmpc_tpu_torch.ops.sqp import SqpConfig
from gpmpc_tpu_torch.parallel.batch import dispatch_decision
from tests._torch_threads import _one_thread  # noqa: F401


L = 8
F32 = np.float32
WIDTHS = [(12, 4), (4, 1), (4, 2)]


def make_batch(seed, t, nx=12, nu=4, scale=1.0, box=1.5):
    """tests/test_pallas_ocp.py::make_batch at any widths, with the state
    boxes of stages 1..t at +-box: (L, ...) batch-leading numpy data."""
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(nx, dtype=F32), (L, t, 1, 1)) + (0.1 * scale) * rng.normal(
        size=(L, t, nx, nx)).astype(F32)
    d = dict(
        A=A, B=rng.normal(size=(L, t, nx, nu)).astype(F32) * 0.4,
        r=rng.normal(size=(L, t, nx)).astype(F32) * 0.05,
        qdiag=rng.uniform(0.5, 2.0, size=(L, t + 1, nx)).astype(F32),
        qx=rng.normal(size=(L, t + 1, nx)).astype(F32) * 0.5,
        rdiag=rng.uniform(0.5, 2.0, size=(L, t, nu)).astype(F32),
        ru=rng.normal(size=(L, t, nu)).astype(F32) * 0.5,
        lx=np.full((L, t + 1, nx), -box, F32), ux=np.full((L, t + 1, nx), box, F32),
        lu=np.full((L, t, nu), -0.3, F32), uu=np.full((L, t, nu), 0.3, F32),
    )
    d["lx"][:, 0, :] = -1e8
    d["ux"][:, 0, :] = 1e8
    return d


def to_port(batches):
    return cuda_ocp.LanesQp(**{
        k: torch.as_tensor(np.stack([np.moveaxis(b[k], 0, -1) for b in batches]).copy())
        for k in cuda_ocp.LanesQp._fields
    })


def to_jax(d):
    return j_ocp.LanesQp(**{k: jnp.asarray(np.moveaxis(v, 0, -1)) for k, v in d.items()})


def boxqp_solutions(d, n_iter, **kw):
    """The XLA interior point, one scenario per vmap lane: (dx, du) (L, ...)."""
    nx, nu = d["A"].shape[-1], d["B"].shape[-1]
    qp = OcpQpData(
        A=jnp.asarray(d["A"]), B=jnp.asarray(d["B"]), r=jnp.asarray(d["r"]),
        Qxx=jnp.asarray(d["qdiag"][..., None] * np.eye(nx, dtype=F32)), qx=jnp.asarray(d["qx"]),
        Ruu=jnp.asarray(d["rdiag"][..., None] * np.eye(nu, dtype=F32)), ru=jnp.asarray(d["ru"]),
        lx=jnp.asarray(d["lx"]), ux=jnp.asarray(d["ux"]), lu=jnp.asarray(d["lu"]),
        uu=jnp.asarray(d["uu"]),
    )
    sol = jax.jit(jax.vmap(lambda q: solve_ocp_qp(q, n_iter=n_iter, **kw)))(qp)
    return np.asarray(sol.dx, F32), np.asarray(sol.du, F32)


def lanes_first(x):
    """(1, ..., L) port output -> (L, ...)."""
    return np.moveaxis(x[0].numpy(), -1, 0)


@pytest.mark.parametrize("mehrotra,n_ip", [(False, 15), (True, 10)])
@pytest.mark.parametrize("nx,nu", WIDTHS)
def test_soft_plain_matches_xla_soft_boxqp_per_scenario(nx, nu, mehrotra, n_ip):
    """Tight boxes (+-0.15) and a penalty below the hard multipliers (rho = 2
    at 12x4, 0.5 at the narrow widths, whose multipliers are smaller), so the
    optimum violates its boxes. atol 5e-4: the reference's own bar between its
    lanes kernel and this oracle (two float32 interior points with different
    elimination orders)."""
    d = make_batch(2, 5, nx, nu, box=0.15)
    rho = 2.0 if nx == 12 else 0.5
    dx, du, gap = cuda_ocp.solve_ocp_qp_lanes(to_port([d]), n_ip=n_ip, soft_rho=rho,
                                              mehrotra=mehrotra)
    assert bool((gap < 1e-3).all())
    dx_ref, du_ref = boxqp_solutions(d, 15, soft_x=rho, mehrotra=mehrotra)
    assert np.abs(dx_ref[:, 1:]).max() > 0.15 + 1e-3, "the oracle should violate its boxes"
    np.testing.assert_allclose(lanes_first(du), du_ref, atol=5e-4)
    np.testing.assert_allclose(lanes_first(dx), dx_ref, atol=5e-4)


def test_soft_crossed_bounds_stay_finite():
    """Lower bound above upper (an over-aggressive tightening) is well-posed
    for the L1-penalized QP; atol 1e-3 is the reference's bar for this case."""
    d = make_batch(4, 5)
    d["lx"][:, 1:, :] = 0.3
    d["ux"][:, 1:, :] = -0.3
    dx, du, _ = cuda_ocp.solve_ocp_qp_lanes(to_port([d]), n_ip=15, soft_rho=5.0)
    assert bool(torch.isfinite(dx).all()) and bool(torch.isfinite(du).all())
    _, du_ref = boxqp_solutions(d, 15, soft_x=5.0)
    np.testing.assert_allclose(lanes_first(du), du_ref, atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(n_ip=15), dict(n_ip=10, mehrotra=True),
    dict(n_ip=15, mehrotra=True, adaptive_tol=1e-6),
], ids=["plain", "mehrotra", "mehrotra-exit"])
def test_soft_plain_matches_pallas_resident_kernel(kw):
    """The same bounded-multiplier algebra in both: atol 5e-5, the
    reference's bar between two float32 orderings of the soft iteration. With
    the exit at 1e-6 the two tiles stop at different iterations (5 and 8: the
    second has twice the gradients), each as the reference kernel run on it
    alone. The gap ends near its 1e-8 floor, where it is float32 rounding
    noise: within 10 % or 5e-8."""
    hard = make_batch(5, 5, box=0.15)
    hard["qx"] *= 2
    hard["ru"] *= 2
    batches = [make_batch(2, 5, box=0.15), hard]
    dx, du, gap = cuda_ocp.solve_ocp_qp_lanes(to_port(batches), soft_rho=2.0, **kw)
    for i, d in enumerate(batches):
        dx_j, du_j, gap_j = j_ocp.solve_ocp_qp_lanes(to_jax(d), soft_rho=2.0, interpret=True, **kw)
        np.testing.assert_allclose(dx[i].numpy(), np.asarray(dx_j, F32), atol=5e-5)
        np.testing.assert_allclose(du[i].numpy(), np.asarray(du_j, F32), atol=5e-5)
        np.testing.assert_allclose(gap[i].numpy(), np.asarray(gap_j, F32), rtol=1e-1, atol=5e-8)


def test_soft_mode_floors_the_exit_tolerance():
    """soft_rho turns the tile-wide exit on at 1e-8 even when the caller asks
    for none: 40 iterations stop where 25 do."""
    qp = to_port([make_batch(2, 5, box=0.15)])
    _, du_25, _ = cuda_ocp.solve_ocp_qp_lanes(qp, n_ip=25, soft_rho=2.0, mehrotra=True)
    _, du_40, _ = cuda_ocp.solve_ocp_qp_lanes(qp, n_ip=40, soft_rho=2.0, mehrotra=True)
    np.testing.assert_array_equal(du_25.numpy(), du_40.numpy())
    with pytest.raises(ValueError, match="soft_rho must be positive"):
        cuda_ocp.solve_ocp_qp_lanes(qp, soft_rho=0.0)


TIERS = {
    "streamed": (cuda_ocp.solve_ocp_qp_lanes_streamed, j_ocp.solve_ocp_qp_lanes_streamed, 16),
    "streamed2": (cuda_ocp.solve_ocp_qp_lanes_streamed2, j_ocp.solve_ocp_qp_lanes_streamed2, 12),
}


@pytest.mark.parametrize("mehrotra", [False, True], ids=["plain", "mehrotra"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_streamed_plain_matches_pallas_streamed_kernel(tier, soft, mehrotra):
    """A horizon of several chunks (T=16: two chunks of 8 in tier 1; T=12:
    three chunks of 4 in tier 2). atol 1e-6 hard and 5e-5 soft: the reference's
    own bars between its streamed and resident kernels; the gap within 10 % or
    5e-8 (near its floor it is rounding noise)."""
    port, ref, t = TIERS[tier]
    d = make_batch(3, t, box=0.15 if soft else 1.5)
    kw = dict(n_ip=15 if soft else 12, mehrotra=mehrotra, soft_rho=2.0 if soft else None)
    dx, du, gap = port(to_port([d]), **kw)
    dx_j, du_j, gap_j = ref(to_jax(d), interpret=True, **kw)
    atol = 5e-5 if soft else 1e-6
    np.testing.assert_allclose(dx[0].numpy(), np.asarray(dx_j, F32), atol=atol)
    np.testing.assert_allclose(du[0].numpy(), np.asarray(du_j, F32), atol=atol)
    np.testing.assert_allclose(gap[0].numpy(), np.asarray(gap_j, F32), rtol=1e-1, atol=5e-8)


@pytest.mark.parametrize("tier", list(TIERS))
def test_streamed_plain_tile_wide_exit_matches_pallas(tier):
    port, ref, t = TIERS[tier]
    d = make_batch(3, t)
    kw = dict(n_ip=12, mehrotra=True, adaptive_tol=1e-6)
    dx, du, _ = port(to_port([d]), **kw)
    dx_j, du_j, _ = ref(to_jax(d), interpret=True, **kw)
    np.testing.assert_allclose(dx[0].numpy(), np.asarray(dx_j, F32), atol=1e-6)
    np.testing.assert_allclose(du[0].numpy(), np.asarray(du_j, F32), atol=1e-6)


def test_streamed_plain_T100_matches_xla_boxqp():
    """A T=100 hard solve against the XLA interior point per scenario (the
    reference's own long-horizon parity test), atol 5e-4."""
    d = make_batch(4, 100, scale=0.3)
    dx, du, gap = cuda_ocp.solve_ocp_qp_lanes_streamed(to_port([d]), n_ip=15)
    assert bool((gap < 1e-4).all())
    dx_ref, du_ref = boxqp_solutions(d, 15)
    np.testing.assert_allclose(lanes_first(du), du_ref, atol=5e-4)
    np.testing.assert_allclose(lanes_first(dx), dx_ref, atol=5e-4)
    assert float(du.max()) <= 0.3 + 1e-4 and float(du.min()) >= -0.3 - 1e-4


@pytest.mark.parametrize("T,soft,expect", [
    (50, False, "resident"), (51, False, "streamed"), (400, False, "streamed"),
    (401, False, "streamed2"), (1024, False, "streamed2"), (1025, False, "raises"),
    (50, True, "resident"), (320, True, "streamed"), (321, True, "streamed2"),
    (768, True, "streamed2"), (769, True, "raises"),
])
@pytest.mark.parametrize("mehrotra", [False, True], ids=["plain", "mehrotra"])
def test_qp_dispatch_by_horizon_matches_reference(monkeypatch, T, soft, expect, mehrotra):
    """`_solve_qp_lanes` of both packages picks the same tier at every cap
    (the three wrappers of each replaced by recorders) and passes the config
    through."""
    cfg = dict(qp_iters=7, qp_tol=1e-6, qp_mehrotra=mehrotra, soft_x_penalty=3.0 if soft else None)
    want_kw = dict(n_ip=7, adaptive_tol=1e-6, mehrotra=mehrotra, soft_rho=3.0 if soft else None)
    names = {"solve_ocp_qp_lanes": "resident", "solve_ocp_qp_lanes_streamed": "streamed",
             "solve_ocp_qp_lanes_streamed2": "streamed2"}

    def picked(mod, solve, qp):
        calls = []
        for attr, name in names.items():
            monkeypatch.setattr(mod, attr, lambda qp, _n=name, **kw: calls.append((_n, kw)))
        if expect == "raises":
            with pytest.raises(ValueError, match=f"up to T={T - 1} .*got {T}"):
                solve(qp)
            assert calls == []
            return "raises"
        solve(qp)
        (name, kw), = calls
        kw.pop("interpret", None)
        assert kw == want_kw
        return name

    port_qp = cuda_ocp.LanesQp(*(torch.zeros(1, T, 1, 1, 1) for _ in cuda_ocp.LanesQp._fields))
    got = picked(sqp_lanes, lambda q: sqp_lanes._solve_qp_lanes(q, SqpConfig(**cfg)), port_qp)
    ref_qp = j_ocp.LanesQp(*(np.zeros((T, 1, 1, 1), F32) for _ in j_ocp.LanesQp._fields))
    ref = picked(j_sqp_lanes,
                 lambda q: j_sqp_lanes._solve_qp_lanes(q, j_sqp_lanes.SqpConfig(**cfg), False),
                 ref_qp)
    assert got == ref == expect


@pytest.mark.parametrize("soft", [None, 10.0], ids=["hard", "soft"])
@pytest.mark.parametrize("T", [50, 51, 320, 321, 400, 401, 768, 769, 1024, 1025])
def test_dispatch_decision_matches_reference_at_the_caps(T, soft):
    """The path and the degraded flag of the step dispatcher at every cap,
    hard and soft, are the reference's (tests/test_dispatch.py's matrix)."""
    kw = dict(sqp_iters=4, qp_iters=6, kernel_linearize=True, soft_x_penalty=soft)
    got = dispatch_decision(SqpConfig(**kw), QUADROTOR_SPEC, T)
    ref = j_dispatch_decision(j_sqp_lanes.SqpConfig(**kw), J_QUADROTOR_SPEC, T, False, "lanes")
    assert (got.path, got.degraded) == (ref.path, ref.degraded)
    fused_cap = 400
    lanes_cap = 768 if soft else 1024
    assert got.path == ("lanes-fused" if T <= fused_cap else "lanes" if T <= lanes_cap else "xla")

"""The port's nominal QP stack (`ops/riccati.py`, `ops/boxqp.py`), batch-first,
against the JAX package's under `jax.vmap`, on the CPU, in float32 on both
sides. Bars: the Riccati solution within 1e-4 of each array's scale; the QP's
dx and du within 5e-4 (chip_smoke.py's QP bar, `TOL["ocp"]`). The batch
semantics of `jax.vmap`: a scenario that reaches `gap_tol` is frozen while
the others go on, and a Guu that is not positive definite gives NaN in its
own scenario only."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops import boxqp as j_boxqp
from gpmpc_tpu.ops import riccati as j_riccati
from gpmpc_tpu_torch.ops import boxqp as t_boxqp
from gpmpc_tpu_torch.ops import riccati as t_riccati

F32 = np.float32
SOFT_RHO = 50.0  # chip_smoke.py's soft penalty


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: torch's intra-op threads cost more than they give on a
    shared CPU. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lq(seed, B, T, nx, nu):
    """Random stage data (numpy float32, batch-first): A near I, diagonal
    positive costs."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx, dtype=F32) + 0.1 * rng.normal(size=(B, T, nx, nx))
    Bm = 0.4 * rng.normal(size=(B, T, nx, nu))
    r = 0.05 * rng.normal(size=(B, T, nx))
    Qxx = np.einsum("btk,kl->btkl", rng.uniform(0.5, 2.0, (B, T + 1, nx)), np.eye(nx))
    qx = 0.5 * rng.normal(size=(B, T + 1, nx))
    Ruu = np.einsum("btk,kl->btkl", rng.uniform(0.5, 2.0, (B, T, nu)), np.eye(nu))
    ru = 0.5 * rng.normal(size=(B, T, nu))
    return [a.astype(F32) for a in (A, Bm, r, Qxx, qx, Ruu, ru)]


def _qp(seed, B, T=10, nx=12, nu=4, box_x=1.5, box_u=0.3):
    """A box QP per scenario with its stage-0 state bounds disabled, as the
    SQP passes it; box_x of 0.4 makes state bounds active, a negative one
    crosses them."""
    lq = _lq(seed, B, T, nx, nu)
    lx = np.full((B, T + 1, nx), -box_x, F32)
    ux = -lx
    lx[:, 0], ux[:, 0] = -1e8, 1e8
    lu = np.full((B, T, nu), -box_u, F32)
    return lq + [lx, ux, lu, -lu]


def _both(cls_j, cls_t, arrays):
    return (cls_j(*[jnp.asarray(a) for a in arrays]), cls_t(*[torch.as_tensor(a) for a in arrays]))


def _close(got, want, atol_scale):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol_scale * scale)


@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 1)])
def test_riccati_matches_jax(nx, nu):
    """T = 8, B = 3: dx, du, K and kff within 1e-4 of each array's scale."""
    B, T = 3, 8
    lq_j, lq_t = _both(j_riccati.LqProblem, t_riccati.LqProblem, _lq(0, B, T, nx, nu))
    dx0 = np.random.default_rng(1).normal(size=(B, nx)).astype(F32)
    want = jax.jit(jax.vmap(j_riccati.riccati_solve))(lq_j, jnp.asarray(dx0))
    got = t_riccati.riccati_solve(lq_t, torch.as_tensor(dx0))
    for name in ("dx", "du", "K", "kff"):
        assert getattr(got, name).dtype == torch.float32
        _close(getattr(got, name), getattr(want, name), 1e-4)


def _jax_qp(n_iter, mehrotra, soft, gap_tol=None):
    return jax.jit(jax.vmap(partial(j_boxqp.solve_ocp_qp, n_iter=n_iter, mehrotra=mehrotra,
                                    soft_x=SOFT_RHO if soft else None, gap_tol=gap_tol)))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("mehrotra", [False, True], ids=["sigma", "mehrotra"])
def test_solve_ocp_qp_matches_jax(soft, mehrotra):
    """T = 10, 12x4, B = 4, 12 IP iterations; in the soft case crossed state
    boxes (lx = 0.02 > ux = -0.02 on stages 1..T), which only the L1-soft QP
    can take: every state violates a bound. dx and du within 5e-4, the final
    gaps within 1e-4 of their scale."""
    data = _qp(2, 4, box_x=-0.02 if soft else 1.5)
    qp_j, qp_t = _both(j_boxqp.OcpQpData, t_boxqp.OcpQpData, data)
    want = _jax_qp(12, mehrotra, soft)(qp_j)
    got = t_boxqp.solve_ocp_qp(qp_t, n_iter=12, mehrotra=mehrotra,
                               soft_x=SOFT_RHO if soft else None)
    assert bool(torch.isfinite(got.dx).all()) and got.gap.shape == (4,)
    np.testing.assert_allclose(got.dx.numpy(), np.asarray(want.dx), atol=5e-4)
    np.testing.assert_allclose(got.du.numpy(), np.asarray(want.du), atol=5e-4)
    _close(got.gap, want.gap, 1e-4)


def test_a_scenario_at_gap_tol_is_frozen_as_in_jax():
    """gap_tol = 1e-4 with scenarios of different difficulty (wide boxes in
    scenario 0, tight ones in the rest): each scenario's result after 14
    iterations is its result after the iteration at which its gap first
    reached the tolerance, exactly; scenario 0 gets there before some other
    scenario; and the port matches JAX's vmapped solver at the same gap_tol."""
    B, n_iter, tol = 4, 14, 1e-4
    data = _qp(5, B, box_x=0.4)
    data[7][0], data[8][0] = -5.0, 5.0  # scenario 0: state bounds far away
    data[7][:, 0], data[8][:, 0] = -1e8, 1e8
    qp_t = t_boxqp.OcpQpData(*[torch.as_tensor(a) for a in data])
    runs = [t_boxqp.solve_ocp_qp(qp_t, n_iter=n, mehrotra=True, gap_tol=tol)
            for n in range(n_iter + 1)]
    reached = [next((n for n, r in enumerate(runs) if float(r.gap[b]) <= tol), None)
               for b in range(B)]
    assert reached[0] is not None and reached[0] < n_iter, reached
    assert any(k is None or k > reached[0] for k in reached[1:]), reached
    final = runs[-1]
    for b, k in enumerate(reached):
        if k is not None:
            assert torch.equal(final.dx[b], runs[k].dx[b]) and torch.equal(final.du[b], runs[k].du[b])
    qp_j = j_boxqp.OcpQpData(*[jnp.asarray(a) for a in data])
    want = _jax_qp(n_iter, True, False, gap_tol=tol)(qp_j)
    np.testing.assert_allclose(final.dx.numpy(), np.asarray(want.dx), atol=5e-4)
    np.testing.assert_allclose(final.du.numpy(), np.asarray(want.du), atol=5e-4)


def test_indefinite_guu_is_nan_in_its_scenario_only():
    """Scenario 1's input cost at stage 3 is -5 I, so its Guu there is not
    positive definite: JAX's vmapped Riccati gives NaN in that scenario
    alone, and so does the port (where torch.linalg.cholesky would raise for
    the whole batch); the box QP carries that NaN in scenario 1 only."""
    B, T, nx, nu = 3, 8, 12, 4
    lq = _lq(3, B, T, nx, nu)
    lq[5][1, 3] = -5.0 * np.eye(nu, dtype=F32)
    lq_j, lq_t = _both(j_riccati.LqProblem, t_riccati.LqProblem, lq)
    dx0 = np.zeros((B, nx), F32)
    want = jax.jit(jax.vmap(j_riccati.riccati_solve))(lq_j, jnp.asarray(dx0))
    got = t_riccati.riccati_solve(lq_t, torch.as_tensor(dx0))
    for g, w in ((got.dx, want.dx), (got.du, want.du)):
        w = np.asarray(w)
        assert np.isnan(w[1]).any() and np.isfinite(w[[0, 2]]).all()
        assert torch.isnan(g[1]).any() and bool(torch.isfinite(g[[0, 2]]).all())
        assert torch.equal(torch.isnan(g), torch.as_tensor(np.isnan(w)))
        np.testing.assert_allclose(g[[0, 2]].numpy(), w[[0, 2]], atol=1e-4)
    qp = t_boxqp.OcpQpData(*[torch.as_tensor(a) for a in _qp(3, B, T)[:5]], lq_t.Ruu,
                           *[torch.as_tensor(a) for a in _qp(3, B, T)[6:]])
    sol = t_boxqp.solve_ocp_qp(qp, n_iter=4)
    assert torch.isnan(sol.du[1]).any() and bool(torch.isfinite(sol.du[[0, 2]]).all())


def test_parallel_scan_raises_naming_its_item():
    qp = t_boxqp.OcpQpData(*[torch.as_tensor(a) for a in _qp(0, 1, T=3)])
    with pytest.raises(t_boxqp.UnsupportedPathError, match="item 13"):
        t_boxqp.solve_ocp_qp(qp, parallel_scan=True)

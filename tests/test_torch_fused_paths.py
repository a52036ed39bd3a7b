"""The step paths that the fused window (bench.py's `BENCH_FUSED=1`) captures
beyond the lanes-fused step, on the CPU: the Riccati recursion's solves
through the inverse of Guu's Cholesky factor (what makes the `xla` step
capturable: `torch.cholesky_solve` goes to MAGMA, which a capturing stream
refuses) against the JAX package's `ops/riccati.py`; the `xla` step never
reaching `torch.cholesky_solve`; and the window on the `xla` backend and on
the `lanes` path (forward-mode linearization) bit for bit the chained loop
with the early exit on."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops import riccati as j_riccati
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.ops import riccati as t_riccati
from gpmpc_tpu_torch.ops import riccati_parallel as t_riccati_parallel
from gpmpc_tpu_torch.parallel.batch import batched_gpmpc_step
from gpmpc_tpu_torch.parallel.fused import FusedWindow
from gpmpc_tpu_torch.parallel.mesh import tree_leaves
from tests._torch_threads import _one_thread  # noqa: F401
from tests.test_torch_bench import BENCH, HORIZON

F32 = np.float32
B = 4
RICCATI_TOL = 1e-4  # of each array's scale, float32 on both sides
INDEFINITE = 1  # the scenario whose Guu is made indefinite


def _lq(seed, Bn, T, nx, nu, indefinite=None):
    """Random stage data (float32, batch-first): A near I, diagonal positive
    costs; in scenario `indefinite` the last stage's Ruu is -10 I, so Guu
    there is not positive definite."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.1 * rng.normal(size=(Bn, T, nx, nx))
    Bm = 0.4 * rng.normal(size=(Bn, T, nx, nu))
    r = 0.05 * rng.normal(size=(Bn, T, nx))
    Qxx = np.einsum("btk,kl->btkl", rng.uniform(0.5, 2.0, (Bn, T + 1, nx)), np.eye(nx))
    qx = 0.5 * rng.normal(size=(Bn, T + 1, nx))
    Ruu = np.einsum("btk,kl->btkl", rng.uniform(0.5, 2.0, (Bn, T, nu)), np.eye(nu))
    ru = 0.5 * rng.normal(size=(Bn, T, nu))
    if indefinite is not None:
        Ruu[indefinite, T - 1] = -10.0 * np.eye(nu)
    return [a.astype(F32) for a in (A, Bm, r, Qxx, qx, Ruu, ru)]


@pytest.mark.parametrize("solver", ["sequential", "parallel"])
@pytest.mark.parametrize("nx,nu", [(12, 4), (4, 1), (4, 2)])
def test_riccati_solve_matches_jax_with_an_indefinite_scenario(nx, nu, solver):
    """T = 6, B = 3, scenario 1 with an indefinite Guu on its last stage:
    the port's `riccati_solve` (and the associative scan's, which solves
    through the same factor inverse) against `jax.vmap` of the JAX
    package's, both in float32. dx, du, K and kff within 1e-4 of each
    array's scale in the other scenarios; NaN in every entry of scenario 1
    (but dx's stage 0, dx0 itself) on both sides, and only there."""
    Bn, T = 3, 6
    arrays = _lq(3, Bn, T, nx, nu, indefinite=INDEFINITE)
    dx0 = np.random.default_rng(4).normal(size=(Bn, nx)).astype(F32)
    want = jax.jit(jax.vmap(j_riccati.riccati_solve))(
        j_riccati.LqProblem(*[jnp.asarray(a) for a in arrays]), jnp.asarray(dx0))
    lq = t_riccati.LqProblem(*[torch.as_tensor(a) for a in arrays])
    solve = (t_riccati.riccati_solve if solver == "sequential"
             else t_riccati_parallel.riccati_solve_parallel)
    got = solve(lq, torch.as_tensor(dx0))
    ok = [b for b in range(Bn) if b != INDEFINITE]
    for name in ("dx", "du", "K", "kff"):
        g, w = getattr(got, name).float().numpy(), np.asarray(getattr(want, name), F32)
        if name == "dx":
            assert np.array_equal(g[:, 0], dx0) and np.array_equal(w[:, 0], dx0)
            g, w = g[:, 1:], w[:, 1:]
        assert np.isnan(w[INDEFINITE]).all() and np.isnan(g[INDEFINITE]).all(), name
        assert np.isfinite(w[ok]).all() and np.isfinite(g[ok]).all(), name
        scale = max(1.0, float(np.abs(w[ok]).max()))
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=RICCATI_TOL * scale, err_msg=name)


def test_cho_apply_is_the_cholesky_solve():
    """`cho_apply(cholesky_inverse_or_nan(G), rhs)` against float64 numpy
    solves of G x = rhs, G = M M' + I at nu = 1..4 (float32 within 1e-5 of
    the solution's scale); a matrix that is not positive definite gives NaN
    in its own solve only."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 4):
        M = rng.normal(size=(5, n, n))
        G = M @ M.transpose(0, 2, 1) + np.eye(n)
        G[2] = -G[2]
        rhs = rng.normal(size=(5, n, 3))
        f32 = partial(torch.tensor, dtype=torch.float32)
        got = t_riccati.cho_apply(t_riccati.cholesky_inverse_or_nan(f32(G)), f32(rhs)).numpy()
        want = np.linalg.solve(G, rhs)
        assert np.isnan(got[2]).all()
        ok = [0, 1, 3, 4]
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5 * np.abs(want[ok]).max())


@pytest.mark.parametrize("parallel_scan", [False, True], ids=["sequential", "pscan"])
def test_xla_step_never_reaches_cholesky_solve(monkeypatch, parallel_scan):
    """The `xla` step (bench.py's quadrotor at T = 8, B = 2, with and
    without BENCH_PSCAN) with `torch.cholesky_solve` patched to raise: it
    runs to finite actions, so no call on it goes to MAGMA's batched
    solve."""
    prob = BENCH.build_problem("quadrotor", HORIZON, device="cpu", **BENCH.FIXTURE_GP)
    cfg = BENCH.configure(prob.ctrl.cfg, {"BENCH_PSCAN": "1" if parallel_scan else "0"})

    def refuse(*args, **kw):
        raise AssertionError("torch.cholesky_solve reached")

    monkeypatch.setattr(torch, "cholesky_solve", refuse)
    with pytest.raises(AssertionError, match="reached"):
        torch.cholesky_solve(torch.eye(2), torch.eye(2))
    es, obs = prob.env_mod.env_reset(prob.env_p, 2, torch.Generator().manual_seed(0), "cpu")
    st = t_mpc.init_state(2, HORIZON, 12, 4, device="cpu")
    u, st, _ = batched_gpmpc_step(prob.model, cfg, prob.ctrl.consts, prob.gp, st, obs,
                                  backend="xla")
    assert u.shape == (2, 4) and bool(torch.isfinite(u).all())


# the step paths past the lanes-fused one: the `xla` backend and the `lanes` path's forward-mode
# linearization (BENCH_KERNEL_LIN=0), each as bench.py's knobs set them
PATHS = {"xla": ("xla", {}), "jacfwd": ("lanes", {"BENCH_KERNEL_LIN": "0"})}
_CHAINED: dict = {}


def _chained(path: str):
    """bench.py's quadrotor loop at T = 8, B = 4 on `path`, 5 chained steps
    with the early exit on: (the step for a config, the config, the initial
    carry, each step's actions, the carry before the last step, the final
    carry)."""
    if path not in _CHAINED:
        backend, knobs = PATHS[path]
        prob = BENCH.build_problem("quadrotor", HORIZON, device="cpu", **BENCH.FIXTURE_GP)
        cfg = BENCH.configure(prob.ctrl.cfg, knobs)
        assert cfg.early_exit and cfg.kernel_linearize == (knobs != PATHS["jacfwd"][1])
        step = lambda cfg_: partial(BENCH.closed_loop_step, prob, cfg_, prob.gp,  # noqa: E731
                                    backend=backend)
        es, obs = prob.env_mod.env_reset(prob.env_p, B, torch.Generator().manual_seed(0), "cpu")
        carry0 = carry = (es, t_mpc.init_state(B, HORIZON, 12, 4, device="cpu"), obs)
        us = []
        for _ in range(5):
            before = carry
            *carry, u = step(cfg)(*carry)
            us.append(u)
        _CHAINED[path] = (step, cfg, carry0, us, before, tuple(carry))
    return _CHAINED[path]


def _equal_trees(a, b) -> bool:
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("unroll", ["1", "3", "full"])
@pytest.mark.parametrize("path", list(PATHS))
def test_fused_window_equals_the_chained_loop_off_the_fused_path(path, unroll):
    """The window on the CPU (T = 8, B = 4, 5 steps; 1, 3 and all 5 steps a
    graph's worth of body, `early_exit=False`) on the `xla` backend and on
    the `lanes` path with forward-mode linearization: the trace of u[0, 0],
    the last step's actions, the carry before it and the final carry bit
    for bit the chained loop's with the early exit on."""
    step, cfg, carry0, us, before, final = _chained(path)
    window = FusedWindow(step(cfg._replace(early_exit=False)), carry0,
                         BENCH.fused_unroll(unroll, 5))
    assert torch.equal(window.run(5), torch.stack([u[0, 0] for u in us]))
    assert torch.equal(window.u, us[-1])
    assert _equal_trees(window.carry, final) and _equal_trees(window.last, before)

"""The port's device mesh (`parallel/mesh.py`) and the programs that run on
its shards, on the CPU: mesh shapes as the JAX package's `make_mesh` gives
them on the suite's virtual devices; shard, replicate and gather round
trips; the sharded `make_batched_controller_step` equal bit for bit to the
unsharded step and within tests/test_torch_step_xla.py's bar (actions
within 5e-4) of JAX's sharded step on the same inputs, in float32;
`batched_episode` rows [lo, hi) against the whole run's rows with plant
noise and randomized plants; and `seed_sweep(mesh=)` against the unsharded
sweep (bar 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.envs import cartpole_env as j_cart_env
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.models import cartpole as j_cart
from gpmpc_tpu.parallel import batch as j_batch
from gpmpc_tpu.parallel import mesh as j_mesh
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control import mpc as t_mpc
from gpmpc_tpu_torch.device import NoCudaDeviceError
from gpmpc_tpu_torch.envs import cartpole_env, drone
from gpmpc_tpu_torch.models import cartpole as t_cart
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
from gpmpc_tpu_torch.parallel import batch as t_batch
from gpmpc_tpu_torch.parallel import mesh as t_mesh
from gpmpc_tpu_torch.parallel import sweep as t_sweep
from gpmpc_tpu_torch.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict
from tests._torch_threads import _one_thread  # noqa: F401

F32 = np.float32
CPU8 = ["cpu"] * 8


def test_mesh_shapes_match_jax():
    """tests/test_parallel.py's shapes: 1-D over 8 devices and (4, 2) over
    ("data", "stage"), as JAX's make_mesh gives them; each local slot's
    shard of each axis."""
    for args, kw in (((8,), {}), ((8,), dict(axis_names=("data", "stage"), shape=(4, 2)))):
        jm, tm = j_mesh.make_mesh(*args, **kw), t_mesh.make_mesh(*args, devices=CPU8, **kw)
        assert tm.devices.shape == jm.devices.shape
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.shape == dict(jm.shape) and tm.size == jm.size
        assert tm.rank == 0 and tm.world_size == 1 and len(tm.local_devices) == 8
    mesh2 = t_mesh.make_mesh(8, axis_names=("data", "stage"), shape=(4, 2), devices=CPU8)
    assert t_mesh.batch_spec(mesh2).index == [0, 0, 1, 1, 2, 2, 3, 3]
    assert t_mesh.batch_spec(mesh2, "stage").index == [0, 1] * 4
    assert t_mesh.batch_spec(mesh2).rows(8) == [(0, 2), (0, 2), (2, 4), (2, 4), (4, 6), (4, 6),
                                                (6, 8), (6, 8)]
    with pytest.raises(ValueError, match=r"mesh shape \(3, 2\) != 8 devices"):
        t_mesh.make_mesh(8, axis_names=("data", "stage"), shape=(3, 2), devices=CPU8)
    with pytest.raises(ValueError, match="needs 8 devices a process and this process has 4"):
        t_mesh.make_mesh(8, devices=["cpu"] * 4)


def test_shard_replicate_gather_round_trip():
    """A tree of float, int and bool leaves (a NamedTuple inside a dict) cut
    over 4 shards and over the (4, 2) mesh's data axis: each shard holds its
    rows, `gather` gives the tree back exactly, `replicate` a copy per
    device; an axis that does not divide raises naming both sizes."""
    rng = np.random.default_rng(0)
    st = t_mpc.MpcState(traj_step=torch.arange(8, dtype=torch.int32),
                        X_warm=torch.as_tensor(rng.normal(size=(8, 3, 2)), dtype=torch.float32),
                        U_warm=torch.as_tensor(rng.normal(size=(8, 2, 1)), dtype=torch.float32))
    tree = {"st": st, "flag": torch.arange(8) % 3 == 0}
    for mesh in (t_mesh.make_mesh(4, devices=["cpu"] * 4),
                 t_mesh.make_mesh(8, axis_names=("data", "stage"), shape=(4, 2), devices=CPU8)):
        sh = t_mesh.shard_leading_axis(tree, mesh)
        assert sh.count == 4 and len(sh.shards) == mesh.size
        for i, part in zip(sh.index, sh.shards):
            assert part["st"].traj_step.tolist() == [2 * i, 2 * i + 1]
            assert isinstance(part["st"], t_mpc.MpcState)
        back = t_mesh.gather(sh, mesh)
        assert all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(t_mesh.tree_leaves(back), t_mesh.tree_leaves(tree)))
        copies = t_mesh.replicate(tree, mesh)
        assert len(copies) == mesh.size
        assert all(torch.equal(c["st"].X_warm, st.X_warm) for c in copies)
    with pytest.raises(ValueError, match=r"leading axis of 6 does not divide into 4 shards"):
        t_mesh.shard_leading_axis(torch.zeros(6, 2), t_mesh.make_mesh(4, devices=["cpu"] * 4))


def test_init_distributed_without_a_card_raises(monkeypatch):
    """init_distributed puts its rank on the card by default, as every entry
    point of the port does: with no card and no device="cpu" it raises
    before it joins a group."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(NoCudaDeviceError, match='device="cpu"'):
        t_mesh.init_distributed("127.0.0.1:1", 2, 0)
    assert t_mesh._DIST is None and not torch.distributed.is_initialized()


def test_mesh_in_a_process_group_lists_every_ranks_devices(monkeypatch):
    """Inside a group each slot holds the device of the rank that owns it:
    rank 0 of two, on cuda:0, sees rank 1's slot as cuda:1 (the all_gather
    stubbed with rank 1's reply)."""
    sent = []

    def all_gather_cat(t, backend, world_size):
        sent.append(t.tolist())
        return torch.cat([t, torch.tensor([[1, 1]])])

    monkeypatch.setattr(t_mesh, "_DIST", t_mesh.DistributedState(0, 2, 0, "gloo",
                                                                 torch.device("cpu")))
    monkeypatch.setattr(t_mesh, "_all_gather_cat", all_gather_cat)
    mesh = t_mesh.make_mesh(devices=["cuda:0"])
    assert sent == [[[1, 0]]]
    assert list(mesh.devices) == [torch.device("cuda:0"), torch.device("cuda:1")]
    assert mesh.ranks.tolist() == [0, 1] and mesh.world_size == 2 and mesh.backend == "gloo"
    assert mesh.local_devices == [torch.device("cuda:0")]


def _cartpole(T):
    """tests/test_torch_step.py's cartpole set-up (bench.py's BENCH_MODEL
    configuration at horizon T) in both packages, with the committed GP."""
    env_p = j_cart_env.EnvParams.default()
    traj = np.asarray(j_cart_env.make_trajectory(env_p))
    kw = dict(horizon=T, q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05], sparse_gp=True, prob=0.95,
              max_gp_samples=40, seed=1, max_gp_points=128, sqp_iters=6, qp_iters=10)
    jc = j_gpmpc.GPMPC(j_cart.symbolic_cartpole(0.02), traj, None,
                       bounds=(j_cart.state_bounds(), j_cart.input_bounds()), **kw)
    tc = t_gpmpc.GPMPC(t_cart.symbolic_cartpole(0.02), traj, None,
                       bounds=(t_cart.state_bounds(), t_cart.input_bounds()), device="cpu", **kw)
    with np.load(convert.bench_gp_path("cartpole")) as d:
        d = dict(d)
    leaf = lambda k: jnp.asarray(d[k])  # noqa: E731
    gp_j = j_gpmpc.GpModel(
        Z=leaf("Z"), y=leaf("y"), mask=leaf("mask"),
        hypers=JGPHypers(leaf("raw_lengthscale"), leaf("raw_outputscale"), leaf("raw_noise")),
        Zs=leaf("Zs"), alpha_s=leaf("alpha_s"), var_Z=leaf("var_Z"), var_mat=leaf("var_mat"),
        var_mask=leaf("var_mask"), trained=jnp.asarray(bool(d["trained"])))
    return traj.astype(F32), jc, tc, gp_j, convert.load_bench_gp("cpu", family="cartpole")


@pytest.fixture(scope="module")
def sharded_cartpole():
    """The cartpole's xla step at T = 5, B = 8 from perturbed trajectory
    states: the port unsharded and on 4 CPU shards, and JAX's
    make_batched_controller_step(mesh=make_mesh(4)) (one compile)."""
    T, B = 5, 8
    traj, jc, tc, gp_j, gp_t = _cartpole(T)
    obs = (traj[:B] + np.random.default_rng(3).normal(0, 0.05, (B, 4))).astype(F32)
    st_t = t_mpc.init_state(B, T, 4, 1, device="cpu")
    plain = t_batch.batched_gpmpc_step(tc.model, tc.cfg, tc.consts, gp_t, st_t, torch.as_tensor(obs))
    mesh = t_mesh.make_mesh(4, devices=["cpu"] * 4)
    step = t_batch.make_batched_controller_step(tc.model, tc.cfg, mesh=mesh)
    sharded = step(tc.consts, gp_t, st_t, torch.as_tensor(obs))
    j_step = j_batch.make_batched_controller_step(jc.model, jc.cfg, mesh=j_mesh.make_mesh(4))
    st_j = jax.vmap(lambda _: j_mpc.init_state(T, 4, 1))(jnp.arange(B))
    obs_j = j_mesh.shard_leading_axis(jnp.asarray(obs), j_mesh.make_mesh(4))
    want = j_step(jc.consts, gp_j, j_mesh.shard_leading_axis(st_j, j_mesh.make_mesh(4)), obs_j)
    return mesh, plain, sharded, want


def test_sharded_step_is_the_unsharded_step_bit_for_bit(sharded_cartpole):
    """Actions, next states and every info field of the 4-shard step equal
    the unsharded step's bit for bit: the xla path solves each scenario
    alone, and each shard's outputs come back as a Sharded (the reference's
    out_shardings)."""
    mesh, plain, sharded, _ = sharded_cartpole
    assert all(isinstance(s, t_mesh.Sharded) and s.count == 4 for s in sharded)
    for got, want in zip(sharded, plain):
        pairs = list(zip(t_mesh.tree_leaves(t_mesh.gather(got, mesh)), t_mesh.tree_leaves(want)))
        assert pairs and all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                             for a, b in pairs)
    assert [tuple(u.shape) for u in sharded[0].shards] == [(2, 1)] * 4


def test_sharded_step_matches_jax_sharded_step(sharded_cartpole):
    """The port's sharded step against JAX's sharded step on the suite's
    virtual devices: actions within 5e-4 and the same clamp fraction per
    scenario. The cartpole's last SQP steps are 1e-7 to 8e-7, against a
    step_tol of 1e-6: float32 rounding there decides whether a scenario
    takes one more iteration, on either side and unsharded too, so the
    iteration counts agree within one."""
    mesh, _, sharded, want = sharded_cartpole
    u, _, info = (t_mesh.gather(s, mesh) for s in sharded)
    np.testing.assert_allclose(u.numpy(), np.asarray(want[0]), atol=5e-4)
    its = np.asarray(want[2].n_iters)
    assert np.abs(info.n_iters.numpy() - its).max() <= 1, (info.n_iters.tolist(), its.tolist())
    np.testing.assert_array_equal(info.clamp_frac.numpy(), np.asarray(want[2].clamp_frac))


@pytest.mark.parametrize("family", ["quadrotor", "cartpole"])
def test_episode_rows_are_the_full_runs_rows(family):
    """`batched_episode(rows=(lo, hi))` on xla with process noise and
    randomized plants (param_scale 0.1): its initial states are rows
    [lo, hi) of the whole batch's run exactly, and its observations,
    actions and rewards within 1e-5 of those rows (one wrong draw moves an
    observation by noise_std sqrt(dt) ~ 7e-3; on the CPU a batch of another
    width can take another vectorized path through an elementwise op, 1e-8
    here); a run without `rows` draws as before (an explicit (0, batch))."""
    B, T, steps = 6, 3, 3
    if family == "quadrotor":
        prior = reference_prior_dict()
        model, env_mod = symbolic_attitude(dt=0.02, params=prior), drone
        env_p = drone.EnvParams.default()._replace(noise_std=0.05)
        ctrl = t_gpmpc.GPMPC(model, drone.make_trajectory(env_p, "cpu").numpy(), prior, horizon=T,
                             q_mpc=Q_MPC, r_mpc=R_MPC, sqp_iters=2, qp_iters=5, device="cpu")
    else:
        model, env_mod = t_cart.symbolic_cartpole(0.02), cartpole_env
        env_p = cartpole_env.EnvParams.default()._replace(noise_std=0.05)
        ctrl = t_gpmpc.GPMPC(model, cartpole_env.make_trajectory(env_p, "cpu").numpy(), None,
                             horizon=T, q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05], sqp_iters=2,
                             qp_iters=5, bounds=(t_cart.state_bounds(), t_cart.input_bounds()),
                             device="cpu")
    run = lambda rows=None: t_batch.batched_episode(  # noqa: E731
        model, ctrl.cfg, env_p, ctrl.consts, convert.load_bench_gp("cpu", family=family),
        torch.Generator().manual_seed(4), steps, B, param_scale=0.1, env_mod=env_mod,
        backend="xla", rows=rows)
    full = run()
    assert torch.equal(full.obs, run((0, B)).obs)
    for lo, hi in ((0, 2), (2, 5), (5, 6)):
        part = run((lo, hi))
        assert torch.equal(part.obs[:, 0], full.obs[lo:hi, 0])
        for a, b in zip(part, full):
            np.testing.assert_allclose(a.numpy(), b[lo:hi].numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match=r"rows \[4, 8\) of a batch of 6"):
        run((4, 8))


def test_seed_sweep_on_two_shards_matches_the_unsharded_sweep():
    """seed_sweep(mesh=) over 2 CPU shards (4 seeds, 1 epoch, xla): the cost
    matrix within 1e-4 of the unsharded one (0 observed: every draw is made
    at the population's width, and the xla path solves each seed alone),
    the fitted hypers within 1e-5 of the unsharded sweep's; an indivisible
    seed count raises as in the reference."""
    envp = drone.EnvParams.default()
    prior = reference_prior_dict()
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = t_gpmpc.GPMPC(model, drone.make_trajectory(envp, "cpu").numpy(), prior, horizon=3,
                         q_mpc=Q_MPC, r_mpc=R_MPC, sqp_iters=1, qp_iters=6, device="cpu")
    kw = dict(n_seeds=4, n_epochs=1, n_steps=6, samples_per_epoch=4, max_inducing=4,
              gp_iters=5, backend="xla")
    mesh = t_mesh.make_mesh(2, devices=["cpu", "cpu"])
    res = t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts, mesh=mesh, **kw)
    ref = t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts, **kw)
    delta = float((res.costs - ref.costs).abs().max())
    print(f"sharded sweep: max |cost - unsharded| = {delta:.3e}")
    assert res.costs.shape == (2, 4) and delta <= 1e-4
    for a, b in zip(res.gp.hypers, ref.gp.hypers):  # the dry run's bar on fitted hypers
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="n_seeds=3 must divide over 2 devices"):
        t_sweep.seed_sweep(model, ctrl.cfg, envp, ctrl.consts, mesh=mesh, **dict(kw, n_seeds=3))

"""`utils/checkpoint.py` of the port against the JAX package's: the same
file format, so a snapshot written by either package loads into the other
(leaf keys equal to the reference's on the same structures, values bit for
bit), and the port's `ExperimentCheckpoint` round trip on its `GPMPC`."""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.control import gpmpc as j_gpmpc
from gpmpc_tpu.control import mpc as j_mpc
from gpmpc_tpu.gp.exact_gp import GPHypers as JGPHypers
from gpmpc_tpu.utils import checkpoint as j_ckpt
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.control import gpmpc as t_gpmpc
from gpmpc_tpu_torch.control.mpc import MpcState
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude as t_sym
from gpmpc_tpu_torch.models.trajectory import figure_eight_trajectory
from gpmpc_tpu_torch.utils import checkpoint as t_ckpt
from gpmpc_tpu_torch.utils.benchkit import reference_prior_dict

F32 = np.float32
HYPERS = ("raw_lengthscale", "raw_outputscale", "raw_noise")


class Pair(NamedTuple):
    first: object
    second: object


def bench_gp_leaves() -> dict:
    with np.load(convert.bench_gp_path("quadrotor")) as f:
        return {k: np.asarray(v) for k, v in f.items()}


def trees(seed: int = 0):
    """The same tree for both packages: a server snapshot's {"states", "obs",
    "gp"} plus a list, a plain tuple, a None and a NamedTuple of arrays."""
    rng = np.random.default_rng(seed)
    d = bench_gp_leaves()
    X, U = rng.normal(size=(4, 7, 12)).astype(F32), rng.normal(size=(4, 6, 4)).astype(F32)
    step, obs = np.arange(4, dtype=np.int32), rng.normal(size=(4, 12)).astype(F32)
    extra = [rng.normal(size=(2,)).astype(F32), (np.int64(3), None)]
    jl = lambda k: jnp.asarray(d[k])  # noqa: E731
    tree_j = {
        "states": j_mpc.MpcState(traj_step=jnp.asarray(step), X_warm=jnp.asarray(X),
                                 U_warm=jnp.asarray(U)),
        "obs": jnp.asarray(obs),
        "gp": j_gpmpc.GpModel(
            Z=jl("Z"), y=jl("y"), mask=jl("mask"), hypers=JGPHypers(*[jl(k) for k in HYPERS]),
            Zs=jl("Zs"), alpha_s=jl("alpha_s"), var_Z=jl("var_Z"), var_mat=jl("var_mat"),
            var_mask=jl("var_mask"), trained=jnp.asarray(bool(d["trained"]))),
        "extra": Pair(jnp.asarray(extra[0]), (jnp.asarray(extra[1][0]), None)),
    }
    tree_t = {
        "states": MpcState(traj_step=torch.as_tensor(step), X_warm=torch.as_tensor(X),
                           U_warm=torch.as_tensor(U)),
        "obs": torch.as_tensor(obs),
        "gp": convert.gp_model_from_numpy(d, "cpu"),
        "extra": Pair(torch.as_tensor(extra[0]), (torch.as_tensor(extra[1][0]), None)),
    }
    return tree_j, tree_t


def npz(path) -> dict:
    with np.load(str(path) + ".npz") as f:
        return {k: f[k] for k in f.files}


def test_leaf_keys_are_the_references(tmp_path):
    """Both packages write the same keys, in the reference's format, and the
    same arrays for the same tree."""
    tree_j, tree_t = trees()
    j_ckpt.save_pytree(tmp_path / "j", tree_j, metadata={"tile": 4})
    t_ckpt.save_pytree(tmp_path / "t", tree_t, metadata={"tile": 4})
    a, b = npz(tmp_path / "j"), npz(tmp_path / "t")
    assert sorted(a) == sorted(b)
    for key in ("['states']/.X_warm", "['gp']/.hypers/.raw_noise", "['extra']/.second/[0]",
                "['gp']/.trained"):
        assert key in b, key
    assert [k for k, _ in t_ckpt.flatten_with_paths(tree_t)] == list(a)  # the reference's order
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(b[k], a[k].astype(b[k].dtype), err_msg=k)
    assert t_ckpt.load_metadata(tmp_path / "t") == j_ckpt.load_metadata(tmp_path / "j") == {"tile": 4}


def test_reference_snapshot_loads_into_the_port_and_back(tmp_path):
    """A snapshot written by the reference loads into the port's structure
    (each leaf a tensor of the port's dtype, equal bit for bit), and one
    written by the port loads into the reference's."""
    tree_j, _ = trees(0)
    _, like_t = trees(1)  # other values, the same structure
    j_ckpt.save_pytree(tmp_path / "ref", tree_j, metadata={"free": [0, 2]})
    got = t_ckpt.load_pytree(tmp_path / "ref", like_t)
    assert isinstance(got["states"], MpcState) and isinstance(got["gp"], t_gpmpc.GpModel)
    assert got["extra"].second[1] is None
    for (k, g), (_, w) in zip(t_ckpt.flatten_with_paths(got), t_ckpt.flatten_with_paths(like_t)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
    np.testing.assert_array_equal(got["states"].X_warm.numpy(), np.asarray(tree_j["states"].X_warm))
    np.testing.assert_array_equal(got["gp"].var_mat.numpy(), np.asarray(tree_j["gp"].var_mat))
    assert bool(got["gp"].trained) == bool(tree_j["gp"].trained)

    _, tree_t = trees(2)
    t_ckpt.save_pytree(tmp_path / "port", tree_t, metadata={"free": [1]})
    back = j_ckpt.load_pytree(tmp_path / "port", tree_j)
    np.testing.assert_array_equal(np.asarray(back["obs"]), tree_t["obs"].numpy())
    np.testing.assert_array_equal(np.asarray(back["states"].traj_step), tree_t["states"].traj_step.numpy())
    np.testing.assert_array_equal(np.asarray(back["gp"].alpha_s), tree_t["gp"].alpha_s.numpy())
    assert j_ckpt.load_metadata(tmp_path / "port") == {"free": [1]}


def test_load_refuses_a_missing_or_misshapen_leaf(tmp_path):
    _, tree_t = trees()
    t_ckpt.save_pytree(tmp_path / "s", {"obs": tree_t["obs"]})
    with pytest.raises(KeyError, match="states"):
        t_ckpt.load_pytree(tmp_path / "s", {"obs": tree_t["obs"], "states": tree_t["states"]})
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.load_pytree(tmp_path / "s", {"obs": torch.zeros(5, 12)})


def _controller(max_gp_samples: int = 8, max_gp_points: int = 32):
    traj = figure_eight_trajectory(n_steps=64, dt=0.02, device="cpu").numpy()
    prior = reference_prior_dict()
    return t_gpmpc.GPMPC(t_sym(dt=0.02, params=prior), traj, prior, horizon=4, q_mpc=[1.0] * 12,
                         r_mpc=[1.0] * 4, sparse_gp=True, max_gp_samples=max_gp_samples,
                         max_gp_points=max_gp_points, seed=3, sqp_iters=1, qp_iters=2,
                         device="cpu")


def test_experiment_checkpoint_round_trip(tmp_path):
    """save -> restore into a fresh controller: the GP, the inducing-draw
    generator (its next draw), the numpy RNG (its next draw), the dataset
    and the runs come back; `latest_epoch` finds the newest."""
    ctrl = _controller()
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, (16, 7)).astype(F32)
    y = rng.normal(0, 0.3, (16, 3)).astype(F32)
    ctrl.train_gp(x, y, lr=0.05, iterations=3)
    runs = {0: {"obs": np.zeros((3, 12), F32), "controller_data": {"clamp": np.ones(3, F32)}}}
    ckpt = t_ckpt.ExperimentCheckpoint(tmp_path / "ckpt")
    ckpt.save(1, ctrl, x[:4], y[:4], rng=rng)
    ckpt.save(2, ctrl, x, y, rng=rng, train_runs=runs, test_runs=runs)
    assert ckpt.latest_epoch() == 2
    want_np = rng.normal(size=4)
    want_gen = torch.rand(5, generator=ctrl._gp_generator)

    fresh, rng2 = _controller(), np.random.default_rng(99)
    torch.rand(7, generator=fresh._gp_generator)  # move it off the saved state
    x2, y2, train_runs, test_runs = ckpt.restore(2, fresh, rng=rng2)
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(y2, y)
    for (k, a), (_, b) in zip(t_ckpt.flatten_with_paths(fresh.gp_model),
                              t_ckpt.flatten_with_paths(ctrl.gp_model)):
        assert torch.equal(a, b), k
    np.testing.assert_array_equal(rng2.normal(size=4), want_np)
    assert torch.equal(torch.rand(5, generator=fresh._gp_generator), want_gen)
    np.testing.assert_array_equal(train_runs[0]["controller_data"]["clamp"], np.ones(3, F32))
    assert test_runs[0]["obs"].shape == (3, 12)


def test_reference_experiment_checkpoint_restores_into_the_port(tmp_path):
    """The reference's `ExperimentCheckpoint.save` of a controller holding the
    benchmark GP restores its GP and dataset into the port's `GPMPC` of the
    same GP shapes (its JAX key is not a torch generator state: the port's
    generator stays as it was)."""
    d = bench_gp_leaves()
    gp_j = trees()[0]["gp"]

    class RefController:  # the attributes the reference's save reads
        gp_model, _gp_key, sparse = gp_j, jnp.asarray([0, 7], jnp.uint32), True

    x = np.arange(14, dtype=F32).reshape(2, 7)
    j_ckpt.ExperimentCheckpoint(tmp_path).save(4, RefController, x, x[:, :3])
    ctrl = _controller(d["Zs"].shape[1], d["Z"].shape[1])
    state = ctrl._gp_generator.get_state()
    x2, y2, train_runs, _ = t_ckpt.ExperimentCheckpoint(tmp_path).restore(4, ctrl)
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(y2, x[:, :3])
    assert train_runs is None
    np.testing.assert_array_equal(ctrl.gp_model.var_mat.numpy(), d["var_mat"])
    assert bool(ctrl.gp_model.trained)
    assert torch.equal(ctrl._gp_generator.get_state(), state)

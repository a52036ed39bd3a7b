"""The multi-device dry run: one training step over an n-device mesh at tiny
shapes, held against the same step unsharded. Port of the reference's
`__graft_entry__.py::dryrun_multichip`.

The training step is the system's multi-device program: closed-loop GP-MPC
rollouts sharded over the scenario axis, the transitions gathered and
preprocessed into GP targets, and the GP ensemble refit on them. The same
step runs unsharded on the same inputs, and the two must agree at the
reference's four bars: the collected data and the fitted hypers within
1e-5, the posterior predictions within 1e-3 (the FITC factors solve an
ill-conditioned system, so a 1e-8 hyper difference moves them while the
posterior they represent stays put) and the mean reward within 1e-5. Then a
weak-scaling table of `make_batched_controller_step` at 1, 2, 4 and 8
devices of the mesh's, and the sharded seed sweep against the unsharded one
within 1e-4. On one card with `devices=["cuda:0"] * n` the table checks the
sharded program at every size; it is not a measure of scaling.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpmpc_tpu_torch.control import mpc as mpc_mod
from gpmpc_tpu_torch.control.gpmpc import (
    GPMPC,
    gp_variances,
    pack_training_data,
    preprocess_data_jnp,
    slice_gp_inputs,
    train_gp_models,
)
from gpmpc_tpu_torch.device import resolve
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.gp.exact_gp import softplus
from gpmpc_tpu_torch.gp.kernels import se_kernel
from gpmpc_tpu_torch.models.symbolic import symbolic_attitude
from gpmpc_tpu_torch.parallel.batch import (
    EpisodeResult,
    batched_episode,
    make_batched_controller_step,
)
from gpmpc_tpu_torch.parallel.mesh import Sharded, batch_spec, gather, make_mesh, tree_map
from gpmpc_tpu_torch.parallel.sweep import seed_sweep
from gpmpc_tpu_torch.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict

BARS = dict(data=1e-5, hypers=1e-5, predictions=1e-3, reward=1e-5, sweep=1e-4)


def _sync(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def dryrun_multichip(n_devices: int, device=None, devices=None) -> dict:
    """Run the dry run on `n_devices` devices: the first n cards, or the
    first n of `devices` (`["cpu"] * n` on the CPU, `["cuda:0"] * n` for n
    shards on one card). `device` is where the controller and the unsharded
    runs live (default `devices[0]`, else the card). The episodes and the
    table take the reference's default path, `xla`. Raises AssertionError
    when a bar is missed; prints one summary line and returns the measured
    deltas and the table."""
    home = resolve(device if device is not None else (devices[0] if devices else None))
    horizon, n_steps, per_dev = 5, 3, 2
    B = n_devices * per_dev
    mesh = make_mesh(n_devices, devices=devices)
    prior = reference_prior_dict()
    env_params = drone.EnvParams.default()._replace(n_steps=32)
    traj = drone.make_trajectory(env_params, "cpu").numpy()
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(model, traj, prior, horizon=horizon, q_mpc=Q_MPC, r_mpc=R_MPC, sparse_gp=True,
                 max_gp_samples=8, seed=1, max_gp_points=B * n_steps, sqp_iters=3, qp_iters=5,
                 device=home)
    cfg, max_points, backend = ctrl.cfg, B * n_steps, "xla"

    def rollouts(dev, rows):
        on = lambda t: tree_map(lambda x: x.to(dev), t)  # noqa: E731
        return batched_episode(model, cfg, env_params, on(ctrl.consts), on(ctrl.gp_model),
                               torch.Generator(device=dev).manual_seed(0), n_steps, B,
                               backend=backend, rows=rows)

    def refit(ep: EpisodeResult):
        # preprocess every transition into GP targets, refit the ensemble on all of them
        x = ep.obs[:, :-1].reshape(-1, 12)
        x_next = ep.obs[:, 1:].reshape(-1, 12)
        u = ep.actions.reshape(-1, 4)
        xi, ti = preprocess_data_jnp(model, prior["a"], prior["b"], x, u, x_next)
        data = pack_training_data(xi, ti, max_points)
        gp = train_gp_models(data, torch.Generator(device=home).manual_seed(1), sparse=True,
                             max_inducing=8, n_train=3, lr=0.05)
        return gp, ep.rewards.mean()

    # the training step, its rollouts sharded over the scenario axis, then unsharded
    spec = batch_spec(mesh)
    shards = [rollouts(d, r) for d, r in zip(mesh.local_devices, spec.rows(B))]
    ep_sharded = gather(Sharded(shards, spec.index, spec.count, mesh.local_devices), mesh)
    gp_new, mean_reward = refit(tree_map(lambda t: t.to(home), ep_sharded))
    _sync(mesh.local_devices)
    assert bool(gp_new.trained.all())
    gp_ref, reward_ref = refit(rollouts(home, None))

    probe = torch.as_tensor(np.random.default_rng(0).normal(0, 0.3, (64, 7)), dtype=torch.float32,
                            device=home)
    zs = slice_gp_inputs(probe)

    def mean_preds(gp):
        ell, sf2 = softplus(gp.hypers.raw_lengthscale), softplus(gp.hypers.raw_outputscale)
        return torch.stack([se_kernel(zs[g], gp.Zs[g], ell[g], sf2[g]) @ gp.alpha_s[g]
                            for g in range(zs.shape[0])])

    deltas = dict(
        data=max(float((a - b).abs().max())
                 for a, b in ((gp_new.Z, gp_ref.Z), (gp_new.y, gp_ref.y))),
        hypers=max(float((a - b).abs().max()) for a, b in zip(gp_new.hypers, gp_ref.hypers)),
        predictions=max(float((mean_preds(gp_new) - mean_preds(gp_ref)).abs().max()),
                        float((gp_variances(gp_new, zs) - gp_variances(gp_ref, zs)).abs().max())),
        reward=abs(float(mean_reward) - float(reward_ref)),
    )
    for k, v in deltas.items():
        assert v <= BARS[k], f"sharded {k} diverged from unsharded: delta {v:.3e} (bar {BARS[k]})"

    # the weak-scaling table of the batched controller step at every mesh size that exists
    per_dev_table = 16
    table = []
    for d in (1, 2, 4, 8):
        if d > n_devices:
            break
        mesh_d = make_mesh(d, devices=None if devices is None else list(devices)[:d])
        step_d = make_batched_controller_step(model, cfg, mesh=mesh_d)
        Bd = d * per_dev_table
        obs_d = torch.as_tensor(traj[0], device=home)[None].expand(Bd, -1).contiguous()
        states_d = mpc_mod.init_state(Bd, horizon, 12, 4, device=home)
        u, states_sh, _ = step_d(ctrl.consts, ctrl.gp_model, states_d, obs_d, backend=backend)
        u_full = gather(u, mesh_d)  # a host read, the barrier
        t0 = time.perf_counter()
        for _ in range(3):
            u, states_sh, _ = step_d(ctrl.consts, ctrl.gp_model, states_sh, obs_d, backend=backend)
        gather(u, mesh_d).cpu()
        dt_s = (time.perf_counter() - t0) / 3
        assert bool(torch.isfinite(u_full).all()), f"non-finite actions at mesh size {d}"
        table.append((d, Bd, Bd / dt_s))
    scaling = "; ".join(f"{d}dev B={Bd}: {sps:.0f} solves/s" for d, Bd, sps in table)

    # the population-parallel learning sweep with the seed axis sharded
    kw = dict(n_seeds=n_devices, n_epochs=1, n_steps=n_steps, samples_per_epoch=n_steps,
              max_inducing=4, gp_iters=2, gp_lr=0.05, backend=backend)
    res = seed_sweep(model, cfg, env_params, ctrl.consts, prior, mesh=mesh, **kw)
    assert res.costs.shape == (2, n_devices) and bool(torch.isfinite(res.costs).all())
    res_ref = seed_sweep(model, cfg, env_params, ctrl.consts, prior, **kw)
    deltas["sweep"] = float((res.costs - res_ref.costs).abs().max())
    assert deltas["sweep"] <= BARS["sweep"], (
        f"sharded sweep diverged from unsharded: max cost delta {deltas['sweep']:.3e}")
    where = ", ".join(str(d) for d in mesh.devices.ravel())
    print(f"dryrun_multichip({n_devices}) on [{where}]: ok, mean_reward={float(mean_reward):.4f}, "
          f"sharded-vs-unsharded parity: data {deltas['data']:.3e}, hypers {deltas['hypers']:.3e}, "
          f"predictions {deltas['predictions']:.3e}, reward {deltas['reward']:.3e}, sweep max "
          f"cost delta {deltas['sweep']:.3e}; weak-scaling [{scaling}] (devices that share a "
          f"card check the program at each size, not scaling); sharded-sweep mean cost "
          f"{float(res.costs[-1].mean()):.4f}", flush=True)
    return dict(deltas=deltas, table=table)

"""Multi-seed GP-MPC learning sweep: S independent learning runs batched.
Port of `gpmpc_tpu/parallel/sweep.py`'s `SweepResult` and `seed_sweep` on the
lanes backend.

Each epoch collects one closed-loop episode per seed with that seed's current
GPs (epoch 1 with the untrained GP, whose zero mean is the prior controller),
samples `samples_per_epoch` of its transitions without replacement,
accumulates them in a padded per-seed buffer, refits every seed's G GPs on
everything seen so far (one `train_gp_models` over S x G) and scores a fixed
per-seed held-out evaluation episode. Row 0 of the cost matrix is the prior
controller's baseline on the same evaluation episodes. All seeds' episodes
run as one batch of S scenarios (a GP population, one model per scenario).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.control.gpmpc import (
    GpModel,
    GpMpcConsts,
    UnsupportedPathError,
    empty_gp_model,
    model_spec,
    pack_training_buffers,
    train_gp_models,
)
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.ops.sqp import SqpConfig
from gpmpc_tpu_torch.parallel.batch import batched_episode


class SweepResult(NamedTuple):
    costs: torch.Tensor  # (n_epochs+1, S) summed squared tracking error of each eval episode
    n_points: torch.Tensor  # (n_epochs+1,) training-set size at each row
    gp: GpModel  # final per-seed GP ensembles (leaves lead with S)


class EpochInfo(NamedTuple):
    """One epoch of `seed_sweep(return_info=True)`: its wall time, the fit's
    share of it (both synchronized with the device) and the fit's Adam
    iterations until every GP froze."""

    epoch: int
    wall_s: float
    fit_s: float
    fit_iterations: int


# The generator streams, each seeded with (master_seed, stream, epoch): the
# reference folds the same three indices into its per-seed keys.
_EVAL, _COLLECT, _SAMPLE, _FIT = 0, 1, 2, 3


def _generator(device, master_seed: int, stream: int, epoch: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (master_seed * 4 + stream) * 1_000_003 + epoch)


def seed_sweep(
    model,
    cfg: SqpConfig,
    env_params,
    consts: GpMpcConsts,
    prior_params: dict | None = None,
    *,
    n_seeds: int,
    n_epochs: int,
    n_steps: int,
    samples_per_epoch: int,
    max_inducing: int,
    sparse: bool = True,
    ard: bool = False,
    gp_iters: int = 100,
    gp_lr: float = 0.05,
    master_seed: int = 0,
    mesh=None,
    env_mod=drone,
    backend: str = "lanes",
    return_info: bool = False,
) -> SweepResult | tuple[SweepResult, list[EpochInfo]]:
    """`n_seeds` GP-MPC learning runs on the device of `consts`. The residual
    structure comes from the model's ResidualSpec and `env_mod` selects the
    plant family; `prior_params` is accepted for the reference's signature
    and unused. A seed's randomness (initial states, samples, inducing
    points) comes from torch generators seeded from `master_seed`, so the
    same master seed reproduces a sweep. With `return_info`, returns
    (result, one `EpochInfo` per epoch). A `mesh` and the `xla` backend are
    not ported and raise `UnsupportedPathError`."""
    if mesh is not None:
        raise UnsupportedPathError("seed_sweep(mesh=...) is not ported (ROADMAP.md Queue 1)")
    if backend != "lanes":
        raise UnsupportedPathError(
            f"seed_sweep(backend={backend!r}) is not ported; backend='lanes' is (ROADMAP.md Queue 1)")
    if samples_per_epoch > n_steps:
        raise ValueError(
            f"samples_per_epoch={samples_per_epoch} > n_steps={n_steps}: an episode yields "
            "n_steps transitions to sample without replacement"
        )
    dev = consts.Ad.device
    cap = n_epochs * samples_per_epoch
    max_inducing = min(max_inducing, cap)  # no more inducing points than data
    spec = model_spec(model)
    S = n_seeds

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def episode(gp, stream, epoch, gp_batched):
        return batched_episode(model, cfg, env_params, consts, gp,
                               _generator(dev, master_seed, stream, epoch), n_steps, S,
                               gp_batched=gp_batched, env_mod=env_mod)

    def eval_cost(gp, gp_batched):
        # the same held-out episode every epoch: the eval stream is not advanced
        return -episode(gp, _EVAL, 0, gp_batched).rewards.sum(dim=-1)  # (S,)

    gp0 = empty_gp_model(cap, max_inducing if sparse else cap, ard=ard, spec=spec, device=dev)
    costs = [eval_cost(gp0, False)]
    gp = GpModel(*[l[None].expand((S,) + tuple(l.shape)).contiguous() if isinstance(l, torch.Tensor)
                   else type(l)(*[h[None].expand((S,) + tuple(h.shape)).contiguous() for h in l])
                   for l in gp0])
    bufx = torch.zeros(S, cap, spec.z_dim, device=dev)
    bufy = torch.zeros(S, cap, spec.num_gps, device=dev)
    epochs = []
    for e in range(n_epochs):
        sync()
        t0 = time.perf_counter()
        # 1. one closed-loop episode per seed with its current GPs
        ep = episode(gp, _COLLECT, e, True)
        # 2. per-seed sampling without replacement, targets, accumulation
        gen = _generator(dev, master_seed, _SAMPLE, e)
        idx = torch.rand(S, n_steps, generator=gen, device=dev).argsort(dim=1)[:, :samples_per_epoch]
        take = lambda a, i: torch.gather(a, 1, i[..., None].expand(-1, -1, a.shape[-1]))  # noqa: E731
        x, u, x_next = take(ep.obs, idx), take(ep.actions, idx), take(ep.obs, idx + 1)
        xi, ti = spec.make_targets(model, x.reshape(S * samples_per_epoch, -1),
                                   u.reshape(S * samples_per_epoch, -1),
                                   x_next.reshape(S * samples_per_epoch, -1))
        start = e * samples_per_epoch
        bufx[:, start:start + samples_per_epoch] = xi.reshape(S, samples_per_epoch, -1)
        bufy[:, start:start + samples_per_epoch] = ti.reshape(S, samples_per_epoch, -1)
        # 3. refit every seed's ensemble on its accumulated data (S x G GPs at once)
        sync()
        t_fit = time.perf_counter()
        gp, info = train_gp_models(
            pack_training_buffers(bufx, bufy, (e + 1) * samples_per_epoch, spec),
            _generator(dev, master_seed, _FIT, e), sparse=sparse, max_inducing=max_inducing,
            n_train=gp_iters, lr=gp_lr, ard=ard, return_info=True,
        )
        sync()
        fit_s = time.perf_counter() - t_fit
        # 4. the held-out evaluation with the refit controllers
        costs.append(eval_cost(gp, True))
        sync()
        epochs.append(EpochInfo(e, time.perf_counter() - t0, fit_s, info.iterations))
    n_points = torch.arange(n_epochs + 1, device=dev) * samples_per_epoch
    result = SweepResult(costs=torch.stack(costs), n_points=n_points, gp=gp)
    return (result, epochs) if return_info else result

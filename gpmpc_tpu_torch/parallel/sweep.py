"""Multi-seed GP-MPC learning sweep: S independent learning runs batched.
Port of `gpmpc_tpu/parallel/sweep.py`'s `SweepResult` and `seed_sweep`, on
either backend of `parallel/batch.py::batched_episode` (`xla`, the
reference's default, or `lanes`).

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

import contextlib
import time
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.control.gpmpc import (
    GpModel,
    GpMpcConsts,
    empty_gp_model,
    model_spec,
    pack_training_buffers,
    train_gp_models,
)
from gpmpc_tpu_torch.device import ShardDraw, draw_rows
from gpmpc_tpu_torch.envs import drone
from gpmpc_tpu_torch.ops.sqp import SqpConfig
from gpmpc_tpu_torch.parallel.batch import batched_episode
from gpmpc_tpu_torch.parallel.mesh import Sharded, batch_spec, gather, tree_map


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
    backend: str = "xla",
    return_info: bool = False,
) -> SweepResult | tuple[SweepResult, list[EpochInfo]]:
    """`n_seeds` GP-MPC learning runs on the device of `consts`. The residual
    structure comes from the model's ResidualSpec and `env_mod` selects the
    plant family; `prior_params` is accepted for the reference's signature
    and unused. A seed's randomness (initial states, samples, inducing
    points) comes from torch generators seeded from `master_seed`, so the
    same master seed reproduces a sweep. With `return_info`, returns
    (result, one `EpochInfo` per epoch). `backend` is `batched_episode`'s.

    With a `mesh` (`parallel/mesh.py`) the seed axis is sharded over the
    mesh's first axis (`n_seeds` must divide over `mesh.size`, as in the
    reference): each of this process's shards runs its seeds' episodes,
    sampling, targets, refits and evaluations on its device, with every
    draw made at the population's full width and cut to its seeds, so the
    shards give the unsharded sweep's numbers up to the batch's arithmetic
    (and, on `lanes`, the QP's tile-wide exit). Every process gets the full
    (n_epochs + 1, n_seeds) cost matrix and its own seeds' GPs (`gp` leaves
    lead with this process's seeds, in order); the reference returns a
    global sharded array instead. Seeds are independent, so the only
    collective is the final gather of the costs."""
    if samples_per_epoch > n_steps:
        raise ValueError(
            f"samples_per_epoch={samples_per_epoch} > n_steps={n_steps}: an episode yields "
            "n_steps transitions to sample without replacement"
        )
    S = n_seeds
    if mesh is None:
        shards, count = [(consts.Ad.device, 0, S, 0)], 1
    else:
        if S % mesh.size:
            raise ValueError(f"n_seeds={S} must divide over {mesh.size} devices")
        shard_spec = batch_spec(mesh, mesh.axis_names[0])
        seen = {}
        for i, d, r in zip(shard_spec.index, mesh.local_devices, shard_spec.rows(S)):
            seen.setdefault(i, (d,) + r + (i,))
        shards, count = [seen[i] for i in sorted(seen)], shard_spec.count
    cap = n_epochs * samples_per_epoch
    max_inducing = min(max_inducing, cap)  # no more inducing points than data
    spec = model_spec(model)

    def sync():
        for d in {sh[0] for sh in shards}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def draw(dev, lo, hi, stream, epoch):
        return ShardDraw(_generator(dev, master_seed, stream, epoch), S, lo, hi)

    class _Shard:
        """One shard's seeds [lo, hi) on its device."""

        def __init__(self, dev, lo, hi, index):
            self.dev, self.lo, self.hi, self.n, self.index = dev, lo, hi, hi - lo, index
            self.consts = tree_map(lambda t: t.to(dev), consts)
            self.gp0 = empty_gp_model(cap, max_inducing if sparse else cap, ard=ard, spec=spec,
                                      device=dev)
            self.gp = GpModel(*[tree_map(lambda t: t[None].expand((self.n,) + tuple(t.shape))
                                         .contiguous(), leaf) for leaf in self.gp0])
            self.bufx = torch.zeros(self.n, cap, spec.z_dim, device=dev)
            self.bufy = torch.zeros(self.n, cap, spec.num_gps, device=dev)
            self.costs = []

        def episode(self, gp, stream, epoch, gp_batched):
            return batched_episode(model, cfg, env_params, self.consts, gp,
                                   _generator(self.dev, master_seed, stream, epoch), n_steps, S,
                                   gp_batched=gp_batched, env_mod=env_mod, backend=backend,
                                   rows=(self.lo, self.hi))

        def eval_cost(self, gp, gp_batched):
            # the same held-out episode every epoch: the eval stream is not advanced
            return -self.episode(gp, _EVAL, 0, gp_batched).rewards.sum(dim=-1)  # (n,)

        def epoch(self, e):
            n = self.n
            # 1. one closed-loop episode per seed with its current GPs
            ep = self.episode(self.gp, _COLLECT, e, True)
            # 2. per-seed sampling without replacement, targets, accumulation
            idx = draw_rows("rand", draw(self.dev, self.lo, self.hi, _SAMPLE, e), (n, n_steps),
                            device=self.dev).argsort(dim=1)[:, :samples_per_epoch]
            x, u, x_next = _take(ep.obs, idx), _take(ep.actions, idx), _take(ep.obs, idx + 1)
            xi, ti = spec.make_targets(model, x.reshape(n * samples_per_epoch, -1),
                                         u.reshape(n * samples_per_epoch, -1),
                                         x_next.reshape(n * samples_per_epoch, -1))
            start = e * samples_per_epoch
            self.bufx[:, start:start + samples_per_epoch] = xi.reshape(n, samples_per_epoch, -1)
            self.bufy[:, start:start + samples_per_epoch] = ti.reshape(n, samples_per_epoch, -1)

        def refit(self, e):
            # 3. refit every seed's ensemble on its accumulated data (n x G GPs at once)
            self.gp, info = train_gp_models(
                pack_training_buffers(self.bufx, self.bufy, (e + 1) * samples_per_epoch, spec),
                draw(self.dev, self.lo, self.hi, _FIT, e), sparse=sparse,
                max_inducing=max_inducing, n_train=gp_iters, lr=gp_lr, ard=ard, return_info=True,
            )
            return info.iterations

    parts = [_Shard(*sh) for sh in shards]
    for part in parts:
        part.costs.append(part.eval_cost(part.gp0, False))
    epochs = []
    for e in range(n_epochs):
        sync()
        t0 = time.perf_counter()
        for part in parts:
            with _on(part.dev):
                part.epoch(e)
        sync()
        t_fit = time.perf_counter()
        iters = []
        for part in parts:
            with _on(part.dev):
                iters.append(part.refit(e))
        sync()
        fit_s = time.perf_counter() - t_fit
        # 4. the held-out evaluation with the refit controllers
        for part in parts:
            with _on(part.dev):
                part.costs.append(part.eval_cost(part.gp, True))
        sync()
        epochs.append(EpochInfo(e, time.perf_counter() - t0, fit_s, max(iters)))
    dev0 = parts[0].dev
    by_seed = [torch.stack(part.costs, dim=1) for part in parts]  # (n, n_epochs + 1) each
    if mesh is not None:
        by_seed = [gather(Sharded(by_seed, [p.index for p in parts], count,
                                  [p.dev for p in parts]), mesh)]
    costs = by_seed[0].T.contiguous()
    gp = parts[0].gp if len(parts) == 1 else tree_map(
        lambda *ls: torch.cat([x.to(dev0) for x in ls]), *[part.gp for part in parts])
    n_points = torch.arange(n_epochs + 1, device=dev0) * samples_per_epoch
    result = SweepResult(costs=costs, n_points=n_points, gp=gp)
    return (result, epochs) if return_info else result


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Rows i (n, k) of each scenario's a (n, steps, d): (n, k, d)."""
    return torch.gather(a, 1, i[..., None].expand(-1, -1, a.shape[-1]))


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

"""Device mesh and multi-process set-up. Port of `gpmpc_tpu/parallel/mesh.py`
on `torch.distributed`.

The reference describes its devices with a `jax.sharding.Mesh` and lets XLA
insert the collectives that a sharded program needs. Here nothing is
inserted: a `Mesh` records the devices (an array of the mesh's shape), the
axis names, and, inside a process group, the rank and world size and which
devices this process owns. `shard_leading_axis` cuts every leaf's leading
axis into this process's shards (one per local device), `replicate` copies
a tree to every local device, `gather` assembles the global value on every
process (the local shards concatenated, then an `all_gather` across ranks),
and `all_reduce` sums a tensor over the ranks. The programs that run on the
shards (`parallel/batch.py::make_batched_controller_step`,
`parallel/sweep.py::seed_sweep`, `ops/riccati_parallel.py`) call these.

`init_distributed` wraps `torch.distributed.init_process_group` over TCP.
The backend is `nccl` for card tensors and `gloo` on the CPU. `gloo` on the
card is an explicit choice (NCCL refuses two ranks on one card): its
collectives then copy their tensors to the host and back.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.device import NoCudaDeviceError

DATA_AXIS = "data"
STAGE_AXIS = "stage"  # the stage-sharded Riccati (ops/riccati_parallel.py)


class DistributedState(NamedTuple):
    """This process's place in the process group (`init_distributed`)."""

    rank: int
    world_size: int
    local_rank: int
    backend: str
    device: torch.device


_DIST: DistributedState | None = None


@dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes. `devices` is an object array of the
    mesh's shape; slot i (in C order) belongs to rank `ranks[i]`, and its
    entry is the torch device of that slot on the process that owns it."""

    devices: np.ndarray
    ranks: np.ndarray
    axis_names: tuple
    rank: int = 0
    world_size: int = 1
    backend: str | None = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_slots(self) -> list[tuple]:
        """The multi-indices of this process's slots, in C order."""
        return [tuple(int(i) for i in s) for s in np.argwhere(self.ranks == self.rank)]

    @property
    def local_devices(self) -> list[torch.device]:
        return [self.devices[s] for s in self.local_slots]


def make_mesh(n_devices: int | None = None, axis_names=(DATA_AXIS,), shape=None,
              devices=None) -> Mesh:
    """A mesh over `n_devices` devices. Without a process group: the first
    `n_devices` cards (all of them by default), raising if there are fewer,
    or the first `n_devices` of `devices` when it is given (`["cpu"] * n` on
    the CPU, `["cuda:0"] * 2` for two shards on one card). Inside a process
    group (`init_distributed`) every rank contributes the same number of
    devices, `devices` or its own card, and the mesh spans all ranks'
    devices: `n_devices` counts them all. Pass `shape` with `axis_names`
    for a mesh of more than one axis, e.g. (4, 2) over ("data", "stage").
    Inside a process group every rank must call it: the ranks' devices are
    all-gathered."""
    world, rank = (_DIST.world_size, _DIST.rank) if _DIST is not None else (1, 0)
    if devices is not None:
        local = [torch.device(d) for d in devices]
    elif _DIST is not None:
        local = [_DIST.device]
    else:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise NoCudaDeviceError("make_mesh() takes the CUDA cards by default and there is "
                                    "none; pass devices=[\"cpu\"] * n to build a mesh on the CPU")
        want = n_cards if n_devices is None else n_devices
        if want > n_cards:
            raise ValueError(f"make_mesh({want}) needs {want} cards and this machine has "
                             f"{n_cards}; pass devices= to place several shards on one card")
        local = [torch.device(f"cuda:{i}") for i in range(want)]
    if n_devices is None:
        n_devices = world * len(local)
    if n_devices % world:
        raise ValueError(f"{n_devices} devices do not divide over {world} processes")
    per_rank = n_devices // world
    if per_rank > len(local):
        raise ValueError(f"make_mesh({n_devices}) needs {per_rank} devices a process and this "
                         f"process has {len(local)}")
    shape = (n_devices,) if shape is None else tuple(shape)
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} != {n_devices} devices")
    if len(axis_names) != len(shape):
        raise ValueError(f"axis names {tuple(axis_names)} for a mesh of shape {shape}")
    local = local[:per_rank]
    if world > 1:
        local = _all_ranks_devices(local)
    flat = np.empty(n_devices, dtype=object)
    flat[:] = local
    ranks = np.repeat(np.arange(world), per_rank)
    return Mesh(devices=flat.reshape(shape), ranks=ranks.reshape(shape),
                axis_names=tuple(axis_names), rank=rank, world_size=world,
                backend=_DIST.backend if _DIST is not None else None)


def _all_ranks_devices(local: list[torch.device]) -> list[torch.device]:
    """Every rank's devices in rank order (each rank passes as many): each
    device sent as (type, index) through one all_gather."""
    codes = torch.tensor([[int(d.type == "cuda"), -1 if d.index is None else d.index]
                          for d in local], dtype=torch.int64, device=_DIST.device)
    got = _all_gather_cat(codes, _DIST.backend, _DIST.world_size).tolist()
    return [torch.device("cuda", i) if cuda else torch.device("cpu") for cuda, i in got]


# -- trees: tensors inside (named) tuples, lists and dicts; other leaves are kept


def tree_map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, t, *[r[i] for r in rest]) for i, t in enumerate(tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *[r[i] for r in rest]) for i, t in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list[torch.Tensor]:
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


class Sharded(NamedTuple):
    """This process's shards of a tree cut along its leading axis: one tree
    per local device (`devices`), `index` each shard's place among the
    `count` shards of the axis."""

    shards: list
    index: list[int]
    count: int
    devices: list


class ShardSpec(NamedTuple):
    """Which shard of `axis` each local device holds (`batch_spec`)."""

    axis: str
    index: list[int]
    count: int

    def rows(self, n: int) -> list[tuple[int, int]]:
        """The row range [lo, hi) of each local device's shard of n rows."""
        if n % self.count:
            raise ValueError(f"a leading axis of {n} does not divide into {self.count} shards "
                             f"(mesh axis '{self.axis}')")
        size = n // self.count
        return [(i * size, (i + 1) * size) for i in self.index]


def batch_spec(mesh: Mesh, axis: str = DATA_AXIS) -> ShardSpec:
    """The shard of `axis` that each of this process's devices holds; the
    other axes replicate. `.rows(n)` gives the shards' row ranges."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no '{axis}'")
    k = mesh.axis_names.index(axis)
    return ShardSpec(axis, [s[k] for s in mesh.local_slots], mesh.shape[axis])


def _leading(tree) -> int:
    sizes = {t.shape[0] for t in tree_leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"the leaves' leading axes differ: {sorted(sizes)}")
    return sizes.pop()


def shard_leading_axis(tree, mesh: Mesh, axis: str = DATA_AXIS) -> Sharded:
    """This process's shards of every leaf's leading axis, one per local
    device, each on its device; the mesh's other axes replicate. Raises a
    ValueError naming both sizes when the axis does not divide."""
    spec = batch_spec(mesh, axis)
    rows = spec.rows(_leading(tree))
    shards = [tree_map(lambda t, lo=lo, hi=hi, d=d: t[lo:hi].to(d), tree)
              for (lo, hi), d in zip(rows, mesh.local_devices)]
    return Sharded(shards, spec.index, spec.count, mesh.local_devices)


def replicate(tree, mesh: Mesh) -> list:
    """A copy of `tree` on every local device (no copy where a leaf is on
    that device already)."""
    return [tree_map(lambda t, d=d: t.to(d), tree) for d in mesh.local_devices]


def _on_host(backend: str | None, t: torch.Tensor) -> bool:
    return backend == "gloo" and t.device.type == "cuda"


def _all_gather_cat(t: torch.Tensor, backend: str | None, world_size: int) -> torch.Tensor:
    """The ranks' tensors (equal shapes) concatenated along the first axis in
    rank order, on every rank."""
    import torch.distributed as dist

    dev, dtype = t.device, t.dtype
    x = t.cpu() if _on_host(backend, t) else t
    if dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world_size)]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(device=dev, dtype=dtype)


def gather(sharded: Sharded, mesh: Mesh):
    """The global tree on every process: this process's shards concatenated
    in their order on its first device, then, across a process group, one
    `all_gather` per leaf (ranks must hold equal, contiguous runs of
    shards, as a one-axis mesh gives them)."""
    first: dict[int, Any] = {}
    for i, t in zip(sharded.index, sharded.shards):
        first.setdefault(i, t)
    mine = sorted(first)
    dev = sharded.devices[0]
    local = tree_map(lambda *ls: torch.cat([x.to(dev) for x in ls]), *[first[i] for i in mine])
    if mesh.world_size == 1:
        if mine != list(range(sharded.count)):
            raise ValueError(f"shards {mine} of {sharded.count}: the mesh lacks some")
        return local
    per = sharded.count // mesh.world_size
    if mine != list(range(mesh.rank * per, (mesh.rank + 1) * per)):
        raise ValueError(f"rank {mesh.rank} holds shards {mine}; gather needs {per} contiguous "
                         "shards a rank, in rank order")
    return tree_map(lambda t: _all_gather_cat(t, mesh.backend, mesh.world_size), local)


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor on t's device; t itself
    without a process group)."""
    if mesh.world_size == 1:
        return t
    import torch.distributed as dist

    x = (t.cpu() if _on_host(mesh.backend, t) else t).clone()
    dist.all_reduce(x)
    return x.to(t.device)


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device: torch.device | str | None = None) -> DistributedState:
    """Join a process group: `torch.distributed.init_process_group` with
    `init_method="tcp://<coordinator_address>"`. Without arguments it reads
    torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
    LOCAL_RANK). The rank's device is `device`, else its card
    `cuda:{LOCAL_RANK % device_count}`; without a card and without
    `device="cpu"` it raises `NoCudaDeviceError`, as every entry point of
    the port does. The backend defaults to `nccl` on a card and `gloo` on
    the CPU; `gloo` with a card is explicit, and its collectives go through
    the host. NCCL refuses two ranks on one card, so that raises here."""
    global _DIST
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE") if k not in env]
        if missing:
            raise ValueError("init_distributed() without a coordinator reads torchrun's "
                             f"environment; {', '.join(missing)} not set")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    elif num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    n_cards = torch.cuda.device_count()
    if device is None:
        if n_cards == 0:
            raise NoCudaDeviceError("init_distributed() puts the rank on a CUDA card by default "
                                    "and there is none; pass device=\"cpu\" to run on the CPU")
        device = f"cuda:{local_rank % n_cards}"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a card; take backend='gloo' on the CPU")
        if local_rank >= n_cards:
            raise ValueError(f"local rank {local_rank} would share one of {n_cards} card(s) with "
                             "another rank, which NCCL refuses; take backend='gloo'")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _DIST = DistributedState(process_id, num_processes, local_rank, backend, device)
    return _DIST


def shutdown_distributed() -> None:
    """Leave the process group `init_distributed` joined."""
    global _DIST
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _DIST = None

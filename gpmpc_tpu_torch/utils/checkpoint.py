"""Checkpoint and resume, in the reference's file format. Port of
`gpmpc_tpu/utils/checkpoint.py`: `save_pytree`, `load_pytree`,
`load_metadata`, `save_runs`, `load_runs` and `ExperimentCheckpoint`.

A tree of tensors (dicts, NamedTuples, tuples and lists of them) is one
`.npz` whose keys are the leaves' paths as the reference writes them
("/".join of each step: `['key']` for a dict key, `.field` for a
NamedTuple field, `[i]` for an index; dict keys sorted, None an empty
subtree), plus a `.json` sidecar with `metadata`. So a snapshot written by
either package loads into the other. The sidecar's `treedef` string is
each package's own description of the tree; nothing reads it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the reference's order and key format."""
    join = lambda step: step if not prefix else f"{prefix}/{step}"  # noqa: E731
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_paths(tree[k], join(f"[{k!r}]"))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten_with_paths(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in flatten_with_paths(v, join(f"[{i}]"))]
    return [(prefix, tree)]


def _unflatten_like(like, leaves: dict[str, Any], prefix: str = ""):
    """`like`'s structure with each leaf replaced by `leaves[its key]`."""
    join = lambda step: step if not prefix else f"{prefix}/{step}"  # noqa: E731
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, join(f"[{k!r}]")) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*[_unflatten_like(getattr(like, f), leaves, join(f".{f}"))
                            for f in like._fields])
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten_like(v, leaves, join(f"[{i}]")) for i, v in enumerate(like))
    return leaves[prefix]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _describe(tree) -> str:
    """A readable description of the tree's structure for the sidecar."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ", ".join(_describe(v) for v in tree) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def save_pytree(path: Path, tree, metadata: dict[str, Any] | None = None):
    """Save a tree of tensors or arrays to `<path>.npz` (+ `<path>.json`
    with `metadata`). Device tensors are copied to the host."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path) + ".npz", **{k: _to_numpy(v) for k, v in flatten_with_paths(tree)})
    meta = {"treedef": _describe(tree), "metadata": metadata or {}}
    with open(str(path) + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_pytree(path: Path, like):
    """Load arrays saved by either package's `save_pytree` into the
    structure of `like`: each tensor leaf becomes a tensor of its dtype on
    its device, each array leaf an array of its dtype, anything else the
    stored array. A missing leaf raises KeyError; a tensor or array leaf
    stored at another shape raises ValueError."""
    path = Path(path)
    with np.load(str(path) + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    out = {}
    for key, leaf in flatten_with_paths(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if isinstance(leaf, (torch.Tensor, np.ndarray)) and tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, expected "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            out[key] = torch.as_tensor(arr).to(dtype=leaf.dtype, device=leaf.device)
        elif isinstance(leaf, np.ndarray):
            out[key] = np.asarray(arr, leaf.dtype)
        else:
            out[key] = arr
    return _unflatten_like(like, out)


def load_metadata(path: Path) -> dict[str, Any]:
    with open(str(Path(path)) + ".json") as f:
        return json.load(f)["metadata"]


def save_runs(path: Path, runs: dict[int, dict]):
    """Persist {epoch: episode_data} dicts (obs, action and reward arrays and
    timing). One level of dict nesting (the per-step `controller_data`
    diagnostics) is flattened into dotted keys, so every stored value is a
    plain array, never a pickled object array."""
    arrays: dict[str, np.ndarray] = {}
    for epoch, run in runs.items():
        for key, val in run.items():
            if isinstance(val, dict):
                for sub, sub_val in val.items():
                    arrays[f"{epoch}|{key}.{sub}"] = _to_numpy(sub_val)
            else:
                arrays[f"{epoch}|{key}"] = _to_numpy(val)
    np.savez(str(path) + ".npz", **arrays)


def load_runs(path: Path) -> dict[int, dict]:
    runs: dict[int, dict] = {}
    with np.load(str(path) + ".npz") as data:
        for name in data.files:
            epoch_s, key = name.split("|", 1)
            run = runs.setdefault(int(epoch_s), {})
            val = data[name]
            if "." in key:
                outer, sub = key.split(".", 1)
                run.setdefault(outer, {})[sub] = val
            else:
                run[key] = list(val) if key == "inference_time_data" else val
    # episodes recorded without any controller diagnostics still need the key
    for run in runs.values():
        run.setdefault("controller_data", {})
    return runs


class ExperimentCheckpoint:
    """Save and restore the learning loop's state: the GP model, the
    accumulated dataset, the episode runs so far and the numpy RNG state.
    The reference keeps its controller's JAX key under `['gp_key']`; the
    port keeps its inducing-draw generator's state under `['gp_generator']`
    (a byte array). A reference checkpoint restores the GP and the dataset
    into the port's `GPMPC` and leaves its generator as it is (JAX's keys
    cannot be turned into a torch generator's state)."""

    def __init__(self, directory: Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(
        self,
        epoch: int,
        ctrl,
        x_train: np.ndarray,
        y_train: np.ndarray,
        rng: np.random.Generator | None = None,
        train_runs: dict | None = None,
        test_runs: dict | None = None,
    ):
        tree = {
            "gp_model": ctrl.gp_model,
            "gp_generator": ctrl._gp_generator.get_state(),
            "x_train": np.asarray(x_train),
            "y_train": np.asarray(y_train),
        }
        rng_state = None
        if rng is not None:
            rng_state = json.loads(json.dumps(
                rng.bit_generator.state,
                default=lambda o: int(o) if isinstance(o, np.integer) else o.tolist(),
            ))
        save_pytree(self.dir / f"ckpt_epoch_{epoch}", tree,
                    metadata={"epoch": epoch, "sparse": ctrl.sparse, "rng_state": rng_state})
        if train_runs is not None:
            save_runs(self.dir / f"train_runs_{epoch}", train_runs)
        if test_runs is not None:
            save_runs(self.dir / f"test_runs_{epoch}", test_runs)

    def latest_epoch(self) -> int | None:
        epochs = [int(p.stem.split("_")[-1]) for p in self.dir.glob("ckpt_epoch_*.npz")]
        return max(epochs) if epochs else None

    def restore(self, epoch: int, ctrl, rng: np.random.Generator | None = None):
        """Restore the GP and the generator into `ctrl` (a `GPMPC` of the
        checkpoint's GP shapes, its leaves onto ctrl's device) and the numpy
        RNG state into `rng`. Returns (x_train, y_train, train_runs,
        test_runs)."""
        path = self.dir / f"ckpt_epoch_{epoch}"
        with np.load(str(path) + ".npz") as data:
            x_train = data["['x_train']"]
            y_train = data["['y_train']"]
            generator = data["['gp_generator']"] if "['gp_generator']" in data.files else None
        tree = load_pytree(path, {"gp_model": ctrl.gp_model})
        ctrl.gp_model = tree["gp_model"]
        if generator is not None:
            ctrl._gp_generator.set_state(torch.as_tensor(generator))
        meta = load_metadata(path)
        if rng is not None and meta.get("rng_state") is not None:
            state = meta["rng_state"]
            # the JSON round trip turns the key array into a list
            if isinstance(state.get("state"), dict) and "key" in state["state"]:
                state["state"]["key"] = np.asarray(state["state"]["key"], dtype=np.uint64)
            rng.bit_generator.state = state
        train_runs = test_runs = None
        if (self.dir / f"train_runs_{epoch}.npz").exists():
            train_runs = load_runs(self.dir / f"train_runs_{epoch}")
        if (self.dir / f"test_runs_{epoch}.npz").exists():
            test_runs = load_runs(self.dir / f"test_runs_{epoch}")
        return x_train, y_train, train_runs, test_runs

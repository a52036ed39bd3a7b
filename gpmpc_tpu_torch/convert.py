"""Carry weights and state across from the JAX package, as numpy arrays.

The reference's pytrees cross over as dicts of numpy arrays (the port never
imports JAX): `gp_model_from_numpy`, `gp_data_from_numpy`,
`hypers_from_numpy`, `consts_from_numpy`, `state_from_numpy` and
`info_from_numpy` turn them into the port's tensors on a given device,
`sqp_config_from_mapping` the reference's SqpConfig into the port's.
`load_bench_gp` reads the committed fixture of a family's benchmark GP
(`data/bench_gp.npz` for the quadrotor, `data/bench_gp_{cartpole,twolink}.npz`,
written by `scripts/export_torch_gp_fixture.py`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gpmpc_tpu_torch.control.gpmpc import GpModel, GpMpcConsts, GPHypers
from gpmpc_tpu_torch.control.mpc import MpcConsts, MpcInfo, MpcState
from gpmpc_tpu_torch.device import resolve
from gpmpc_tpu_torch.gp.exact_gp import GPData
from gpmpc_tpu_torch.ops.sqp import SqpConfig

DATA = Path(__file__).resolve().parent / "data"
BENCH_GP_PATH = DATA / "bench_gp.npz"


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32, order="C"), device=device)


def gp_model_from_numpy(d, device=None) -> GpModel:
    """GpModel from a flat mapping with the leaf names of the reference's GpModel,
    the hyperparameters as `raw_lengthscale`, `raw_outputscale`, `raw_noise`.
    A population keeps its leading scenario axis on every leaf (`Zs` of four
    dimensions, `trained` of shape (B,))."""
    device = resolve(device)
    return GpModel(
        Z=_f32(d["Z"], device), y=_f32(d["y"], device), mask=_f32(d["mask"], device),
        hypers=GPHypers(
            raw_lengthscale=_f32(d["raw_lengthscale"], device),
            raw_outputscale=_f32(d["raw_outputscale"], device),
            raw_noise=_f32(d["raw_noise"], device),
        ),
        Zs=_f32(d["Zs"], device), alpha_s=_f32(d["alpha_s"], device),
        var_Z=_f32(d["var_Z"], device), var_mat=_f32(d["var_mat"], device),
        var_mask=_f32(d["var_mask"], device),
        trained=torch.as_tensor(np.asarray(d["trained"], bool), device=device),
    )


def gp_data_from_numpy(d, device=None, dtype=torch.float32) -> GPData:
    """GPData from a mapping with `x`, `y` and `mask` (any leading batch
    axes), in `dtype` (float64 for the fits held against JAX in x64)."""
    device = resolve(device)
    return GPData(*[torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=device)
                    for k in GPData._fields])


def hypers_from_numpy(d, device=None, dtype=torch.float32) -> GPHypers:
    """GPHypers from a mapping of the raw leaves, each at its own shape: the
    lengthscale (G,) isotropic or (G, D) for ARD."""
    device = resolve(device)
    return GPHypers(*[torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=device)
                      for k in GPHypers._fields])


def consts_from_numpy(d, device=None) -> GpMpcConsts:
    """GpMpcConsts from a mapping of its fields, `mpc` itself a mapping of
    MpcConsts fields."""
    device = resolve(device)
    m = d["mpc"]
    return GpMpcConsts(
        mpc=MpcConsts(**{k: _f32(m[k], device) for k in MpcConsts._fields}),
        **{k: _f32(d[k], device) for k in GpMpcConsts._fields if k != "mpc"},
    )


def state_from_numpy(d, device=None) -> MpcState:
    """Batched MpcState from a mapping with traj_step (B,), X_warm, U_warm."""
    device = resolve(device)
    return MpcState(
        traj_step=torch.as_tensor(np.array(d["traj_step"], np.int32), device=device),
        X_warm=_f32(d["X_warm"], device),
        U_warm=_f32(d["U_warm"], device),
    )


def info_from_numpy(d, device=None) -> MpcInfo:
    """Batched MpcInfo from a mapping of its fields (n_iters and converged keep
    their integer and boolean types, the rest become float32)."""
    device = resolve(device)
    as_is = ("n_iters", "converged")
    return MpcInfo(**{
        k: torch.as_tensor(np.array(d[k]), device=device) if k in as_is else _f32(d[k], device)
        for k in MpcInfo._fields
    })


def sqp_config_from_mapping(d) -> SqpConfig:
    """The port's SqpConfig from the reference's as a mapping (`cfg._asdict()`):
    the fields are the same, `soft_x_penalty` and `qp_tol` may be None."""
    unknown = set(d) - set(SqpConfig._fields)
    if unknown:
        raise ValueError(f"SqpConfig has no fields {sorted(unknown)}")
    opt = lambda v: None if v is None else float(v)  # noqa: E731
    d = dict(d)
    for k in ("qp_tol", "soft_x_penalty", "kkt_tol"):
        if k in d:
            d[k] = opt(d[k])
    return SqpConfig(**d)


def bench_gp_path(family: str = "quadrotor") -> Path:
    if family not in ("quadrotor", "cartpole", "twolink"):
        raise ValueError(f"no bench GP fixture for model family {family!r}")
    return BENCH_GP_PATH if family == "quadrotor" else DATA / f"bench_gp_{family}.npz"


def load_bench_gp(device=None, family: str = "quadrotor") -> GpModel:
    """The benchmark's GP of a model family (`synthetic_gp_model`,
    `synthetic_cartpole_gp_model` or `synthetic_twolink_gp_model` at bench.py's
    defaults)."""
    with np.load(bench_gp_path(family)) as d:
        return gp_model_from_numpy(dict(d), device)

"""Carry weights and state across from the JAX package, as numpy arrays.

The reference's pytrees cross over as dicts of numpy arrays (the port never
imports JAX): `gp_model_from_numpy`, `consts_from_numpy` and
`state_from_numpy` turn them into the port's tensors on a given device.
`load_bench_gp` reads the committed fixture of the benchmark's GP
(`data/bench_gp.npz`, written by `scripts/export_torch_gp_fixture.py`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gpmpc_tpu_torch.control.gpmpc import GpModel, GpMpcConsts, GPHypers
from gpmpc_tpu_torch.control.mpc import MpcConsts, MpcState

BENCH_GP_PATH = Path(__file__).resolve().parent / "data" / "bench_gp.npz"


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32, order="C"), device=device)


def gp_model_from_numpy(d, device="cpu") -> GpModel:
    """GpModel from a flat mapping with the leaf names of the reference's GpModel,
    the hyperparameters as `raw_lengthscale`, `raw_outputscale`, `raw_noise`."""
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
        trained=torch.as_tensor(bool(np.asarray(d["trained"])), device=device),
    )


def consts_from_numpy(d, device="cpu") -> GpMpcConsts:
    """GpMpcConsts from a mapping of its fields, `mpc` itself a mapping of
    MpcConsts fields."""
    m = d["mpc"]
    return GpMpcConsts(
        mpc=MpcConsts(**{k: _f32(m[k], device) for k in MpcConsts._fields}),
        **{k: _f32(d[k], device) for k in GpMpcConsts._fields if k != "mpc"},
    )


def state_from_numpy(d, device="cpu") -> MpcState:
    """Batched MpcState from a mapping with traj_step (B,), X_warm, U_warm."""
    return MpcState(
        traj_step=torch.as_tensor(np.array(d["traj_step"], np.int32), device=device),
        X_warm=_f32(d["X_warm"], device),
        U_warm=_f32(d["U_warm"], device),
    )


def load_bench_gp(device="cpu") -> GpModel:
    """The benchmark's GP (`synthetic_gp_model` at bench.py's defaults)."""
    with np.load(BENCH_GP_PATH) as d:
        return gp_model_from_numpy(dict(d), device)

"""Argument checks shared by the kernel wrappers in `ops/cuda_*.py`.

A wrapper takes its plain PyTorch version only when its tensors lie on the
CPU; on a CUDA device it launches the kernel or raises."""

from __future__ import annotations

import torch

# (nx, nu) pairs csrc/tighten.cu and csrc/ocp_ip.cu are instantiated for
# (lanes.cuh dispatch_nx_nu): quadrotor, cartpole, two-link arm.
KERNEL_SHAPES = ((12, 4), (4, 1), (4, 2))


def check_widths(kernel: str, nx: int, nu: int) -> None:
    """Raise unless the kernel has an instantiation for (nx, nu)."""
    if (nx, nu) not in KERNEL_SHAPES:
        raise ValueError(
            f"{kernel} kernel is instantiated for (nx, nu) in {KERNEL_SHAPES}, got ({nx}, {nu})"
        )


def check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`
    (None entries of `shape` match any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def route(device: torch.device) -> str:
    """'plain' for CPU tensors, 'kernel' for CUDA tensors; anything else raises."""
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel and no plain route for device {device}")

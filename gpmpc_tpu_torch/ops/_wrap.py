"""Argument checks shared by the kernel wrappers in `ops/cuda_*.py`.

A wrapper takes its plain PyTorch version only when its tensors lie on the
CPU; on a CUDA device it launches the kernel or raises."""

from __future__ import annotations

import torch


def check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous float32 tensor of `shape` on `device`
    (None entries of `shape` match any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
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

"""Reference trajectory. Port of `gpmpc_tpu/models/trajectory.py`."""

from __future__ import annotations

import math

import torch


def figure_eight_trajectory(
    n_steps: int = 300,
    dt: float = 0.02,
    amplitude: float = 0.8,
    height: float = 1.0,
    n_periods: int = 1,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Periodic figure-eight reference in the X-Y plane, (n_steps, 12) float32."""
    t = torch.arange(n_steps, dtype=torch.float32, device=device) * dt
    w = 2.0 * math.pi * n_periods / (n_steps * dt)
    x = amplitude * torch.sin(w * t)
    dx = amplitude * w * torch.cos(w * t)
    y = 0.5 * amplitude * torch.sin(2.0 * w * t)
    dy = amplitude * w * torch.cos(2.0 * w * t)
    z = torch.full_like(t, height)
    zeros = torch.zeros_like(t)
    return torch.stack([x, dx, y, dy, z, zeros] + [zeros] * 6, dim=1)

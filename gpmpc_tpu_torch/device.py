"""Where the port's entry points put their tensors.

Every entry point that creates tensors takes `device=None` and resolves it
here: the card unless the caller asks for the CPU. Functions that take
tensors follow their inputs' device instead.
"""

from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """An entry point was left on its default device and there is no card."""


def resolve(device: torch.device | str | None = None) -> torch.device:
    """`device` as a torch.device; None means `cuda:0`. Never falls back to
    the CPU by itself: without a card the default raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "gpmpc_tpu_torch runs on the CUDA card by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda:0")

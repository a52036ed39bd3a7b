"""Where the port's entry points put their tensors.

Every entry point that creates tensors takes `device=None` and resolves it
here: the card unless the caller asks for the CPU. Functions that take
tensors follow their inputs' device instead. A path of the reference that
the port does not have raises `UnsupportedPathError` and never falls back.
"""

from __future__ import annotations

import contextlib

import torch


class NoCudaDeviceError(RuntimeError):
    """An entry point was left on its default device and there is no card."""


class UnsupportedPathError(NotImplementedError):
    """The configuration needs a path of the reference that is not ported;
    the message names its item in ROADMAP.md."""


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


@contextlib.contextmanager
def strict_float32():
    """Float32 matrix products in full float32 inside the block, whatever the
    process had set: `torch.func` turns the GP algebra into `bmm` calls that
    follow the process-wide TF32 flag, and a GP at its noise floor does not
    survive TF32's three digits. The flag is restored on exit and never
    turned on."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

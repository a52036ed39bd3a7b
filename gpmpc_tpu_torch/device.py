"""Where the port's entry points put their tensors.

Every entry point that creates tensors takes `device=None` and resolves it
here: the card unless the caller asks for the CPU. Functions that take
tensors follow their inputs' device instead. A path of the reference that
the port does not have raises `UnsupportedPathError` and never falls back.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

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


class ShardDraw(NamedTuple):
    """Rows [lo, hi) of a population of `batch`: a random draw for them is
    made at the population's full width from `generator` and cut to the
    rows, so a shard of a population draws exactly the numbers the whole
    population's run gives its rows (`draw_rows`)."""

    generator: torch.Generator
    batch: int
    lo: int
    hi: int


def draw_rows(kind: str, generator: torch.Generator | ShardDraw, shape: tuple,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """`torch.rand` ("rand") or `torch.randn` ("randn") of `shape` from
    `generator`; for a `ShardDraw`, `shape[0]` rows cut from a draw of
    (batch, *shape[1:])."""
    fn = {"rand": torch.rand, "randn": torch.randn}[kind]
    if not isinstance(generator, ShardDraw):
        return fn(shape, generator=generator, dtype=dtype, device=device)
    if shape[0] != generator.hi - generator.lo:
        raise ValueError(f"a draw of {shape[0]} rows for rows [{generator.lo}, {generator.hi})")
    full = fn((generator.batch,) + tuple(shape[1:]), generator=generator.generator, dtype=dtype,
              device=device)
    return full[generator.lo:generator.hi]


# Device constants built from plain parameters (`device_constant`): key -> tensor, oldest first.
_CONSTANTS: dict = {}
_CONSTANTS_KEPT = 32


def _plain(value) -> bool:
    """True for a number, string, None, device or a tuple of those: a value
    that is hashable and compares by value alone."""
    if isinstance(value, tuple):
        return all(_plain(v) for v in value)
    return value is None or isinstance(value, (bool, int, float, str, torch.device))


def device_constant(key: tuple, device, build):
    """`build(device)`, a tensor (or a tuple of tensors) made from the plain
    values in `key` alone, built once per (key, device) and kept for the next
    calls (the last `_CONSTANTS_KEPT`). A step that reads its constants this
    way makes no host-to-device copy after its first call, so it can be
    captured in a CUDA graph. A key holding anything but plain values (a
    tensor among the parameters) builds anew every call. The tensors are made
    outside inference mode, and no caller may write them."""
    device = torch.device(device)
    key = key + (device,)
    if not _plain(key):
        return build(device)
    hit = _CONSTANTS.get(key)
    if hit is None:
        with torch.inference_mode(False):
            hit = build(device)
        _CONSTANTS[key] = hit
        while len(_CONSTANTS) > _CONSTANTS_KEPT:
            del _CONSTANTS[next(iter(_CONSTANTS))]
    return hit


def cached_constants() -> list:
    """Every tensor `device_constant` keeps now: a CUDA graph that read them
    holds them, so that none is freed under it."""
    return list(_CONSTANTS.values())

"""The reference's matrix products, in full float32 or, for the precision
control, with TF32's rounding of the operands.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits; a tensor core
rounds both operands of a product to it and accumulates in float32. The
control emulates that by rounding the operands (to nearest, ties to even)
and multiplying in float32 with TF32 off, so it gives the same numbers on the
CPU and on the card, whatever cuBLAS picks for a small batched product.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits, ties to even."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + keep) & ~0x1FFF
    return rounded.view(torch.float32)


class Precision:
    """The products of one reference evaluation: `mm` (matrix by matrix)
    and `mv` (matrix by vector), batched over leading axes."""

    def __init__(self, name: str = "float32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {name!r}")
        self.name = name
        self._round = round_tf32 if name == "tf32" else (lambda t: t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._round(a), self._round(b))

    def mv(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.mm(a, v[..., None])[..., 0]


@contextlib.contextmanager
def full_float32():
    """TF32 off for the block, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

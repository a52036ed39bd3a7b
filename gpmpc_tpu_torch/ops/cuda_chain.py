"""Lane-wise matmul chains: kernels 7, 8 and 9 of the port, the probe kernels
of the roofline script.

Port of the three Pallas kernels of `scripts/bench_roofline.py`:
`lanes_chain` (float32, 12 x 12), `lanes_chain_bf16` (every operation in
bf16, tiles twice as wide) and `lanes_chain_16` (float32, the 12 x 12 blocks
embedded in 16 x 16). Each applies `n_chain` dependent rounds of
`acc <- 0.5 * (acc @ acc) + 0.5 * acc` to every N x N matrix of
x (tiles, T, N, N, L): one scenario per lane, the T stages independent. The
CUDA kernels are in `csrc/lanes_chain.cu`; beside each wrapper stands the
same arithmetic in plain PyTorch (`*_plain`), which the wrapper runs for CPU
tensors.

The map l -> 0.5 l^2 + 0.5 l is unstable at 1, so on matrices near the
identity the chain leaves float32 after some ten rounds: it is there to be
timed, and comparisons are made after a few rounds.

Kernels 7 and 8 take their launch geometry from `chain_geometry`, in one
place: how many blocks a (tile, stage) pair is cut into, and how wide each is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, route
from gpmpc_tpu_torch.ops.cuda_ocp import _mm

N = 12  # the quadrotor's state width
N_PAD = 16

# Slots (threads: one float32 lane, or two bf16 lanes) a block of
# csrc/lanes_chain.cu::chain_kernel takes at most: the kernel's kChainSlots,
# its launch bound, which its launcher checks.
CHAIN_SLOTS = 64
KINDS = ("f32", "bf16")


class ChainGeometry(NamedTuple):
    """Launch geometry of kernel 7 or 8 for tiles of L lanes: each (tile,
    stage) pair is `slices` blocks of `slots_per_block` threads, one 32-bit
    slot a thread, with `shared_bytes` of shared memory a block (one 12 x 12
    buffer a slot)."""

    slots_per_block: int
    slices: int
    shared_bytes: int

    def blocks(self, pairs: int) -> int:
        """Blocks of a launch over `pairs` (tile, stage) pairs."""
        return pairs * self.slices


def chain_geometry(kind: str, L: int) -> ChainGeometry:
    """Geometry of `chain_kernel` ("f32": kernel 7, "bf16": kernel 8) for
    tiles of L lanes: L slots in float32, L / 2 in packed bf16 (an odd L is
    refused). A block takes the widest part of a tile's slots that divides
    them and is at most CHAIN_SLOTS wide; the launcher checks these numbers
    and launches nothing else."""
    if kind not in KINDS:
        raise ValueError(f"chain kind {kind!r}: expected one of {KINDS}")
    if not isinstance(L, int) or L < 1:
        raise ValueError(f"tile width L={L!r}: expected a positive int")
    if kind == "bf16" and L % 2:
        raise ValueError(f"lanes_chain_bf16: no kernel instantiation for an odd tile width "
                         f"(L={L}): a slot holds two bf16 lanes")
    slots = L // 2 if kind == "bf16" else L
    slices = next(s for s in range(1, slots + 1)
                  if slots % s == 0 and slots // s <= CHAIN_SLOTS)
    per_block = slots // slices
    return ChainGeometry(per_block, slices, 4 * N * N * per_block)


def _mm_each_op(x, y):
    """`_mm` with the sum over b taken term by term, so that in bf16 every
    product and every partial sum rounds to bf16 (torch.sum would accumulate
    in float32)."""
    acc = x[:, :, 0:1, :] * y[:, 0:1, :, :]
    for k in range(1, x.shape[2]):
        acc = acc + x[:, :, k : k + 1, :] * y[:, k : k + 1, :, :]
    return acc


def _chain_plain(x: torch.Tensor, n_chain: int, mm) -> torch.Tensor:
    acc = x.reshape((-1,) + tuple(x.shape[2:]))  # (tiles * T, N, N, L)
    for _ in range(n_chain):
        acc = 0.5 * mm(acc, acc) + 0.5 * acc
    return acc.reshape(x.shape)


def lanes_chain_plain(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """x (tiles, T, 12, 12, L) float32 -> the same after `n_chain` rounds."""
    return _chain_plain(x, n_chain, _mm)


def lanes_chain_bf16_plain(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """x (tiles, T, 12, 12, L) bfloat16: every multiply and add rounds to bf16."""
    return _chain_plain(x, n_chain, _mm_each_op)


def lanes_chain_16_plain(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """x (tiles, T, 16, 16, L) float32."""
    return _chain_plain(x, n_chain, _mm)


def _chain(wrapper, plain, entry: str, x: torch.Tensor, n_chain: int, n: int, dtype,
           kind: str | None = None) -> torch.Tensor:
    """Shared body of the wrappers: checks, the plain route for CPU tensors,
    the launch (with `chain_geometry(kind, L)` where `kind` is given) and the
    wrapper's count."""
    if not isinstance(n_chain, int) or n_chain < 0:
        raise ValueError(f"n_chain: expected a non-negative int, got {n_chain!r}")
    check("x", x, (None, None, n, n, None), x.device, dtype)
    if route(x.device) == "plain":
        return plain(x, n_chain)
    tiles, T, _, _, L = x.shape
    if tiles * T == 0:
        raise ValueError(f"{entry} kernel needs at least one tile and one stage")
    geometry = () if kind is None else tuple(chain_geometry(kind, L))
    out = torch.empty_like(x)
    _build.launch(entry + "_launch", _build.ptr(x), _build.ptr(out), tiles * T, L, n_chain,
                  *geometry, _build.stream_handle(x.device))
    wrapper.launches += 1
    return out


def lanes_chain(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """Kernel wrapper with `lanes_chain_plain`'s signature. CPU tensors take the
    plain version; CUDA tensors launch `chain_kernel`: a thread per lane
    holding its whole matrix in registers, one shared 12 x 12 buffer per lane
    for the old rows (the left operands) and the new ones, blocks as
    `chain_geometry("f32", L)` cuts the tiles."""
    return _chain(lanes_chain, lanes_chain_plain, "lanes_chain", x, n_chain, N, torch.float32,
                  "f32")


def lanes_chain_bf16(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """Kernel wrapper with `lanes_chain_bf16_plain`'s signature: on the card
    `chain_kernel` in packed bf16, a thread per pair of lanes (L even)
    holding both lanes' whole matrices in registers as `__nv_bfloat162`,
    blocks as `chain_geometry("bf16", L)` cuts the tiles."""
    return _chain(lanes_chain_bf16, lanes_chain_bf16_plain, "lanes_chain_bf16", x, n_chain, N,
                  torch.bfloat16, "bf16")


def lanes_chain_16(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """Kernel wrapper with `lanes_chain_16_plain`'s signature: on the card
    `team_chain16_kernel`, the mapping of the port's QP kernels: a team of
    threads per scenario, each member keeping its rows of the matrix in
    registers and reading the rest from the scenario's one shared buffer;
    one block per (tile, stage) and slice of lanes. It computes the padded
    function in full, bit for bit what one thread per scenario computed."""
    return _chain(lanes_chain_16, lanes_chain_16_plain, "lanes_chain_16", x, n_chain, N_PAD,
                  torch.float32)


lanes_chain.launches = 0
lanes_chain_bf16.launches = 0
lanes_chain_16.launches = 0

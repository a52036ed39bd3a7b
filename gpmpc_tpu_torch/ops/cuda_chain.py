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
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, route
from gpmpc_tpu_torch.ops.cuda_ocp import _mm

N = 12  # the quadrotor's state width
N_PAD = 16


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


def _chain(wrapper, plain, entry: str, x: torch.Tensor, n_chain: int, n: int, dtype) -> torch.Tensor:
    if not isinstance(n_chain, int) or n_chain < 0:
        raise ValueError(f"n_chain: expected a non-negative int, got {n_chain!r}")
    check("x", x, (None, None, n, n, None), x.device, dtype)
    if route(x.device) == "plain":
        return plain(x, n_chain)
    tiles, T, _, _, L = x.shape
    if tiles * T == 0:
        raise ValueError(f"{entry} kernel needs at least one tile and one stage")
    out = torch.empty_like(x)
    _build.launch(entry + "_launch", _build.ptr(x), _build.ptr(out), tiles * T, L, n_chain,
                  _build.stream_handle(x.device))
    wrapper.launches += 1
    return out


def lanes_chain(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """Kernel wrapper with `lanes_chain_plain`'s signature. CPU tensors take the
    plain version; CUDA tensors launch `chain_kernel`, one block per
    (tile, stage) and slice of at most 128 lanes, one thread per lane."""
    return _chain(lanes_chain, lanes_chain_plain, "lanes_chain", x, n_chain, N, torch.float32)


def lanes_chain_bf16(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """Kernel wrapper with `lanes_chain_bf16_plain`'s signature: on the card
    `chain_kernel` in packed bf16, one thread per pair of lanes (L even)."""
    return _chain(lanes_chain_bf16, lanes_chain_bf16_plain, "lanes_chain_bf16", x, n_chain, N,
                  torch.bfloat16)


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

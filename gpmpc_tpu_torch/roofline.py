"""Roofline probe for the batched small-matrix algebra of the Riccati/IP stack.

Port of `scripts/bench_roofline.py`. The question: for B scenarios x
(12 x 12 @ 12 x 12) products, the core operation of the interior-point
kernels, which mapping onto the card wins?

  a) torch_batched        : `torch.matmul` on (B, T, 12, 12), the library's
                            batched GEMM (the counterpart of `xla_batched`)
  b) tc_blockdiag         : ten scenarios packed into 128 x 128 block-diagonal
                            operands, `torch.matmul`, masked each round (the
                            counterpart of `mxu_blockdiag`); float32, TF32 off
  c) cuda_lanes           : `ops/cuda_chain.py::lanes_chain`, one thread per
                            scenario holding its whole matrix in registers
                            as the right operand, one shared buffer per
                            scenario for the old rows (the left operands)
                            and the new ones; narrow blocks
                            (`cuda_chain.chain_geometry`) keep every SM busy
  d) cuda_lanes_bf16_pair : `lanes_chain_bf16`, the same mapping with two
                            scenarios per 32-bit register in packed bf16
  e) cuda_lanes_pad16     : `lanes_chain_16`, the blocks embedded in 16 x 16,
                            on the QP kernels' mapping since their redesign: a
                            team of threads per scenario, rows in registers,
                            one shared buffer read as 16-byte broadcasts
                            ((16/12)^3 of the operations)

Each row runs `n_chain` dependent rounds of acc <- 0.5 acc @ acc + 0.5 acc over
B = 1280 scenarios and T independent stages, at the reference's sizes and on
its data, and reports useful GFLOP/s: 2 B T 12^3 per round, so the padding of
(b) and (e) does not count. One JSON line per row, with the reference's metric
names. Times are CUDA events around `reps` calls after one warm call; there is
no CPU path.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve, strict_float32
from gpmpc_tpu_torch.ops import cuda_chain

N = cuda_chain.N
N_PAD = cuda_chain.N_PAD
LANES = 128
BLOCKS = LANES // N  # 12 x 12 blocks per 128 x 128 operand
B = 1280  # 10 lane tiles, 128 block-diagonal operands
T = 25  # independent stages per scenario, as in the QP kernels' sweep
T_PAD = 12  # stages of the padded row, as in the reference
N_CHAIN = 200
ROWS = ("torch_batched", "tc_blockdiag", "cuda_lanes", "cuda_lanes_bf16_pair", "cuda_lanes_pad16")


def reference_mats(batch: int = B, stages: int = T, seed: int = 0) -> np.ndarray:
    """(batch, stages, 12, 12) float32: eye + 0.05 * normal, the reference's data."""
    rng = np.random.default_rng(seed)
    return (np.eye(N) + 0.05 * rng.normal(size=(batch, stages, N, N))).astype(np.float32)


def pad16_mats(mats: np.ndarray, stages: int = T_PAD) -> np.ndarray:
    """The first `stages` stages embedded in 16 x 16, identity on the pad diagonal."""
    out = np.tile(np.eye(N_PAD, dtype=np.float32), (mats.shape[0], stages, 1, 1))
    out[:, :, :N, :N] = mats[:, :stages]
    return out


def to_lanes(mats: torch.Tensor, lanes: int = LANES) -> torch.Tensor:
    """(B, T, n, n) -> (B / lanes, T, n, n, lanes), contiguous."""
    b = mats.shape[0]
    if b % lanes:
        raise ValueError(f"batch {b} is not a multiple of the tile width {lanes}")
    return mats.reshape((b // lanes, lanes) + tuple(mats.shape[1:])).movedim(1, -1).contiguous()


def from_lanes(x: torch.Tensor) -> torch.Tensor:
    """(tiles, T, n, n, lanes) -> (tiles * lanes, T, n, n)."""
    x = x.movedim(-1, 1)
    return x.reshape((-1,) + tuple(x.shape[2:]))


def torch_batched_chain(x: torch.Tensor, n_chain: int) -> torch.Tensor:
    """The chain on (B, T, n, n) with one `torch.matmul` a round."""
    acc = x
    for _ in range(n_chain):
        acc = 0.5 * torch.matmul(acc, acc) + 0.5 * acc
    return acc


def pack_blockdiag(mats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, 12, 12) -> (operands (B / 10, T, 128, 128) with ten scenarios on
    the diagonal, the (128, 128) mask of the diagonal blocks)."""
    b, t = mats.shape[:2]
    if b % BLOCKS:
        raise ValueError(f"batch {b} is not a multiple of {BLOCKS}")
    grouped = mats.reshape(b // BLOCKS, BLOCKS, t, N, N)
    packed = torch.zeros(b // BLOCKS, t, LANES, LANES, dtype=mats.dtype, device=mats.device)
    mask = torch.zeros(LANES, LANES, dtype=mats.dtype, device=mats.device)
    for k in range(BLOCKS):
        sl = slice(k * N, (k + 1) * N)
        packed[:, :, sl, sl] = grouped[:, k]
        mask[sl, sl] = 1.0
    return packed, mask


def unpack_blockdiag(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_blockdiag`: (B / 10, T, 128, 128) -> (B, T, 12, 12)."""
    blocks = [packed[:, :, k * N:(k + 1) * N, k * N:(k + 1) * N] for k in range(BLOCKS)]
    out = torch.stack(blocks, dim=1)
    return out.reshape((-1,) + tuple(out.shape[2:]))


def tc_blockdiag_chain(packed: torch.Tensor, mask: torch.Tensor, n_chain: int) -> torch.Tensor:
    """The chain as true 128 x 128 GEMMs; the mask keeps the product
    block-diagonal each round."""
    acc = packed
    for _ in range(n_chain):
        acc = (0.5 * torch.matmul(acc, acc) + 0.5 * acc) * mask
    return acc


def timed_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of `reps` calls between two CUDA events, after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def useful_flops(stages: int, n_chain: int, batch: int = B) -> float:
    return 2.0 * batch * stages * N**3 * n_chain


def iter_rows(device=None, only=None, n_chain: int = N_CHAIN, reps: int = 5):
    """Time the selected rows (all of `ROWS` when `only` is None) on the card
    and yield one record per row as it is measured: the reference's four keys,
    the time of one chain in ms and the card's name."""
    device = resolve(device)
    if device.type != "cuda":
        raise ValueError(f"the roofline rows are device times; {device} is not a CUDA device")
    unknown = set(only or ()) - set(ROWS)
    if unknown:
        raise ValueError(f"unknown rows {sorted(unknown)}; choose from {ROWS}")
    mats_np = reference_mats()
    mats = torch.as_tensor(mats_np, device=device)
    cases = {
        "torch_batched": lambda: (lambda x=mats: torch_batched_chain(x, n_chain), T),
        "tc_blockdiag": lambda: (
            lambda pm=pack_blockdiag(mats): tc_blockdiag_chain(pm[0], pm[1], n_chain), T),
        "cuda_lanes": lambda: (
            lambda x=to_lanes(mats): cuda_chain.lanes_chain(x, n_chain), T),
        "cuda_lanes_bf16_pair": lambda: (
            lambda x=to_lanes(mats, 2 * LANES).to(torch.bfloat16):
            cuda_chain.lanes_chain_bf16(x, n_chain), T),
        "cuda_lanes_pad16": lambda: (
            lambda x=to_lanes(torch.as_tensor(pad16_mats(mats_np), device=device)):
            cuda_chain.lanes_chain_16(x, n_chain), T_PAD),
    }
    name = torch.cuda.get_device_name(device)
    for row in ROWS:
        if only is not None and row not in only:
            continue
        fn, stages = cases[row]()
        with strict_float32():  # float32 products stay float32, whatever the process had set
            ms = timed_ms(fn, reps)
        yield {
            "metric": f"riccati_mm_gflops[{row}]",
            "value": round(useful_flops(stages, n_chain) / (ms * 1e-3) / 1e9, 1),
            "unit": "GFLOP/s (useful)",
            "vs_baseline": 0.0,
            "ms": ms,
            "device": name,
        }


def main() -> int:
    """Print one JSON line per row; BENCH_ROOFLINE_ONLY=cuda_lanes,... selects rows."""
    only = os.environ.get("BENCH_ROOFLINE_ONLY")
    for rec in iter_rows(only=only.split(",") if only else None):
        print(json.dumps(rec), flush=True)
    return 0

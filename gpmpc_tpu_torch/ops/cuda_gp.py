"""Fused GP posterior mean and variance: kernel 1 of the port.

Port of `gpmpc_tpu/ops/pallas_gp.py::gp_mean_var`. The CUDA kernel is
`csrc/gp_posterior.cu`, which takes every GP of an ensemble in one launch
(`gp_mean_var_multi`), any number of points (`gp_geometry` picks the
instantiation), from a form packed once per ensemble (`pack_form`:
the live inducing points only, Z transposed, the hyperparameters as the
kernel reads them). `gp_mean_var` takes one GP, through the same wrapper.
Past 128 points the sums run in float64, on the FP64 tensor cores, over a
grid split along W's tiles (`gp_tiled_plan`).
`gp_mean_var_plain` is the function in plain PyTorch, which the wrappers run
for CPU tensors. Strict float32 throughout: run the plain version on a card
only with TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`, the default), since the
quadratic form cancels entries ~1/noise down to variances ~1e-2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.gp.kernels import se_kernel
from gpmpc_tpu_torch.ops._wrap import check, route

POINT_BLOCK = 8  # the kernel's points come in blocks of 8 (csrc/gp_posterior.cu JB)
REGISTER_BUCKETS = (64, 128)  # the kernel row in registers, templated on a bucket >= M
MAX_DIMS = 8
QTILE = 128  # queries (threads) a block of the register buckets
# The tiled kernel (csrc/gp_posterior.cu QT, TK, TJ): a block's tile of QUERY_TILE
# queries x TILE_COLS columns of W, its rows staged TILE_ROWS at a time.
QUERY_TILE, TILE_ROWS, TILE_COLS = 64, 32, 128
SMS = 132  # an H100 SXM's streaming multiprocessors: the plan's default card
TILED_BLOCKS_PER_SM = 1  # resident tiled blocks an SM holds (shared memory, registers)
WAVE_TARGET = 2 * SMS * TILED_BLOCKS_PER_SM  # blocks the row split aims the grid at, on SMS SMs
COLUMN_WARPS = 4  # the tiled kernel's consumer warps along a tile's columns, 2 along its queries
RING_STAGES = 2  # float32 stages in flight in its ring
# a tiled block's shared memory at any M and D: two buffers each of the W
# slab and the K slab in float64 with rows padded by 4, the column warps'
# exchange, a ring of float32 stages (W slab, the rows' points at MAX_DIMS,
# their mask), the queries, the column tile's points, mask and alpha
TILED_SHARED_BYTES = 8 * (2 * TILE_ROWS * (TILE_COLS + 4) + 2 * QUERY_TILE * (TILE_ROWS + 4)
                          + 2 * (COLUMN_WARPS - 1) * QUERY_TILE) + 4 * (
    RING_STAGES * (TILE_ROWS * TILE_COLS + MAX_DIMS * TILE_ROWS + TILE_ROWS)
    + QUERY_TILE * MAX_DIMS + MAX_DIMS * TILE_COLS + 2 * TILE_COLS)


class GpGeometry(NamedTuple):
    """The instantiation of `csrc/gp_posterior.cu` that serves M points in D
    dimensions: `bucket` 64 or 128 (the kernel row in registers, W whole in
    shared memory) or 0 (the tiled kernel, any M: W streamed through shared
    memory in tiles, so a block's share does not grow with M; its sums run
    in float64 on the FP64 tensor cores, its split in `gp_tiled_plan`), and
    the shared memory a block asks for. The C launcher takes `bucket` and
    refuses any other."""

    bucket: int
    shared_bytes: int


def gp_geometry(m: int, d: int) -> GpGeometry:
    """The launch of M points (a multiple of 8) in D <= 8 dimensions."""
    if m < POINT_BLOCK or m % POINT_BLOCK or not 1 <= d <= MAX_DIMS:
        raise ValueError(f"gp_posterior kernel needs M a positive multiple of {POINT_BLOCK} and "
                         f"1 <= D <= {MAX_DIMS} (M={m}, D={d})")
    for bucket in REGISTER_BUCKETS:
        if m <= bucket:
            return GpGeometry(bucket, 4 * (m * m + (d + 2) * m + m * QTILE))
    return GpGeometry(0, TILED_SHARED_BYTES)


class GpTiledPlan(NamedTuple):
    """The tiled kernel's launch for G GPs of M points and N queries: the
    grid (query tiles, column tiles x splits, G); W's rows in `stages` of
    TILE_ROWS, cut into `splits` ranges of `stages_per_split` (the last may
    be shorter); a float64 workspace (G, partials, N) of per-query partials,
    col_tiles x splits of k W k^T, then col_tiles of the mean. The split
    is chosen here alone; the C launcher refuses a split whose ranges do not
    cover the stages, or leave one empty."""

    query_tiles: int
    col_tiles: int
    stages: int
    splits: int
    stages_per_split: int
    grid: tuple
    workspace: tuple
    shared_bytes: int

    def block(self, y: int, m: int) -> tuple:
        """What block row `y` of the grid sums: (its W rows, its W columns,
        as ranges clipped to M; the index of its k W k^T partial; the index
        of its mean partial, or None past the first row range)."""
        col, split = divmod(y, self.splits)
        s0 = split * self.stages_per_split
        s1 = min(self.stages, s0 + self.stages_per_split)
        rows = range(s0 * TILE_ROWS, min(m, s1 * TILE_ROWS))
        cols = range(col * TILE_COLS, min(m, (col + 1) * TILE_COLS))
        return rows, cols, y, self.col_tiles * self.splits + col if split == 0 else None


def gp_tiled_plan(G: int, n: int, m: int, d: int, sms: int = SMS) -> GpTiledPlan:
    """The rows are split only as far as the grid needs to reach two waves
    of resident blocks on each of the card's `sms` SMs (WAVE_TARGET on an
    H100 SXM), at most into one stage a range: the longest ranges that
    reach it, then balanced (queries and column tiles come first)."""
    gp_geometry(m, d)
    if G < 1 or n < 1:
        raise ValueError(f"gp_posterior kernel needs G > 0 GPs and N > 0 queries (G={G}, N={n})")
    query_tiles = -(-n // QUERY_TILE)
    col_tiles = -(-m // TILE_COLS)
    stages = -(-m // TILE_ROWS)
    want = -(-2 * sms * TILED_BLOCKS_PER_SM // (query_tiles * col_tiles * G))
    per = stages
    while per > 1 and -(-stages // per) < want:
        per -= 1
    splits = -(-stages // per)
    per = -(-stages // splits)
    return GpTiledPlan(query_tiles, col_tiles, stages, splits, per,
                       (query_tiles, col_tiles * splits, G), (G, col_tiles * (splits + 1), n),
                       TILED_SHARED_BYTES)


def gp_mean_var_plain(
    z: torch.Tensor,  # (N, D) queries
    Z: torch.Tensor,  # (M, D) inducing / training inputs (padded)
    alpha: torch.Tensor,  # (M,)
    W: torch.Tensor,  # (M, M) variance quadratic form
    lengthscale: torch.Tensor,  # () or (D,)
    outputscale: torch.Tensor,  # ()
    noise: torch.Tensor,  # ()
    mask: torch.Tensor,  # (M,)
    include_noise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean (N,), var (N,)) of the SE-kernel posterior."""
    k = se_kernel(z, Z, lengthscale, outputscale) * mask[None, :]
    mean = k @ alpha
    var = torch.clamp_min(outputscale - torch.sum((k @ W) * k, dim=-1), 1e-12)
    if include_noise:
        var = var + noise
    return mean, var


class GpForm(NamedTuple):
    """G GPs' posterior forms as the kernel takes them: M points each (a
    multiple of 8; points past a GP's own have mask, alpha and W entries 0),
    lengthscales per dimension. Z, alpha, W, the hyperparameters and mask are
    `gp_mean_var_plain`'s arguments per GP; Zt and hyp are the kernel's
    layout of the same numbers."""

    Z: torch.Tensor  # (G, M, D)
    alpha: torch.Tensor  # (G, M)
    W: torch.Tensor  # (G, M, M)
    lengthscale: torch.Tensor  # (G, D)
    outputscale: torch.Tensor  # (G,)
    noise: torch.Tensor  # (G,)
    mask: torch.Tensor  # (G, M)
    Zt: torch.Tensor  # (G, D, M)
    hyp: torch.Tensor  # (G, 2 + D): outputscale, noise, 1 / lengthscale_d^2


def pack_form(
    Z: torch.Tensor,  # (G, M, D)
    alpha: torch.Tensor,  # (G, M)
    W: torch.Tensor,  # (G, M, M)
    lengthscale: torch.Tensor,  # (G,) or (G, D)
    outputscale: torch.Tensor,  # (G,)
    noise: torch.Tensor,  # (G,)
    mask: torch.Tensor,  # (G, M)
    compact: bool = True,
) -> GpForm:
    """The packed form of G GPs, on their device. With `compact`, each GP
    keeps only its live points (mask != 0), in their order, and the forms are
    padded to the largest live count rounded up to a multiple of 8: a masked
    point's terms are exactly 0 in both sums, so this is the same function
    (it reads the mask on the host once). Without it, every point stays and
    M is padded to a multiple of 8."""
    G, M, D = Z.shape
    f32 = torch.float32
    if compact:
        live = [torch.nonzero(mask[g] != 0).flatten() for g in range(G)]
    else:
        live = [torch.arange(M, device=Z.device) for _ in range(G)]
    m = max(POINT_BLOCK, -(-max(len(i) for i in live) // POINT_BLOCK) * POINT_BLOCK)
    Zc = torch.zeros(G, m, D, dtype=f32, device=Z.device)
    ac = torch.zeros(G, m, dtype=f32, device=Z.device)
    Wc = torch.zeros(G, m, m, dtype=f32, device=Z.device)
    mc = torch.zeros(G, m, dtype=f32, device=Z.device)
    for g, idx in enumerate(live):
        n = len(idx)
        Zc[g, :n] = Z[g, idx]
        ac[g, :n] = alpha[g, idx]
        Wc[g, :n, :n] = W[g][idx][:, idx]
        mc[g, :n] = mask[g, idx]
    ell = lengthscale.to(f32).reshape(G, -1).expand(G, D).contiguous()
    sf2, nz = outputscale.to(f32).contiguous(), noise.to(f32).contiguous()
    hyp = torch.cat([sf2[:, None], nz[:, None], 1.0 / ell**2], dim=1).contiguous()
    return GpForm(Zc, ac, Wc, ell, sf2, nz, mc, Zc.transpose(1, 2).contiguous(), hyp)


def gp_mean_var_multi_plain(
    z: torch.Tensor, form: GpForm, include_noise: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean (G, N), var (G, N)) at queries z (G, N, D): `gp_mean_var_plain`
    once per GP."""
    outs = [
        gp_mean_var_plain(z[g], form.Z[g], form.alpha[g], form.W[g], form.lengthscale[g],
                          form.outputscale[g], form.noise[g], form.mask[g], include_noise)
        for g in range(z.shape[0])
    ]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _check_form(z: torch.Tensor, form: GpForm) -> None:
    dev = z.device
    G, n, d = z.shape
    m = form.Z.shape[1]
    check("z", z, (G, n, d), dev)
    for name, shape in (("Z", (G, m, d)), ("alpha", (G, m)), ("W", (G, m, m)),
                        ("lengthscale", (G, d)), ("outputscale", (G,)), ("noise", (G,)),
                        ("mask", (G, m)), ("Zt", (G, d, m)), ("hyp", (G, 2 + d))):
        check(name, getattr(form, name), shape, dev)


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device, SMS for any other."""
    if device.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def gp_mean_var_multi(
    z: torch.Tensor, form: GpForm, include_noise: bool = False, tiled: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper with `gp_mean_var_multi_plain`'s signature: all G GPs
    in one launch, of `gp_posterior_kernel` (the kernel row in registers)
    up to 128 points and of the tiled kernel (W streamed through shared
    memory in tiles, float64 sums on the FP64 tensor cores, its partials
    summed by a second small kernel) past that (`gp_geometry`). `tiled`
    takes the tiled kernel at any M (a kernel-level measurement of its
    float64 sums; no path sets it). CPU tensors take the plain version."""
    _check_form(z, form)
    if route(z.device) == "plain":
        return gp_mean_var_multi_plain(z, form, include_noise)
    G, n, d = z.shape
    m = form.Z.shape[1]
    if n == 0:
        raise ValueError("gp_posterior kernel needs N > 0 queries")
    for name in ("W", "Zt", "mask"):  # read as 16-byte chunks
        if getattr(form, name).data_ptr() % 16:
            raise ValueError(f"gp_posterior kernel needs form.{name} 16-byte aligned")
    geometry = gp_geometry(m, d)
    p = _build.ptr
    mean = torch.empty(G, n, dtype=torch.float32, device=z.device)
    var = torch.empty(G, n, dtype=torch.float32, device=z.device)
    if tiled or geometry.bucket == 0:
        plan = gp_tiled_plan(G, n, m, d, sm_count(z.device))
        try:
            ws = torch.empty(plan.workspace, dtype=torch.float64, device=z.device)
        except torch.OutOfMemoryError as e:
            raise ValueError(
                f"gp_posterior: the tiled kernel's workspace {plan.workspace} (float64) takes "
                f"{8 * G * plan.workspace[1] * n} bytes, more than the card can allocate; ask "
                "for fewer queries per call") from e
        launch = (0, plan.splits, plan.stages_per_split, plan.shared_bytes, p(ws))
    else:
        launch = (geometry.bucket, 0, 0, geometry.shared_bytes, None)
    _build.launch(
        "gp_posterior_launch", p(z), p(form.Zt), p(form.alpha), p(form.W), p(form.mask),
        p(form.hyp), G, n, m, d, int(include_noise), *launch, p(mean), p(var),
        _build.stream_handle(z.device),
    )
    gp_mean_var_multi.launches += 1
    return mean, var


PROBE_K = 16  # the depth of dmma_probe's product (csrc/gp_posterior.cu PROBE_K)


def dmma_probe_cases(seed: int = 0) -> list:
    """(a, b) pairs for `dmma_probe` whose products are exact in float64
    (numpy): identity blocks, permutations scaled by their row and column
    numbers, and permutations of the integers below 32 x 16 and 16 x 32."""
    rng = np.random.default_rng(seed)
    k, n = PROBE_K, PROBE_N
    eye = np.eye(k)
    return [(np.tile(eye, (32 // k, 1)), np.tile(eye, (1, n // k))),
            (np.tile(eye[rng.permutation(k)], (32 // k, 1)) * np.arange(1, 33)[:, None],
             np.tile(eye[rng.permutation(k)], (1, n // k)) * np.arange(1, n + 1)[None, :]),
            (rng.permutation(32 * k).reshape(32, k).astype(np.float64),
             rng.permutation(k * n).reshape(k, n).astype(np.float64))]


PROBE_N = TILE_COLS // COLUMN_WARPS  # a consumer warp's columns


def dmma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (32, 16) @ b (16, 32) in float64 through the tiled kernel's DMMA
    fragments and accumulator layout, one warp (`gp_dmma_probe_kernel`): run
    with identity and permutation matrices it shows which lane's register
    lands where. Not a port of a TPU kernel and not counted. CPU tensors
    take `a @ b`."""
    check("a", a, (32, PROBE_K), a.device, torch.float64)
    check("b", b, (PROBE_K, PROBE_N), a.device, torch.float64)
    if route(a.device) == "plain":
        return a @ b
    out = torch.empty(32, PROBE_N, dtype=torch.float64, device=a.device)
    p = _build.ptr
    _build.launch("gp_dmma_probe_launch", p(a), p(b), p(out), _build.stream_handle(a.device))
    return out


def gp_mean_var(
    z: torch.Tensor,
    Z: torch.Tensor,
    alpha: torch.Tensor,
    W: torch.Tensor,
    lengthscale: torch.Tensor,
    outputscale: torch.Tensor,
    noise: torch.Tensor,
    mask: torch.Tensor,
    include_noise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`gp_mean_var_plain`'s signature for one GP, over `gp_mean_var_multi`
    with G = 1 on the GP's points as given (packed per call). CPU tensors
    take the plain version."""
    dev = z.device
    n, d = z.shape
    m = Z.shape[0]
    check("z", z, (n, d), dev)
    check("Z", Z, (m, d), dev)
    check("alpha", alpha, (m,), dev)
    check("W", W, (m, m), dev)
    check("mask", mask, (m,), dev)
    check("outputscale", outputscale, (), dev)
    check("noise", noise, (), dev)
    if lengthscale.shape not in ((), (d,)):
        raise ValueError(f"lengthscale: shape {tuple(lengthscale.shape)}, expected () or ({d},)")
    if route(dev) == "plain":
        return gp_mean_var_plain(z, Z, alpha, W, lengthscale, outputscale, noise, mask, include_noise)
    form = pack_form(Z[None], alpha[None], W[None], lengthscale[None], outputscale[None],
                     noise[None], mask[None], compact=False)
    mean, var = gp_mean_var_multi(z[None], form, include_noise)
    return mean[0], var[0]


gp_mean_var_multi.launches = 0  # kernel launches so far

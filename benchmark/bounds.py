"""The least time one H100 could take for each kernel of the step: the larger
of its bytes over the memory bandwidth and its operations over the float32
rate outside the tensor cores, from the call's shapes alone.

Every input is read once and every output written once; an FMA is two
operations; elementwise barrier terms, square roots and exponentials beyond
one per kernel evaluation are left out, so each bound is a lower one. Where
the work depends on the data (the interior point stops a tile early), the
operations count what these inputs need, as a reference solver finds it, and
never what the kernel reports it ran. Peaks: NVIDIA's data sheet for the
SXM part at its 700 W limit.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F32 = 4


class Bound(NamedTuple):
    seconds: float
    by: str  # "bytes" or "operations"
    bytes: int
    flops: int


def bound(n_bytes: int, flops: int) -> Bound:
    t_b, t_f = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS
    return Bound(max(t_b, t_f), "bytes" if t_b >= t_f else "operations", int(n_bytes), int(flops))


def bound_gp(n_queries: int, live_points: list[int], d: int) -> Bound:
    """Kernel 1, one launch for every GP of a step: per GP, n_queries
    queries against its m live points in d dimensions, the kernel vector
    (3 d + 2 per pair), the mean (2 m) and the variance's quadratic form
    (2 m^2 + 2 m). Padded, masked points are no work: bytes and operations
    count the live ones (points, weights, the m x m form, the queries, the
    hyperparameters, mean and variance)."""
    n_bytes = flops = 0
    for m in live_points:
        n_bytes += F32 * (n_queries * d + m * d + m + m * m + d + 2 + 2 * n_queries)
        flops += n_queries * (2 * m * m + m * (3 * d + 6))
    return bound(n_bytes, flops)


def bound_tighten(b: int, t: int, nd: int, nx: int, nu: int) -> Bound:
    """Kernel 2 for b scenarios over t stages with nd disturbance rows: the
    operations of the cheaper formulation of the same function. The
    recursion, per scenario and stage: (A + B K) cov as one nx^3 product, the
    upper triangle of its product with (A + B K)^T (nx^2 (nx+1) / 2 FMAs),
    the diagonal of K cov K^T (nx (nx+1) / 2 FMAs per input) and the nd
    disturbance terms. The direct form, per scenario: the triangular sums
    over the nx state rows at k = 0..t and the nu input rows at k = 0..t-1.
    Bytes: the disturbance diagonals (b, t, nd), the four matrices, the
    quantile and the tightenings out ((b, t+1, nx), (b, t, nu))."""
    recursion = b * t * (2 * nx ** 3 + nx * nx * (nx + 1) + nu * nx * (nx + 1) + nd)
    direct = b * nd * (nx * t * (t + 1) + nu * t * (t - 1))
    n_bytes = F32 * (b * t * nd + nx * nx + nx * nu + nu * nx + nx * nd + 1
                     + b * (t + 1) * nx + b * t * nu)
    return bound(n_bytes, min(recursion, direct))


# nonzeros of the quadrotor's continuous-time Jacobians (Jx, Ju)
QUAD_JAC_NNZ = (18, 5)


def bound_linearize(b: int, t: int, nx: int, nu: int, g: int, ms: int, d: int) -> Bound:
    """Kernel 3, one launch: per scenario and stage, four closure
    evaluations of RK4 (g GPs x ms points: 6 d + 4 each for the mean and its
    gradient) and three chain products of the sparse closure Jacobian with
    an nx x (nx + nu) block. Bytes: the plant coefficients, the GP
    hyperparameters, points and weights, X (b, t+1, nx) and U (b, t, nu) in;
    fnext, A and B out."""
    jx, _ = QUAD_JAC_NNZ
    per_stage = 4 * g * ms * (6 * d + 4) + 3 * 2 * jx * (nx + nu)
    n_bytes = F32 * (8 + g * (1 + d) + g * ms * d + g * ms + b * (t + 1) * nx + b * t * nu
                     + b * t * (nx + nx * nx + nx * nu))
    return bound(n_bytes, b * t * per_stage)


def qp_stage_flops(nx: int, nu: int, mehrotra: bool) -> int:
    """Operations of one stage of one interior-point iteration of one
    scenario: a Riccati factorization (W = P [A|B]; of [A|B]^T W the upper
    triangles of the symmetric Gxx and Guu, and Gxu; the nu x nu Cholesky;
    the gains; the upper triangle of the symmetric P + Gxu K; P r and the
    gradients; the dynamics residual) and one rollout; Mehrotra adds the
    corrector's vector sweep and its rollout."""
    rollout = 2 * nx * (nx + nu) + 2 * nu * nx
    factor = (2 * nx * nx * (nx + nu)
              + nx * nx * (nx + 1) + 2 * nx * nx * nu + nx * nu * (nu + 1)
              + nu ** 3 // 3 + 2 * nu * nu * nx
              + nx * (nx + 1) * nu
              + 2 * nx * nx + 2 * nx * (nx + nu) + 2 * nx * nu
              + 2 * nx * (nx + nu))
    vector = 2 * nx * (nx + nu) + 2 * nu * nu + 2 * nx * nu
    return factor + rollout + (vector + rollout if mehrotra else 0)


def bound_qp(tile_iterations: float, lanes: int, n_tiles: int, t: int, nx: int, nu: int,
             mehrotra: bool, launches: float = 1) -> Bound:
    """Kernel 4, `launches` launches over n_tiles tiles of `lanes` scenarios
    that together need `tile_iterations` interior-point iterations (summed
    over tiles and launches): operations per scenario, stage and iteration as
    `qp_stage_flops`; bytes, each launch's QP data in (A, B, r, the two
    diagonals, the gradients and the four boxes) and dx, du and the gap
    out."""
    b = n_tiles * lanes
    n_bytes = launches * F32 * b * (t * nx * (nx + nu) + t * nx + 4 * (t + 1) * nx + 4 * t * nu
                                    + (t + 1) * nx + t * nu + 1)
    return bound(n_bytes, tile_iterations * lanes * t * qp_stage_flops(nx, nu, mehrotra))

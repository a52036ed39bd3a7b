"""Parallel-in-time Riccati: the associative-scan LQR, batch-first. Port of
`gpmpc_tpu/ops/riccati_parallel.py` in plain torch (the reference's is XLA
code, not a Pallas kernel).

The backward Riccati recursion is an associative operation on conditional
value functions (Särkkä's parallel LQT). An element e = (A, b, C, eta, J)
encodes V_e(x, z) = 1/2 (z - A x - b)' C^+ (z - A x - b) + 1/2 x' J x - eta' x
for entering state x and exit state z; `_combine` composes an earlier
element with a later one. The suffix combination e_k x ... x e_T gives
P_k = J and p_k = -eta. Stage init for x' = A x + B u + r and costs
(Qxx, qx), (Ruu, ru): A_e = A, C_e = B Ruu^-1 B', b_e = r - B Ruu^-1 ru,
J_e = Qxx, eta_e = -qx; the terminal element is (0, 0, 0, -qx_T, Qxx_T).
The gains follow pointwise from (P_{k+1}, p_{k+1}), and the forward rollout
x_{k+1} = F_k x_k + f_k is a second associative scan, over affine maps.

`_scan` is the reference's `jax.lax.associative_scan` recursion (combine
pairs, scan the half, fill in the rest): O(log T) depth of batched products
over all stages at once. With a `mesh` whose axes include "stage", both
scans are two-level: each shard scans its block of stages on its device,
the block totals are gathered, and their exclusive suffix (prefix, for the
rollout) is combined into each block; the gains are computed between the
two scans on the problem's own device. This is what XLA's partitioner makes
of the reference's scan with the stage axis sharded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch.device import strict_float32
from gpmpc_tpu_torch.ops.riccati import (
    LqProblem,
    LqSolution,
    _mv,
    cho_apply,
    cholesky_inverse_or_nan,
)


class _ValueElem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M^-1 rhs, NaN in every matrix of the batch that is singular (the
    others solved as usual) where `torch.linalg.solve` would raise for all."""
    x, info = torch.linalg.solve_ex(M, rhs)
    return torch.where((info != 0)[..., None, None], torch.full_like(x, torch.nan), x)


def _combine(ei: _ValueElem, ej: _ValueElem) -> _ValueElem:
    """Compose the earlier element ei with the later element ej (batched
    over leading axes)."""
    eye = torch.eye(ei.A.shape[-1], dtype=ei.A.dtype, device=ei.A.device)
    M = eye + ei.C @ ej.J  # (I + C_i J_j)
    Minv_Ai = _solve(M, ei.A)
    Minv_bCeta = _solve(M, (ei.b + _mv(ei.C, ej.eta))[..., None])[..., 0]
    Minv_Ci = _solve(M, ei.C)
    N = eye + ej.J @ ei.C  # (I + J_j C_i)
    Ninv_Jj = _solve(N, ej.J)
    Ninv_rhs = _solve(N, (ej.eta - _mv(ej.J, ei.b))[..., None])[..., 0]
    AiT, AjT = ei.A.transpose(-1, -2), ej.A.transpose(-1, -2)
    return _ValueElem(
        A=ej.A @ Minv_Ai,
        b=_mv(ej.A, Minv_bCeta) + ej.b,
        C=ej.A @ Minv_Ci @ AjT + ej.C,
        eta=_mv(AiT, Ninv_rhs) + ei.eta,
        J=AiT @ Ninv_Jj @ ei.A + ei.J,
    )


class _Affine(NamedTuple):
    M: torch.Tensor
    v: torch.Tensor


def _affine_combine(m1: _Affine, m2: _Affine) -> _Affine:
    """The earlier affine map m1 then the later m2: x -> M2 (M1 x + v1) + v2."""
    return _Affine(m2.M @ m1.M, _mv(m2.M, m1.v) + m2.v)


def _cut(elems, start: int, stop: int | None = None, step: int = 1):
    return type(elems)(*[e[:, start:stop:step] for e in elems])


def _scan(fn, elems):
    """Inclusive scan of `fn(earlier, later)` along axis 1 of every leaf
    (the reference's associative_scan recursion)."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _scan(fn, fn(_cut(elems, 0, n - 1, 2), _cut(elems, 1, None, 2)))
    rest = _cut(elems, 2, None, 2)
    head = _cut(odd, 0, odd[0].shape[1] - 1) if n % 2 == 0 else odd
    even = fn(head, rest) if rest[0].shape[1] else rest
    even = type(elems)(*[torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)])
    out = []
    for e, o in zip(even, odd):
        x = torch.empty((e.shape[0], n) + tuple(e.shape[2:]), dtype=e.dtype, device=e.device)
        x[:, 0::2], x[:, 1::2] = e, o
        out.append(x)
    return type(elems)(*out)


def _suffix(elems: _ValueElem) -> _ValueElem:
    """result[k] = e_k x e_{k+1} x ... x e_last (composition in time order)."""
    flip = lambda t: type(t)(*[x.flip(1) for x in t])  # noqa: E731
    return flip(_scan(lambda later, earlier: _combine(earlier, later), flip(elems)))


def _prefix(elems):
    return _scan(_affine_combine, elems)


def _blocks(n: int, k: int) -> list[tuple[int, int]]:
    """k contiguous blocks of n items, as even as they come."""
    return [(i * n // k, (i + 1) * n // k) for i in range(k)]


def _stage_devices(mesh) -> list[torch.device]:
    """One device per block of the mesh's "stage" axis, from this process's
    devices (the stage-sharded scan runs within one process)."""
    if mesh.world_size != 1:
        raise ValueError("the stage-sharded Riccati runs over one process's devices")
    k = mesh.axis_names.index("stage")
    devices = {}
    for slot, dev in zip(mesh.local_slots, mesh.local_devices):
        devices.setdefault(slot[k], dev)
    return [devices[i] for i in range(mesh.shape["stage"])]


def _two_level(elems, devices, combine, suffix: bool):
    """The scan of `elems` (axis 1) in blocks on `devices`: each block scanned
    on its device, the block totals scanned, and each block combined with
    the exclusive suffix (or prefix) of the other blocks' totals. The
    result is gathered on the elements' device."""
    home = elems[0].device
    placed = [(r, d) for r, d in zip(_blocks(elems[0].shape[1], len(devices)), devices) if r[1] > r[0]]
    ranges, devices = [r for r, _ in placed], [d for _, d in placed]  # no empty blocks
    n_blocks = len(devices)
    local = []
    for (lo, hi), dev in zip(ranges, devices):
        block = type(elems)(*[e[:, lo:hi].to(dev) for e in elems])
        local.append(_suffix(block) if suffix else _prefix(block))
    # the block totals (first element of a suffix scan, last of a prefix scan), gathered home
    pick = 0 if suffix else -1
    totals = type(elems)(*[torch.stack([blk[j][:, pick].to(home) for blk in local], dim=1)
                           for j in range(len(elems))])
    scanned = _suffix(totals) if suffix else _prefix(totals)
    out = []
    for i, (blk, dev) in enumerate(zip(local, devices)):
        j = i + 1 if suffix else i - 1
        if 0 <= j < n_blocks:
            other = type(elems)(*[s[:, j:j + 1].to(dev).expand_as(b) for s, b in zip(scanned, blk)])
            blk = combine(blk, other) if suffix else combine(other, blk)
        out.append(blk)
    return type(elems)(*[torch.cat([blk[j].to(home) for blk in out], dim=1)
                         for j in range(len(elems))])


def riccati_solve_parallel(lq: LqProblem, dx0: torch.Tensor, mesh=None) -> LqSolution:
    """Associative-scan LQR solve; the contract of `ops/riccati.py::
    riccati_solve` (every leaf leads with the scenario axis, dx0 (B, nx)).
    Products in full float32 (the reference pins "highest": interior-point
    barrier weights push P to 1e6-1e8). With `mesh`, the stages are sharded
    over its "stage" axis (module docstring)."""
    with strict_float32():
        return _solve_parallel(lq, dx0, mesh)


def _solve_parallel(lq: LqProblem, dx0: torch.Tensor, mesh) -> LqSolution:
    Bn, nx = lq.A.shape[0], lq.A.shape[2]
    dtype, dev = lq.A.dtype, lq.A.device
    if mesh is None:
        suffix_scan = _suffix
        prefix_scan = _prefix
    else:
        devices = _stage_devices(mesh)
        suffix_scan = lambda e: _two_level(e, devices, _combine, True)  # noqa: E731
        prefix_scan = lambda e: _two_level(e, devices, _affine_combine, False)  # noqa: E731

    # stage elements k = 0..T-1 and the terminal element
    Linv_ruu = cholesky_inverse_or_nan(lq.Ruu)
    Rinv_Bt = cho_apply(Linv_ruu, lq.B.transpose(-1, -2))  # (B, T, nu, nx)
    Rinv_ru = cho_apply(Linv_ruu, lq.ru[..., None])[..., 0]  # (B, T, nu)
    zeros_m = torch.zeros(Bn, 1, nx, nx, dtype=dtype, device=dev)
    zeros_v = torch.zeros(Bn, 1, nx, dtype=dtype, device=dev)
    elems = _ValueElem(
        A=torch.cat([lq.A, zeros_m], dim=1),
        b=torch.cat([lq.r - _mv(lq.B, Rinv_ru), zeros_v], dim=1),
        C=torch.cat([lq.B @ Rinv_Bt, zeros_m], dim=1),
        eta=-lq.qx,
        J=lq.Qxx,
    )
    suffix = suffix_scan(elems)
    P_next, p_next = suffix.J[:, 1:], -suffix.eta[:, 1:]

    # gains from the (k+1)-suffix value functions, pointwise over the stages
    Bt = lq.B.transpose(-1, -2)
    BtP = Bt @ P_next
    Guu = lq.Ruu + BtP @ lq.B
    Gxu_T = BtP @ lq.A  # (B, T, nu, nx) = Gxu'
    gu = lq.ru + _mv(Bt, _mv(P_next, lq.r) + p_next)
    Linv = cholesky_inverse_or_nan(Guu)
    K = -cho_apply(Linv, Gxu_T)
    kff = -cho_apply(Linv, gu[..., None])[..., 0]

    # the rollout: a prefix scan of the closed loop's affine maps
    Ms, vs = prefix_scan(_Affine(lq.A + lq.B @ K, _mv(lq.B, kff) + lq.r))
    dx = torch.cat([dx0[:, None], _mv(Ms, dx0[:, None]) + vs], dim=1)
    du = _mv(K, dx[:, :-1]) + kff
    return LqSolution(dx=dx, du=du, K=K, kff=kff)

"""Fused GP posterior mean and variance: kernel 1 of the port.

Port of `gpmpc_tpu/ops/pallas_gp.py::gp_mean_var`. The CUDA kernel is
`csrc/gp_posterior.cu`, which takes every GP of an ensemble in one launch
(`gp_mean_var_multi`) from a form packed once per ensemble (`pack_form`:
the live inducing points only, Z transposed, the hyperparameters as the
kernel reads them). `gp_mean_var` takes one GP, through the same wrapper.
`gp_mean_var_plain` is the function in plain PyTorch, which the wrappers run
for CPU tensors. Strict float32 throughout: run the plain version on a card
only with TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`, the default), since the
quadratic form cancels entries ~1/noise down to variances ~1e-2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch import _build
from gpmpc_tpu_torch.ops._wrap import check, route

POINT_BLOCK = 8  # the kernel's points come in blocks of 8 (csrc/gp_posterior.cu JB)
MAX_POINTS = 128  # the kernel's largest bucket of points
MAX_DIMS = 8


def se_kernel(
    x1: torch.Tensor,  # (..., n, d)
    x2: torch.Tensor,  # (..., m, d)
    lengthscale: torch.Tensor,  # () or (d,)
    outputscale: torch.Tensor,  # ()
) -> torch.Tensor:
    """K[..., i, j] = sf2 * exp(-0.5 * sum_d (x1[i, d] - x2[j, d])^2 / ell_d^2),
    with the squared differences scaled by 1 / ell^2 as the CUDA kernels do."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return outputscale * torch.exp(-0.5 * torch.sum(diff * diff * (1.0 / lengthscale**2), dim=-1))


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


def gp_mean_var_multi(
    z: torch.Tensor, form: GpForm, include_noise: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper with `gp_mean_var_multi_plain`'s signature: all G GPs
    in one launch of `gp_posterior_kernel`. CPU tensors take the plain
    version."""
    _check_form(z, form)
    if route(z.device) == "plain":
        return gp_mean_var_multi_plain(z, form, include_noise)
    G, n, d = z.shape
    m = form.Z.shape[1]
    if n == 0 or d > MAX_DIMS or m % POINT_BLOCK:
        raise ValueError(f"gp_posterior kernel needs N > 0, D <= {MAX_DIMS} and M % "
                         f"{POINT_BLOCK} == 0 (N={n}, D={d}, M={m})")
    if m > MAX_POINTS:
        raise NotImplementedError(
            f"gp_posterior kernel holds a query's kernel row in registers: M={m} live points "
            f"(> {MAX_POINTS}); streaming W for large GPs is ROADMAP.md Queue 2 work"
        )
    mean = torch.empty(G, n, dtype=torch.float32, device=z.device)
    var = torch.empty(G, n, dtype=torch.float32, device=z.device)
    p = _build.ptr
    _build.launch(
        "gp_posterior_launch", p(z), p(form.Zt), p(form.alpha), p(form.W), p(form.mask),
        p(form.hyp), G, n, m, d, int(include_noise), p(mean), p(var),
        _build.stream_handle(z.device),
    )
    gp_mean_var_multi.launches += 1
    return mean, var


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

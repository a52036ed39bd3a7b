"""Exact Gaussian-process regression: training and posterior. Port of
`gpmpc_tpu/gp/exact_gp.py`.

GPyTorch's ExactGP with a zero mean, a scaled RBF kernel and a Gaussian
likelihood, fitted by Adam on the exact marginal log-likelihood with the
|delta loss| < 1e-3 early stop: the same softplus "raw" parameterization and
initial values, the padded buffers with row masks (a padded row gets a unit
diagonal and a zero target, which leaves the likelihood, the posterior and
the gradients of the active rows unchanged) and the bounded jitter
escalation of the Cholesky factorization.

Every function is batched over any leading axes of its data (G GPs, or S
seeds x G GPs, fit in one loop) and follows the data's dtype and device.
The fit runs under `device.strict_float32` (TF32 never touches it): a long
fit drives the likelihood noise toward its floor, where the Gram's
conditioning needs every bit of float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch.device import resolve, strict_float32
from gpmpc_tpu_torch.gp.kernels import se_kernel

_LOG_2PI = 1.8378770664093453


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without torch's linear cutoff (matches jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class GPData(NamedTuple):
    """Padded training set; leading axes may batch an ensemble."""

    x: torch.Tensor  # (..., M, D) inputs; padded rows and columns zero
    y: torch.Tensor  # (..., M) targets; padded rows zero
    mask: torch.Tensor  # (..., M) 1.0 for active rows


class GPHypers(NamedTuple):
    """Raw (unconstrained) hyperparameters with GPyTorch's transforms.
    `raw_lengthscale` has the batch shape of the others for the isotropic
    kernel and one more axis of D for ARD."""

    raw_lengthscale: torch.Tensor
    raw_outputscale: torch.Tensor
    raw_noise: torch.Tensor

    @property
    def lengthscale(self) -> torch.Tensor:
        return softplus(self.raw_lengthscale)

    @property
    def outputscale(self) -> torch.Tensor:
        return softplus(self.raw_outputscale)

    @property
    def noise(self) -> torch.Tensor:
        # GaussianLikelihood(noise_constraint=GreaterThan(1e-6))
        return softplus(self.raw_noise) + 1e-6


class GPPosterior(NamedTuple):
    """Cached factorization of K + sigma^2 I."""

    chol: torch.Tensor  # (..., M, M) lower Cholesky factor (unit rows on padding)
    alpha: torch.Tensor  # (..., M) (K + sigma^2 I)^-1 y


def init_hypers(
    dtype=torch.float32, ard_dims: int | None = None, device=None, batch_shape: tuple = ()
) -> GPHypers:
    """GPyTorch's initial values (raw 0, a lengthscale of ~0.6931), for a
    batch of `batch_shape` GPs."""
    device = resolve(device)
    zero = torch.zeros(batch_shape, dtype=dtype, device=device)
    ell = zero if ard_dims is None else torch.zeros(batch_shape + (ard_dims,), dtype=dtype,
                                                    device=device)
    return GPHypers(raw_lengthscale=ell, raw_outputscale=zero.clone(), raw_noise=zero.clone())


def _ard(hypers: GPHypers) -> bool:
    return hypers.raw_lengthscale.dim() > hypers.raw_outputscale.dim()


def _kernel(x1: torch.Tensor, x2: torch.Tensor, hypers: GPHypers) -> torch.Tensor:
    """se_kernel with a batch of hyperparameters: (..., n, m)."""
    ell = hypers.lengthscale
    ell = ell[..., None, None, :] if _ard(hypers) else ell[..., None, None, None]
    return se_kernel(x1, x2, ell, hypers.outputscale[..., None, None])


def _masked_gram(data: GPData, hypers: GPHypers) -> torch.Tensor:
    """K(X, X) + sigma^2 I with padded rows and columns replaced by the
    identity, and an outputscale-relative jitter of 1e-6 on the active
    diagonal."""
    K = _kernel(data.x, data.x, hypers)
    K = K * (data.mask[..., :, None] * data.mask[..., None, :])
    jitter = 1e-6 * hypers.outputscale
    diag = (hypers.noise + jitter)[..., None] * data.mask + (1.0 - data.mask)
    return K + torch.diag_embed(diag)


# Escalation multipliers of `_robust_cholesky`'s retries; level 0 is the plain
# factorization.
_JITTER_ESCALATION = (10.0, 100.0, 1e3, 1e4)


def _cholesky_or_nan(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(factor, ok (...,)): `torch.linalg.cholesky_ex` without a host sync,
    where a failed factorization (info != 0, or a non-finite factor) becomes
    NaN as JAX's does (LAPACK leaves a partial factor)."""
    L, info = torch.linalg.cholesky_ex(K)
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1)
    return torch.where(ok[..., None, None], L, torch.full_like(L, torch.nan)), ok


def _robust_cholesky(data: GPData, hypers: GPHypers) -> tuple[torch.Tensor, torch.Tensor]:
    """(Cholesky factor of the masked Gram, plain_ok (...,)). Where the plain
    factorization fails (float32 positive-definiteness loss), the first of
    the retries with 10x, 100x, 1e3x and 1e4x the base outputscale-relative
    jitter on the active diagonal that succeeds; NaN if none does.

    The reference runs every retry under `lax.cond`, and JAX's gradient of
    its marginal likelihood is NaN wherever the plain factorization failed
    (the failed factor's NaNs reach the cotangents, batched or not: checked
    on JAX's CPU backend), so its fit skips those updates. `plain_ok` carries
    that: `marginal_log_likelihood_and_grad` poisons the gradient of a GP
    whose plain factorization failed. The retries run only when some GP of
    the batch needs one (one host read of the flags), since a retry after a
    successful level is never selected."""
    K = _masked_gram(data, hypers)
    chol, ok = _cholesky_or_nan(K)
    plain_ok = ok
    if bool(ok.all()):
        return chol, plain_ok
    base = 1e-6 * hypers.outputscale
    for mult in _JITTER_ESCALATION:
        retry, ok_r = _cholesky_or_nan(K + torch.diag_embed((base * mult)[..., None] * data.mask))
        chol = torch.where(ok[..., None, None], chol, retry)
        ok = ok | ok_r
        if bool(ok.all()):
            break
    return chol, plain_ok


def _cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 b for b (..., M) or (..., M, k)."""
    if b.dim() == chol.dim() - 1:
        return torch.cholesky_solve(b[..., None], chol)[..., 0]
    return torch.cholesky_solve(b, chol)


def _mll_from_chol(chol: torch.Tensor, data: GPData) -> torch.Tensor:
    alpha = _cho_solve(chol, data.y)
    n = torch.clamp_min(torch.sum(data.mask, dim=-1), 1.0)
    quad = torch.sum(data.y * alpha, dim=-1)
    # padded rows have a unit diagonal: log-det contribution 0
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (quad + logdet + n * _LOG_2PI) / n


def marginal_log_likelihood(hypers: GPHypers, data: GPData) -> torch.Tensor:
    """Exact MLL averaged over the active points (GPyTorch's
    ExactMarginalLogLikelihood per datum), (...,)."""
    chol, _ = _robust_cholesky(data, hypers)
    return _mll_from_chol(chol, data)


def marginal_log_likelihood_and_grad(
    hypers: GPHypers, data: GPData
) -> tuple[torch.Tensor, GPHypers]:
    """(negative MLL (...,), its gradient with respect to each raw leaf), as
    the reference's `jax.value_and_grad` of it gives them: the gradient of a
    GP whose plain factorization failed is NaN (see `_robust_cholesky`)."""
    with torch.enable_grad():
        leaves = [h.detach().requires_grad_(True) for h in hypers]
        h = GPHypers(*leaves)
        chol, plain_ok = _robust_cholesky(data, h)
        loss = -_mll_from_chol(chol, data)
        grads = torch.autograd.grad(loss.sum(), leaves)
    grads = [
        torch.where(plain_ok.reshape(plain_ok.shape + (1,) * (g.dim() - plain_ok.dim())), g,
                    torch.full_like(g, torch.nan))
        for g in grads
    ]
    return loss.detach(), GPHypers(*grads)


class _AdamState(NamedTuple):
    m: GPHypers
    v: GPHypers
    t: torch.Tensor  # (...,) int32: steps taken, per GP


def _adam_update(g: GPHypers, st: _AdamState, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step per GP, with the bias corrections computed in the
    parameters' dtype (as the reference pins them)."""
    t = st.t + 1
    m = GPHypers(*[b1 * m_ + (1 - b1) * g_ for m_, g_ in zip(st.m, g)])
    v = GPHypers(*[b2 * v_ + (1 - b2) * g_ * g_ for v_, g_ in zip(st.v, g)])

    def step_leaf(m_, v_):
        dt = m_.dtype
        tf = t.to(dt).reshape(t.shape + (1,) * (m_.dim() - t.dim()))
        c1 = 1 - torch.tensor(b1, dtype=dt, device=m_.device) ** tf
        c2 = 1 - torch.tensor(b2, dtype=dt, device=m_.device) ** tf
        return torch.tensor(lr, dtype=dt, device=m_.device) * (m_ / c1) / (torch.sqrt(v_ / c2) + eps)

    step = GPHypers(*[step_leaf(m_, v_) for m_, v_ in zip(m, v)])
    return step, _AdamState(m=m, v=v, t=t)


class FitInfo(NamedTuple):
    """What the fit did, per GP: the iteration (0-based) at which the early
    stop froze it (-1 if it never did), and how many iterations the loop
    ran before every GP was frozen (at most n_train)."""

    freeze_step: torch.Tensor  # (...,) int64
    iterations: int


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


def fit_gp(
    data: GPData,
    hypers: GPHypers | None = None,
    n_train: int = 500,
    lr: float = 0.01,
    return_info: bool = False,
):
    """Adam on the negative MLL with the |delta loss| < 1e-3 early stop,
    per GP of the batch: (hypers, final loss (...,)), and a FitInfo with
    `return_info`.

    The reference's fixed-length scan, step by step: an iteration whose loss
    or gradient is not finite, or of a frozen GP, changes nothing; a GP
    freezes at the first finite iteration whose loss is within 1e-3 of the
    last applied one (that iteration's update still applies). The loop
    stops once every GP is frozen, which gives the same result as running
    on (one host read a iteration)."""
    if hypers is None:
        hypers = init_hypers(data.x.dtype, device=data.x.device, batch_shape=tuple(data.y.shape[:-1]))
    with strict_float32():
        return _fit_gp(data, hypers, n_train, lr, return_info)


def _fit_gp(data, hypers, n_train, lr, return_info):
    batch = tuple(data.y.shape[:-1])
    dev, dtype = data.x.device, data.x.dtype
    hypers = GPHypers(*[h.detach().expand(batch + h.shape[len(batch):]).clone() for h in hypers])
    zeros = GPHypers(*[torch.zeros_like(h) for h in hypers])
    adam = _AdamState(m=zeros, v=zeros, t=torch.zeros(batch, dtype=torch.int32, device=dev))
    last_loss = torch.full(batch, torch.inf, dtype=dtype, device=dev)
    frozen = torch.zeros(batch, dtype=torch.bool, device=dev)
    freeze_step = torch.full(batch, -1, dtype=torch.int64, device=dev)
    it = 0
    for it in range(n_train):
        loss, g = marginal_log_likelihood_and_grad(hypers, data)
        finite = torch.isfinite(loss)
        for g_ in g:
            finite = finite & torch.isfinite(g_).reshape(batch + (-1,)).all(-1)
        skip = frozen | ~finite
        step, adam_new = _adam_update(g, adam, lr)
        h_new = GPHypers(*[p - s for p, s in zip(hypers, step)])
        now_frozen = frozen | (finite & (torch.abs(last_loss - loss) < 1e-3))
        freeze_step = torch.where(now_frozen & ~frozen, it, freeze_step)
        hypers = GPHypers(*[_where(skip, old, new) for old, new in zip(hypers, h_new)])
        adam = _AdamState(
            m=GPHypers(*[_where(skip, o, n) for o, n in zip(adam.m, adam_new.m)]),
            v=GPHypers(*[_where(skip, o, n) for o, n in zip(adam.v, adam_new.v)]),
            t=torch.where(skip, adam.t, adam_new.t),
        )
        last_loss = torch.where(skip, last_loss, loss)
        frozen = now_frozen
        if bool(frozen.all()):
            break
    if not return_info:
        return hypers, last_loss
    return hypers, last_loss, FitInfo(freeze_step=freeze_step, iterations=it + 1 if n_train else 0)


def posterior(hypers: GPHypers, data: GPData) -> GPPosterior:
    """Factorize K + sigma^2 I (with `_robust_cholesky`'s escalation) and
    cache alpha = (K + sigma^2 I)^-1 y."""
    with strict_float32(), torch.no_grad():
        chol, _ = _robust_cholesky(data, hypers)
        return GPPosterior(chol=chol, alpha=_cho_solve(chol, data.y))


def predict_mean(hypers: GPHypers, data: GPData, post: GPPosterior, z: torch.Tensor) -> torch.Tensor:
    """Posterior mean k(z, X) alpha at test points z: (..., n, D) -> (..., n)."""
    K_zx = _kernel(z, data.x, hypers) * data.mask[..., None, :]
    return (K_zx @ post.alpha[..., None])[..., 0]


def predict_var(
    hypers: GPHypers, data: GPData, post: GPPosterior, z: torch.Tensor, include_noise: bool = True
) -> torch.Tensor:
    """Exact posterior variance at z: (..., n, D) -> (..., n)."""
    K_zx = _kernel(z, data.x, hypers) * data.mask[..., None, :]
    v = torch.linalg.solve_triangular(post.chol, K_zx.transpose(-1, -2), upper=False)
    var = torch.clamp_min(hypers.outputscale[..., None] - torch.sum(v * v, dim=-2), 1e-12)
    if include_noise:
        var = var + hypers.noise[..., None]
    return var

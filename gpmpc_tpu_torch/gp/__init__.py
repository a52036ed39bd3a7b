from gpmpc_tpu_torch.gp.exact_gp import (
    GPData,
    GPHypers,
    GPPosterior,
    fit_gp,
    init_hypers,
    marginal_log_likelihood,
    posterior,
    predict_mean,
    predict_var,
)
from gpmpc_tpu_torch.gp.kernels import se_kernel, se_kernel_diag
from gpmpc_tpu_torch.gp.sparse import fitc_posterior_mean

__all__ = [
    "se_kernel",
    "se_kernel_diag",
    "GPData",
    "GPHypers",
    "GPPosterior",
    "fit_gp",
    "init_hypers",
    "marginal_log_likelihood",
    "posterior",
    "predict_mean",
    "predict_var",
    "fitc_posterior_mean",
]

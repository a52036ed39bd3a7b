"""gpmpc_tpu_torch: the GP-MPC engine of `gpmpc_tpu`, ported to PyTorch and CUDA.

The JAX package `gpmpc_tpu` is the reference; this package mirrors its module
paths (`ops/pallas_X.py` becomes `ops/cuda_X.py`) and is tested against it on
identical inputs. It imports `torch`, numpy and scipy, never `jax` and never
`gpmpc_tpu`.

The slice ported so far is the `lanes-fused` closed-loop step
(`parallel/batch.py::batched_gpmpc_step`) for the three model families
(quadrotor, cartpole, two-link arm): hard or L1-soft state bounds, Mehrotra
IP, horizons up to `ops/sqp_lanes.py::MAX_FUSED_HORIZON` (400). Its kernels
are hand-written CUDA C++ in `csrc/` (GP posterior, tightening, linearization
and the interior-point QP in its resident and two streamed tiers),
instantiated per family and built with `nvcc` on first use (`_build.py`);
every kernel wrapper runs its plain PyTorch version only for CPU tensors.
Entry points that create tensors default to the card (`device.py::resolve`)
and raise without one; the tests pass `device="cpu"`. Importing this package
does no work beyond defining names.
"""

__version__ = "0.1.0"

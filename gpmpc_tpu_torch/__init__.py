"""gpmpc_tpu_torch: the GP-MPC engine of `gpmpc_tpu`, ported to PyTorch and CUDA.

The JAX package `gpmpc_tpu` is the reference; this package mirrors its module
paths (`ops/pallas_X.py` becomes `ops/cuda_X.py`) and is tested against it on
identical inputs. It imports `torch`, numpy and scipy, never `jax` and never
`gpmpc_tpu`.

The slice ported so far is the `lanes-fused` closed-loop step
(`parallel/batch.py::batched_gpmpc_step`): quadrotor, hard bounds, Mehrotra IP,
horizons up to `ops/sqp_lanes.py::MAX_LANES_HORIZON`. Its four kernels are
hand-written CUDA C++ in `csrc/`, built with `nvcc` on first use
(`_build.py`); every kernel wrapper runs its plain PyTorch version only for
CPU tensors. Importing this package does no work beyond defining names.
"""

__version__ = "0.1.0"

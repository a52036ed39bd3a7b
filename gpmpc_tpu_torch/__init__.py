"""gpmpc_tpu_torch: the GP-MPC engine of `gpmpc_tpu`, ported to PyTorch and CUDA.

The JAX package `gpmpc_tpu` is the reference; this package mirrors its module
paths (`ops/pallas_X.py` becomes `ops/cuda_X.py`) and is tested against it on
identical inputs. It imports `torch`, numpy and scipy, never `jax` and never
`gpmpc_tpu`.

Ported so far: the closed-loop GP-MPC step for the three model families
(quadrotor, cartpole, two-link arm) on all three dispatch paths of
`parallel/batch.py::batched_gpmpc_step` (`lanes-fused`, `lanes`, and `xla`,
the reference's default: `control/gpmpc.py::select_action` on the nominal
solver stack `ops/riccati.py`, `ops/boxqp.py`, `ops/sqp.py::sqp_solve`),
hard or L1-soft state bounds, the nominal `MPC`, GP training, the stateful
`GPMPC`, `OnlineLearner`, episodes and the seed sweep. The kernels are
hand-written CUDA C++ in `csrc/` (GP posterior, tightening, linearization
and the interior-point QP in its resident and two streamed tiers, and the
lane chains of the roofline probe), built with `nvcc` at the first launch
(`_build.py`); every kernel wrapper runs its plain PyTorch version only for
CPU tensors, and the `xla` path is plain torch, as it is XLA code in the
reference. Entry points that create tensors default to the card
(`device.py::resolve`) and raise without one; the tests pass
`device="cpu"`. The packages export the reference's names (`__all__`) that
are ported; importing them builds nothing. ROADMAP.md lists what is not
ported yet.
"""

__version__ = "0.1.0"

from gpmpc_tpu_torch.models.symbolic import SymbolicModel, symbolic_attitude
from gpmpc_tpu_torch.models.trajectory import figure_eight_trajectory

__all__ = [
    "SymbolicModel",
    "symbolic_attitude",
    "figure_eight_trajectory",
    "__version__",
]

// Box-constrained OCP-QP primal-dual interior point, resident kernel, hard
// state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py:1807 solve_ocp_qp_lanes (body
// _ip_kernel_body, :158, with _mm, _mv and the _chol4_* helpers), hard-bound
// modes: plain centering or Mehrotra predictor-corrector, fixed iteration
// count or the adaptive exit. Mehrotra factorizes once per iteration: the
// affine sweep stores P r, the Guu Cholesky factor and Gxu, and the corrector
// reuses them in a vector-only sweep.
//
// What bounds it on an H100: operations, about 11.5k per stage and iteration
// at 12x4 (chip_smoke.py::bound_ocp), most of them a chain of small dependent
// products per scenario; there is no data reuse across scenarios.
//
// Design: ocp_ip_resident.cuh (shared with the soft kernel), here as
// Cfg<NX, NU, SOFT = false>: a team of threads per scenario, one per matrix
// row; a 128-scenario tile spread over a thread-block cluster, whose blocks
// vote on the adaptive exit through distributed shared memory; [A_k | B_k]
// staged into shared memory a stage ahead with cp.async. ptxas's registers and
// spills, and the launch geometry, are in PERF.md.
#include "ocp_ip_resident.cuh"

GPMPC_OCP_IP_RESIDENT_ENTRY_POINTS(ocp_ip, false)

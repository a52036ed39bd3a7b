// Box-constrained OCP-QP primal-dual interior point, resident kernel, hard
// state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py::solve_ocp_qp_lanes (_ip_kernel_body,
// with _mm, _mv and the _chol4_* helpers), hard-bound modes: plain centering or
// Mehrotra predictor-corrector, fixed iteration count or the adaptive exit.
// Mehrotra factorizes once per iteration: the affine sweep stores P r, the
// Guu Cholesky factor and Gxu, and the corrector reuses them in a
// vector-only sweep.
//
// What bounds it on an H100: the sequential dependency chain per scenario
// (T stages x ~4k FMAs per Riccati step at NX = 12, twice per iteration) and on-chip
// memory bandwidth for the per-stage matrices; there is no data reuse across
// scenarios. Device-memory traffic is the QP data (~1 KB per scenario-stage,
// read once per sweep from L2) and the per-scenario workspace.
//
// Design: ocp_ip.cuh (shared with the soft and the streamed kernels), here as
// Cfg<NX, NU, SOFT = false, RESIDENT>. The per-stage register arrays (Gxu,
// Guu, its factor, gx, p) spill some (ptxas -v; the counts are in PERF.md).
#include "ocp_ip.cuh"

GPMPC_OCP_IP_ENTRY_POINTS(ocp_ip, false, gpmpc::ocp::RESIDENT)

// Box-constrained OCP-QP primal-dual interior point, resident kernel, L1-soft
// state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py::solve_ocp_qp_lanes with soft_rho set
// (_ip_kernel_body, soft branches): the state boxes become L1 penalties of
// weight rho in the bounded-multiplier form, so that crossed or infeasible
// boxes stay well posed; input boxes stay hard.
//
// What bounds it on an H100: as the hard kernel, the sequential Riccati chain
// per scenario; the soft algebra adds ~30 flops and four divisions per state
// element and pass, and four more (T+1) NX workspace arrays per scenario.
//
// Design: ocp_ip.cuh, here as Cfg<NX, NU, SOFT = true, RESIDENT>: the fused
// weight over den, explicit nu, the extra step-length and gap pairs, and the
// 1e-8 centering floors. The tile-wide exit is always on (the wrapper passes
// adaptive_tol >= 1e-8): it is also the numerical stop of the soft mode.
#include "ocp_ip.cuh"

GPMPC_OCP_IP_ENTRY_POINTS(ocp_ip_soft, true, gpmpc::ocp::RESIDENT)

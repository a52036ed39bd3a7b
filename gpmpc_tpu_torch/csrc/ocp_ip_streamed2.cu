// Box-constrained OCP-QP interior point for the longest horizons the lanes
// path serves, tier 2, hard state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py::solve_ocp_qp_lanes_streamed2
// (_ip_kernel_body_streamed2). The arithmetic of tier 1 (no factorization
// stores, two matrix sweeps per Mehrotra iteration, the dynamics residual
// inside the first sweep).
//
// What bounds it on an H100: the sequential Riccati chain per scenario and
// device-memory traffic: at these horizons the QP data of a batch (~1 KB per
// scenario-stage) and the workspace (~0.64 KB per scenario-stage hard) pass
// the L2's 50 MB, so every sweep reads them from device memory.
//
// Design: ocp_ip.cuh, here as Cfg<NX, NU, SOFT = false, STREAMED2>. What differs
// from tier 1 on this card: the backward sweep hints every read-only array of
// the next stage into L2 (r, qdiag, qx, rdiag, ru and the four boxes beside A
// and B), not A and B alone. The gains K already live in the device-memory
// workspace in every tier. All flat offsets are 64-bit (lanes.cuh), and the
// wrapper refuses a call whose workspace does not fit the card's free memory.
#include "ocp_ip.cuh"

GPMPC_OCP_IP_ENTRY_POINTS(ocp_ip_streamed2, false, gpmpc::ocp::STREAMED2)

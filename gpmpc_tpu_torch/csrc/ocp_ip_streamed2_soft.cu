// Box-constrained OCP-QP interior point for the longest horizons the lanes
// path serves, tier 2, L1-soft state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py:1607 solve_ocp_qp_lanes_streamed2
// with soft_rho set (body _ip_kernel_body_streamed2, :1021, soft branches):
// the state boxes become L1 penalties of weight rho in the bounded-multiplier
// form; input boxes stay hard. As for the hard kernel, the TPU kernel's
// corrector repeats the matrix sweep, and this one keeps the affine sweep's
// stores: the same solution and per-tile iteration count.
//
// What bounds it on an H100: as the hard kernel, operations in a chain of
// small products per scenario and the QP data's device-memory traffic; the
// soft algebra adds ~30 flops and four divisions per state element and pass,
// and four more (T+1) NX workspace arrays per scenario.
//
// Design: ocp_ip_resident.cuh, here as Cfg<NX, NU, SOFT = true> under tier
// 2's names (see ocp_ip_streamed2.cu). The tile-wide exit is always on (the
// wrapper passes adaptive_tol >= 1e-8): it is also the numerical stop of the
// soft mode.
#include "ocp_ip_resident.cuh"

GPMPC_OCP_IP_RESIDENT_ENTRY_POINTS(ocp_ip_streamed2_soft, true)

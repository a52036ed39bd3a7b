// Box-constrained OCP-QP interior point for horizons past the resident cap,
// tier 1, L1-soft state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py:1711 solve_ocp_qp_lanes_streamed
// with soft_rho set (body _ip_kernel_body_streamed, :517, soft branches): the
// state boxes become L1 penalties of weight rho in the bounded-multiplier
// form; input boxes stay hard. As for the hard kernel, the TPU kernel's
// corrector repeats the matrix sweep, and this one keeps the affine sweep's
// stores: the same solution and per-tile iteration count. The plain version
// keeps the TPU kernel's arithmetic (refactor=True).
//
// What bounds it on an H100: as the hard kernel, operations in a chain of
// dependent small products per stage and scenario; the soft algebra adds ~30
// flops and four divisions per state element and pass, and four more (T+1)
// NX workspace arrays per scenario.
//
// Design: ocp_ip_resident.cuh, here as Cfg<NX, NU, SOFT = true> under tier
// 1's names (see ocp_ip_streamed.cu). The tile-wide exit is always on (the
// wrapper passes adaptive_tol >= 1e-8): it is also the numerical stop of the
// soft mode.
#include "ocp_ip_resident.cuh"

GPMPC_OCP_IP_RESIDENT_ENTRY_POINTS(ocp_ip_streamed_soft, true)

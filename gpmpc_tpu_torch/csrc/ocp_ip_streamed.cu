// Box-constrained OCP-QP interior point for horizons past the resident cap,
// tier 1, hard state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py:1711 solve_ocp_qp_lanes_streamed
// (body _ip_kernel_body_streamed, :517). The TPU kernel keeps no
// factorization stores, since VMEM could not hold them past the resident cap,
// so its Mehrotra corrector repeats the matrix sweep. The corrector's
// matrices are the affine sweep's, so keeping the stores computes the same
// solution and the same per-tile iteration count; the plain version
// (ops/cuda_ocp.py::solve_ocp_qp_lanes_streamed_plain) keeps the TPU
// kernel's arithmetic (refactor=True: the corrector repeats the sweep).
//
// What bounds it on an H100: operations, about 11.5k per stage and iteration
// at 12x4 (chip_smoke.py::bound_ocp), of which a scenario's Riccati stage is
// a chain of dependent small products. The Mehrotra stores fit the card at
// this tier's caps: the workspace is 252 T floats a scenario at 12x4, about
// 0.4 GB at T = 400, B = 1024.
//
// Design: the resident kernel's (ocp_ip_resident.cuh), instantiated under
// tier 1's names as Cfg<NX, NU, SOFT = false>: a team of threads per
// scenario, a 128-lane tile over a thread-block cluster with the exit voted
// through distributed shared memory, [A_k | B_k] staged a stage ahead with
// cp.async, the Mehrotra stores in the device-memory workspace, 64-bit
// offsets into every lanes-layout array. All three tiers are this one
// kernel; ops/sqp_lanes.py keeps the reference's horizon caps, so a horizon
// goes to the same tier in both packages.
#include "ocp_ip_resident.cuh"

GPMPC_OCP_IP_RESIDENT_ENTRY_POINTS(ocp_ip_streamed, false)

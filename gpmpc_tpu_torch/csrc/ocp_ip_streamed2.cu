// Box-constrained OCP-QP interior point for the longest horizons the lanes
// path serves, tier 2, hard state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py:1607 solve_ocp_qp_lanes_streamed2
// (body _ip_kernel_body_streamed2, :1021). The TPU kernel keeps no
// factorization stores, since VMEM could not hold them at these horizons, so
// its Mehrotra corrector repeats the matrix sweep. The corrector's matrices
// are the affine sweep's, so keeping the stores computes the same solution
// and the same per-tile iteration count; the plain version
// (ops/cuda_ocp.py::solve_ocp_qp_lanes_streamed2_plain) keeps the TPU
// kernel's arithmetic.
//
// What bounds it on an H100: operations, about 11.5k per stage and iteration
// at 12x4 (chip_smoke.py::bound_ocp), of which a scenario's Riccati stage is
// a chain of dependent small products; and device-memory traffic, since at
// these horizons the QP data of a batch (~1 KB a scenario and stage, 134 MB
// at T = 512, B = 256) passes the L2's 50 MB.
//
// Design: the resident kernel's (ocp_ip_resident.cuh), instantiated under
// tier 2's names as Cfg<NX, NU, SOFT = false>: a team of threads per
// scenario, a 128-lane tile over a thread-block cluster with the exit voted
// through distributed shared memory, [A_k | B_k] staged a stage ahead with
// cp.async, and the Mehrotra stores (P r, the Guu factor and Gxu, 76 T floats
// a scenario at 12x4) in the device-memory workspace. Every offset into a
// lanes-layout array is 64-bit. Staging each stage's other read-only rows
// (r, the diagonals, gradients and boxes) into shared memory as well gained
// nothing on the card at T = 512 and 1024 (PERF.md, section 6): the chain of
// dependent small products in each stage bounds the kernel, not the QP
// data's traffic. The wrapper refuses a call whose workspace does not fit
// the card's free memory.
#include "ocp_ip_resident.cuh"

GPMPC_OCP_IP_RESIDENT_ENTRY_POINTS(ocp_ip_streamed2, false)

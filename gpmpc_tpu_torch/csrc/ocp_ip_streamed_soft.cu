// Box-constrained OCP-QP interior point for horizons past the resident cap,
// tier 1, L1-soft state bounds.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py::solve_ocp_qp_lanes_streamed
// (_ip_kernel_body_streamed). The same interior point as the resident kernel
// with another arithmetic: no factorization stores, so the Mehrotra corrector
// repeats the full matrix sweep, and the dynamics residual is formed inside
// the first backward sweep of an iteration.
//
// What bounds it on an H100: the sequential Riccati chain per scenario, now
// two matrix sweeps per Mehrotra iteration (T stages x ~4k FMAs each at
// NX = 12), and the per-scenario workspace in device memory, which at long
// horizons no longer stays in L2. On this card the tier earns its keep by
// its smaller workspace (160 T floats per scenario at 12x4 against the
// resident kernel's 252 T), not by where A and B live.
//
// Design: ocp_ip.cuh, here as Cfg<NX, NU, SOFT = true, STREAMED>. There is no
// chunked copy of A and B into the block: the sweep hints the next stage's A
// and B into L2 while it works on the current one (prefetch_stage), which
// hides their device-memory latency behind ~10k FMAs and takes no shared
// memory.
#include "ocp_ip.cuh"

GPMPC_OCP_IP_ENTRY_POINTS(ocp_ip_streamed_soft, true, gpmpc::ocp::STREAMED)

// The resident OCP-QP interior-point kernel (kernel 4, hard and soft), as
// designed for Hopper: a team of threads per scenario and a 128-scenario tile
// spread over a thread-block cluster. ocp_ip.cu and ocp_ip_soft.cu instantiate
// it, and so do the tier-1 sources (kernel 5, ocp_ip_streamed*.cu) and the
// tier-2 sources (kernel 6, ocp_ip_streamed2*.cu) under their own names: all
// three QP tiers are this kernel. The element algebra (Terms, pair_*,
// x_terms, chol) is ocp_ip.cuh's.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py:1807 solve_ocp_qp_lanes (body
// _ip_kernel_body, :158), every mode: plain centering or Mehrotra, a fixed
// iteration count or the tile-wide adaptive exit, hard or L1-soft state bounds
// (soft_rho). Mehrotra factorizes once per iteration: the affine sweep stores
// P r, the Guu Cholesky factor and Gxu, and the corrector is a vector-only
// sweep over them.
//
// What bounds it on an H100: operations, about 11.5k per stage and iteration
// at 12x4 (chip_smoke.py::bound_ocp), of which a single scenario's Riccati
// stage is a chain of dependent small products. One thread per scenario (the
// design this replaces) ran that chain of ~12k operations alone, with 8 blocks
// of 128 threads at B = 1024 on 132 SMs and spilled registers.
//
// Design:
//  * A team of TEAM threads (16 at 12x4, 8 at 4x1 and 4x2: the power of two
//    at or above NX + NU, so a team lies inside one warp) solves one
//    scenario. Thread i of a team owns row i: of P (kept in registers across
//    the backward sweep), of W = P [A|B], of [A|B]^T W (Gxx, Gxu; thread
//    NX + u takes row u of Guu) and of the gains; it forms its row of each
//    product, so a thread's chain per stage is about NX times shorter. The
//    operands every row needs (P r, the rows of W, the columns of K, Guu and
//    gu) go through the team's own shared memory between __syncwarp()s. The
//    NU x NU Cholesky and its solves are computed by every thread of the team
//    from the broadcast Guu. The element loops (barrier terms, step lengths,
//    gaps, the update) spread a scenario's (T+1) NX state and T NU input
//    elements over the team's threads; the team's minima and sums are
//    butterfly shuffles, which leave the same bits in every thread of the
//    team, and the update forms the next gap on the way.
//  * A tile of L lanes is one cluster of `cluster` blocks with L / cluster
//    scenarios each (ops/cuda_ocp.py::resident_geometry; at 12x4, 8
//    scenarios x 16 threads = 128 threads a block and a cluster of 16, so
//    128 blocks at B = 1024 instead of 8). The tile stays the unit of the
//    adaptive exit: each block votes with __syncthreads_and over its
//    scenarios' threads, writes its vote into its shared memory, and every
//    thread reads all the cluster's votes through distributed shared memory
//    after a cluster barrier (two vote slots, so one barrier a vote).
//    Padded lanes vote, as in the reference.
//  * [A_k | B_k] of the block's scenarios is staged into shared memory one
//    stage ahead with cp.async (double-buffered), each scenario's rows padded
//    to 16-byte quads, so a team reads a row with a few 16-byte broadcasts;
//    the copies read each entry as a contiguous run of the block's lanes.
//    Each of the four sweeps an iteration (affine and corrector, each
//    backward and forward) streams it once; the dynamics residual forms
//    inside the first backward sweep of an iteration. What the next stage
//    reads from device memory is hinted into L1 while the current one runs.
//  * The per-scenario state (slacks, duals, dx, du, K, kff, the dynamics
//    residual, directions and the Mehrotra stores) lives in device memory,
//    scenario-major (a team reads consecutive floats), allocated by the
//    wrapper at ws_layout(T).total floats a scenario; the read-only vectors
//    (r, the diagonals, gradients and boxes) are read from the lanes layout.
//    dx and du are copied to the lanes-layout outputs at the end.
//  * float32 throughout, no tensor cores.
#pragma once

#include <cooperative_groups.h>

#include "ocp_ip.cuh"

namespace gpmpc {
namespace ocp {
namespace resident {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;  // threads a block may have: the launch bounds leave ptxas
                                  // up to 255 registers a thread, so nothing spills

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// n floats rounded up to whole 16-byte quads, and then to an odd number of
// quads: consecutive scenarios' areas, read as quads by the teams of one
// warp, then start in different banks.
__host__ __device__ constexpr int odd_quads(int n) {
  return ((n + 3) / 4 % 2 == 1) ? (n + 3) / 4 * 4 : (n + 3) / 4 * 4 + 4;
}

template <int NX_, int NU_, bool SOFT_>
struct Cfg {
  static constexpr int NX = NX_, NU = NU_, NXU = NX_ + NU_;
  static constexpr bool SOFT = SOFT_;
  static constexpr int TEAM = pow2_at_least(NX_ + NU_);
  static constexpr int AB = NX_ * NX_ + NX_ * NU_;  // entries of [A_k | B_k]
  // a row of [A_k | B_k] (or of W) in shared memory, padded to whole quads
  static constexpr int RW = (NXU + 3) / 4 * 4;
  // floats of one scenario's [A_k | B_k] in a stage slab: NX rows of RW
  static constexpr int SLAB = odd_quads(NX * RW);
  // floats of one team's shared memory: W (NX rows of RW, reused for
  // P + Gxu K), the dynamics residual and F = P r + p (NX each), K (NU x NX),
  // Guu and gu, and the rollout's two state vectors
  static constexpr int TEAM_FLOATS = odd_quads(NX * RW + 2 * NX + NU * NX + NU * NU + NU + 2 * NX);
  static_assert(TEAM <= 32 && TEAM >= NXU, "a team covers the NX + NU rows inside one warp");
  static_assert((NX * RW + 2 * NX) % 4 == 0 && NX % 4 == 0, "K's rows start on 16-byte boundaries");
};

// Bytes of dynamic shared memory of a block of `spb` scenarios: two stage
// slabs, the teams' areas and the two vote slots. Every area starts on a
// 16-byte boundary.
template <class C>
__host__ __device__ long shared_bytes(int spb) {
  return 4L * (2L * C::SLAB * spb + (long)spb * C::TEAM_FLOATS + 2);
}

// Offsets (in floats per scenario) of the workspace arrays.
struct WsLayout {
  long slx, sux, llx, lux, slu, suu, llu, luu;
  long K, kff, rdyn, ddx_a, ddu_a, ddx, ddu, Pr, lchol, Gxu, dx, du;
  long elx, eux, nulx, nuux;  // soft only
  long total;
};

template <class C>
__host__ __device__ WsLayout ws_layout(int T) {
  constexpr int NX = C::NX, NU = C::NU;
  WsLayout w{};
  const long nxs = (long)(T + 1) * NX, nus = (long)T * NU;
  long o = 0;
  w.slx = o; o += nxs;
  w.sux = o; o += nxs;
  w.llx = o; o += nxs;
  w.lux = o; o += nxs;
  w.slu = o; o += nus;
  w.suu = o; o += nus;
  w.llu = o; o += nus;
  w.luu = o; o += nus;
  w.K = o; o += (long)T * NU * NX;
  w.kff = o; o += nus;
  w.rdyn = o; o += (long)T * NX;
  w.ddx_a = o; o += nxs;
  w.ddu_a = o; o += nus;
  w.ddx = o; o += nxs;
  w.ddu = o; o += nus;
  w.Pr = o; o += (long)T * NX;
  w.lchol = o; o += (long)T * NU * NU;
  w.Gxu = o; o += (long)T * NX * NU;
  w.dx = o; o += nxs;
  w.du = o; o += nus;
  if (C::SOFT) {
    w.elx = o; o += nxs;
    w.eux = o; o += nxs;
    w.nulx = o; o += nxs;
    w.nuux = o; o += nxs;
  }
  w.total = o;
  return w;
}

// One scenario's contiguous workspace array.
struct Seg {
  float* p;
  __device__ __forceinline__ float& operator[](long i) const { return p[i]; }
};

// One scenario's read-only array in the lanes layout (element i at i * L).
struct Strided {
  const float* p;
  int L;
  __device__ __forceinline__ float operator[](long i) const { return __ldg(p + i * L); }
  __device__ __forceinline__ const float* at(long i) const { return p + i * L; }
};

// One scenario's view of the problem, with the member names x_terms and
// u_terms (ocp_ip.cuh) read.
template <class C>
struct TeamIp {
  static constexpr bool SOFT = C::SOFT;
  int T;
  bool mehrotra;
  Strided r, qdiag, qx, rdiag, ru, lx, ux, lu, uu;
  Seg dx, du, slx, sux, llx, lux, slu, suu, llu, luu;
  Seg K, kff, rdyn, ddx_a, ddu_a, ddx, ddu, Pr, lchol, Gxu;
  Seg elx, eux, nulx, nuux;
};

// Where a thread sits: its row in the team, its scenario in the block, and
// the block's shared memory.
template <class C>
struct Team {
  int tr, s, spb;
  int copy_e, copy_s;  // the first slab entry and the lane this thread copies
  const float* A;  // (tile, 0, 0, 0, lane0) of the lanes-layout A
  const float* B;
  int L, T;
  float* slab;  // two stage slabs of C::SLAB * spb floats, scenario by scenario, row-major
  float *W, *rd, *F, *K, *Gu, *x;
};

// ---- staging [A_k | B_k] -------------------------------------------------------

// (cp_async4, cp_async_commit and cp_async_wait: lanes.cuh)

// Issue the copy of stage k's [A_k | B_k] for the block's spb lanes into dst:
// entry (j, c) of scenario s at dst[s * SLAB + j * RW + c], so that a team
// reads its rows as 16-byte quads. Thread t copies lane t % spb of entries
// t / spb, + TEAM, ...: neighbouring threads read neighbouring lanes.
template <class C>
__device__ __forceinline__ void fetch_stage(const Team<C>& tm, float* dst, int k) {
  constexpr int NXX = C::NX * C::NX, NXU_B = C::NX * C::NU;
  const long L = tm.L;
  const float* a = tm.A + (long)k * NXX * L + tm.copy_s;
  const float* b = tm.B + (long)k * NXU_B * L + tm.copy_s;
  float* mine = dst + tm.copy_s * C::SLAB;
  for (int e = tm.copy_e; e < C::AB; e += C::TEAM) {
    if (e < NXX)
      cp_async4(mine + (e / C::NX) * C::RW + e % C::NX, a + (long)e * L);
    else
      cp_async4(mine + ((e - NXX) / C::NU) * C::RW + C::NX + (e - NXX) % C::NU,
                b + (long)(e - NXX) * L);
  }
  cp_async_commit();
}

// Row j of [A_k | B_k] of this thread's scenario in a stage slab.
template <class C>
__device__ __forceinline__ const float* ab_row(const Team<C>& tm, const float* slab, int j) {
  return slab + tm.s * C::SLAB + j * C::RW;
}

// The first N floats of a 16-byte aligned row, read as quads.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&r)[N]) {
#pragma unroll
  for (int q = 0; q < (N + 3) / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < N) r[4 * q + i] = w[i];
  }
}

// Stage n of a sweep over the horizon, backward (k = T-1 .. 0) or forward
// (k = 0 .. T-1): waits for stage n's [A_k | B_k] and returns its slab, with
// the next stage's copy in flight (the first call also issues its own copy).
// The block-wide barrier here, and the one the caller puts after the stage's
// work (`stage_leave`), keep the two slabs apart: every thread of the block
// runs every sweep, since the tile's control flow is uniform.
template <class C>
__device__ __forceinline__ const float* stage_enter(const Team<C>& tm, bool backward, int n) {
  const int T = tm.T, step = backward ? -1 : 1, k0 = backward ? T - 1 : 0;
  const int stride = C::SLAB * tm.spb;
  if (n == 0) fetch_stage(tm, tm.slab, k0);
  if (n + 1 < T) {
    fetch_stage(tm, tm.slab + ((n + 1) & 1) * stride, k0 + step * (n + 1));
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return tm.slab + (n & 1) * stride;
}

__device__ __forceinline__ void stage_leave() { __syncthreads(); }

// ---- prefetching the next stage into L1 -------------------------------------------

__device__ __forceinline__ void prefetch_l1(const float* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// Hints into L1 what row tr of stage k of a backward sweep will read from
// device memory: the barrier terms' state and inputs of its element (state
// row tr, or input row tr - NX), the dynamics residual's operands or value,
// and in the corrector the affine sweep's stores. Each thread names its own
// element; together a team covers the scenario's lines. A hint only: it
// never faults and moves nothing into the block.
template <bool MATRIX, class C>
__device__ __forceinline__ void prefetch_back(const TeamIp<C>& ip, int tr, int k,
                                              bool compute_rdyn) {
  constexpr int NX = C::NX, NU = C::NU;
  if (tr < NX) {
    const int i = k * NX + tr;
    prefetch_l1(&ip.dx[i]);
    prefetch_l1(&ip.slx[i]);
    prefetch_l1(&ip.sux[i]);
    prefetch_l1(&ip.llx[i]);
    prefetch_l1(&ip.lux[i]);
    prefetch_l1(ip.lx.at(i));
    prefetch_l1(ip.ux.at(i));
    prefetch_l1(ip.qdiag.at(i));
    prefetch_l1(ip.qx.at(i));
    if constexpr (C::SOFT) {
      prefetch_l1(&ip.elx[i]);
      prefetch_l1(&ip.eux[i]);
      prefetch_l1(&ip.nulx[i]);
      prefetch_l1(&ip.nuux[i]);
    }
    if (compute_rdyn) {
      prefetch_l1(&ip.dx[i + NX]);
      prefetch_l1(ip.r.at(i));
    } else {
      prefetch_l1(&ip.rdyn[i]);
    }
    if constexpr (!MATRIX) {
      prefetch_l1(&ip.ddx_a[i]);
      prefetch_l1(&ip.Pr[i]);
      prefetch_l1(&ip.Gxu[(long)i * NU]);
    }
  } else if (tr < NX + NU) {
    const int i = k * NU + (tr - NX);
    prefetch_l1(&ip.du[i]);
    prefetch_l1(&ip.slu[i]);
    prefetch_l1(&ip.suu[i]);
    prefetch_l1(&ip.llu[i]);
    prefetch_l1(&ip.luu[i]);
    prefetch_l1(ip.lu.at(i));
    prefetch_l1(ip.uu.at(i));
    prefetch_l1(ip.rdiag.at(i));
    prefetch_l1(ip.ru.at(i));
    if constexpr (!MATRIX) {
      prefetch_l1(&ip.ddu_a[i]);
      prefetch_l1(&ip.lchol[(long)k * NU * NU + (tr - NX) * NU]);
    }
  }
}

// The same for stage k of a rollout: the gains, the feedforward and the
// dynamics residual.
template <class C>
__device__ __forceinline__ void prefetch_forward(const TeamIp<C>& ip, int tr, int k) {
  constexpr int NX = C::NX, NU = C::NU;
  if (tr < NX) {
    prefetch_l1(&ip.rdyn[k * NX + tr]);
    prefetch_l1(&ip.K[(long)k * NU * NX + tr * NU]);
  } else if (tr == NX) {
    prefetch_l1(&ip.kff[k * NU]);
  }
}

// ---- team reductions -------------------------------------------------------------

template <int TEAM>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = TEAM / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int TEAM>
__device__ __forceinline__ float team_min(float v) {
#pragma unroll
  for (int o = TEAM / 2; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- the Newton system ----------------------------------------------------------

// Backward Riccati sweep and forward rollout; writes the state and input
// directions to (ddx_o, ddu_o). MATRIX = false is the Mehrotra corrector over
// the affine sweep's stores (K, P r, the Cholesky factors, Gxu). compute_rdyn
// (first sweep of an iteration) forms the dynamics residual
// r_dyn_k = A dx_k + B du_k + r - dx_{k+1} inside the sweep.
template <bool MATRIX, class C>
__device__ void newton(const TeamIp<C>& ip, const Team<C>& tm, int mode, float cent,
                       bool compute_rdyn, const Seg& ddx_o, const Seg& ddu_o) {
  constexpr int NX = C::NX, NU = C::NU, NXU = C::NXU;
  const int T = ip.T, tr = tm.tr;
  const bool xrow = tr < NX, row = tr < NXU;
  float P[NX];  // row tr of P
  float p = 0.0f;
  __syncwarp();  // the element loops spread a row over the team: their writes are seen
  if (xrow) {
    float sig;
    p = qhat(ip, T * NX + tr, mode, cent, sig);
    const float d = ip.qdiag[T * NX + tr] + sig;
#pragma unroll
    for (int j = 0; j < NX; ++j) P[j] = j == tr ? d : 0.0f;
  }
  for (int n = 0; n < T; ++n) {
    const int k = T - 1 - n;
    const float* slab = stage_enter(tm, true, n);
    if (k > 0) prefetch_back<MATRIX>(ip, tr, k - 1, compute_rdyn);
    // the Newton right-hand side and barrier diagonal of row tr: they do not
    // depend on the sweep, so their loads go out first
    float rhs = 0.0f, diag = 0.0f, grad = 0.0f;
    if (row) {
      float sig;
      if (xrow) {
        rhs = qhat(ip, k * NX + tr, mode, cent, sig);
        diag = ip.qdiag[k * NX + tr] + sig;
      } else {
        rhs = rhat(ip, k * NU + (tr - NX), mode, cent, sig);
        diag = ip.rdiag[k * NU + (tr - NX)] + sig;
      }
    }
    if constexpr (MATRIX) {
      if (compute_rdyn) {
        if (xrow) {
          float row[NXU];
          load_row(ab_row(tm, slab, tr), row);
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < NX; ++j) s += row[j] * ip.dx[k * NX + j];
          float t = 0.0f;
#pragma unroll
          for (int u = 0; u < NU; ++u) t += row[NX + u] * ip.du[k * NU + u];
          const float rd = s + t + ip.r[k * NX + tr] - ip.dx[(k + 1) * NX + tr];
          ip.rdyn[k * NX + tr] = rd;
          tm.rd[tr] = rd;
        }
      } else if (xrow) {
        tm.rd[tr] = ip.rdyn[k * NX + tr];
      }
      __syncwarp();
      // P r, F = P r + p, and row tr of W = P [A_k | B_k]
      if (xrow) {
        float pr = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) pr += P[j] * tm.rd[j];
        if (ip.mehrotra) ip.Pr[k * NX + tr] = pr;
        tm.F[tr] = pr + p;
        float w[NXU];
#pragma unroll
        for (int c = 0; c < NXU; ++c) w[c] = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float row[NXU];
          load_row(ab_row(tm, slab, j), row);
#pragma unroll
          for (int c = 0; c < NXU; ++c) w[c] += P[j] * row[c];
        }
#pragma unroll
        for (int c = 0; c < NXU; ++c) tm.W[tr * C::RW + c] = w[c];
      }
      __syncwarp();
      // row tr of [A|B]^T W with its barrier diagonal, and the gradient
      float G[NXU];
      if (row) {
        float col[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) col[j] = ab_row(tm, slab, j)[tr];
        float g = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) g += col[j] * tm.F[j];
#pragma unroll
        for (int c = 0; c < NXU; ++c) G[c] = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float row[NXU];
          load_row(tm.W + j * C::RW, row);
#pragma unroll
          for (int c = 0; c < NXU; ++c) G[c] += col[j] * row[c];
        }
        grad = rhs + g;
#pragma unroll
        for (int c = 0; c < NXU; ++c)
          if (c == tr) G[c] += diag;
        if (!xrow) {
#pragma unroll
          for (int u = 0; u < NU; ++u) tm.Gu[(tr - NX) * NU + u] = G[NX + u];
          tm.Gu[NU * NU + (tr - NX)] = grad;
        }
      }
      __syncwarp();
      // every thread: the Cholesky factor of Guu and kff
      float l[NU][NU], kf[NU];
      {
        float Guu[NU][NU];
#pragma unroll
        for (int i = 0; i < NU; ++i)
#pragma unroll
          for (int j = 0; j < NU; ++j) Guu[i][j] = tm.Gu[i * NU + j];
        chol<NU>(Guu, l);
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) kf[u] = tm.Gu[NU * NU + u];
      chol_solve<NU>(l, kf);
#pragma unroll
      for (int u = 0; u < NU; ++u) kf[u] = -kf[u];
      if (tr == 0) {
#pragma unroll
        for (int u = 0; u < NU; ++u) ip.kff[k * NU + u] = kf[u];
        if (ip.mehrotra) {
#pragma unroll
          for (int i = 0; i < NU; ++i)
#pragma unroll
            for (int j = 0; j < NU; ++j) ip.lchol[(k * NU + i) * NU + j] = j <= i ? l[i][j] : 0.0f;
        }
      }
      // column tr of K = -Guu^-1 Gxu^T, and p
      if (xrow) {
        float b[NU];
#pragma unroll
        for (int u = 0; u < NU; ++u) b[u] = G[NX + u];
        chol_solve<NU>(l, b);
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          tm.K[u * NX + tr] = -b[u];
          ip.K[(k * NU + u) * NX + tr] = -b[u];
        }
        if (ip.mehrotra) {
#pragma unroll
          for (int u = 0; u < NU; ++u) ip.Gxu[(k * NX + tr) * NU + u] = G[NX + u];
        }
        float s = grad;
#pragma unroll
        for (int u = 0; u < NU; ++u) s += G[NX + u] * kf[u];
        p = s;
      }
      __syncwarp();
      // P = Gxx + Gxu K (through W, no longer read), then symmetrized
      if (xrow) {
        float Kr[NU][NX];
#pragma unroll
        for (int u = 0; u < NU; ++u) load_row(tm.K + u * NX, Kr[u]);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float s = G[j];
#pragma unroll
          for (int u = 0; u < NU; ++u) s += G[NX + u] * Kr[u][j];
          tm.W[tr * C::RW + j] = s;
        }
      }
      __syncwarp();
      if (xrow) {
#pragma unroll
        for (int j = 0; j < NX; ++j)
          P[j] = j == tr ? tm.W[tr * C::RW + j]
                         : 0.5f * (tm.W[tr * C::RW + j] + tm.W[j * C::RW + tr]);
      }
    } else {
      // the corrector: the affine sweep's P r, Cholesky factors and Gxu,
      // loaded before the first exchange
      float l[NU][NU], gxu[NU], kf[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) l[i][j] = ip.lchol[(k * NU + i) * NU + j];
      if (xrow) {
#pragma unroll
        for (int u = 0; u < NU; ++u) gxu[u] = ip.Gxu[(k * NX + tr) * NU + u];
        tm.F[tr] = ip.Pr[k * NX + tr] + p;
      }
      __syncwarp();
      if (row) {
        float g = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) g += ab_row(tm, slab, j)[tr] * tm.F[j];
        grad = rhs + g;
        if (!xrow) tm.Gu[NU * NU + (tr - NX)] = grad;
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < NU; ++u) kf[u] = tm.Gu[NU * NU + u];
      chol_solve<NU>(l, kf);
#pragma unroll
      for (int u = 0; u < NU; ++u) kf[u] = -kf[u];
      if (tr == 0) {
#pragma unroll
        for (int u = 0; u < NU; ++u) ip.kff[k * NU + u] = kf[u];
      }
      if (xrow) {
        float s = grad;
#pragma unroll
        for (int u = 0; u < NU; ++u) s += gxu[u] * kf[u];
        p = s;
      }
    }
    stage_leave();
  }
  // forward rollout: x_{k+1} = A x_k + B (K x_k + kff) + r_dyn, the state in
  // the team's two vectors, alternately
  if (xrow) {
    tm.x[tr] = 0.0f;
    ddx_o[tr] = 0.0f;
  }
  for (int k = 0; k < T; ++k) {
    const float* slab = stage_enter(tm, false, k);
    if (k + 1 < T) prefetch_forward(ip, tr, k + 1);
    const float* xp = tm.x + (k & 1) * NX;
    float du[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float s = ip.kff[k * NU + u];
#pragma unroll
      for (int j = 0; j < NX; ++j) s += ip.K[(k * NU + u) * NX + j] * xp[j];
      du[u] = s;
    }
    if (tr == 0) {
#pragma unroll
      for (int u = 0; u < NU; ++u) ddu_o[k * NU + u] = du[u];
    }
    if (xrow) {
      float row[NXU];
      load_row(ab_row(tm, slab, tr), row);
      float s = ip.rdyn[k * NX + tr];
#pragma unroll
      for (int j = 0; j < NX; ++j) s += row[j] * xp[j];
#pragma unroll
      for (int u = 0; u < NU; ++u) s += row[NX + u] * du[u];
      tm.x[((k + 1) & 1) * NX + tr] = s;
      ddx_o[(k + 1) * NX + tr] = s;
    }
    stage_leave();
  }
}

// ---- the element loops: thread tr takes elements tr, tr + TEAM, ... ------------
// They stay rolled (#pragma unroll 1): unrolled by two they held ~35 more
// registers and ran slower on the card.

template <class C>
__device__ void step_lengths(const TeamIp<C>& ip, int tr, int mode, float cent, const Seg& ddx_d,
                             const Seg& ddu_d, float t, float& a_p, float& a_d) {
  constexpr int NX = C::NX, NU = C::NU;
  float ap = CUDART_INF_F, ad = CUDART_INF_F;
#pragma unroll 1
  for (int idx = tr; idx < (ip.T + 1) * NX; idx += C::TEAM) {
    const Terms p = x_terms(ip, idx, mode, cent);
    const Dir d = pair_dir<C::SOFT>(p, ddx_d[idx]);
    ap = fminf(ap, fminf(ratio(p.sl, d.ds_l, t), ratio(p.su, d.ds_u, t)));
    ad = fminf(ad, fminf(ratio(p.ll, d.dl_l, t), ratio(p.lu, d.dl_u, t)));
    if constexpr (C::SOFT) {
      ap = fminf(ap, fminf(ratio(p.el, d.de_l, t), ratio(p.eu, d.de_u, t)));
      ad = fminf(ad, fminf(ratio(p.nl, -d.dl_l, t), ratio(p.nu, -d.dl_u, t)));
    }
  }
#pragma unroll 1
  for (int idx = tr; idx < ip.T * NU; idx += C::TEAM) {
    const Terms p = u_terms(ip, idx, mode, cent);
    const Dir d = pair_dir<false>(p, ddu_d[idx]);
    ap = fminf(ap, fminf(ratio(p.sl, d.ds_l, t), ratio(p.su, d.ds_u, t)));
    ad = fminf(ad, fminf(ratio(p.ll, d.dl_l, t), ratio(p.lu, d.dl_u, t)));
  }
  a_p = fminf(1.0f, team_min<C::TEAM>(ap));
  a_d = fminf(1.0f, team_min<C::TEAM>(ad));
}

// Sum of the complementarity products of every pair of the scenario.
template <class C>
__device__ float gap_sum(const TeamIp<C>& ip, int tr) {
  constexpr int NX = C::NX, NU = C::NU, TEAM = C::TEAM;
  float g_lx = 0.0f, g_ux = 0.0f, g_lu = 0.0f, g_uu = 0.0f, g_e = 0.0f;
#pragma unroll 1
  for (int idx = tr; idx < (ip.T + 1) * NX; idx += C::TEAM) {
    g_lx += ip.slx[idx] * ip.llx[idx];
    g_ux += ip.sux[idx] * ip.lux[idx];
    if constexpr (C::SOFT) g_e += ip.elx[idx] * ip.nulx[idx] + ip.eux[idx] * ip.nuux[idx];
  }
#pragma unroll 1
  for (int idx = tr; idx < ip.T * NU; idx += C::TEAM) {
    g_lu += ip.slu[idx] * ip.llu[idx];
    g_uu += ip.suu[idx] * ip.luu[idx];
  }
  return team_sum<TEAM>(g_lx) + team_sum<TEAM>(g_ux) + team_sum<TEAM>(g_lu) +
         team_sum<TEAM>(g_uu) + team_sum<TEAM>(g_e);
}

// One interior-point iteration; returns the next centering parameter. `gap`
// holds gap_sum of the state on entry and of the updated state on return: the
// update forms it on the way, so neither end of an iteration rereads the state.
template <class C>
__device__ float ip_iteration(const TeamIp<C>& ip, const Team<C>& tm, float mu, float sigma,
                              float tau, float m_total, float& gap) {
  constexpr int NX = C::NX, NU = C::NU, TEAM = C::TEAM;
  const int T = ip.T, tr = tm.tr;
  int mode = PLAIN;
  float cent = mu;
  if (ip.mehrotra) {
    const float gap_now = gap / m_total;
    newton<true>(ip, tm, AFFINE, 0.0f, true, ip.ddx_a, ip.ddu_a);
    float ap, ad;
    step_lengths(ip, tr, AFFINE, 0.0f, ip.ddx_a, ip.ddu_a, 1.0f, ap, ad);
    float g_lx = 0.0f, g_ux = 0.0f, g_lu = 0.0f, g_uu = 0.0f, g_e = 0.0f;
#pragma unroll 1
    for (int idx = tr; idx < (T + 1) * NX; idx += C::TEAM) {
      const Terms p = x_terms(ip, idx, AFFINE, 0.0f);
      const Dir d = pair_dir<C::SOFT>(p, ip.ddx_a[idx]);
      g_lx += (p.sl + ap * d.ds_l) * (p.ll + ad * d.dl_l);
      g_ux += (p.su + ap * d.ds_u) * (p.lu + ad * d.dl_u);
      if constexpr (C::SOFT)
        g_e += (p.el + ap * d.de_l) * (p.nl - ad * d.dl_l) +
               (p.eu + ap * d.de_u) * (p.nu - ad * d.dl_u);
    }
#pragma unroll 1
    for (int idx = tr; idx < T * NU; idx += C::TEAM) {
      const Terms p = u_terms(ip, idx, AFFINE, 0.0f);
      const Dir d = pair_dir<false>(p, ip.ddu_a[idx]);
      g_lu += (p.sl + ap * d.ds_l) * (p.ll + ad * d.dl_l);
      g_uu += (p.su + ap * d.ds_u) * (p.lu + ad * d.dl_u);
    }
    const float gap_aff = (team_sum<TEAM>(g_lx) + team_sum<TEAM>(g_ux) + team_sum<TEAM>(g_lu) +
                           team_sum<TEAM>(g_uu) + team_sum<TEAM>(g_e)) /
                          m_total;
    const float ratio_aff = gap_aff / fmaxf(gap_now, 1e-16f);
    const float sig = fminf(fmaxf(ratio_aff * ratio_aff * ratio_aff, 1e-4f), 1.0f);
    mode = CORRECTOR;
    cent = fmaxf(sig * gap_now, C::SOFT ? 1e-8f : 1e-14f);
    newton<false>(ip, tm, CORRECTOR, cent, false, ip.ddx, ip.ddu);
  } else {
    newton<true>(ip, tm, PLAIN, cent, true, ip.ddx, ip.ddu);
  }

  float a_p, a_d;
  step_lengths(ip, tr, mode, cent, ip.ddx, ip.ddu, tau, a_p, a_d);
  // Update in place: every element's directions come from its old values,
  // and each element has one owner thread. The sums are gap_sum's, term for
  // term, over the values stored.
  float g_lx = 0.0f, g_ux = 0.0f, g_lu = 0.0f, g_uu = 0.0f, g_e = 0.0f;
#pragma unroll 1
  for (int idx = tr; idx < (T + 1) * NX; idx += C::TEAM) {
    const Terms p = x_terms(ip, idx, mode, cent);
    const float dd = ip.ddx[idx];
    const Dir d = pair_dir<C::SOFT>(p, dd);
    const float sl = p.sl + a_p * d.ds_l, su = p.su + a_p * d.ds_u;
    const float ll = p.ll + a_d * d.dl_l, lu = p.lu + a_d * d.dl_u;
    ip.dx[idx] = ip.dx[idx] + a_p * dd;
    ip.slx[idx] = sl;
    ip.sux[idx] = su;
    ip.llx[idx] = ll;
    ip.lux[idx] = lu;
    g_lx += sl * ll;
    g_ux += su * lu;
    if constexpr (C::SOFT) {
      const float el = p.el + a_p * d.de_l, eu = p.eu + a_p * d.de_u;
      const float nl = p.nl - a_d * d.dl_l, nu = p.nu - a_d * d.dl_u;
      ip.elx[idx] = el;
      ip.eux[idx] = eu;
      ip.nulx[idx] = nl;
      ip.nuux[idx] = nu;
      g_e += el * nl + eu * nu;
    }
  }
#pragma unroll 1
  for (int idx = tr; idx < T * NU; idx += C::TEAM) {
    const Terms p = u_terms(ip, idx, mode, cent);
    const float dd = ip.ddu[idx];
    const Dir d = pair_dir<false>(p, dd);
    const float sl = p.sl + a_p * d.ds_l, su = p.su + a_p * d.ds_u;
    const float ll = p.ll + a_d * d.dl_l, lu = p.lu + a_d * d.dl_u;
    ip.du[idx] = ip.du[idx] + a_p * dd;
    ip.slu[idx] = sl;
    ip.suu[idx] = su;
    ip.llu[idx] = ll;
    ip.luu[idx] = lu;
    g_lu += sl * ll;
    g_uu += su * lu;
  }
  gap = team_sum<TEAM>(g_lx) + team_sum<TEAM>(g_ux) + team_sum<TEAM>(g_lu) +
        team_sum<TEAM>(g_uu) + team_sum<TEAM>(g_e);
  return fmaxf(sigma * (gap / m_total), C::SOFT ? 1e-8f : 1e-12f);
}

// Whether `pred` holds in every thread of the tile: a block-wide vote, then,
// over a cluster, every block's vote read through distributed shared memory.
// `flags` are the block's two vote slots; `parity` alternates between them, so
// a slot is written again only after the next cluster barrier, by which time
// every block has read it.
__device__ __forceinline__ bool tile_all(bool pred, int* flags, int& parity, int cluster) {
  const int b = __syncthreads_and(pred);
  if (cluster == 1) return b != 0;
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) flags[parity] = b;
  cl.sync();
  int all = 1;
  for (int r = 0; r < cluster; ++r) all &= *cl.map_shared_rank(flags + parity, r);
  parity ^= 1;
  return all != 0;
}

#ifdef __CUDACC__
// One block: spb = blockDim.x / TEAM scenarios of tile blockIdx.x / cluster,
// lanes (blockIdx.x % cluster) * spb onwards. adaptive_tol < 0 runs all n_ip
// iterations; soft_rho is read only by the SOFT instantiations, whose callers
// always pass adaptive_tol >= 1e-8. n_iters[tile] receives the number of
// iterations the tile ran.
template <class C>
__global__ void __launch_bounds__(kMaxThreads)
    kernel(const float* __restrict__ A, const float* __restrict__ B, const float* r,
           const float* qdiag, const float* qx, const float* rdiag, const float* ru,
           const float* lx, const float* ux, const float* lu, const float* uu, float* dx_out,
           float* du_out, float* gap, int* n_iters, float* ws, int T, int L, int cluster, int n_ip,
           float mu0, float sigma, float tau, float adaptive_tol, bool mehrotra, float soft_rho) {
  constexpr int NX = C::NX, NU = C::NU, TEAM = C::TEAM;
  extern __shared__ __align__(16) float smem[];
  const int spb = blockDim.x / TEAM;
  const int tile = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int tr = threadIdx.x % TEAM, s = threadIdx.x / TEAM;
  const int lane0 = rank * spb, lane = lane0 + s;
  const long nxs = (long)(T + 1) * NX, nus = (long)T * NU;

  Team<C> tm;
  tm.tr = tr;
  tm.s = s;
  tm.spb = spb;
  tm.copy_e = threadIdx.x / spb;
  tm.copy_s = threadIdx.x % spb;
  tm.L = L;
  tm.T = T;
  tm.A = A + (long)tile * T * NX * NX * L + lane0;
  tm.B = B + (long)tile * T * NX * NU * L + lane0;
  tm.slab = smem;
  float* team = smem + 2L * C::SLAB * spb + (long)s * C::TEAM_FLOATS;
  tm.W = team;
  tm.rd = tm.W + NX * C::RW;
  tm.F = tm.rd + NX;
  tm.K = tm.F + NX;
  tm.Gu = tm.K + NU * NX;
  tm.x = tm.Gu + NU * NU + NU;
  int* flags = reinterpret_cast<int*>(smem + 2L * C::SLAB * spb + (long)spb * C::TEAM_FLOATS);

  const WsLayout w = ws_layout<C>(T);
  float* mine = ws + ((long)tile * L + lane) * w.total;
  auto seg = [&](long off) { return Seg{mine + off}; };
  auto in = [&](const float* p, long per_lane) {
    return Strided{p + (long)tile * per_lane * L + lane, L};
  };
  TeamIp<C> ip;
  ip.T = T;
  ip.mehrotra = mehrotra;
  ip.r = in(r, (long)T * NX);
  ip.qdiag = in(qdiag, nxs);
  ip.qx = in(qx, nxs);
  ip.rdiag = in(rdiag, nus);
  ip.ru = in(ru, nus);
  ip.lx = in(lx, nxs);
  ip.ux = in(ux, nxs);
  ip.lu = in(lu, nus);
  ip.uu = in(uu, nus);
  ip.dx = seg(w.dx);
  ip.du = seg(w.du);
  ip.slx = seg(w.slx);
  ip.sux = seg(w.sux);
  ip.llx = seg(w.llx);
  ip.lux = seg(w.lux);
  ip.slu = seg(w.slu);
  ip.suu = seg(w.suu);
  ip.llu = seg(w.llu);
  ip.luu = seg(w.luu);
  ip.K = seg(w.K);
  ip.kff = seg(w.kff);
  ip.rdyn = seg(w.rdyn);
  ip.ddx_a = seg(w.ddx_a);
  ip.ddu_a = seg(w.ddu_a);
  ip.ddx = seg(w.ddx);
  ip.ddu = seg(w.ddu);
  ip.Pr = seg(w.Pr);
  ip.lchol = seg(w.lchol);
  ip.Gxu = seg(w.Gxu);
  ip.elx = seg(w.elx);
  ip.eux = seg(w.eux);
  ip.nulx = seg(w.nulx);
  ip.nuux = seg(w.nuux);

  // init: dx = du = 0, slacks clipped to the interior, duals mu0 / s (soft
  // state bounds: e = s_min, lam <= 0.49 rho, nu = rho - lam)
  const float s_min = 1e-2f;
#pragma unroll 1
  for (int idx = tr; idx < (T + 1) * NX; idx += C::TEAM) {
    ip.dx[idx] = 0.0f;
    if constexpr (C::SOFT) {
      ip.elx[idx] = s_min;
      ip.eux[idx] = s_min;
      ip.slx[idx] = fmaxf(s_min - ip.lx[idx], s_min);
      ip.sux[idx] = fmaxf(ip.ux[idx] + s_min, s_min);
      ip.llx[idx] = fminf(mu0 / ip.slx[idx], 0.49f * soft_rho);
      ip.lux[idx] = fminf(mu0 / ip.sux[idx], 0.49f * soft_rho);
      ip.nulx[idx] = soft_rho - ip.llx[idx];
      ip.nuux[idx] = soft_rho - ip.lux[idx];
    } else {
      ip.slx[idx] = fmaxf(-ip.lx[idx], s_min);
      ip.sux[idx] = fmaxf(ip.ux[idx], s_min);
      ip.llx[idx] = mu0 / ip.slx[idx];
      ip.lux[idx] = mu0 / ip.sux[idx];
    }
  }
#pragma unroll 1
  for (int idx = tr; idx < T * NU; idx += C::TEAM) {
    ip.du[idx] = 0.0f;
    ip.slu[idx] = fmaxf(-ip.lu[idx], s_min);
    ip.suu[idx] = fmaxf(ip.uu[idx], s_min);
    ip.llu[idx] = mu0 / ip.slu[idx];
    ip.luu[idx] = mu0 / ip.suu[idx];
  }
  const float m_total = 2.0f * (float)(nxs + nus) + (C::SOFT ? 2.0f * (float)nxs : 0.0f);

  float mu = mu0;
  const bool adaptive = adaptive_tol >= 0.0f;
  int it = 0, parity = 0;
  float gap_now = gap_sum(ip, tr);
  for (; it < n_ip; ++it) {
    // Tile-wide exit: stop only when every lane of this tile has mu <= tol.
    if (adaptive && tile_all(mu <= adaptive_tol, flags, parity, cluster)) break;
    mu = ip_iteration(ip, tm, mu, sigma, tau, m_total, gap_now);
  }
  if (rank == 0 && threadIdx.x == 0) n_iters[tile] = it;
  const float g = gap_now / m_total;
  if (tr == 0) gap[(long)tile * L + lane] = g;
  for (int idx = tr; idx < nxs; idx += TEAM)
    dx_out[((long)tile * nxs + idx) * L + lane] = ip.dx[idx];
  for (int idx = tr; idx < nus; idx += TEAM)
    du_out[((long)tile * nus + idx) * L + lane] = ip.du[idx];
  // no block leaves while another may still read its vote slots
  if (cluster > 1) cg::this_cluster().sync();
}

// Floats of workspace per scenario, or kUnsupported.
template <bool SOFT>
long workspace_floats(int T, int nx, int nu) {
  long n = kUnsupported;
  dispatch_nx_nu(nx, nu, [&](auto nx_c, auto nu_c) {
    n = ws_layout<Cfg<decltype(nx_c)::value, decltype(nu_c)::value, SOFT>>(T).total;
    return 0;
  });
  return n;
}

// Launches n_tiles clusters of `cluster` blocks, each block L / cluster
// scenarios of `team` threads. Returns kUnsupported for a geometry this
// instantiation does not take (another team size, an L the cluster does not
// split, more than kMaxThreads threads a block), else cudaGetLastError().
template <bool SOFT>
int launch(const float* A, const float* B, const float* r, const float* qdiag, const float* qx,
           const float* rdiag, const float* ru, const float* lx, const float* ux, const float* lu,
           const float* uu, float* dx, float* du, float* gap, int* n_iters, float* ws, int n_tiles,
           int T, int L, int nx, int nu, int n_ip, float mu0, float sigma, float tau,
           float adaptive_tol, int mehrotra, float soft_rho, int team, int cluster, void* stream) {
  return dispatch_nx_nu(nx, nu, [&](auto nx_c, auto nu_c) {
    constexpr int NX = decltype(nx_c)::value, NU = decltype(nu_c)::value;
    using C = Cfg<NX, NU, SOFT>;
    if (team != C::TEAM || cluster < 1 || cluster > 16 || L % cluster != 0 || n_tiles < 1 || T < 1)
      return kUnsupported;
    const int spb = L / cluster;
    if (spb * C::TEAM > kMaxThreads) return kUnsupported;
    const long smem = shared_bytes<C>(spb);
    cudaError_t err = cudaFuncSetAttribute(kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (cluster > 8) {
      err = cudaFuncSetAttribute(kernel<C>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(n_tiles * cluster, 1, 1);
    config.blockDim = dim3(spb * C::TEAM, 1, 1);
    config.dynamicSmemBytes = (size_t)smem;
    config.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel<C>, A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu, dx,
                             du, gap, n_iters, ws, T, L, cluster, n_ip, mu0, sigma, tau,
                             adaptive_tol, mehrotra != 0, soft_rho);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
}

// The C entry points of one variant: NAME_workspace_floats, NAME_shared_bytes
// (bytes of shared memory a block of `spb` scenarios takes) and NAME_launch
// (arguments as `launch` above).
#define GPMPC_OCP_IP_RESIDENT_ENTRY_POINTS(NAME, SOFT)                                            \
  extern "C" long NAME##_workspace_floats(int T, int nx, int nu) {                                \
    return gpmpc::ocp::resident::workspace_floats<SOFT>(T, nx, nu);                               \
  }                                                                                               \
  extern "C" long NAME##_shared_bytes(int nx, int nu, int spb) {                                  \
    long n = gpmpc::kUnsupported;                                                                 \
    gpmpc::dispatch_nx_nu(nx, nu, [&](auto nx_c, auto nu_c) {                                     \
      n = gpmpc::ocp::resident::shared_bytes<gpmpc::ocp::resident::Cfg<                           \
          decltype(nx_c)::value, decltype(nu_c)::value, SOFT>>(spb);                              \
      return 0;                                                                                   \
    });                                                                                           \
    return n;                                                                                     \
  }                                                                                               \
  extern "C" int NAME##_launch(                                                                   \
      const float* A, const float* B, const float* r, const float* qdiag, const float* qx,        \
      const float* rdiag, const float* ru, const float* lx, const float* ux, const float* lu,     \
      const float* uu, float* dx, float* du, float* gap, int* n_iters, float* ws, int n_tiles,    \
      int T, int L, int nx, int nu, int n_ip, float mu0, float sigma, float tau,                  \
      float adaptive_tol, int mehrotra, float soft_rho, int team, int cluster, void* stream) {    \
    return gpmpc::ocp::resident::launch<SOFT>(A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu, dx,  \
                                              du, gap, n_iters, ws, n_tiles, T, L, nx, nu, n_ip,  \
                                              mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho,  \
                                              team, cluster, stream);                             \
  }
#endif  // __CUDACC__

}  // namespace resident
}  // namespace ocp
}  // namespace gpmpc

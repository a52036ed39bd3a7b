// Device code of the tier-1 streamed OCP-QP interior-point kernel
// (ocp_ip_streamed*.cu), and the element algebra of the interior point that
// the resident kernel and tier 2 (ocp_ip_resident.cuh) share. One scenario
// per thread, one block per L-scenario tile; templated on Cfg<NX, NU, SOFT>
// and instantiated by each source for (12, 4), (4, 1) and (4, 2).
//
// Each interior-point iteration: barrier weights, dynamics residual, a
// backward Riccati sweep (diagonal Q/R plus barrier, an NU x NU Cholesky per
// stage), a forward rollout, per-scenario fraction-to-boundary step lengths,
// and the slack/dual update. What the variants change:
//
//  * SOFT: L1-soft state bounds in the bounded-multiplier form. Per state
//    bound a violation slack e > 0 and the penalty dual nu = rho - lam > 0 are
//    state of their own (four more (T+1) NX arrays; nu is stored, since
//    rho - lam rounds to 0 in float32 once lam reaches rho). The barrier
//    weight is w = lam nu / den with den = s nu + e lam, floored at
//    lam nu 1e-6, so nothing divides by a multiplier that has underflowed;
//    the complementarity gradients are formed over the same den; step lengths
//    and gaps take the extra pairs (e, nu); the centering floors move to 1e-8,
//    below which float32 barrier weights break the Riccati recursion.
//  * Streamed: the kernel keeps no factorization stores (P r, the Guu
//    factors and Gxu: 76 T floats per scenario at 12x4): the Mehrotra
//    corrector repeats the full matrix sweep, and the dynamics residual is
//    formed inside the first backward sweep of an iteration. It hints the
//    next stage's A and B into L2 ahead of use (`prefetch.global.L2`). The
//    hint takes no shared memory: at 12x4 and L = 128 the Riccati matrices
//    below already hold 172 KB of the block's 227 KB, and one stage of A and
//    B is 96 KB, so staging them in shared memory would only fit at a
//    narrower tile.
//
// Common design:
//  * the tile-wide adaptive exit is a block-wide vote,
//    __syncthreads_and(mu <= tol), over exactly the L lanes of the tile:
//    padded scenarios vote too;
//  * the Riccati matrix P (NX x NX) and W = P [A | B] (NX x (NX+NU)) of each
//    scenario live in shared memory, lane-interleaved (entry e of lane l at
//    e * L + l, bank-conflict-free): (2 NX^2 + NX NU) * L floats. At NX = 12
//    they would need ~340 registers per thread, past the 255 limit;
//  * everything that must survive a sweep (slacks, duals, K, kff, the dynamics
//    residual, directions) is a per-scenario workspace in device memory,
//    scenario axis last, allocated by the wrapper;
//  * the Newton right-hand sides (q-hat, r-hat), the barrier diagonals and the
//    slack/dual directions are recomputed element by element from the stored
//    state instead of being stored. x_terms, u_terms, qhat and rhat take any
//    problem view with this header's member names (Ip here, TeamIp in the
//    resident kernel).
#pragma once

#include <math_constants.h>

#include "lanes.cuh"

namespace gpmpc {
namespace ocp {

enum Mode { AFFINE = 0, CORRECTOR = 1, PLAIN = 2 };
template <int NX_, int NU_, bool SOFT_>
struct Cfg {
  static constexpr int NX = NX_, NU = NU_;
  static constexpr bool SOFT = SOFT_;
};

// Offsets (in floats per scenario) of the workspace arrays.
struct WsLayout {
  long slx, sux, llx, lux, slu, suu, llu, luu;
  long K, kff, rdyn, ddx_a, ddu_a, ddx, ddu;
  long elx, eux, nulx, nuux;    // soft only
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
  if (C::SOFT) {
    w.elx = o; o += nxs;
    w.eux = o; o += nxs;
    w.nulx = o; o += nxs;
    w.nuux = o; o += nxs;
  }
  w.total = o;
  return w;
}

template <class C>
struct Ip {
  static constexpr int NX = C::NX, NU = C::NU;
  static constexpr bool SOFT = C::SOFT;
  int T, L;
  bool mehrotra;
  ConstLaneView A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu;
  LaneView dx, du, slx, sux, llx, lux, slu, suu, llu, luu;
  LaneView K, kff, rdyn, ddx_a, ddu_a, ddx, ddu;
  LaneView elx, eux, nulx, nuux;
  float* P_s;  // NX*NX*L shared, this lane at +lane
  float* W_s;  // NX*(NX+NU)*L shared
  __device__ __forceinline__ float& P(int i, int j) const { return P_s[(i * NX + j) * L]; }
  __device__ __forceinline__ float& W(int i, int c) const { return W_s[(i * (NX + NU) + c) * L]; }
  // column c of [A_k | B_k], row j
  __device__ __forceinline__ float AB(int k, int j, int c) const {
    return c < NX ? A[(k * NX + j) * NX + c] : B[(k * NX + j) * NU + (c - NX)];
  }
};

// Slacks, duals, slack residuals and complementarity right-hand sides of one
// box pair (lower/upper bound on one variable), for the given mode:
//   AFFINE:    r_c = s * lam
//   PLAIN:     r_c = s * lam - mu
//   CORRECTOR: r_c = s * lam + ds_aff * dlam_aff - target
// A soft pair adds the violation slacks e, the penalty duals nu, their
// right-hand sides r_e (e * nu in place of s * lam, d(e) d(nu) = -de dlam),
// the fused weights w = lam nu / den and the gradients cg over den.
struct Terms {
  float sl, su, ll, lu, r_sl, r_su, rc_l, rc_u;
  float el, eu, nl, nu, re_l, re_u, w_l, w_u, den_l, den_u, cg_l, cg_u;  // soft only
};

// Directions of one box pair given the primal direction dd of its variable.
struct Dir {
  float ds_l, ds_u, dl_l, dl_u;
  float de_l, de_u;  // soft only
};

template <bool SOFT>
__device__ __forceinline__ Dir pair_dir(const Terms& t, float dd) {
  Dir d;
  if constexpr (SOFT) {
    d.dl_l = -(t.w_l * dd + t.cg_l);
    d.dl_u = t.w_u * dd - t.cg_u;
    d.de_l = (-t.re_l + t.el * d.dl_l) / t.nl;
    d.de_u = (-t.re_u + t.eu * d.dl_u) / t.nu;
    d.ds_l = dd + d.de_l + t.r_sl;
    d.ds_u = -dd + d.de_u + t.r_su;
  } else {
    d.ds_l = dd + t.r_sl;
    d.ds_u = t.r_su - dd;
    d.dl_l = -(t.rc_l + t.ll * d.ds_l) / t.sl;
    d.dl_u = -(t.rc_u + t.lu * d.ds_u) / t.su;
    d.de_l = 0.0f;
    d.de_u = 0.0f;
  }
  return d;
}

template <bool SOFT>
__device__ __forceinline__ void soft_gradients(Terms& t) {
  if constexpr (SOFT) {
    t.cg_l = (t.ll * t.nl * t.r_sl + t.nl * t.rc_l - t.ll * t.re_l) / t.den_l;
    t.cg_u = (t.lu * t.nu * t.r_su + t.nu * t.rc_u - t.lu * t.re_u) / t.den_u;
  }
}

// Fills the right-hand sides of `t` (whose slacks, duals and residuals are
// set) for `mode`; dd_aff is the stored affine primal direction (CORRECTOR).
template <bool SOFT>
__device__ __forceinline__ void pair_rhs(Terms& t, int mode, float cent, float dd_aff) {
  const float c_l = t.sl * t.ll, c_u = t.su * t.lu;
  float ce_l = 0.0f, ce_u = 0.0f;
  if constexpr (SOFT) {
    ce_l = t.el * t.nl;
    ce_u = t.eu * t.nu;
    t.den_l = fmaxf(t.sl * t.nl + t.el * t.ll, t.ll * t.nl * 1e-6f);
    t.den_u = fmaxf(t.su * t.nu + t.eu * t.lu, t.lu * t.nu * 1e-6f);
    t.w_l = t.ll * t.nl / t.den_l;
    t.w_u = t.lu * t.nu / t.den_u;
  }
  t.rc_l = c_l;
  t.rc_u = c_u;
  t.re_l = ce_l;
  t.re_u = ce_u;
  if (mode == PLAIN) {
    t.rc_l -= cent;
    t.rc_u -= cent;
    t.re_l -= cent;
    t.re_u -= cent;
  } else if (mode == CORRECTOR) {
    soft_gradients<SOFT>(t);  // the affine gradients, for the affine directions
    const Dir a = pair_dir<SOFT>(t, dd_aff);
    t.rc_l = c_l + a.ds_l * a.dl_l - cent;
    t.rc_u = c_u + a.ds_u * a.dl_u - cent;
    t.re_l = ce_l - a.de_l * a.dl_l - cent;
    t.re_u = ce_u - a.de_u * a.dl_u - cent;
  }
  soft_gradients<SOFT>(t);
}

template <class IP>
__device__ __forceinline__ Terms x_terms(const IP& ip, int idx, int mode, float cent) {
  Terms t;
  const float d = ip.dx[idx];
  t.sl = ip.slx[idx];
  t.su = ip.sux[idx];
  t.ll = ip.llx[idx];
  t.lu = ip.lux[idx];
  t.r_sl = d - ip.lx[idx] - t.sl;
  t.r_su = ip.ux[idx] - d - t.su;
  if constexpr (IP::SOFT) {
    t.el = ip.elx[idx];
    t.eu = ip.eux[idx];
    t.nl = ip.nulx[idx];
    t.nu = ip.nuux[idx];
    t.r_sl += t.el;  // s = dx + e - lx
    t.r_su += t.eu;
  }
  pair_rhs<IP::SOFT>(t, mode, cent, mode == CORRECTOR ? ip.ddx_a[idx] : 0.0f);
  return t;
}

// Input bounds are actuator limits: always hard.
template <class IP>
__device__ __forceinline__ Terms u_terms(const IP& ip, int idx, int mode, float cent) {
  Terms t;
  const float d = ip.du[idx];
  t.sl = ip.slu[idx];
  t.su = ip.suu[idx];
  t.ll = ip.llu[idx];
  t.lu = ip.luu[idx];
  t.r_sl = d - ip.lu[idx] - t.sl;
  t.r_su = ip.uu[idx] - d - t.su;
  pair_rhs<false>(t, mode, cent, mode == CORRECTOR ? ip.ddu_a[idx] : 0.0f);
  return t;
}

// Complementarity correction of the Newton right-hand side, and the barrier
// diagonal, of one pair.
template <bool SOFT>
__device__ __forceinline__ float pair_corr(const Terms& t) {
  if constexpr (SOFT) return t.cg_l - t.cg_u;
  return (t.rc_l + t.ll * t.r_sl) / t.sl - (t.rc_u + t.lu * t.r_su) / t.su;
}

template <bool SOFT>
__device__ __forceinline__ float pair_sig(const Terms& t) {
  if constexpr (SOFT) return t.w_l + t.w_u;
  return t.ll / t.sl + t.lu / t.su;
}

// q-hat of state element idx, and its barrier diagonal in `sig`.
template <class IP>
__device__ __forceinline__ float qhat(const IP& ip, int idx, int mode, float cent, float& sig) {
  const Terms t = x_terms(ip, idx, mode, cent);
  sig = pair_sig<IP::SOFT>(t);
  return ip.qdiag[idx] * ip.dx[idx] + ip.qx[idx] - t.ll + t.lu + pair_corr<IP::SOFT>(t);
}

template <class IP>
__device__ __forceinline__ float rhat(const IP& ip, int idx, int mode, float cent, float& sig) {
  const Terms t = u_terms(ip, idx, mode, cent);
  sig = pair_sig<false>(t);
  return ip.rdiag[idx] * ip.du[idx] + ip.ru[idx] - t.ll + t.lu + pair_corr<false>(t);
}

// Lower Cholesky factor of an NU x NU SPD matrix, with a 1e-12 floor on the
// pivots (at NU = 1, a square root).
template <int NU>
__device__ __forceinline__ void chol(const float G[NU][NU], float l[NU][NU]) {
  for (int j = 0; j < NU; ++j) {
    float s = G[j][j];
    for (int k = 0; k < j; ++k) s -= l[j][k] * l[j][k];
    l[j][j] = sqrtf(fmaxf(s, 1e-12f));
    const float inv = 1.0f / l[j][j];
    for (int i = j + 1; i < NU; ++i) {
      float t = G[i][j];
      for (int k = 0; k < j; ++k) t -= l[i][k] * l[j][k];
      l[i][j] = t * inv;
    }
  }
}

// Solve L L^T x = b in place.
template <int NU>
__device__ __forceinline__ void chol_solve(const float l[NU][NU], float b[NU]) {
  float y[NU];
  for (int i = 0; i < NU; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= l[i][k] * y[k];
    y[i] = s / l[i][i];
  }
  for (int i = NU - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < NU; ++k) s -= l[k][i] * b[k];
    b[i] = s / l[i][i];
  }
}

// Hint into L2 the `rows` per-lane rows of a lanes-layout array that start at
// per-lane element `first`: one 128-byte line per warp and row, the rows
// spread over the warp's lanes. A hint only: it never faults and moves no
// data into the block.
__device__ __forceinline__ void prefetch_rows(const ConstLaneView& v, long first, int rows) {
#ifdef __CUDA_ARCH__
  for (int e = threadIdx.x & 31; e < rows; e += 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(v.base + (first + e) * v.L));
#endif
}

// The read-only data of stage k that a streamed sweep is about to need.
template <class C>
__device__ __forceinline__ void prefetch_stage(const Ip<C>& ip, int k) {
  constexpr int NX = C::NX, NU = C::NU;
  prefetch_rows(ip.A, (long)k * NX * NX, NX * NX);
  prefetch_rows(ip.B, (long)k * NX * NU, NX * NU);
}

// Backward Riccati sweep + forward rollout of the Newton system; writes the
// state and input directions to (ddx_o, ddu_o). compute_rdyn (first sweep of
// an iteration) forms the dynamics residual r_dyn_k = A dx_k + B du_k + r -
// dx_{k+1} inside the sweep.
template <class C>
__device__ void newton(const Ip<C>& ip, int mode, float cent, bool compute_rdyn,
                       const LaneView& ddx_o, const LaneView& ddu_o) {
  constexpr int NX = C::NX, NU = C::NU;
  const int T = ip.T;
  float p[NX];
  for (int i = 0; i < NX; ++i) {
    float sig;
    p[i] = qhat(ip, T * NX + i, mode, cent, sig);
    for (int j = 0; j < NX; ++j) ip.P(i, j) = i == j ? ip.qdiag[T * NX + i] + sig : 0.0f;
  }
  for (int k = T - 1; k >= 0; --k) {
    float Frp[NX], gx[NX], gu[NU], kf[NU];
    float Gxu[NX][NU];
    if (k > 0) prefetch_stage(ip, k - 1);
    if (compute_rdyn) {
      for (int i = 0; i < NX; ++i) {
        float s = 0.0f;
        for (int j = 0; j < NX; ++j) s += ip.A[(k * NX + i) * NX + j] * ip.dx[k * NX + j];
        float t = 0.0f;
        for (int u = 0; u < NU; ++u) t += ip.B[(k * NX + i) * NU + u] * ip.du[k * NU + u];
        ip.rdyn[k * NX + i] = s + t + ip.r[k * NX + i] - ip.dx[(k + 1) * NX + i];
      }
    }
    for (int i = 0; i < NX; ++i) {
      float s = 0.0f;
      for (int j = 0; j < NX; ++j) s += ip.P(i, j) * ip.rdyn[k * NX + j];
      Frp[i] = s + p[i];
    }
    // W = P [A_k | B_k]
    for (int c = 0; c < NX + NU; ++c) {
      float col[NX];
      for (int j = 0; j < NX; ++j) col[j] = ip.AB(k, j, c);
      for (int i = 0; i < NX; ++i) {
        float s = 0.0f;
        for (int j = 0; j < NX; ++j) s += ip.P(i, j) * col[j];
        ip.W(i, c) = s;
      }
    }
    // [A|B]^T W: Gxx overwrites P (P is no longer needed), Gxu and Guu in registers.
    float Guu[NU][NU];
    for (int a = 0; a < NX + NU; ++a) {
      float col[NX];
      for (int j = 0; j < NX; ++j) col[j] = ip.AB(k, j, a);
      float g = 0.0f;
      for (int j = 0; j < NX; ++j) g += col[j] * Frp[j];
      float sig;
      if (a < NX) {
        for (int c = 0; c < NX + NU; ++c) {
          float s = 0.0f;
          for (int j = 0; j < NX; ++j) s += col[j] * ip.W(j, c);
          if (c < NX)
            ip.P(a, c) = s;
          else
            Gxu[a][c - NX] = s;
        }
        gx[a] = qhat(ip, k * NX + a, mode, cent, sig) + g;
        ip.P(a, a) += ip.qdiag[k * NX + a] + sig;
      } else {
        for (int c = NX; c < NX + NU; ++c) {
          float s = 0.0f;
          for (int j = 0; j < NX; ++j) s += col[j] * ip.W(j, c);
          Guu[a - NX][c - NX] = s;
        }
        gu[a - NX] = rhat(ip, k * NU + (a - NX), mode, cent, sig) + g;
        Guu[a - NX][a - NX] += ip.rdiag[k * NU + (a - NX)] + sig;
      }
    }
    float l[NU][NU];
    chol<NU>(Guu, l);
    // K = -Guu^-1 Gxu^T, column by column
    for (int j = 0; j < NX; ++j) {
      float b[NU];
      for (int u = 0; u < NU; ++u) b[u] = Gxu[j][u];
      chol_solve<NU>(l, b);
      for (int u = 0; u < NU; ++u) ip.K[(k * NU + u) * NX + j] = -b[u];
    }
    for (int u = 0; u < NU; ++u) kf[u] = gu[u];
    chol_solve<NU>(l, kf);
    for (int u = 0; u < NU; ++u) kf[u] = -kf[u];
    // P = Gxx + Gxu K, symmetrized
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        float s = ip.P(i, j);
        for (int u = 0; u < NU; ++u) s += Gxu[i][u] * ip.K[(k * NU + u) * NX + j];
        ip.P(i, j) = s;
      }
    for (int i = 0; i < NX; ++i)
      for (int j = i + 1; j < NX; ++j) {
        const float s = 0.5f * (ip.P(i, j) + ip.P(j, i));
        ip.P(i, j) = s;
        ip.P(j, i) = s;
      }
    for (int u = 0; u < NU; ++u) ip.kff[k * NU + u] = kf[u];
    for (int i = 0; i < NX; ++i) {
      float s = gx[i];
      for (int u = 0; u < NU; ++u) s += Gxu[i][u] * kf[u];
      p[i] = s;
    }
  }
  // forward rollout
  float xprev[NX];
  for (int i = 0; i < NX; ++i) {
    xprev[i] = 0.0f;
    ddx_o[i] = 0.0f;
  }
  for (int k = 0; k < T; ++k) {
    if (k + 1 < T) prefetch_stage(ip, k + 1);
    float du[NU], xn[NX];
    for (int u = 0; u < NU; ++u) {
      float s = ip.kff[k * NU + u];
      for (int j = 0; j < NX; ++j) s += ip.K[(k * NU + u) * NX + j] * xprev[j];
      du[u] = s;
      ddu_o[k * NU + u] = s;
    }
    for (int i = 0; i < NX; ++i) {
      float s = ip.rdyn[k * NX + i];
      for (int j = 0; j < NX; ++j) s += ip.A[(k * NX + i) * NX + j] * xprev[j];
      for (int u = 0; u < NU; ++u) s += ip.B[(k * NX + i) * NU + u] * du[u];
      xn[i] = s;
    }
    for (int i = 0; i < NX; ++i) {
      xprev[i] = xn[i];
      ddx_o[(k + 1) * NX + i] = xn[i];
    }
  }
}

__device__ __forceinline__ float ratio(float v, float d, float t) {
  return d < 0.0f ? -t * v / fminf(d, -1e-30f) : CUDART_INF_F;
}

// Per-scenario fraction-to-boundary step lengths over every stage and dim.
// Soft pairs also keep e (primal) and nu = rho - lam (dual) positive.
template <class C>
__device__ void step_lengths(const Ip<C>& ip, int mode, float cent, const LaneView& ddx_d,
                             const LaneView& ddu_d, float t, float& a_p, float& a_d) {
  constexpr int NX = C::NX, NU = C::NU;
  float ap = CUDART_INF_F, ad = CUDART_INF_F;
  for (int idx = 0; idx < (ip.T + 1) * NX; ++idx) {
    const Terms p = x_terms(ip, idx, mode, cent);
    const Dir d = pair_dir<C::SOFT>(p, ddx_d[idx]);
    ap = fminf(ap, fminf(ratio(p.sl, d.ds_l, t), ratio(p.su, d.ds_u, t)));
    ad = fminf(ad, fminf(ratio(p.ll, d.dl_l, t), ratio(p.lu, d.dl_u, t)));
    if constexpr (C::SOFT) {
      ap = fminf(ap, fminf(ratio(p.el, d.de_l, t), ratio(p.eu, d.de_u, t)));
      ad = fminf(ad, fminf(ratio(p.nl, -d.dl_l, t), ratio(p.nu, -d.dl_u, t)));
    }
  }
  for (int idx = 0; idx < ip.T * NU; ++idx) {
    const Terms p = u_terms(ip, idx, mode, cent);
    const Dir d = pair_dir<false>(p, ddu_d[idx]);
    ap = fminf(ap, fminf(ratio(p.sl, d.ds_l, t), ratio(p.su, d.ds_u, t)));
    ad = fminf(ad, fminf(ratio(p.ll, d.dl_l, t), ratio(p.lu, d.dl_u, t)));
  }
  a_p = fminf(1.0f, ap);
  a_d = fminf(1.0f, ad);
}

// Sum of the complementarity products of every pair.
template <class C>
__device__ float gap_sum(const Ip<C>& ip) {
  constexpr int NX = C::NX, NU = C::NU;
  float g_lx = 0.0f, g_ux = 0.0f, g_lu = 0.0f, g_uu = 0.0f, g_e = 0.0f;
  for (int idx = 0; idx < (ip.T + 1) * NX; ++idx) {
    g_lx += ip.slx[idx] * ip.llx[idx];
    g_ux += ip.sux[idx] * ip.lux[idx];
    if constexpr (C::SOFT) g_e += ip.elx[idx] * ip.nulx[idx] + ip.eux[idx] * ip.nuux[idx];
  }
  for (int idx = 0; idx < ip.T * NU; ++idx) {
    g_lu += ip.slu[idx] * ip.llu[idx];
    g_uu += ip.suu[idx] * ip.luu[idx];
  }
  return g_lx + g_ux + g_lu + g_uu + g_e;
}

// One interior-point iteration; returns the next centering parameter.
template <class C>
__device__ float ip_iteration(const Ip<C>& ip, float mu, float sigma, float tau, float m_total) {
  constexpr int NX = C::NX, NU = C::NU;
  const int T = ip.T;

  int mode = PLAIN;
  float cent = mu;
  if (ip.mehrotra) {
    const float gap_now = gap_sum(ip) / m_total;
    newton(ip, AFFINE, 0.0f, true, ip.ddx_a, ip.ddu_a);
    float ap, ad;
    step_lengths(ip, AFFINE, 0.0f, ip.ddx_a, ip.ddu_a, 1.0f, ap, ad);
    float g_lx = 0.0f, g_ux = 0.0f, g_lu = 0.0f, g_uu = 0.0f, g_e = 0.0f;
    for (int idx = 0; idx < (T + 1) * NX; ++idx) {
      const Terms p = x_terms(ip, idx, AFFINE, 0.0f);
      const Dir d = pair_dir<C::SOFT>(p, ip.ddx_a[idx]);
      g_lx += (p.sl + ap * d.ds_l) * (p.ll + ad * d.dl_l);
      g_ux += (p.su + ap * d.ds_u) * (p.lu + ad * d.dl_u);
      if constexpr (C::SOFT)
        g_e += (p.el + ap * d.de_l) * (p.nl - ad * d.dl_l) +
               (p.eu + ap * d.de_u) * (p.nu - ad * d.dl_u);
    }
    for (int idx = 0; idx < T * NU; ++idx) {
      const Terms p = u_terms(ip, idx, AFFINE, 0.0f);
      const Dir d = pair_dir<false>(p, ip.ddu_a[idx]);
      g_lu += (p.sl + ap * d.ds_l) * (p.ll + ad * d.dl_l);
      g_uu += (p.su + ap * d.ds_u) * (p.lu + ad * d.dl_u);
    }
    const float gap_aff = (g_lx + g_ux + g_lu + g_uu + g_e) / m_total;
    const float ratio_aff = gap_aff / fmaxf(gap_now, 1e-16f);
    const float sig = fminf(fmaxf(ratio_aff * ratio_aff * ratio_aff, 1e-4f), 1.0f);
    mode = CORRECTOR;
    cent = fmaxf(sig * gap_now, C::SOFT ? 1e-8f : 1e-14f);
    newton(ip, CORRECTOR, cent, false, ip.ddx, ip.ddu);
  } else {
    newton(ip, PLAIN, cent, true, ip.ddx, ip.ddu);
  }

  float a_p, a_d;
  step_lengths(ip, mode, cent, ip.ddx, ip.ddu, tau, a_p, a_d);
  // Update in place: every element's directions come from its old values.
  for (int idx = 0; idx < (T + 1) * NX; ++idx) {
    const Terms p = x_terms(ip, idx, mode, cent);
    const float dd = ip.ddx[idx];
    const Dir d = pair_dir<C::SOFT>(p, dd);
    ip.dx[idx] = ip.dx[idx] + a_p * dd;
    ip.slx[idx] = p.sl + a_p * d.ds_l;
    ip.sux[idx] = p.su + a_p * d.ds_u;
    ip.llx[idx] = p.ll + a_d * d.dl_l;
    ip.lux[idx] = p.lu + a_d * d.dl_u;
    if constexpr (C::SOFT) {
      ip.elx[idx] = p.el + a_p * d.de_l;
      ip.eux[idx] = p.eu + a_p * d.de_u;
      ip.nulx[idx] = p.nl - a_d * d.dl_l;
      ip.nuux[idx] = p.nu - a_d * d.dl_u;
    }
  }
  for (int idx = 0; idx < T * NU; ++idx) {
    const Terms p = u_terms(ip, idx, mode, cent);
    const float dd = ip.ddu[idx];
    const Dir d = pair_dir<false>(p, dd);
    ip.du[idx] = ip.du[idx] + a_p * dd;
    ip.slu[idx] = p.sl + a_p * d.ds_l;
    ip.suu[idx] = p.su + a_p * d.ds_u;
    ip.llu[idx] = p.ll + a_d * d.dl_l;
    ip.luu[idx] = p.lu + a_d * d.dl_u;
  }
  return fmaxf(sigma * (gap_sum(ip) / m_total), C::SOFT ? 1e-8f : 1e-12f);
}

// The whole solve of one scenario: `smem` is the block's dynamic shared
// memory. adaptive_tol < 0 runs all n_ip iterations; soft_rho is read only
// by the SOFT instantiations, whose callers always pass adaptive_tol >= 1e-8.
// n_iters[tile] receives the number of iterations the tile ran.
template <class C>
__device__ void solve(const float* A, const float* B, const float* r, const float* qdiag,
                      const float* qx, const float* rdiag, const float* ru, const float* lx,
                      const float* ux, const float* lu, const float* uu, float* dx, float* du,
                      float* gap, int* n_iters, float* ws, float* smem, int T, int L, int n_ip,
                      float mu0, float sigma, float tau, float adaptive_tol, bool mehrotra,
                      float soft_rho) {
  constexpr int NX = C::NX, NU = C::NU;
  const int lane = threadIdx.x;
  const long nxs = (long)(T + 1) * NX, nus = (long)T * NU;
  const WsLayout w = ws_layout<C>(T);
  LaneView wsl = lane_view(ws, w.total, L);
  auto sub = [&](long off) { return LaneView{wsl.base + off * L, L}; };

  Ip<C> ip;
  ip.T = T;
  ip.L = L;
  ip.mehrotra = mehrotra;
  ip.A = lane_view(A, (long)T * NX * NX, L);
  ip.B = lane_view(B, (long)T * NX * NU, L);
  ip.r = lane_view(r, (long)T * NX, L);
  ip.qdiag = lane_view(qdiag, nxs, L);
  ip.qx = lane_view(qx, nxs, L);
  ip.rdiag = lane_view(rdiag, nus, L);
  ip.ru = lane_view(ru, nus, L);
  ip.lx = lane_view(lx, nxs, L);
  ip.ux = lane_view(ux, nxs, L);
  ip.lu = lane_view(lu, nus, L);
  ip.uu = lane_view(uu, nus, L);
  ip.dx = lane_view(dx, nxs, L);
  ip.du = lane_view(du, nus, L);
  ip.slx = sub(w.slx);
  ip.sux = sub(w.sux);
  ip.llx = sub(w.llx);
  ip.lux = sub(w.lux);
  ip.slu = sub(w.slu);
  ip.suu = sub(w.suu);
  ip.llu = sub(w.llu);
  ip.luu = sub(w.luu);
  ip.K = sub(w.K);
  ip.kff = sub(w.kff);
  ip.rdyn = sub(w.rdyn);
  ip.ddx_a = sub(w.ddx_a);
  ip.ddu_a = sub(w.ddu_a);
  ip.ddx = sub(w.ddx);
  ip.ddu = sub(w.ddu);
  ip.elx = sub(w.elx);
  ip.eux = sub(w.eux);
  ip.nulx = sub(w.nulx);
  ip.nuux = sub(w.nuux);
  ip.P_s = smem + lane;
  ip.W_s = smem + (long)NX * NX * L + lane;

  // init: dx = du = 0, slacks clipped to the interior, duals mu0 / s (soft
  // state bounds: e = s_min, lam <= 0.49 rho, nu = rho - lam)
  const float s_min = 1e-2f;
  for (int idx = 0; idx < nxs; ++idx) {
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
  for (int idx = 0; idx < nus; ++idx) {
    ip.du[idx] = 0.0f;
    ip.slu[idx] = fmaxf(-ip.lu[idx], s_min);
    ip.suu[idx] = fmaxf(ip.uu[idx], s_min);
    ip.llu[idx] = mu0 / ip.slu[idx];
    ip.luu[idx] = mu0 / ip.suu[idx];
  }
  const float m_total = 2.0f * (float)(nxs + nus) + (C::SOFT ? 2.0f * (float)nxs : 0.0f);

  float mu = mu0;
  const bool adaptive = adaptive_tol >= 0.0f;
  int it = 0;
  for (; it < n_ip; ++it) {
    // Tile-wide exit: stop only when every lane of this tile has mu <= tol.
    if (adaptive && __syncthreads_and(mu <= adaptive_tol)) break;
    mu = ip_iteration(ip, mu, sigma, tau, m_total);
  }
  if (lane == 0) n_iters[blockIdx.x] = it;
  gap[(long)blockIdx.x * L + lane] = gap_sum(ip) / m_total;
}

#ifdef __CUDACC__
template <class C>
__global__ void kernel(const float* A, const float* B, const float* r, const float* qdiag,
                       const float* qx, const float* rdiag, const float* ru, const float* lx,
                       const float* ux, const float* lu, const float* uu, float* dx, float* du,
                       float* gap, int* n_iters, float* ws, int T, int L, int n_ip, float mu0,
                       float sigma, float tau, float adaptive_tol, bool mehrotra, float soft_rho) {
  extern __shared__ float smem[];
  solve<C>(A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu, dx, du, gap, n_iters, ws, smem, T, L,
           n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho);
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

template <bool SOFT>
int launch(const float* A, const float* B, const float* r, const float* qdiag, const float* qx,
           const float* rdiag, const float* ru, const float* lx, const float* ux, const float* lu,
           const float* uu, float* dx, float* du, float* gap, int* n_iters, float* ws, int n_tiles,
           int T, int L, int nx, int nu, int n_ip, float mu0, float sigma, float tau,
           float adaptive_tol, int mehrotra, float soft_rho, void* stream) {
  return dispatch_nx_nu(nx, nu, [&](auto nx_c, auto nu_c) {
    constexpr int NX = decltype(nx_c)::value, NU = decltype(nu_c)::value;
    using C = Cfg<NX, NU, SOFT>;
    const size_t smem = sizeof(float) * (size_t)(NX * NX + NX * (NX + NU)) * L;
    cudaError_t err = cudaFuncSetAttribute(kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<C><<<n_tiles, L, smem, static_cast<cudaStream_t>(stream)>>>(
        A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu, dx, du, gap, n_iters, ws, T, L, n_ip, mu0,
        sigma, tau, adaptive_tol, mehrotra != 0, soft_rho);
    return (int)cudaGetLastError();
  });
}

// The two C entry points of one kernel variant: NAME_workspace_floats and
// NAME_launch (arguments as `launch` above).
#define GPMPC_OCP_IP_ENTRY_POINTS(NAME, SOFT)                                                     \
  extern "C" long NAME##_workspace_floats(int T, int nx, int nu) {                                \
    return gpmpc::ocp::workspace_floats<SOFT>(T, nx, nu);                                         \
  }                                                                                               \
  extern "C" int NAME##_launch(                                                                   \
      const float* A, const float* B, const float* r, const float* qdiag, const float* qx,        \
      const float* rdiag, const float* ru, const float* lx, const float* ux, const float* lu,     \
      const float* uu, float* dx, float* du, float* gap, int* n_iters, float* ws, int n_tiles,    \
      int T, int L, int nx, int nu, int n_ip, float mu0, float sigma, float tau,                  \
      float adaptive_tol, int mehrotra, float soft_rho, void* stream) {                           \
    return gpmpc::ocp::launch<SOFT>(A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu, dx, du,        \
                                          gap, n_iters, ws, n_tiles, T, L, nx, nu, n_ip, mu0,     \
                                          sigma, tau, adaptive_tol, mehrotra, soft_rho, stream);  \
  }
#endif  // __CUDACC__

}  // namespace ocp
}  // namespace gpmpc

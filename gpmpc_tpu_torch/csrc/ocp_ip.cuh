// The element algebra of the box-constrained OCP-QP interior point, which
// all three QP tiers share: the resident kernel (ocp_ip.cu, ocp_ip_soft.cu),
// tier 1 (ocp_ip_streamed*.cu) and tier 2 (ocp_ip_streamed2*.cu) are one
// kernel, ocp_ip_resident.cuh, instantiated under each tier's names. This
// header holds what that kernel computes element by element and per stage:
//
//  * the modes of a Newton solve (AFFINE, CORRECTOR, PLAIN centering);
//  * the slacks, duals, residuals and complementarity right-hand sides of one
//    box pair (Terms, pair_rhs, x_terms, u_terms), the directions of a pair
//    given its primal direction (Dir, pair_dir), its correction of the Newton
//    right-hand side and its barrier diagonal (pair_corr, pair_sig, qhat,
//    rhat), and the fraction-to-boundary ratio of one slack or dual (ratio);
//  * the NU x NU Cholesky factor and its solves (chol, chol_solve).
//
// SOFT pairs are L1-soft state bounds in the bounded-multiplier form. Per
// state bound a violation slack e > 0 and the penalty dual nu = rho - lam > 0
// are state of their own (nu is stored, since rho - lam rounds to 0 in
// float32 once lam reaches rho). The barrier weight is w = lam nu / den with
// den = s nu + e lam, floored at lam nu 1e-6, so nothing divides by a
// multiplier that has underflowed; the complementarity gradients are formed
// over the same den; step lengths and gaps take the extra pairs (e, nu); the
// centering floors move to 1e-8, below which float32 barrier weights break
// the Riccati recursion. Input bounds are actuator limits: always hard.
//
// x_terms, u_terms, qhat and rhat take any problem view with the member
// names of ocp_ip_resident.cuh's TeamIp.
#pragma once

#include <math_constants.h>

#include "lanes.cuh"

namespace gpmpc {
namespace ocp {

enum Mode { AFFINE = 0, CORRECTOR = 1, PLAIN = 2 };

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

// Fraction-to-boundary ratio of a slack or dual v moving along d, with margin
// t: infinite unless d < 0.
__device__ __forceinline__ float ratio(float v, float d, float t) {
  return d < 0.0f ? -t * v / fminf(d, -1e-30f) : CUDART_INF_F;
}

}  // namespace ocp
}  // namespace gpmpc

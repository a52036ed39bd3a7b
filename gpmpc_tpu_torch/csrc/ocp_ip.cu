// Box-constrained OCP-QP primal-dual interior point, one scenario per thread.
//
// Replaces: gpmpc_tpu/ops/pallas_ocp.py::solve_ocp_qp_lanes (_ip_kernel_body,
// with _mm, _mv and the _chol4_* helpers), hard-bound modes: plain centering or
// Mehrotra predictor-corrector, fixed iteration count or the adaptive exit.
// Each iteration: barrier weights, dynamics residual, a backward Riccati sweep
// (diagonal Q/R plus barrier, a 4x4 Cholesky per stage), a forward rollout,
// per-scenario fraction-to-boundary step lengths, and the slack/dual update.
// Mehrotra factorizes once per iteration: the affine sweep stores P r, the
// Guu Cholesky factor and Gxu, and the corrector reuses them in a
// vector-only sweep.
//
// What bounds it on an H100: the sequential dependency chain per scenario
// (T stages x ~4k FMAs per Riccati step, twice per iteration) and on-chip
// memory bandwidth for the per-stage matrices; there is no data reuse across
// scenarios. Device-memory traffic is the QP data (~1 KB per scenario-stage,
// read once per sweep from L2) and the per-scenario workspace.
//
// Design:
//  * one block per L-scenario tile, one thread per scenario (lane);
//  * the tile-wide adaptive exit of the reference is a block-wide vote,
//    __syncthreads_and(mu <= tol), over exactly the L lanes of the tile:
//    padded scenarios vote too, as in the reference;
//  * the Riccati matrix P (12x12) and W = P [A | B] (12x16) of each scenario
//    live in shared memory, lane-interleaved (entry e of lane l at e * L + l,
//    bank-conflict-free): 336 * L floats, 172 KB at L = 128. In registers they
//    would need ~340 per thread, past the 255 limit. The per-stage register
//    arrays (Gxu, Guu, its factor, gx, p) still spill some (ptxas -v; the
//    counts are in PERF.md);
//  * everything that must survive a sweep (slacks, duals, K, kff, the dynamics
//    residual, directions and the Mehrotra stores) is a per-scenario workspace
//    in device memory, scenario axis last, allocated by the wrapper;
//  * the Newton right-hand sides (q-hat, r-hat), the barrier diagonals and the
//    slack/dual directions are recomputed element by element from the stored
//    state instead of being stored.
#include <math_constants.h>

#include "lanes.cuh"

namespace {

using gpmpc::NX;
using gpmpc::NU;
using gpmpc::ConstLaneView;
using gpmpc::LaneView;

enum Mode { AFFINE = 0, CORRECTOR = 1, PLAIN = 2 };

struct WsLayout {
  long slx, sux, llx, lux, slu, suu, llu, luu;
  long K, kff, rdyn, ddx_a, ddu_a, ddx, ddu, Pr, lchol, Gxu;
  long total;
};

__host__ __device__ WsLayout ws_layout(int T) {
  WsLayout w;
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
  w.total = o;
  return w;
}

struct Ip {
  int T, L;
  bool mehrotra;
  ConstLaneView A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu;
  LaneView dx, du, slx, sux, llx, lux, slu, suu, llu, luu;
  LaneView K, kff, rdyn, ddx_a, ddu_a, ddx, ddu, Pr, lchol, Gxu;
  float* P_s;  // NX*NX*L shared, this lane at +lane
  float* W_s;  // NX*(NX+NU)*L shared
  __device__ __forceinline__ float& P(int i, int j) const { return P_s[(i * NX + j) * L]; }
  __device__ __forceinline__ float& W(int i, int c) const { return W_s[(i * (NX + NU) + c) * L]; }
  // column c of [A_k | B_k], row j
  __device__ __forceinline__ float AB(int k, int j, int c) const {
    return c < NX ? A[(k * NX + j) * NX + c] : B[(k * NX + j) * NU + (c - NX)];
  }
};

// Slack residuals and complementarity right-hand sides of one box pair
// (lower/upper bound on one variable), for the given mode:
//   AFFINE:    r_c = s * lam
//   PLAIN:     r_c = s * lam - mu
//   CORRECTOR: r_c = s * lam + ds_aff * dlam_aff - target
struct Pair {
  float sl, su, ll, lu, r_sl, r_su, rc_l, rc_u;
};

__device__ __forceinline__ Pair pair_terms(float d, float lo, float hi, float sl, float su,
                                           float ll, float lu, int mode, float cent,
                                           float dd_aff) {
  Pair p{sl, su, ll, lu, d - lo - sl, hi - d - su, 0.0f, 0.0f};
  if (mode == AFFINE) {
    p.rc_l = sl * ll;
    p.rc_u = su * lu;
  } else if (mode == PLAIN) {
    p.rc_l = sl * ll - cent;
    p.rc_u = su * lu - cent;
  } else {
    const float ds_l = dd_aff + p.r_sl, ds_u = p.r_su - dd_aff;
    const float dl_l = -(sl * ll + ll * ds_l) / sl;
    const float dl_u = -(su * lu + lu * ds_u) / su;
    p.rc_l = sl * ll + ds_l * dl_l - cent;
    p.rc_u = su * lu + ds_u * dl_u - cent;
  }
  return p;
}

__device__ __forceinline__ float pair_corr(const Pair& p) {
  return (p.rc_l + p.ll * p.r_sl) / p.sl - (p.rc_u + p.lu * p.r_su) / p.su;
}

__device__ __forceinline__ Pair x_pair(const Ip& ip, int idx, int mode, float cent) {
  return pair_terms(ip.dx[idx], ip.lx[idx], ip.ux[idx], ip.slx[idx], ip.sux[idx], ip.llx[idx],
                    ip.lux[idx], mode, cent, mode == CORRECTOR ? ip.ddx_a[idx] : 0.0f);
}

__device__ __forceinline__ Pair u_pair(const Ip& ip, int idx, int mode, float cent) {
  return pair_terms(ip.du[idx], ip.lu[idx], ip.uu[idx], ip.slu[idx], ip.suu[idx], ip.llu[idx],
                    ip.luu[idx], mode, cent, mode == CORRECTOR ? ip.ddu_a[idx] : 0.0f);
}

__device__ __forceinline__ float qhat(const Ip& ip, int idx, int mode, float cent) {
  const Pair p = x_pair(ip, idx, mode, cent);
  return ip.qdiag[idx] * ip.dx[idx] + ip.qx[idx] - p.ll + p.lu + pair_corr(p);
}

__device__ __forceinline__ float rhat(const Ip& ip, int idx, int mode, float cent) {
  const Pair p = u_pair(ip, idx, mode, cent);
  return ip.rdiag[idx] * ip.du[idx] + ip.ru[idx] - p.ll + p.lu + pair_corr(p);
}

__device__ __forceinline__ float sigx(const Ip& ip, int idx) {
  return ip.llx[idx] / ip.slx[idx] + ip.lux[idx] / ip.sux[idx];
}

__device__ __forceinline__ float sigu(const Ip& ip, int idx) {
  return ip.llu[idx] / ip.slu[idx] + ip.luu[idx] / ip.suu[idx];
}

// Lower Cholesky factor of a 4x4 SPD matrix, packed row-major (10 entries),
// with the reference's 1e-12 floor on the pivots.
__device__ __forceinline__ void chol4(const float G[NU][NU], float l[NU][NU]) {
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
__device__ __forceinline__ void chol4_solve(const float l[NU][NU], float b[NU]) {
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

// Backward Riccati sweep + forward rollout of the Newton system. matrix=false
// is the Mehrotra corrector: it reuses K, P r, the Cholesky factors and Gxu of
// the affine sweep and updates only the vector recursion. Writes the state and
// input directions to (ddx_o, ddu_o).
__device__ void newton(const Ip& ip, int mode, float cent, bool matrix, const LaneView& ddx_o,
                       const LaneView& ddu_o) {
  const int T = ip.T;
  float p[NX];
  for (int i = 0; i < NX; ++i) p[i] = qhat(ip, T * NX + i, mode, cent);
  if (matrix) {
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j)
        ip.P(i, j) = i == j ? ip.qdiag[T * NX + i] + sigx(ip, T * NX + i) : 0.0f;
  }
  for (int k = T - 1; k >= 0; --k) {
    float Frp[NX], gx[NX], gu[NU], kf[NU];
    float Gxu[NX][NU];
    if (matrix) {
      for (int i = 0; i < NX; ++i) {
        float s = 0.0f;
        for (int j = 0; j < NX; ++j) s += ip.P(i, j) * ip.rdyn[k * NX + j];
        if (ip.mehrotra) ip.Pr[k * NX + i] = s;
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
        if (a < NX) {
          for (int c = 0; c < NX + NU; ++c) {
            float s = 0.0f;
            for (int j = 0; j < NX; ++j) s += col[j] * ip.W(j, c);
            if (c < NX)
              ip.P(a, c) = s;
            else
              Gxu[a][c - NX] = s;
          }
          gx[a] = qhat(ip, k * NX + a, mode, cent) + g;
        } else {
          for (int c = NX; c < NX + NU; ++c) {
            float s = 0.0f;
            for (int j = 0; j < NX; ++j) s += col[j] * ip.W(j, c);
            Guu[a - NX][c - NX] = s;
          }
          gu[a - NX] = rhat(ip, k * NU + (a - NX), mode, cent) + g;
        }
      }
      for (int i = 0; i < NX; ++i) ip.P(i, i) += ip.qdiag[k * NX + i] + sigx(ip, k * NX + i);
      for (int u = 0; u < NU; ++u) Guu[u][u] += ip.rdiag[k * NU + u] + sigu(ip, k * NU + u);
      float l[NU][NU];
      chol4(Guu, l);
      if (ip.mehrotra) {
        for (int i = 0; i < NU; ++i)
          for (int j = 0; j < NU; ++j) ip.lchol[(k * NU + i) * NU + j] = j <= i ? l[i][j] : 0.0f;
        for (int i = 0; i < NX; ++i)
          for (int u = 0; u < NU; ++u) ip.Gxu[(k * NX + i) * NU + u] = Gxu[i][u];
      }
      // K = -Guu^-1 Gxu^T, column by column
      for (int j = 0; j < NX; ++j) {
        float b[NU];
        for (int u = 0; u < NU; ++u) b[u] = Gxu[j][u];
        chol4_solve(l, b);
        for (int u = 0; u < NU; ++u) ip.K[(k * NU + u) * NX + j] = -b[u];
      }
      for (int u = 0; u < NU; ++u) kf[u] = gu[u];
      chol4_solve(l, kf);
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
    } else {
      for (int i = 0; i < NX; ++i) Frp[i] = ip.Pr[k * NX + i] + p[i];
      for (int a = 0; a < NX; ++a) {
        float g = 0.0f;
        for (int j = 0; j < NX; ++j) g += ip.A[(k * NX + j) * NX + a] * Frp[j];
        gx[a] = qhat(ip, k * NX + a, mode, cent) + g;
      }
      for (int u = 0; u < NU; ++u) {
        float g = 0.0f;
        for (int j = 0; j < NX; ++j) g += ip.B[(k * NX + j) * NU + u] * Frp[j];
        gu[u] = rhat(ip, k * NU + u, mode, cent) + g;
      }
      float l[NU][NU];
      for (int i = 0; i < NU; ++i)
        for (int j = 0; j < NU; ++j) l[i][j] = ip.lchol[(k * NU + i) * NU + j];
      for (int u = 0; u < NU; ++u) kf[u] = gu[u];
      chol4_solve(l, kf);
      for (int u = 0; u < NU; ++u) kf[u] = -kf[u];
      for (int i = 0; i < NX; ++i)
        for (int u = 0; u < NU; ++u) Gxu[i][u] = ip.Gxu[(k * NX + i) * NU + u];
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

// Directions of one box pair given the primal direction dd of its variable.
struct PairDir {
  float ds_l, ds_u, dl_l, dl_u;
};

__device__ __forceinline__ PairDir pair_dir(const Pair& p, float dd) {
  PairDir d;
  d.ds_l = dd + p.r_sl;
  d.ds_u = p.r_su - dd;
  d.dl_l = -(p.rc_l + p.ll * d.ds_l) / p.sl;
  d.dl_u = -(p.rc_u + p.lu * d.ds_u) / p.su;
  return d;
}

// Per-scenario fraction-to-boundary step lengths over every stage and dim.
__device__ void step_lengths(const Ip& ip, int mode, float cent, const LaneView& ddx_d,
                             const LaneView& ddu_d, float t, float& a_p, float& a_d) {
  float ap = CUDART_INF_F, ad = CUDART_INF_F;
  for (int idx = 0; idx < (ip.T + 1) * NX; ++idx) {
    const Pair p = x_pair(ip, idx, mode, cent);
    const PairDir d = pair_dir(p, ddx_d[idx]);
    ap = fminf(ap, fminf(ratio(p.sl, d.ds_l, t), ratio(p.su, d.ds_u, t)));
    ad = fminf(ad, fminf(ratio(p.ll, d.dl_l, t), ratio(p.lu, d.dl_u, t)));
  }
  for (int idx = 0; idx < ip.T * NU; ++idx) {
    const Pair p = u_pair(ip, idx, mode, cent);
    const PairDir d = pair_dir(p, ddu_d[idx]);
    ap = fminf(ap, fminf(ratio(p.sl, d.ds_l, t), ratio(p.su, d.ds_u, t)));
    ad = fminf(ad, fminf(ratio(p.ll, d.dl_l, t), ratio(p.lu, d.dl_u, t)));
  }
  a_p = fminf(1.0f, ap);
  a_d = fminf(1.0f, ad);
}

__device__ float gap_sum(const Ip& ip) {
  float g_lx = 0.0f, g_ux = 0.0f, g_lu = 0.0f, g_uu = 0.0f;
  for (int idx = 0; idx < (ip.T + 1) * NX; ++idx) {
    g_lx += ip.slx[idx] * ip.llx[idx];
    g_ux += ip.sux[idx] * ip.lux[idx];
  }
  for (int idx = 0; idx < ip.T * NU; ++idx) {
    g_lu += ip.slu[idx] * ip.llu[idx];
    g_uu += ip.suu[idx] * ip.luu[idx];
  }
  return g_lx + g_ux + g_lu + g_uu;
}

// One interior-point iteration; returns the next centering parameter.
__device__ float ip_iteration(const Ip& ip, float mu, float sigma, float tau, float m_total) {
  const int T = ip.T;
  // dynamics residual r_dyn_k = A dx_k + B du_k + r - dx_{k+1}
  for (int k = 0; k < T; ++k)
    for (int i = 0; i < NX; ++i) {
      float s = 0.0f;
      for (int j = 0; j < NX; ++j) s += ip.A[(k * NX + i) * NX + j] * ip.dx[k * NX + j];
      float t = 0.0f;
      for (int u = 0; u < NU; ++u) t += ip.B[(k * NX + i) * NU + u] * ip.du[k * NU + u];
      ip.rdyn[k * NX + i] = s + t + ip.r[k * NX + i] - ip.dx[(k + 1) * NX + i];
    }

  int mode = PLAIN;
  float cent = mu;
  if (ip.mehrotra) {
    const float gap_now = gap_sum(ip) / m_total;
    newton(ip, AFFINE, 0.0f, true, ip.ddx_a, ip.ddu_a);
    float ap, ad;
    step_lengths(ip, AFFINE, 0.0f, ip.ddx_a, ip.ddu_a, 1.0f, ap, ad);
    float g_lx = 0.0f, g_ux = 0.0f, g_lu = 0.0f, g_uu = 0.0f;
    for (int idx = 0; idx < (T + 1) * NX; ++idx) {
      const Pair p = x_pair(ip, idx, AFFINE, 0.0f);
      const PairDir d = pair_dir(p, ip.ddx_a[idx]);
      g_lx += (p.sl + ap * d.ds_l) * (p.ll + ad * d.dl_l);
      g_ux += (p.su + ap * d.ds_u) * (p.lu + ad * d.dl_u);
    }
    for (int idx = 0; idx < T * NU; ++idx) {
      const Pair p = u_pair(ip, idx, AFFINE, 0.0f);
      const PairDir d = pair_dir(p, ip.ddu_a[idx]);
      g_lu += (p.sl + ap * d.ds_l) * (p.ll + ad * d.dl_l);
      g_uu += (p.su + ap * d.ds_u) * (p.lu + ad * d.dl_u);
    }
    const float gap_aff = (g_lx + g_ux + g_lu + g_uu) / m_total;
    const float ratio_aff = gap_aff / fmaxf(gap_now, 1e-16f);
    const float sig = fminf(fmaxf(ratio_aff * ratio_aff * ratio_aff, 1e-4f), 1.0f);
    mode = CORRECTOR;
    cent = fmaxf(sig * gap_now, 1e-14f);
    newton(ip, CORRECTOR, cent, false, ip.ddx, ip.ddu);
  } else {
    newton(ip, PLAIN, cent, true, ip.ddx, ip.ddu);
  }

  float a_p, a_d;
  step_lengths(ip, mode, cent, ip.ddx, ip.ddu, tau, a_p, a_d);
  // Update in place: every element's directions come from its old values.
  for (int idx = 0; idx < (T + 1) * NX; ++idx) {
    const Pair p = x_pair(ip, idx, mode, cent);
    const float dd = ip.ddx[idx];
    const PairDir d = pair_dir(p, dd);
    ip.dx[idx] = ip.dx[idx] + a_p * dd;
    ip.slx[idx] = p.sl + a_p * d.ds_l;
    ip.sux[idx] = p.su + a_p * d.ds_u;
    ip.llx[idx] = p.ll + a_d * d.dl_l;
    ip.lux[idx] = p.lu + a_d * d.dl_u;
  }
  for (int idx = 0; idx < T * NU; ++idx) {
    const Pair p = u_pair(ip, idx, mode, cent);
    const float dd = ip.ddu[idx];
    const PairDir d = pair_dir(p, dd);
    ip.du[idx] = ip.du[idx] + a_p * dd;
    ip.slu[idx] = p.sl + a_p * d.ds_l;
    ip.suu[idx] = p.su + a_p * d.ds_u;
    ip.llu[idx] = p.ll + a_d * d.dl_l;
    ip.luu[idx] = p.lu + a_d * d.dl_u;
  }
  return fmaxf(sigma * (gap_sum(ip) / m_total), 1e-12f);
}

__global__ void ocp_ip_kernel(const float* A, const float* B, const float* r, const float* qdiag,
                              const float* qx, const float* rdiag, const float* ru,
                              const float* lx, const float* ux, const float* lu,
                              const float* uu, float* dx, float* du, float* gap, float* ws,
                              int T, int L, int n_ip, float mu0, float sigma, float tau,
                              float adaptive_tol, bool mehrotra) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const long nxs = (long)(T + 1) * NX, nus = (long)T * NU;
  const WsLayout w = ws_layout(T);
  LaneView wsl = gpmpc::lane_view(ws, w.total, L);
  auto sub = [&](long off) { return LaneView{wsl.base + off * L, L}; };

  Ip ip;
  ip.T = T;
  ip.L = L;
  ip.mehrotra = mehrotra;
  ip.A = gpmpc::lane_view(A, (long)T * NX * NX, L);
  ip.B = gpmpc::lane_view(B, (long)T * NX * NU, L);
  ip.r = gpmpc::lane_view(r, (long)T * NX, L);
  ip.qdiag = gpmpc::lane_view(qdiag, nxs, L);
  ip.qx = gpmpc::lane_view(qx, nxs, L);
  ip.rdiag = gpmpc::lane_view(rdiag, nus, L);
  ip.ru = gpmpc::lane_view(ru, nus, L);
  ip.lx = gpmpc::lane_view(lx, nxs, L);
  ip.ux = gpmpc::lane_view(ux, nxs, L);
  ip.lu = gpmpc::lane_view(lu, nus, L);
  ip.uu = gpmpc::lane_view(uu, nus, L);
  ip.dx = gpmpc::lane_view(dx, nxs, L);
  ip.du = gpmpc::lane_view(du, nus, L);
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
  ip.Pr = sub(w.Pr);
  ip.lchol = sub(w.lchol);
  ip.Gxu = sub(w.Gxu);
  ip.P_s = smem + lane;
  ip.W_s = smem + (long)NX * NX * L + lane;

  // init: dx = du = 0, slacks clipped to the interior, duals mu0 / s
  const float s_min = 1e-2f;
  for (int idx = 0; idx < nxs; ++idx) {
    ip.dx[idx] = 0.0f;
    ip.slx[idx] = fmaxf(-ip.lx[idx], s_min);
    ip.sux[idx] = fmaxf(ip.ux[idx], s_min);
    ip.llx[idx] = mu0 / ip.slx[idx];
    ip.lux[idx] = mu0 / ip.sux[idx];
  }
  for (int idx = 0; idx < nus; ++idx) {
    ip.du[idx] = 0.0f;
    ip.slu[idx] = fmaxf(-ip.lu[idx], s_min);
    ip.suu[idx] = fmaxf(ip.uu[idx], s_min);
    ip.llu[idx] = mu0 / ip.slu[idx];
    ip.luu[idx] = mu0 / ip.suu[idx];
  }
  const float m_total = 2.0f * (float)(nxs + nus);

  float mu = mu0;
  const bool adaptive = adaptive_tol >= 0.0f;
  for (int it = 0; it < n_ip; ++it) {
    // Tile-wide exit: stop only when every lane of this tile has mu <= tol.
    if (adaptive && __syncthreads_and(mu <= adaptive_tol)) break;
    mu = ip_iteration(ip, mu, sigma, tau, m_total);
  }
  gap[(long)blockIdx.x * L + lane] = gap_sum(ip) / m_total;
}

}  // namespace

extern "C" long ocp_ip_workspace_floats(int T) { return ws_layout(T).total; }

extern "C" int ocp_ip_launch(const float* A, const float* B, const float* r, const float* qdiag,
                             const float* qx, const float* rdiag, const float* ru,
                             const float* lx, const float* ux, const float* lu, const float* uu,
                             float* dx, float* du, float* gap, float* ws, int n_tiles, int T,
                             int L, int n_ip, float mu0, float sigma, float tau,
                             float adaptive_tol, int mehrotra, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(NX * NX + NX * (NX + NU)) * L;
  cudaError_t err = cudaFuncSetAttribute(
      ocp_ip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ocp_ip_kernel<<<n_tiles, L, smem, static_cast<cudaStream_t>(stream)>>>(
      A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu, dx, du, gap, ws, T, L, n_ip, mu0, sigma, tau,
      adaptive_tol, mehrotra != 0);
  return (int)cudaGetLastError();
}

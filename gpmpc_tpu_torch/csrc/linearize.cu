// Dynamics linearization of the three model families: RK4 of the prior plus
// the GP-mean residual, with the analytic Jacobian chain through the four RK4
// stages.
//
// Replaces: gpmpc_tpu/ops/pallas_linearize.py::linearize_ocp_lanes with its
// family closures (_linearize_kernel_body, _gp_mean_grad, _build_mat, and
// _quad_fc_and_jac, _cart_fc_and_jac, _twolink_fc_and_jac of the
// _FAMILY_FC_JAC registry). For each stage k of each scenario:
//   fnext_k = RK4(x_k, u_k),  A_k = d fnext / dx,  B_k = d fnext / du.
//
// What bounds it on an H100: the writes of A and B (832 bytes per
// scenario-stage at the quadrotor's widths, against 64 read), then the
// arithmetic: each stage evaluates the G GP means and gradients 4 times over
// Ms inducing points (one expf each) and the Jacobian chain. Nothing is
// carried from one stage to the next (the reference's stage body reads x_k
// and u_k and writes stage k only), so a kernel that walks the stages of a
// scenario in one thread leaves T-fold parallelism unused: at B = 1024 the
// one-thread-per-scenario mapping is 8 blocks of 128 threads on 132 SMs.
//
// Design: stages in the grid and a team of threads per (scenario, stage).
// Block (x, y) covers up to 128 / TEAM lanes of one tile at stage y: grid
// (n_tiles * lane chunks, T), threads (lanes a block, TEAM) (the reference's
// T <= 1024 keeps the grid's y under its limit of 65,535, so no block needs
// to walk several stages). With the stages in the grid even a team of 1
// gives T times the blocks of a thread-per-scenario kernel. threadIdx.x is
// the lane, so a warp is 32 consecutive scenarios and every load of X and U
// and store of fnext, A and B is one coalesced 128-byte transaction;
// threadIdx.y is the team member. TEAM is a constant of each family trait,
// the fastest of 1, 2 and 4 on an H100 (scripts/bench_linearize_team_torch.py,
// which builds this file with -DLINEARIZE_TEAM=n to give every family a team
// of n): 1 for the quadrotor, whose closure, repeated by every member,
// outweighs the split GP sums, and for the cartpole, where 1 and 2 read
// alike; 2 for the two-link arm, whose GP inputs are six wide. The team
// splits the GP sums (member t takes inducing points j = t mod TEAM): at each
// of the four RK evaluations the members' partial means and gradients
// (G (1 + D) values) meet in shared memory behind one __syncthreads (two
// buffers alternate, so a member never overwrites a buffer another is still
// reading) and every member adds them in member order, so all members hold
// the same closure values. The team then splits the NX + NU columns of
// [A | B] (column c to member c mod TEAM); member 0 writes fnext. Every
// thread of a block runs every evaluation and reaches every barrier: a lane
// past L computes lane L - 1 and stores nothing. The kernel is a template on
// a family trait that supplies NX, NU, the GP count G and input width D, its
// TEAM, the family's sparse continuous Jacobian (struct Jac: only its
// non-constant entries), fc_and_jac (f and Jac at one point; it asks the team
// for the GP terms) and jac_col (one column of [Jx | Ju] applied to a
// vector). The inducing inputs, weights and hyperparameters (shared by all
// scenarios) are staged in shared memory per block and read as broadcasts.
// The chain dk_{i+1} = J_{i+1} (I + h dk_i) acts column by column on
// [dx | du], so each column runs the whole four-stage chain with three
// NX-vectors in registers and is written straight to A or B.
#include "lanes.cuh"

namespace {

constexpr float GRAVITY = 9.81f;

constexpr int kThreads = 128;  // threads a block: lanes x TEAM

#ifdef LINEARIZE_TEAM
#define FAMILY_TEAM(measured) LINEARIZE_TEAM
#else
#define FAMILY_TEAM(measured) measured
#endif

// The GP operands (shared memory, staged per block) and one team member's
// share of the GP sums.
template <int G, int D, int TEAM>
struct GpTeam {
  static constexpr int NV = G * (1 + D);  // per GP: the mean and its gradient
  const float* Zs;     // (G, Ms, D)
  const float* alpha;  // (G, Ms)
  const float* hyp;    // (G, 1 + D): sf2, 1/ell^2 per dim
  int Ms;
  float* red;          // 2 x TEAM x NV x lanes (TEAM > 1)
  int member, lane, lanes;
  int parity;          // the reduction buffer of the next evaluation

  // SE posterior means of the G GPs at z[g] and their gradients d mean / dz.
  // Member t sums the inducing points j = t (mod TEAM); the partial sums meet
  // in shared memory and every member adds them in member order.
  __device__ void mean_grad(const float z[G][D], float mean[G], float grad[G][D]) {
    float part[NV];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* Z = Zs + g * Ms * D;
      const float* a = alpha + g * Ms;
      const float sf2 = hyp[g * (1 + D)];
      const float* inv = hyp + g * (1 + D) + 1;
      float m = 0.0f, gs[D];
#pragma unroll
      for (int d = 0; d < D; ++d) gs[d] = 0.0f;
      for (int j = member; j < Ms; j += TEAM) {
        float diff[D], dist2 = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          diff[d] = Z[j * D + d] - z[g][d];
          dist2 += diff[d] * diff[d] * inv[d];
        }
        const float ka = sf2 * expf(-0.5f * dist2) * a[j];
        m += ka;
#pragma unroll
        for (int d = 0; d < D; ++d) gs[d] += ka * diff[d];
      }
      part[g * (1 + D)] = m;
#pragma unroll
      for (int d = 0; d < D; ++d) part[g * (1 + D) + 1 + d] = gs[d];
    }
    if constexpr (TEAM > 1) {
      float* buf = red + parity * TEAM * NV * lanes;
      parity ^= 1;
#pragma unroll
      for (int v = 0; v < NV; ++v) buf[(member * NV + v) * lanes + lane] = part[v];
      __syncthreads();
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float sum = buf[v * lanes + lane];
#pragma unroll
        for (int t = 1; t < TEAM; ++t) sum += buf[(t * NV + v) * lanes + lane];
        part[v] = sum;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* inv = hyp + g * (1 + D) + 1;
      mean[g] = part[g * (1 + D)];
#pragma unroll
      for (int d = 0; d < D; ++d) grad[g][d] = part[g * (1 + D) + 1 + d] * inv[d];
    }
  }
};

// ---- quadrotor: models/quadrotor.py plus thrust, roll-rate, pitch-rate GPs --

struct Quad {
  static constexpr int NX = 12, NU = 4, G = 3, D = 3, TEAM = FAMILY_TEAM(1);
  struct Jac {  // non-constant entries of the continuous Jacobian
    float x1_6, x1_7, x1_8, x3_6, x3_7, x3_8, x5_6, x5_7, x9_6, x9_9, x10_7, x10_10;
    float u1_0, u3_0, u5_0, u9_1, u10_2;
  };

  // f(x, u) and its Jacobian entries (models/jacobians.py's closed forms plus
  // the GP terms; the GP rotation is the psi = 0 slice). par = [a..l].
  template <class Gp>
  static __device__ void fc_and_jac(const float* par, Gp& gp, bool use_gp, const float x[NX],
                                    const float u[NU], float f[NX], Jac& J) {
    const float pa = par[0], pb = par[1], pc = par[2], pd = par[3];
    const float pe = par[4], pf = par[5], ph = par[6], pl = par[7];
    const float phi = x[6], theta = x[7], psi = x[8];
    const float dphi = x[9], dtheta = x[10], dpsi = x[11];
    const float cphi = cosf(phi), sphi = sinf(phi);
    const float cth = cosf(theta), sth = sinf(theta);
    const float cpsi = cosf(psi), spsi = sinf(psi);
    const float acc = pa * u[0] + pb;

    float gm[G] = {0.0f, 0.0f, 0.0f}, gd[G][D] = {};
    if (use_gp) {
      // thrust GP (u0, 0, 0), roll-rate GP (phi, dphi, u1), pitch-rate GP
      const float z[G][D] = {{u[0], 0.0f, 0.0f}, {phi, dphi, u[1]}, {theta, dtheta, u[2]}};
      gp.mean_grad(z, gm, gd);
    }
    const float Tp = gm[0], Rp = gm[1], Pp = gm[2];
    const float* dT = gd[0];
    const float* dR = gd[1];
    const float* dP = gd[2];

    f[0] = x[1];
    f[1] = acc * (cphi * sth * cpsi + sphi * spsi) + Tp * cphi * sth;
    f[2] = x[3];
    f[3] = acc * (cphi * sth * spsi - sphi * cpsi) + Tp * (-sphi);
    f[4] = x[5];
    f[5] = acc * cphi * cth - GRAVITY + Tp * cphi * cth;
    f[6] = dphi;
    f[7] = dtheta;
    f[8] = dpsi;
    f[9] = pc * phi + pd * dphi + pe * u[1] + Rp;
    f[10] = pf * theta + ph * dtheta + pl * u[2] + Pp;
    f[11] = 0.0f;

    J.x1_6 = acc * (-sphi * sth * cpsi + cphi * spsi) - Tp * sphi * sth;
    J.x1_7 = acc * (cphi * cth * cpsi) + Tp * cphi * cth;
    J.x1_8 = acc * (-cphi * sth * spsi + sphi * cpsi);
    J.x3_6 = acc * (-sphi * sth * spsi - cphi * cpsi) - Tp * cphi;
    J.x3_7 = acc * (cphi * cth * spsi);
    J.x3_8 = acc * (cphi * sth * cpsi + sphi * spsi);
    J.x5_6 = -(acc + Tp) * sphi * cth;
    J.x5_7 = -(acc + Tp) * cphi * sth;
    J.x9_6 = pc + dR[0];
    J.x9_9 = pd + dR[1];
    J.x10_7 = pf + dP[0];
    J.x10_10 = ph + dP[1];
    J.u1_0 = pa * (cphi * sth * cpsi + sphi * spsi) + dT[0] * cphi * sth;
    J.u3_0 = pa * (cphi * sth * spsi - sphi * cpsi) - dT[0] * sphi;
    J.u5_0 = pa * cphi * cth + dT[0] * cphi * cth;
    J.u9_1 = pe + dR[2];
    J.u10_2 = pl + dP[2];
  }

  // out = Jx v + (column c of Ju, for input columns c >= NX).
  static __device__ __forceinline__ void jac_col(const Jac& J, const float v[NX], int c,
                                                 float out[NX]) {
    out[0] = v[1];
    out[1] = J.x1_6 * v[6] + J.x1_7 * v[7] + J.x1_8 * v[8];
    out[2] = v[3];
    out[3] = J.x3_6 * v[6] + J.x3_7 * v[7] + J.x3_8 * v[8];
    out[4] = v[5];
    out[5] = J.x5_6 * v[6] + J.x5_7 * v[7];
    out[6] = v[9];
    out[7] = v[10];
    out[8] = v[11];
    out[9] = J.x9_6 * v[6] + J.x9_9 * v[9];
    out[10] = J.x10_7 * v[7] + J.x10_10 * v[10];
    out[11] = 0.0f;
    if (c == NX) {
      out[1] += J.u1_0;
      out[3] += J.u3_0;
      out[5] += J.u5_0;
    } else if (c == NX + 1) {
      out[9] += J.u9_1;
    } else if (c == NX + 2) {
      out[10] += J.u10_2;
    }
  }
};

// ---- cartpole: models/cartpole.py, GP0 on the cart row, GP1 on the pole row -
//
// State [x, v, theta, w], input [F], par = [m_cart, m_pole, length]. With
// M = m_cart + m_pole, k = m_pole l / M, s = sin theta, c = cos theta:
//   p = (F + k M w^2 s) / M,   n = g s - c p,   e = l (4/3 - m_pole c^2 / M),
//   theta'' = n / e,           x'' = p - k c theta''.
// Partials by the chain rule through (p, n, e):
//   d theta'' = (dn - theta'' de) / e,   dx'' = dp - k (c dtheta'' - s theta'' dtheta).
// GP0 sees (v, w, F) and adds to x''; GP1 sees (theta, w, F) and adds to theta''.

struct Cart {
  static constexpr int NX = 4, NU = 1, G = 2, D = 3, TEAM = FAMILY_TEAM(1);
  struct Jac {  // rows 1 (x'') and 3 (theta''); rows 0 and 2 are constant
    float x1_1, x1_2, x1_3, x3_2, x3_3, u1_0, u3_0;
  };

  template <class Gp>
  static __device__ void fc_and_jac(const float* par, Gp& gp, bool use_gp, const float x[NX],
                                    const float u[NU], float f[NX], Jac& J) {
    const float mc = par[0], mp = par[1], len = par[2];
    const float M = mc + mp, k = mp * len / M;
    const float v = x[1], th = x[2], w = x[3], F = u[0];
    const float s = sinf(th), c = cosf(th);

    float gm[G] = {0.0f, 0.0f}, gd[G][D] = {};
    if (use_gp) {
      const float z[G][D] = {{v, w, F}, {th, w, F}};
      gp.mean_grad(z, gm, gd);
    }
    const float g0 = gm[0], g1 = gm[1];
    const float* d0 = gd[0];
    const float* d1 = gd[1];

    const float p = (F + mp * len * w * w * s) / M;
    const float e = len * (4.0f / 3.0f - mp * c * c / M);
    const float n = GRAVITY * s - c * p;
    const float thdd = n / e;
    const float xdd = p - k * thdd * c;

    // (d/dtheta, d/dw, d/dF) of p, n and e
    const float p_th = mp * len * w * w * c / M, p_w = 2.0f * mp * len * w * s / M, p_F = 1.0f / M;
    const float e_th = 2.0f * len * mp * c * s / M;
    const float n_th = GRAVITY * c + s * p - c * p_th, n_w = -c * p_w, n_F = -c * p_F;
    const float thdd_th = (n_th - thdd * e_th) / e, thdd_w = n_w / e, thdd_F = n_F / e;

    f[0] = v;
    f[1] = xdd + g0;
    f[2] = w;
    f[3] = thdd + g1;
    J.x1_1 = d0[0];
    J.x1_2 = p_th - k * (c * thdd_th - s * thdd);
    J.x1_3 = p_w - k * c * thdd_w + d0[1];
    J.u1_0 = p_F - k * c * thdd_F + d0[2];
    J.x3_2 = thdd_th + d1[0];
    J.x3_3 = thdd_w + d1[1];
    J.u3_0 = thdd_F + d1[2];
  }

  static __device__ __forceinline__ void jac_col(const Jac& J, const float v[NX], int c,
                                                 float out[NX]) {
    out[0] = v[1];
    out[1] = J.x1_1 * v[1] + J.x1_2 * v[2] + J.x1_3 * v[3];
    out[2] = v[3];
    out[3] = J.x3_2 * v[2] + J.x3_3 * v[3];
    if (c == NX) {
      out[1] += J.u1_0;
      out[3] += J.u3_0;
    }
  }
};

// ---- two-link arm: models/twolink.py, both GPs on the full feature vector ---
//
// State [q1, q2, dq1, dq2], input [t1, t2], par = [m1, m2, l1, l2]. Uniform
// rods: M(q) ddq = r, r = t - C(q, dq) dq - g(q), with
//   M = [[k1 + 2 a c2, k2 + a c2], [k2 + a c2, k2]],  a = m2 l1 l2 / 2,
//   h = a s2,  C dq = (-h dq2 (2 dq1 + dq2), h dq1^2),
//   g = (g1c cos q1 + g2c cos(q1 + q2), g2c cos(q1 + q2)).
// ddq = M^-1 r by the 2x2 inverse (det = m11 m22 - m12 m12, the reference's
// order). For any coordinate p, d ddq / dp = M^-1 (dr/dp - dM/dp ddq), and
// only q2 moves M. Both GPs see z = (q1, q2, dq1, dq2, t1 / 10, t2 / 10)
// (models/residual.py::_TWOLINK_TAU_SCALE), so their torque gradients carry
// the chain-rule factor 0.1.

struct TwoLink {
  static constexpr int NX = 4, NU = 2, G = 2, D = 6, TEAM = FAMILY_TEAM(2);
  static constexpr float TAU_SCALE = 0.1f;
  struct Jac {  // rows 2 and 3 (ddq1, ddq2); rows 0 and 1 are constant
    float x[2][NX], u[2][NU];
  };

  template <class Gp>
  static __device__ void fc_and_jac(const float* par, Gp& gp, bool use_gp, const float x[NX],
                                    const float u[NU], float f[NX], Jac& J) {
    const float m1 = par[0], m2 = par[1], l1 = par[2], l2 = par[3];
    const float lc1 = 0.5f * l1, lc2 = 0.5f * l2;
    const float i1 = m1 * l1 * l1 / 12.0f, i2 = m2 * l2 * l2 / 12.0f;
    const float k1 = i1 + i2 + m1 * lc1 * lc1 + m2 * (l1 * l1 + lc2 * lc2);
    const float k2 = i2 + m2 * lc2 * lc2;
    const float a = m2 * l1 * lc2;
    const float g1c = (m1 * lc1 + m2 * l1) * GRAVITY, g2c = m2 * lc2 * GRAVITY;
    const float q1 = x[0], q2 = x[1], dq1 = x[2], dq2 = x[3];
    const float c2 = cosf(q2), s2 = sinf(q2), c12 = cosf(q1 + q2), s12 = sinf(q1 + q2);

    float gm[G] = {0.0f, 0.0f}, gd[G][D] = {};
    if (use_gp) {
      const float zi[D] = {q1, q2, dq1, dq2, TAU_SCALE * u[0], TAU_SCALE * u[1]};
      float z[G][D];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int d = 0; d < D; ++d) z[g][d] = zi[d];
      gp.mean_grad(z, gm, gd);
    }

    const float m11 = k1 + 2.0f * a * c2, m12 = k2 + a * c2, m22 = k2;
    const float det = m11 * m22 - m12 * m12;
    const float h = a * s2;
    const float r1 = u[0] + h * dq2 * (2.0f * dq1 + dq2) - (g1c * cosf(q1) + g2c * c12);
    const float r2 = u[1] - h * dq1 * dq1 - g2c * c12;
    const float dd1 = (m22 * r1 - m12 * r2) / det;
    const float dd2 = (m11 * r2 - m12 * r1) / det;

    // dr/dp for p = q1, q2, dq1, dq2 (the torques give dr = unit vectors)
    const float dh = a * c2, gs12 = g2c * s12;
    const float dr1[NX] = {g1c * sinf(q1) + gs12, dh * dq2 * (2.0f * dq1 + dq2) + gs12,
                           2.0f * h * dq2, 2.0f * h * (dq1 + dq2)};
    const float dr2[NX] = {gs12, -dh * dq1 * dq1 + gs12, -2.0f * h * dq1, 0.0f};
    const float dm11 = -2.0f * a * s2, dm12 = -a * s2;  // d/dq2; dm22 = 0

    f[0] = dq1;
    f[1] = dq2;
    f[2] = dd1 + gm[0];
    f[3] = dd2 + gm[1];
    for (int p = 0; p < NX; ++p) {
      float w1 = dr1[p], w2 = dr2[p];
      if (p == 1) {
        w1 -= dm11 * dd1 + dm12 * dd2;
        w2 -= dm12 * dd1;
      }
      J.x[0][p] = (m22 * w1 - m12 * w2) / det + gd[0][p];
      J.x[1][p] = (m11 * w2 - m12 * w1) / det + gd[1][p];
    }
    J.u[0][0] = m22 / det + TAU_SCALE * gd[0][4];
    J.u[0][1] = -m12 / det + TAU_SCALE * gd[0][5];
    J.u[1][0] = -m12 / det + TAU_SCALE * gd[1][4];
    J.u[1][1] = m11 / det + TAU_SCALE * gd[1][5];
  }

  static __device__ __forceinline__ void jac_col(const Jac& J, const float v[NX], int c,
                                                 float out[NX]) {
    out[0] = v[2];
    out[1] = v[3];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) s += J.x[r][j] * v[j];
      out[2 + r] = c >= NX ? s + J.u[r][c - NX] : s;
    }
  }
};

template <class Fam>
__global__ void __launch_bounds__(kThreads)
    linearize_kernel(const float* __restrict__ par8,   // (8,)
                     const float* __restrict__ hyp,    // (G, 1+D)
                     const float* __restrict__ X,      // (n_tiles, T+1, NX, L)
                     const float* __restrict__ U,      // (n_tiles, T, NU, L)
                     const float* __restrict__ Zs,     // (G, Ms, D)
                     const float* __restrict__ alpha,  // (G, Ms)
                     int T, int L, int Ms, bool use_gp, float dt,
                     float* __restrict__ fnext,        // (n_tiles, T, NX, L)
                     float* __restrict__ Aout,         // (n_tiles, T, NX, NX, L)
                     float* __restrict__ Bout) {       // (n_tiles, T, NX, NU, L)
  constexpr int NX = Fam::NX, NU = Fam::NU, G = Fam::G, D = Fam::D, TEAM = Fam::TEAM;
  using Gp = GpTeam<G, D, TEAM>;
  extern __shared__ float smem[];
  const int lanes = blockDim.x;
  const int tid = threadIdx.y * lanes + threadIdx.x, nthreads = lanes * TEAM;
  float* par_s = smem;                  // 8
  float* hyp_s = par_s + 8;             // G*(1+D)
  float* Zs_s = hyp_s + G * (1 + D);    // G*Ms*D
  float* alpha_s = Zs_s + G * Ms * D;   // G*Ms
  float* red_s = alpha_s + G * Ms;      // 2*TEAM*NV*lanes
  for (int i = tid; i < 8; i += nthreads) par_s[i] = par8[i];
  for (int i = tid; i < G * (1 + D); i += nthreads) hyp_s[i] = hyp[i];
  for (int i = tid; i < G * Ms * D; i += nthreads) Zs_s[i] = Zs[i];
  for (int i = tid; i < G * Ms; i += nthreads) alpha_s[i] = alpha[i];
  __syncthreads();
  Gp gp{Zs_s, alpha_s, hyp_s, Ms, red_s, (int)threadIdx.y, (int)threadIdx.x, lanes, 0};

  const int chunks = (L + lanes - 1) / lanes;
  const int tile = blockIdx.x / chunks;
  const int lane = (blockIdx.x % chunks) * lanes + threadIdx.x;
  const bool store = lane < L;  // a lane past L computes lane L - 1 and stores nothing
  const int lane_c = store ? lane : L - 1;
  const gpmpc::ConstLaneView Xl{X + gpmpc::lane_offset(tile, lane_c, (long)(T + 1) * NX, L), L};
  const gpmpc::ConstLaneView Ul{U + gpmpc::lane_offset(tile, lane_c, (long)T * NU, L), L};
  const gpmpc::LaneView Fl{fnext + gpmpc::lane_offset(tile, lane_c, (long)T * NX, L), L};
  const gpmpc::LaneView Al{Aout + gpmpc::lane_offset(tile, lane_c, (long)T * NX * NX, L), L};
  const gpmpc::LaneView Bl{Bout + gpmpc::lane_offset(tile, lane_c, (long)T * NX * NU, L), L};
  const float h = 0.5f * dt;
  const float dt6 = dt / 6.0f;
  const int k = blockIdx.y;
  float x[NX], u[NU], xs[NX], kf[NX], ksum[NX];
  for (int i = 0; i < NX; ++i) x[i] = Xl[k * NX + i];
  for (int i = 0; i < NU; ++i) u[i] = Ul[k * NU + i];
  typename Fam::Jac J1, J2, J3, J4;
  Fam::fc_and_jac(par_s, gp, use_gp, x, u, kf, J1);
  for (int i = 0; i < NX; ++i) { ksum[i] = kf[i]; xs[i] = x[i] + h * kf[i]; }
  Fam::fc_and_jac(par_s, gp, use_gp, xs, u, kf, J2);
  for (int i = 0; i < NX; ++i) { ksum[i] += 2.0f * kf[i]; xs[i] = x[i] + h * kf[i]; }
  Fam::fc_and_jac(par_s, gp, use_gp, xs, u, kf, J3);
  for (int i = 0; i < NX; ++i) { ksum[i] += 2.0f * kf[i]; xs[i] = x[i] + dt * kf[i]; }
  Fam::fc_and_jac(par_s, gp, use_gp, xs, u, kf, J4);
  if (store && threadIdx.y == 0)
    for (int i = 0; i < NX; ++i) Fl[k * NX + i] = x[i] + dt6 * (ksum[i] + kf[i]);

  // Column c of [A | B]: e = unit column (state) or 0 (input). Member t
  // takes the columns c = t (mod TEAM); the loop is unrolled so that every
  // index into m and J is a constant (registers, no local memory), and the
  // test is uniform across a warp (a warp holds one member).
#pragma unroll
  for (int c = 0; c < NX + NU; ++c) {
    if (c % TEAM != (int)threadIdx.y) continue;
    float m[NX], n[NX], s[NX];
    for (int i = 0; i < NX; ++i) m[i] = 0.0f;
    if (c < NX) m[c] = 1.0f;
    Fam::jac_col(J1, m, c, n);  // J1 e (+ J1u column)
    for (int i = 0; i < NX; ++i) {
      s[i] = n[i];
      m[i] = (i == c ? 1.0f : 0.0f) + h * n[i];
    }
    Fam::jac_col(J2, m, c, n);
    for (int i = 0; i < NX; ++i) {
      s[i] += 2.0f * n[i];
      m[i] = (i == c ? 1.0f : 0.0f) + h * n[i];
    }
    Fam::jac_col(J3, m, c, n);
    for (int i = 0; i < NX; ++i) {
      s[i] += 2.0f * n[i];
      m[i] = (i == c ? 1.0f : 0.0f) + dt * n[i];
    }
    Fam::jac_col(J4, m, c, n);
    if (!store) continue;
    if (c < NX) {
      for (int i = 0; i < NX; ++i)
        Al[(k * NX + i) * NX + c] = (i == c ? 1.0f : 0.0f) + dt6 * (s[i] + n[i]);
    } else {
      for (int i = 0; i < NX; ++i) Bl[(k * NX + i) * NU + (c - NX)] = dt6 * (s[i] + n[i]);
    }
  }
}

template <class Fam>
int launch_family(int nx, int nu, const float* par8, const float* hyp, const float* X,
                  const float* U, const float* Zs, const float* alpha, int n_tiles, int T, int L,
                  int Ms, int use_gp, float dt, float* fnext, float* A, float* B,
                  cudaStream_t stream) {
  constexpr int G = Fam::G, D = Fam::D, TEAM = Fam::TEAM;
  if (nx != Fam::NX || nu != Fam::NU) return gpmpc::kUnsupported;
  if (n_tiles <= 0 || T <= 0 || T > 65535 || L <= 0 || L > 1024) return gpmpc::kUnsupported;
  // whole warps of lanes, fewer than 128 / TEAM where the tile is narrower
  const int lanes = min(kThreads / TEAM, 32 * ((L + 31) / 32));
  const size_t red = TEAM > 1 ? 2 * (size_t)TEAM * GpTeam<G, D, TEAM>::NV * lanes : 0;
  const size_t smem =
      sizeof(float) * (8 + G * (1 + D) + (size_t)G * Ms * D + (size_t)G * Ms + red);
  cudaError_t err = cudaFuncSetAttribute(
      linearize_kernel<Fam>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles * ((L + lanes - 1) / lanes), T);
  linearize_kernel<Fam><<<grid, dim3(lanes, TEAM), smem, stream>>>(
      par8, hyp, X, U, Zs, alpha, T, L, Ms, use_gp != 0, dt, fnext, A, B);
  return (int)cudaGetLastError();
}

}  // namespace

// family: 0 quadrotor, 1 cartpole, 2 two-link arm (ops/cuda_linearize.py
// FAMILIES); (nx, nu) must be the family's widths.
extern "C" int linearize_launch(int family, int nx, int nu, const float* par8, const float* hyp,
                                const float* X, const float* U, const float* Zs,
                                const float* alpha, int n_tiles, int T, int L, int Ms,
                                int use_gp, float dt, float* fnext, float* A, float* B,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0:
      return launch_family<Quad>(nx, nu, par8, hyp, X, U, Zs, alpha, n_tiles, T, L, Ms, use_gp,
                                 dt, fnext, A, B, s);
    case 1:
      return launch_family<Cart>(nx, nu, par8, hyp, X, U, Zs, alpha, n_tiles, T, L, Ms, use_gp,
                                 dt, fnext, A, B, s);
    case 2:
      return launch_family<TwoLink>(nx, nu, par8, hyp, X, U, Zs, alpha, n_tiles, T, L, Ms,
                                    use_gp, dt, fnext, A, B, s);
    default:
      return gpmpc::kUnsupported;
  }
}

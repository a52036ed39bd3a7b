// Quadrotor dynamics linearization: RK4 of the prior plus the GP-mean
// residual, with the analytic Jacobian chain through the four RK4 stages.
//
// Replaces: gpmpc_tpu/ops/pallas_linearize.py::linearize_ocp_lanes with the
// quadrotor closure (_linearize_kernel_body, _quad_fc_and_jac, _gp_mean_grad,
// _build_mat). For each stage k of each scenario:
//   fnext_k = RK4(x_k, u_k),  A_k = d fnext / dx,  B_k = d fnext / du.
//
// What bounds it on an H100: arithmetic and special functions. Each stage
// evaluates the GP means and gradients 4 times (3 GPs x Ms inducing points,
// one expf each) and the Jacobian chain; it reads 64 bytes and writes 832 bytes
// per scenario-stage, so the writes of A and B are the device-memory traffic.
//
// Design: one block per L-scenario tile, one thread per scenario, stages in a
// loop. The inducing inputs, weights and hyperparameters (shared by all
// scenarios) are staged in shared memory and read as broadcasts. The
// continuous Jacobian of the quadrotor has 17 non-constant entries, so each
// RK4 evaluation keeps only those (struct QuadJac) and multiplies sparsely.
// The chain  dk_{i+1} = J_{i+1} (I + h dk_i)  acts column by column on
// [dx | du], so each of the 16 columns runs the whole four-stage chain with
// three 12-vectors in registers and is written straight to A or B: no 12x12
// matrix is ever held per thread.
#include "lanes.cuh"

namespace {

using gpmpc::NX;
using gpmpc::NU;
constexpr int G = 3;  // quadrotor GPs: thrust, roll rate, pitch rate
constexpr int D = 3;  // input width of each GP slice
constexpr float GRAVITY = 9.81f;

struct QuadJac {  // non-constant entries of the continuous Jacobian
  float x1_6, x1_7, x1_8, x3_6, x3_7, x3_8, x5_6, x5_7, x9_6, x9_9, x10_7, x10_10;
  float u1_0, u3_0, u5_0, u9_1, u10_2;
};

struct GpShared {
  const float* Zs;     // (G, Ms, D)
  const float* alpha;  // (G, Ms)
  const float* hyp;    // (G, 1 + D): sf2, 1/ell^2 per dim
  int Ms;
};

__device__ void gp_mean_grad(const GpShared& gp, int g, float z0, float z1, float z2,
                             float& mean, float grad[3]) {
  const float* Z = gp.Zs + g * gp.Ms * D;
  const float* a = gp.alpha + g * gp.Ms;
  const float sf2 = gp.hyp[g * (1 + D)];
  const float i0 = gp.hyp[g * (1 + D) + 1], i1 = gp.hyp[g * (1 + D) + 2],
              i2 = gp.hyp[g * (1 + D) + 3];
  float m = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int j = 0; j < gp.Ms; ++j) {
    const float d0 = Z[j * D] - z0, d1 = Z[j * D + 1] - z1, d2 = Z[j * D + 2] - z2;
    const float dist2 = d0 * d0 * i0 + d1 * d1 * i1 + d2 * d2 * i2;
    const float ka = sf2 * expf(-0.5f * dist2) * a[j];
    m += ka;
    g0 += ka * d0;
    g1 += ka * d1;
    g2 += ka * d2;
  }
  mean = m;
  grad[0] = g0 * i0;
  grad[1] = g1 * i1;
  grad[2] = g2 * i2;
}

// Continuous dynamics f(x, u) and its Jacobian entries (models/jacobians.py's
// closed forms plus the GP terms; the GP rotation is the psi = 0 slice).
__device__ void fc_and_jac(const float* par, const GpShared& gp, bool use_gp,
                           const float x[NX], const float u[NU], float f[NX], QuadJac& J) {
  const float pa = par[0], pb = par[1], pc = par[2], pd = par[3];
  const float pe = par[4], pf = par[5], ph = par[6], pl = par[7];
  const float phi = x[6], theta = x[7], psi = x[8];
  const float dphi = x[9], dtheta = x[10], dpsi = x[11];
  const float cphi = cosf(phi), sphi = sinf(phi);
  const float cth = cosf(theta), sth = sinf(theta);
  const float cpsi = cosf(psi), spsi = sinf(psi);
  const float acc = pa * u[0] + pb;

  float Tp = 0.0f, Rp = 0.0f, Pp = 0.0f;
  float dT[3] = {0.0f, 0.0f, 0.0f}, dR[3] = {0.0f, 0.0f, 0.0f}, dP[3] = {0.0f, 0.0f, 0.0f};
  if (use_gp) {
    gp_mean_grad(gp, 0, u[0], 0.0f, 0.0f, Tp, dT);  // thrust GP sees (u0, 0, 0)
    gp_mean_grad(gp, 1, phi, dphi, u[1], Rp, dR);
    gp_mean_grad(gp, 2, theta, dtheta, u[2], Pp, dP);
  }

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
__device__ __forceinline__ void jac_col(const QuadJac& J, const float v[NX], int c,
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

__global__ void linearize_kernel(const float* __restrict__ par8,   // (8,)
                                 const float* __restrict__ hyp,    // (G, 1+D)
                                 const float* __restrict__ X,      // (n_tiles, T+1, NX, L)
                                 const float* __restrict__ U,      // (n_tiles, T, NU, L)
                                 const float* __restrict__ Zs,     // (G, Ms, D)
                                 const float* __restrict__ alpha,  // (G, Ms)
                                 int T, int L, int Ms, bool use_gp, float dt,
                                 float* __restrict__ fnext,        // (n_tiles, T, NX, L)
                                 float* __restrict__ Aout,         // (n_tiles, T, NX, NX, L)
                                 float* __restrict__ Bout) {       // (n_tiles, T, NX, NU, L)
  extern __shared__ float smem[];
  float* par_s = smem;                  // 8
  float* hyp_s = par_s + 8;             // G*(1+D)
  float* Zs_s = hyp_s + G * (1 + D);    // G*Ms*D
  float* alpha_s = Zs_s + G * Ms * D;   // G*Ms
  for (int i = threadIdx.x; i < 8; i += blockDim.x) par_s[i] = par8[i];
  for (int i = threadIdx.x; i < G * (1 + D); i += blockDim.x) hyp_s[i] = hyp[i];
  for (int i = threadIdx.x; i < G * Ms * D; i += blockDim.x) Zs_s[i] = Zs[i];
  for (int i = threadIdx.x; i < G * Ms; i += blockDim.x) alpha_s[i] = alpha[i];
  __syncthreads();
  const GpShared gp{Zs_s, alpha_s, hyp_s, Ms};

  gpmpc::ConstLaneView Xl = gpmpc::lane_view(X, (long)(T + 1) * NX, L);
  gpmpc::ConstLaneView Ul = gpmpc::lane_view(U, (long)T * NU, L);
  gpmpc::LaneView Fl = gpmpc::lane_view(fnext, (long)T * NX, L);
  gpmpc::LaneView Al = gpmpc::lane_view(Aout, (long)T * NX * NX, L);
  gpmpc::LaneView Bl = gpmpc::lane_view(Bout, (long)T * NX * NU, L);
  const float h = 0.5f * dt;
  const float dt6 = dt / 6.0f;

  for (int k = 0; k < T; ++k) {
    float x[NX], u[NU], xs[NX], kf[NX], ksum[NX];
    for (int i = 0; i < NX; ++i) x[i] = Xl[k * NX + i];
    for (int i = 0; i < NU; ++i) u[i] = Ul[k * NU + i];
    QuadJac J1, J2, J3, J4;
    fc_and_jac(par_s, gp, use_gp, x, u, kf, J1);
    for (int i = 0; i < NX; ++i) { ksum[i] = kf[i]; xs[i] = x[i] + h * kf[i]; }
    fc_and_jac(par_s, gp, use_gp, xs, u, kf, J2);
    for (int i = 0; i < NX; ++i) { ksum[i] += 2.0f * kf[i]; xs[i] = x[i] + h * kf[i]; }
    fc_and_jac(par_s, gp, use_gp, xs, u, kf, J3);
    for (int i = 0; i < NX; ++i) { ksum[i] += 2.0f * kf[i]; xs[i] = x[i] + dt * kf[i]; }
    fc_and_jac(par_s, gp, use_gp, xs, u, kf, J4);
    for (int i = 0; i < NX; ++i) Fl[k * NX + i] = x[i] + dt6 * (ksum[i] + kf[i]);

    // Column c of [A | B]: e = unit column (state) or 0 (input).
    for (int c = 0; c < NX + NU; ++c) {
      float m[NX], n[NX], s[NX];
      for (int i = 0; i < NX; ++i) m[i] = 0.0f;
      if (c < NX) m[c] = 1.0f;
      jac_col(J1, m, c, n);  // J1 e (+ J1u column)
      for (int i = 0; i < NX; ++i) {
        s[i] = n[i];
        m[i] = (i == c ? 1.0f : 0.0f) + h * n[i];
      }
      jac_col(J2, m, c, n);
      for (int i = 0; i < NX; ++i) {
        s[i] += 2.0f * n[i];
        m[i] = (i == c ? 1.0f : 0.0f) + h * n[i];
      }
      jac_col(J3, m, c, n);
      for (int i = 0; i < NX; ++i) {
        s[i] += 2.0f * n[i];
        m[i] = (i == c ? 1.0f : 0.0f) + dt * n[i];
      }
      jac_col(J4, m, c, n);
      if (c < NX) {
        for (int i = 0; i < NX; ++i)
          Al[(k * NX + i) * NX + c] = (i == c ? 1.0f : 0.0f) + dt6 * (s[i] + n[i]);
      } else {
        for (int i = 0; i < NX; ++i) Bl[(k * NX + i) * NU + (c - NX)] = dt6 * (s[i] + n[i]);
      }
    }
  }
}

}  // namespace

extern "C" int linearize_launch(const float* par8, const float* hyp, const float* X,
                                const float* U, const float* Zs, const float* alpha,
                                int n_tiles, int T, int L, int Ms, int use_gp, float dt,
                                float* fnext, float* A, float* B, void* stream) {
  const size_t smem = sizeof(float) * (8 + G * (1 + D) + (size_t)G * Ms * D + (size_t)G * Ms);
  cudaError_t err = cudaFuncSetAttribute(
      linearize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  linearize_kernel<<<n_tiles, L, smem, static_cast<cudaStream_t>(stream)>>>(
      par8, hyp, X, U, Zs, alpha, T, L, Ms, use_gp != 0, dt, fnext, A, B);
  return (int)cudaGetLastError();
}

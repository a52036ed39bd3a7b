// Chance-constraint covariance recursion, one scenario per thread.
//
// Replaces: gpmpc_tpu/ops/pallas_tighten.py::tighten_lanes (_tighten_kernel_body).
// From cov_0 = 0, for k = 0..T-1:
//   t_x[k] = ppf * sqrt(diag cov_k),  t_u[k] = ppf * sqrt(diag(K cov_k K^T)),
//   cov_{k+1} = A cov A^T + A cov K^T B^T + B K cov A^T + B K cov K^T B^T
//               + Bd diag(D_k) Bd^T,
// and t_x[T] from cov_T. The four middle terms are (A + B K) cov (A + B K)^T,
// which is what this kernel computes (half the products of the expanded form;
// the two differ only in float32 rounding).
//
// What bounds it on an H100: the dependent chain of T small 12x12 products per
// scenario (~3.5k FMAs per stage) and on-chip memory traffic; device-memory
// traffic is only D and the outputs (~0.5 KB per scenario-stage).
//
// Design: one block per L-scenario tile, one thread per scenario. The shared
// A + B K, K and Bd (identical for every scenario) are built once per block in
// shared memory and read as broadcasts. Each scenario's 12x12 covariance and
// the product (A + B K) cov live in shared memory, lane-interleaved
// (entry e of lane l at e * L + l, conflict-free), 2 * 144 * L floats: 147 KB
// at L = 128. Keeping them in registers would need ~300 per thread.
#include "lanes.cuh"

namespace {

using gpmpc::NX;
using gpmpc::NU;

__global__ void tighten_kernel(const float* __restrict__ covdn,  // (n_tiles, T, nd, L)
                               const float* __restrict__ A,      // (NX, NX)
                               const float* __restrict__ B,      // (NX, NU)
                               const float* __restrict__ K,      // (NU, NX)
                               const float* __restrict__ Bd,     // (NX, nd)
                               const float* __restrict__ ppf_p,  // (1,)
                               int T, int nd, int L,
                               float* __restrict__ tx,           // (n_tiles, T+1, NX, L)
                               float* __restrict__ tu) {         // (n_tiles, T, NU, L)
  extern __shared__ float smem[];
  float* Acl_s = smem;              // NX*NX
  float* K_s = Acl_s + NX * NX;     // NU*NX
  float* Bd_s = K_s + NU * NX;      // NX*nd
  float* cov = Bd_s + NX * nd;      // NX*NX*L (lane-interleaved)
  float* tmp = cov + NX * NX * L;   // NX*NX*L

  const int lane = threadIdx.x;
  for (int e = lane; e < NX * NX; e += blockDim.x) {
    const int i = e / NX, j = e % NX;
    float s = A[e];
    for (int u = 0; u < NU; ++u) s += B[i * NU + u] * K[u * NX + j];
    Acl_s[e] = s;
  }
  for (int e = lane; e < NU * NX; e += blockDim.x) K_s[e] = K[e];
  for (int e = lane; e < NX * nd; e += blockDim.x) Bd_s[e] = Bd[e];
  for (int e = 0; e < NX * NX; ++e) cov[e * L + lane] = 0.0f;
  __syncthreads();

  const float ppf = ppf_p[0];
  gpmpc::ConstLaneView D = gpmpc::lane_view(covdn, (long)T * nd, L);
  gpmpc::LaneView tx_l = gpmpc::lane_view(tx, (long)(T + 1) * NX, L);
  gpmpc::LaneView tu_l = gpmpc::lane_view(tu, (long)T * NU, L);
  auto C = [&](int i, int j) -> float& { return cov[(i * NX + j) * L + lane]; };
  auto Tm = [&](int i, int j) -> float& { return tmp[(i * NX + j) * L + lane]; };

  for (int k = 0; k <= T; ++k) {
    for (int i = 0; i < NX; ++i) tx_l[k * NX + i] = ppf * sqrtf(fmaxf(C(i, i), 0.0f));
    if (k == T) break;
    for (int u = 0; u < NU; ++u) {
      float s = 0.0f;
      for (int i = 0; i < NX; ++i) {
        float ci = 0.0f;
        for (int j = 0; j < NX; ++j) ci += C(i, j) * K_s[u * NX + j];
        s += K_s[u * NX + i] * ci;
      }
      tu_l[k * NU + u] = ppf * sqrtf(fmaxf(s, 0.0f));
    }
    // tmp = Acl cov
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        float s = 0.0f;
        for (int m = 0; m < NX; ++m) s += Acl_s[i * NX + m] * C(m, j);
        Tm(i, j) = s;
      }
    // cov = tmp Acl^T + Bd diag(D_k) Bd^T
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        float s = 0.0f;
        for (int m = 0; m < NX; ++m) s += Tm(i, m) * Acl_s[j * NX + m];
        for (int q = 0; q < nd; ++q) s += Bd_s[i * nd + q] * D[k * nd + q] * Bd_s[j * nd + q];
        C(i, j) = s;
      }
  }
}

}  // namespace

extern "C" int tighten_launch(const float* covdn, const float* A, const float* B, const float* K,
                              const float* Bd, const float* ppf, int n_tiles, int T, int nd,
                              int L, float* tx, float* tu, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)NX * NX + NU * NX + (size_t)NX * nd + 2ull * NX * NX * L);
  cudaError_t err = cudaFuncSetAttribute(
      tighten_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tighten_kernel<<<n_tiles, L, smem, static_cast<cudaStream_t>(stream)>>>(
      covdn, A, B, K, Bd, ppf, T, nd, L, tx, tu);
  return (int)cudaGetLastError();
}

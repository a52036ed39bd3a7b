// Fused GP posterior mean and variance.
//
// Replaces: gpmpc_tpu/ops/pallas_gp.py::gp_mean_var (body _gp_posterior_kernel).
// For each query z_n: k_j = sf2 * exp(-1/2 sum_d (z_nd - Z_jd)^2 / ell_d^2) * mask_j,
// mean_n = k . alpha, var_n = max(sf2 - k W k^T, 1e-12) + noise * include_noise.
//
// What bounds it on an H100: arithmetic. The quadratic form costs 2*M^2 FLOP
// per query against ~12 bytes of query input and output, so at M = 128 the
// kernel is far above the bytes/FLOP line; the exp()s (M per query) are a
// small share. It must stay strict FP32 FMA: W holds entries up to ~1/noise
// that cancel to variances ~1e-2, which TF32 (10 mantissa bits) would destroy,
// so there is no mma/wgmma here.
//
// Design: one block of QTILE = 128 threads per 128-query tile, one thread per
// query. W (M x M), the transposed inputs Z^T (D x M), alpha and the mask are
// staged once per block in shared memory; each thread writes its kernel row k
// into a column of a shared (M x QTILE) buffer (k_s[j * QTILE + tid]:
// conflict-free), then forms t = k W in register blocks of 8 columns, reading W
// as warp-wide broadcasts, and accumulates sum_j t_j k_j. Shared memory is
// (M*M + M*QTILE + (D+2)*M) floats: 130 KB at M = 128. Padded and masked
// inducing points have mask 0, so their k_j are exactly 0 and contribute 0.
#include "lanes.cuh"

namespace {

constexpr int QTILE = 128;
constexpr int JB = 8;  // register block of t = k W columns

__global__ void gp_posterior_kernel(const float* __restrict__ z,      // (n, d)
                                    const float* __restrict__ Zt,     // (d, m)
                                    const float* __restrict__ alpha,  // (m,)
                                    const float* __restrict__ W,      // (m, m)
                                    const float* __restrict__ mask,   // (m,)
                                    const float* __restrict__ hyp,    // (3 + d,)
                                    int n, int m, int d,
                                    float* __restrict__ mean_out,     // (n,)
                                    float* __restrict__ var_out) {    // (n,)
  extern __shared__ float smem[];
  float* W_s = smem;                 // m * m
  float* k_s = W_s + m * m;          // m * QTILE
  float* Zt_s = k_s + m * QTILE;     // d * m
  float* alpha_s = Zt_s + d * m;     // m
  float* mask_s = alpha_s + m;       // m

  const int tid = threadIdx.x;
  for (int i = tid; i < m * m; i += blockDim.x) W_s[i] = W[i];
  for (int i = tid; i < d * m; i += blockDim.x) Zt_s[i] = Zt[i];
  for (int i = tid; i < m; i += blockDim.x) {
    alpha_s[i] = alpha[i];
    mask_s[i] = mask[i];
  }
  __syncthreads();

  const float sf2 = hyp[0];
  const float noise = hyp[1];
  const float add_noise = hyp[2];
  const int q = blockIdx.x * QTILE + tid;
  const bool valid = q < n;

  float zq[8];  // d <= 8, checked by the wrapper
  for (int dd = 0; dd < d; ++dd) zq[dd] = valid ? z[(long)q * d + dd] : 0.0f;

  float mean = 0.0f;
  for (int j = 0; j < m; ++j) {
    float dist2 = 0.0f;
    for (int dd = 0; dd < d; ++dd) {
      const float diff = zq[dd] - Zt_s[dd * m + j];
      dist2 += diff * diff * hyp[3 + dd];
    }
    const float k = sf2 * expf(-0.5f * dist2) * mask_s[j];
    k_s[j * QTILE + tid] = k;
    mean += k * alpha_s[j];
  }

  float quad = 0.0f;
  for (int j0 = 0; j0 < m; j0 += JB) {
    float t[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) t[jj] = 0.0f;
    for (int i = 0; i < m; ++i) {
      const float ki = k_s[i * QTILE + tid];
      const float* wrow = W_s + i * m + j0;
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) t[jj] += ki * wrow[jj];
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) quad += t[jj] * k_s[(j0 + jj) * QTILE + tid];
  }

  if (valid) {
    mean_out[q] = mean;
    var_out[q] = fmaxf(sf2 - quad, 1e-12f) + noise * add_noise;
  }
}

}  // namespace

extern "C" const char* cudaGetErrorString_wrapper(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gp_posterior_launch(const float* z, const float* Zt, const float* alpha,
                                   const float* W, const float* mask, const float* hyp,
                                   int n, int m, int d, float* mean, float* var,
                                   void* stream) {
  const size_t smem = sizeof(float) * ((size_t)m * m + (size_t)m * QTILE + (size_t)(d + 2) * m);
  cudaError_t err = cudaFuncSetAttribute(
      gp_posterior_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + QTILE - 1) / QTILE;
  gp_posterior_kernel<<<grid, QTILE, smem, static_cast<cudaStream_t>(stream)>>>(
      z, Zt, alpha, W, mask, hyp, n, m, d, mean, var);
  return (int)cudaGetLastError();
}

// Fused GP posterior mean and variance, every GP of a step in one launch.
//
// Replaces: gpmpc_tpu/ops/pallas_gp.py::gp_mean_var (body _gp_posterior_kernel),
// which the reference launches once per GP (control/gpmpc.py::batched_variances).
// For GP g and query z_n: k_j = sf2 * exp(-1/2 sum_d (z_nd - Z_jd)^2 / ell_d^2) * mask_j,
// mean_n = k . alpha, var_n = max(sf2 - k W k^T, 1e-12) (+ noise with include_noise).
//
// What bounds it on an H100: arithmetic. The quadratic form costs 2 M^2 FLOP
// per query against ~20 bytes of query input and output, far above the
// bytes/FLOP line; the M exp()s per query are a small share. It must stay
// strict FP32 FMA or wider: W holds entries up to ~1/noise that cancel to
// variances ~1e-2, which TF32 (10 mantissa bits) would destroy, so there is
// no mma/wgmma here (and the tiled kernel below sums in FP64).
//
// Design (ops/cuda_gp.py::GpForm packs the inputs once per GP ensemble):
//  * The wrapper hands the live inducing points only (mask != 0, in order),
//    padded to a multiple of 8 with zero mask, alpha and W rows and columns:
//    M = 40 at the bench GPs instead of the capacity 128, ~10x fewer FMAs.
//  * The grid is (query tiles, G): one launch for all GPs of a step.
//  * One thread per query, QTILE = 128 queries a block: 600 blocks for the
//    quadrotor's step (G = 3, N = 25,600), several resident on each SM
//    (64 a block did no better on the card, 256 worse). Its kernel row k lives in
//    registers (96 at MB = 64, 168 at MB = 128, no spills). The kernel is
//    templated on a bucket MB >= M (64 or 128): the loops over the points
//    are unrolled to MB and skip the blocks of 8 past M (M is uniform, so
//    the branch never diverges).
//  * W (M x M, 6.4 KB at M = 40), Z^T, alpha and the mask are staged once
//    per block in shared memory and read as 16-byte broadcasts: t = k W in
//    register blocks of 8 columns, each row of the block two float4 loads
//    for 8 FMAs. The dot t . k needs k at a runtime column, so each thread
//    also keeps its row in a shared (M x QTILE) column (conflict-free).
//    About 28 KB a block at M = 40, so several blocks share an SM.
//  * Padded points have mask 0 and zero alpha and W entries, so their terms
//    are exactly 0 in both sums, as masked points are in the reference.
//
// Past 128 live points (a trained exact GP: 300 points in a 512-row buffer)
// the kernel row no longer fits in registers, nor W (360 KB at M = 300) in
// shared memory, so a second kernel, gp_posterior_tiled_kernel, serves any
// M (a multiple of 8): one thread per query, 128 a block, and every input
// streamed through shared memory in tiles of TI rows x TJ columns, so a
// block holds the same 52,736 bytes at any M.
//  * For each tile of TJ columns a thread keeps t_j = sum_i k_i W_ij in
//    registers and its own k_j of those columns in a shared (TJ x QTILE)
//    column; the k_i of the rows are recomputed from the row tile's points
//    for each column tile (M / TJ times in all, 3 D + 4 operations each
//    against 2 TJ FMAs of the product, some 20-35 % more work at D = 3-6).
//  * The sums run in float64 (t, k W k^T and the mean; k, the inputs and the
//    outputs stay float32, W is widened as it is staged). A trained exact GP
//    at its noise floor has W entries up to ~1/noise that cancel to t_j of
//    order 10 and to variances below 0.1; summed in float32 in any order,
//    the plain version included, the variance is then off by a share of
//    itself or more, while float64 sums leave only k's own float32 rounding.
//    FP64 FMAs run at half the FP32 rate on an H100.
//  * The wrapper (ops/cuda_gp.py::gp_geometry) names the instantiation and
//    the launcher refuses any other.
#include "lanes.cuh"

namespace {

constexpr int QTILE = 128;  // queries (threads) a block
constexpr int JB = 8;       // register block of t = k W columns, and the padding of M

template <int MB>
__global__ void __launch_bounds__(QTILE)
    gp_posterior_kernel(const float* __restrict__ z,      // (G, n, d)
                        const float* __restrict__ Zt,     // (G, d, m)
                        const float* __restrict__ alpha,  // (G, m)
                        const float* __restrict__ W,      // (G, m, m)
                        const float* __restrict__ mask,   // (G, m)
                        const float* __restrict__ hyp,    // (G, 2 + d): sf2, noise, 1/ell_d^2
                        int n, int m, int d, int include_noise,
                        float* __restrict__ mean_out,     // (G, n)
                        float* __restrict__ var_out) {    // (G, n)
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.y;
  float* W_s = smem;               // m * m
  float* Zt_s = W_s + m * m;       // d * m
  float* alpha_s = Zt_s + d * m;   // m
  float* mask_s = alpha_s + m;     // m
  float* k_s = mask_s + m;         // m * QTILE

  const int tid = threadIdx.x;
  {
    // every area is a whole number of float4 (m % 8 == 0)
    const float4* W4 = reinterpret_cast<const float4*>(W + (long)g * m * m);
    for (int i = tid; i < m * m / 4; i += QTILE) reinterpret_cast<float4*>(W_s)[i] = W4[i];
    const float4* Z4 = reinterpret_cast<const float4*>(Zt + (long)g * d * m);
    for (int i = tid; i < d * m / 4; i += QTILE) reinterpret_cast<float4*>(Zt_s)[i] = Z4[i];
    for (int i = tid; i < m; i += QTILE) {
      alpha_s[i] = alpha[(long)g * m + i];
      mask_s[i] = mask[(long)g * m + i];
    }
  }
  const float* h = hyp + (long)g * (2 + d);
  const float sf2 = h[0];
  const float noise = h[1];
  float inv_ell2[8], zq[8];  // d <= 8, checked by the wrapper
  const int q = blockIdx.x * QTILE + tid;
  const bool valid = q < n;
  const float* zrow = z + ((long)g * n + (valid ? q : 0)) * d;
#pragma unroll
  for (int dd = 0; dd < 8; ++dd) {
    inv_ell2[dd] = dd < d ? h[2 + dd] : 0.0f;
    zq[dd] = dd < d ? zrow[dd] : 0.0f;
  }
  __syncthreads();

  // kernel row and mean: points j0 .. j0 + 3 read as one float4 per dimension
  float k[MB];
  float mean = 0.0f;
#pragma unroll
  for (int j0 = 0; j0 < MB; j0 += 4) {
    if (j0 < m) {
      float dist2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        if (dd < d) {
          const float4 zt = *reinterpret_cast<const float4*>(Zt_s + dd * m + j0);
          const float zj[4] = {zt.x, zt.y, zt.z, zt.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float diff = zq[dd] - zj[jj];
            dist2[jj] += diff * diff * inv_ell2[dd];
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        k[j] = sf2 * expf(-0.5f * dist2[jj]) * mask_s[j];
        k_s[j * QTILE + tid] = k[j];
        mean += k[j] * alpha_s[j];
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) k[j0 + jj] = 0.0f;
    }
  }

  // quad = sum_j (sum_i k_i W_ij) k_j, t = k W in blocks of JB columns
  float quad = 0.0f;
  for (int j0 = 0; j0 < m; j0 += JB) {
    float t[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) t[jj] = 0.0f;
#pragma unroll
    for (int i0 = 0; i0 < MB; i0 += JB) {
      if (i0 < m) {
#pragma unroll
        for (int ii = 0; ii < JB; ++ii) {
          const float ki = k[i0 + ii];
          const float4* wrow = reinterpret_cast<const float4*>(W_s + (i0 + ii) * m + j0);
          const float4 w0 = wrow[0], w1 = wrow[1];
          t[0] += ki * w0.x;
          t[1] += ki * w0.y;
          t[2] += ki * w0.z;
          t[3] += ki * w0.w;
          t[4] += ki * w1.x;
          t[5] += ki * w1.y;
          t[6] += ki * w1.z;
          t[7] += ki * w1.w;
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) quad += t[jj] * k_s[(j0 + jj) * QTILE + tid];
  }

  if (valid) {
    float v = fmaxf(sf2 - quad, 1e-12f);
    if (include_noise) v += noise;
    mean_out[(long)g * n + q] = mean;
    var_out[(long)g * n + q] = v;
  }
}

constexpr int TI = 32;    // rows of a W tile
constexpr int TJ = 64;    // columns of a W tile: t_j in registers
constexpr int DMAX = 8;   // dimensions at most (the wrapper checks)
// the tiled kernel's shared memory, the same for every m (ops/cuda_gp.py::gp_geometry)
constexpr size_t TILED_SMEM = sizeof(double) * TI * TJ +
                              sizeof(float) * (TJ * QTILE + (DMAX + 2) * TI + (DMAX + 1) * TJ);

__global__ void __launch_bounds__(QTILE)
    gp_posterior_tiled_kernel(const float* __restrict__ z,      // (G, n, d)
                              const float* __restrict__ Zt,     // (G, d, m)
                              const float* __restrict__ alpha,  // (G, m)
                              const float* __restrict__ W,      // (G, m, m)
                              const float* __restrict__ mask,   // (G, m)
                              const float* __restrict__ hyp,    // (G, 2 + d)
                              int n, int m, int d, int include_noise,
                              float* __restrict__ mean_out,     // (G, n)
                              float* __restrict__ var_out) {    // (G, n)
  extern __shared__ __align__(16) double smem_d[];
  double* W_s = smem_d;                                   // TI * TJ: this W tile, as float64
  float* kc_s = reinterpret_cast<float*>(W_s + TI * TJ);  // TJ * QTILE: each query's k_j
  float* Zr_s = kc_s + TJ * QTILE;  // DMAX * TI: the row tile's points
  float* ar_s = Zr_s + DMAX * TI;   // TI: its alpha
  float* mr_s = ar_s + TI;          // TI: its mask
  float* Zc_s = mr_s + TI;          // DMAX * TJ: the column tile's points
  float* mc_s = Zc_s + DMAX * TJ;   // TJ: its mask
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const float* Zg = Zt + (long)g * d * m;
  const float* ag = alpha + (long)g * m;
  const float* mg = mask + (long)g * m;
  const float* h = hyp + (long)g * (2 + d);
  const float sf2 = h[0];
  const float noise = h[1];
  float inv_ell2[DMAX], zq[DMAX];
  const int q = blockIdx.x * QTILE + tid;
  const bool valid = q < n;
  const float* zrow = z + ((long)g * n + (valid ? q : 0)) * d;
#pragma unroll
  for (int dd = 0; dd < DMAX; ++dd) {
    inv_ell2[dd] = dd < d ? h[2 + dd] : 0.0f;
    zq[dd] = dd < d ? zrow[dd] : 0.0f;
  }

  // k_j of this thread's query at point j of a staged tile (a tile's points
  // `stride` apart per dimension), in float32 as the plain version computes
  // it, recomputed wherever it is needed
  auto kval = [&](const float* Zs, const float* ms, int stride, int j) {
    float dist2 = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DMAX; ++dd) {
      if (dd < d) {
        const float diff = zq[dd] - Zs[dd * stride + j];
        dist2 += diff * diff * inv_ell2[dd];
      }
    }
    return sf2 * expf(-0.5f * dist2) * ms[j];
  };

  const float4* Wg = reinterpret_cast<const float4*>(W + (long)g * m * m);
  const int m4 = m / 4;
  double mean = 0.0;
  double quad = 0.0;
  for (int j0 = 0; j0 < m; j0 += TJ) {
    // columns past m (m % 8 == 0, so whole float4s) have mask 0, k_j = 0 and W = 0
    const int cols = min(TJ, m - j0);
    __syncthreads();  // every thread is done with the previous column tile's points
    for (int e = tid; e < d * TJ; e += QTILE) {
      const int dd = e / TJ, jj = e % TJ;
      Zc_s[dd * TJ + jj] = jj < cols ? Zg[(long)dd * m + j0 + jj] : 0.0f;
    }
    for (int jj = tid; jj < TJ; jj += QTILE) mc_s[jj] = jj < cols ? mg[j0 + jj] : 0.0f;
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < TJ; ++jj) kc_s[jj * QTILE + tid] = jj < cols ? kval(Zc_s, mc_s, TJ, jj) : 0.0f;
    double t[TJ];  // t_j = sum_i k_i W_ij
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) t[jj] = 0.0;
    for (int i0 = 0; i0 < m; i0 += TI) {
      const int rows = min(TI, m - i0);
      __syncthreads();  // every thread is done with the previous row tile
      for (int e = tid; e < TI * TJ / 4; e += QTILE) {
        const int ii = e / (TJ / 4), c4 = e % (TJ / 4);
        const int i = i0 + ii, col4 = j0 / 4 + c4;
        const float4 w =
            (i < m && col4 < m4) ? Wg[(long)i * m4 + col4] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        reinterpret_cast<double2*>(W_s)[2 * e] = make_double2(w.x, w.y);
        reinterpret_cast<double2*>(W_s)[2 * e + 1] = make_double2(w.z, w.w);
      }
      for (int e = tid; e < d * TI; e += QTILE) {
        const int dd = e / TI, ii = e % TI;
        Zr_s[dd * TI + ii] = ii < rows ? Zg[(long)dd * m + i0 + ii] : 0.0f;
      }
      for (int ii = tid; ii < TI; ii += QTILE) {
        ar_s[ii] = ii < rows ? ag[i0 + ii] : 0.0f;
        mr_s[ii] = ii < rows ? mg[i0 + ii] : 0.0f;
      }
      __syncthreads();
      for (int ii = 0; ii < rows; ++ii) {
        const double ki = kval(Zr_s, mr_s, TI, ii);
        if (j0 == 0) mean = fma(ki, (double)ar_s[ii], mean);  // the mean on the first column tile
        const double2* wrow = reinterpret_cast<const double2*>(W_s + ii * TJ);
#pragma unroll
        for (int c2 = 0; c2 < TJ / 2; ++c2) {
          const double2 w = wrow[c2];
          t[2 * c2] = fma(ki, w.x, t[2 * c2]);
          t[2 * c2 + 1] = fma(ki, w.y, t[2 * c2 + 1]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) quad = fma(t[jj], (double)kc_s[jj * QTILE + tid], quad);
  }

  if (valid) {
    float v = fmaxf((float)((double)sf2 - quad), 1e-12f);
    if (include_noise) v += noise;
    mean_out[(long)g * n + q] = (float)mean;
    var_out[(long)g * n + q] = v;
  }
}

template <int MB>
int launch_bucket(const float* z, const float* Zt, const float* alpha, const float* W,
                  const float* mask, const float* hyp, int G, int n, int m, int d,
                  int include_noise, float* mean, float* var, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)m * m + (size_t)(d + 2) * m + (size_t)m * QTILE);
  cudaError_t err = cudaFuncSetAttribute(
      gp_posterior_kernel<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + QTILE - 1) / QTILE, G);
  gp_posterior_kernel<MB><<<grid, QTILE, smem, stream>>>(z, Zt, alpha, W, mask, hyp, n, m, d,
                                                         include_noise, mean, var);
  return (int)cudaGetLastError();
}

int launch_tiled(const float* z, const float* Zt, const float* alpha, const float* W,
                 const float* mask, const float* hyp, int G, int n, int m, int d,
                 int include_noise, float* mean, float* var, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gp_posterior_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILED_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + QTILE - 1) / QTILE, G);
  gp_posterior_tiled_kernel<<<grid, QTILE, TILED_SMEM, stream>>>(z, Zt, alpha, W, mask, hyp, n, m,
                                                                 d, include_noise, mean, var);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* cudaGetErrorString_wrapper(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// G GPs of m points each (m % 8 == 0), n queries each, d <= 8 dimensions.
// `bucket` names the instantiation the wrapper chose: 64 (m <= 64) or 128
// (m <= 128) for the kernel row in registers, 0 for the tiled kernel
// (m > 128); kUnsupported for any other shape or choice.
extern "C" int gp_posterior_launch(const float* z, const float* Zt, const float* alpha,
                                   const float* W, const float* mask, const float* hyp, int G,
                                   int n, int m, int d, int include_noise, int bucket,
                                   float* mean, float* var, void* stream) {
  if (G < 1 || n < 1 || m < JB || m % JB || d < 1 || d > 8) return gpmpc::kUnsupported;
  const int expected = m <= 64 ? 64 : m <= 128 ? 128 : 0;
  if (bucket != expected) return gpmpc::kUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bucket == 64)
    return launch_bucket<64>(z, Zt, alpha, W, mask, hyp, G, n, m, d, include_noise, mean, var, s);
  if (bucket == 128)
    return launch_bucket<128>(z, Zt, alpha, W, mask, hyp, G, n, m, d, include_noise, mean, var, s);
  return launch_tiled(z, Zt, alpha, W, mask, hyp, G, n, m, d, include_noise, mean, var, s);
}

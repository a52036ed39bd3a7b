// Fused GP posterior mean and variance, every GP of a step in one launch.
//
// Replaces: gpmpc_tpu/ops/pallas_gp.py::gp_mean_var (body _gp_posterior_kernel),
// which the reference launches once per GP (control/gpmpc.py::batched_variances).
// For GP g and query z_n: k_j = sf2 * exp(-1/2 sum_d (z_nd - Z_jd)^2 / ell_d^2) * mask_j,
// mean_n = k . alpha, var_n = max(sf2 - k W k^T, 1e-12) (+ noise with include_noise).
//
// What bounds it on an H100: operations, about 2 M^2 a query for the
// quadratic form against ~20 bytes of query input and output, far above the
// bytes/FLOP line; the M exp()s a query are a small share. The sums must stay
// strict FP32 FMA or wider: W holds entries up to ~1/noise that cancel to
// variances ~1e-2, which TF32 (10 mantissa bits) would destroy, so there is
// no TF32 mma here. Two instantiations (ops/cuda_gp.py::gp_geometry names the
// one for M points; the launcher refuses any other):
//
// The register buckets, M <= 128 (ops/cuda_gp.py::GpForm packs the inputs
// once per GP ensemble):
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
// The tiled kernel, past 128 live points (a trained exact GP: 300 points in a
// 512-row buffer; the launcher also takes it at any M for measurement), where
// neither the kernel row fits in registers nor W (360 KB at M = 300) in
// shared memory. Its sums run in float64: a trained exact GP at its noise
// floor has W entries up to ~1/noise that cancel to variances below 0.1;
// summed in float32 in any order, the plain version included, the variance
// is then off by a share of itself or more, while float64 sums leave only
// k's own float32 rounding.
//  * GEMM form. For GP g, V = K W with K the (N x M) kernel rows, and
//    quad_n = sum_j V_nj K_nj. The form is bilinear, so each (row range I,
//    column range J) of W gives an independent partial sum over i in I, j in
//    J of k_i W_ij k_j, and the partials add.
//  * The product runs on the FP64 tensor cores: mma.sync m16n8k8 .f64 (DMMA;
//    on an H100 m8n8k4 was 1.30-1.54x slower and m16n8k16 1-3 %, PERF.md). Each
//    of its FMAs is an exact IEEE float64 one, so the float64 contract holds at
//    the DMMA rate, 67 TFLOP/s on an H100 SXM, twice that of the FP64 FMA pipe.
//    A block's 8 consumer warps hold a tile of QT = 64 queries x TJ = 128
//    columns of V, each warp 32 x 32 in 32 float64 accumulators a lane (128
//    columns compute each k of the K slab for twice the product that 64 did).
//  * How the split fills the card: the grid is (query tiles, W tiles, G), the
//    W tiles being the column tiles times `splits` ranges of the rows, each a
//    whole number of stages of TK = 32 rows. The plan (ops/cuda_gp.py::
//    gp_tiled_plan, from the card's SM count) splits the rows only until the
//    grid holds two waves of a block on each SM (264 blocks on an H100 SXM),
//    or one stage a split: the two-link exact GP's launch (N = 20, M = 304,
//    G = 2) is 60 blocks where a grid over the queries alone had 2; at
//    N = 4,096, M = 2,048, G = 3 the column tiles alone give 3,072. The
//    launcher checks that the plan's ranges cover the stages.
//  * Warp specialization: 8 producer warps stage, 8 consumer warps multiply.
//    Measured on an H100 with the same warps doing both (PERF.md), the
//    staging alone took two thirds of the time: run between the products in
//    warps whose 128 accumulator registers left room for 8 warps an SM, it
//    could not hide its latency; 4 producer warps were slower still; 3 or 4
//    stages of copies in flight gained nothing over 2.
//    A stage: the W slab (TK x TJ float32), the rows' points and mask are
//    copied with cp.async one stage ahead into a ring of two (zero-filled past
//    M, so those terms are exactly 0, as masked points are in the reference);
//    then W is widened to float64 into one of two operand buffers and the K
//    slab (QT x TK) computed in float32 with the plain version's formula
//    (`kval`, its loop over the dimensions specialized on D, `kslab_rows`:
//    on an H100 at D = 3 the kernel ran 11 % faster than with the loop to
//    DMAX under a predicate) and widened beside it, while the consumers
//    multiply the other buffer. Named barriers hand each buffer over (full:
//    producers arrive, consumers wait; empty: the reverse). Both row strides
//    are 4 mod 16 doubles, so a warp's fragment reads hit no bank twice in
//    either half (without the padding the kernel was 1.5-2.0x slower);
//    `a_col` keeps the K slab's writes free of conflicts too.
//  * Each block writes its per-query float64 partial of k W k^T over its W
//    tile, and in the first row range that of the mean over its columns, to
//    a workspace (G, partials, N) that the wrapper allocates: the epilogue
//    recomputes each lane's k_j of its fragment's columns and sums, in a
//    fixed order, the lane's terms, then the four lanes of a row (shuffles),
//    then the four column warps of a row in turn (shared memory). A second kernel sums the
//    partials in a fixed order (column tile, then row range), applies
//    max(sf2 - quad, 1e-12) and the noise, and writes float32 mean and
//    variance. No atomics: two calls give the same bits. The kernels
//    allocate nothing and do not synchronize.
//  * k is recomputed once per column tile (M / TJ times; 3 D + 5 float32
//    operations and an exp each, against the product's 2 TJ), and a block's
//    shared memory is 149,760 bytes at any M and D (one block an SM, 512
//    threads of at most 128 registers), so an exact GP of 5,120 points at
//    D = 8 launches.
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

// ---- the tiled kernel -------------------------------------------------------

constexpr int QT = 64;                // queries a tiled block
constexpr int TJ = 128;               // W columns a tiled block
constexpr int TK = 32;                // W rows a stage
constexpr int DMAX = 8;               // dimensions at most (the wrapper checks)
constexpr int COLUMN_WARPS = 4;       // consumer warps along a tile's columns
constexpr int CONSUMER_WARPS = 2 * COLUMN_WARPS;  // the product: 2 (queries) x 4 of 32 x 32
constexpr int PRODUCER_THREADS = 256; // the staging: 8 warps
constexpr int TILED_THREADS = 32 * CONSUMER_WARPS + PRODUCER_THREADS;
constexpr int WN = TJ / COLUMN_WARPS; // a consumer warp's columns
constexpr int NT = WN / 8;            // its n-tiles of 8 columns
constexpr int MMA_K = 8;              // the DMMA shape's depth, m16n8k8
constexpr int RING_STAGES = 2;        // float32 stages: copies run one stage ahead
constexpr int TILED_BLOCKS_PER_SM = 1;
constexpr int LDA = TK + 4;           // float64 row strides, 4 mod 16: conflict-free fragments
constexpr int LDW = TJ + 4;
constexpr int RING = TK * TJ + DMAX * TK + TK;  // floats a stage: W slab, rows' points, mask
static_assert((TK * TJ / 4) % PRODUCER_THREADS == 0 && (TK * TJ / 2) % PRODUCER_THREADS == 0 &&
                  (DMAX + 1) * (TK / 4) <= PRODUCER_THREADS && (QT * TK) % PRODUCER_THREADS == 0,
              "the producers' shares of a stage");
// the tiled kernel's shared memory, the same for every m and d (ops/cuda_gp.py::TILED_SHARED_BYTES)
constexpr size_t TILED_SMEM =
    sizeof(double) * (2 * TK * LDW + 2 * QT * LDA + 2 * (COLUMN_WARPS - 1) * QT) +
    sizeof(float) * (RING_STAGES * RING + QT * DMAX + DMAX * TJ + 2 * TJ);
static_assert(TK % MMA_K == 0, "whole k-steps a stage");

// 16 bytes from global to shared memory, or 16 zero bytes (`in` false: src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// D = A B + D on the FP64 tensor cores, m16n8k8, one warp; g = lane / 4,
// t = lane % 4. A lane holds A at rows g and g + 8 of two k-slices of 4
// (cols t and t + 4: a0, a1 and a2, a3), B at rows t and t + 4 of col g
// (b0, b1), C at rows g (c0, c1) and g + 8 (c2, c3) of cols 2 t, 2 t + 1.
__device__ __forceinline__ void dmma_m16n8k8(double (&c0)[2], double (&c1)[2], const double* a,
                                             const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c0[0]), "+d"(c0[1]), "+d"(c1[0]), "+d"(c1[1])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// A consumer warp's 32 x WN tile of the product: acc[mt][nt][c] is the entry
// at row frag_row(mt) and column frag_col(nt, c) of the tile.
__device__ __forceinline__ int frag_row(int mt, int lane) { return 8 * mt + (lane >> 2); }
__device__ __forceinline__ int frag_col(int nt, int c, int lane) {
  return 8 * nt + 2 * (lane & 3) + c;
}

// The K slab's column of (row, k) in shared memory: k with bit 1 flipped in
// rows 4-7 of every 8 (a fragment's half-warp, rows g < 4 or g >= 4, still
// reads a permutation of its own four columns); it keeps the slab's writes
// free of bank conflicts when two threads share a query.
__device__ __forceinline__ int a_col(int row, int k) { return k ^ (((row >> 2) & 1) << 1); }

// One step of MMA_K along k: A (the warp's first row, stride LDA) rows x k,
// B (the warp's first column, stride LDW) k x columns, both float64 in
// shared memory.
__device__ __forceinline__ void warp_mma_step(double (&acc)[4][NT][2], const double* A,
                                              const double* B, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int S = MMA_K / 4;  // k-slices of 4
  double a[4][S], b[NT][S];     // a[mt][s]: row 8 mt + g, col k0 + 4 s + t
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) a[mt][s] = A[(8 * mt + g) * LDA + a_col(g, k0 + 4 * s + t)];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt][s] = B[(k0 + 4 * s + t) * LDW + 8 * nt + g];
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    double ap[2 * S];  // the m16 tile's A fragment: rows g, g + 8 of each k-slice
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ap[2 * s] = a[2 * p][s];
      ap[2 * s + 1] = a[2 * p + 1][s];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) dmma_m16n8k8(acc[2 * p][nt], acc[2 * p + 1][nt], ap, b[nt]);
  }
}

// k_j of the query zq at a staged point j (its coordinates `stride` apart),
// in float32 with the plain version's formula
__device__ __forceinline__ float kval(const float (&zq)[DMAX], const float (&inv_ell2)[DMAX], int d,
                                      float sf2, const float* Zp, int stride, float mask) {
  float dist2 = 0.0f;
#pragma unroll
  for (int dd = 0; dd < DMAX; ++dd) {
    if (dd < d) {
      const float diff = zq[dd] - Zp[dd * stride];
      dist2 += diff * diff * inv_ell2[dd];
    }
  }
  return sf2 * expf(-0.5f * dist2) * mask;
}

// Named barriers of the tiled kernel (0 is __syncthreads): a stage's float64
// operands in buffer b are full (producers arrive, consumers wait) or empty
// (consumers arrive, producers wait), each over the whole block; and the
// producers' and the consumers' own barriers.
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PRODUCERS = 5, BAR_CONSUMERS = 6;
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A K slab's share of one producer thread: its query zk at rows i0, i0 +
// step, ... of the stage (`count` rows), in float32 with kval's formula over
// DD dimensions (DD = d, so no dimension past d is issued), widened.
template <int DD>
__device__ __forceinline__ void kslab_rows(double* A_row, const float (&zk)[DMAX],
                                           const float (&inv_ell2)[DMAX], float sf2,
                                           const float* Zr, const float* mr, int nk, int i0) {
  constexpr int KT = 4;  // threads a query (PRODUCER_THREADS / QT)
#pragma unroll
  for (int k = 0; k < TK / KT; ++k) {
    const int i = i0 + KT * k;
    float dist2 = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DD; ++dd) {
      const float diff = zk[dd] - Zr[dd * TK + i];
      dist2 += diff * diff * inv_ell2[dd];
    }
    A_row[a_col(nk, i)] = (double)(sf2 * expf(-0.5f * dist2) * mr[i]);
  }
}

// grid (query tiles, col_tiles * splits, G): block y holds column tile
// y / splits and row range y % splits, whose quad partial is partial y and,
// in row range 0, whose mean partial is partial col_tiles * splits + y / splits.
// Warps 0-7 consume (the product and the epilogue), warps 8-15 produce (the
// stages' copies, the widening and the K slab).
__global__ void __launch_bounds__(TILED_THREADS, TILED_BLOCKS_PER_SM)
    gp_posterior_tiled_kernel(const float* __restrict__ z,      // (G, n, d)
                              const float* __restrict__ Zt,     // (G, d, m)
                              const float* __restrict__ alpha,  // (G, m)
                              const float* __restrict__ W,      // (G, m, m)
                              const float* __restrict__ mask,   // (G, m)
                              const float* __restrict__ hyp,    // (G, 2 + d)
                              int n, int m, int d, int splits, int per,
                              double* __restrict__ ws) {        // (G, col_tiles (splits + 1), n)
  extern __shared__ __align__(16) double smem_d[];
  double* Wd = smem_d;                               // 2 x TK x LDW: the W slabs, float64
  double* Ad = Wd + 2 * TK * LDW;                    // 2 x QT x LDA: the K slabs, float64
  double* xq = Ad + 2 * QT * LDA;                    // (COLUMN_WARPS - 1) x QT: quad partials
  double* xm = xq + (COLUMN_WARPS - 1) * QT;         // of column warps 1.., and mean partials
  float* ring = reinterpret_cast<float*>(xm + (COLUMN_WARPS - 1) * QT);  // the copies in flight
  float* zq_s = ring + RING_STAGES * RING;           // QT x DMAX: the block's queries
  float* Zc_s = zq_s + QT * DMAX;                    // DMAX x TJ: the column tile's points
  float* mc_s = Zc_s + DMAX * TJ;                    // TJ: its mask
  float* ac_s = mc_s + TJ;                           // TJ: its alpha

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.z;
  const int col_tiles = (m + TJ - 1) / TJ, stages = (m + TK - 1) / TK;
  const int ct = blockIdx.y / splits, split = blockIdx.y % splits;
  const int s0 = split * per, n_stages = min(stages, s0 + per) - s0;
  const int q0 = blockIdx.x * QT, j0 = ct * TJ;
  const float* Zg = Zt + (long)g * d * m;
  const float* ag = alpha + (long)g * m;
  const float* mg = mask + (long)g * m;
  const float* Wg = W + (long)g * m * m;
  const float* h = hyp + (long)g * (2 + d);
  const float sf2 = h[0];
  float inv_ell2[DMAX];
#pragma unroll
  for (int dd = 0; dd < DMAX; ++dd) inv_ell2[dd] = dd < d ? h[2 + dd] : 0.0f;

  for (int e = tid; e < QT * DMAX; e += TILED_THREADS) {
    const int nq = e / DMAX, dd = e % DMAX, q = q0 + nq;
    zq_s[e] = (q < n && dd < d) ? z[((long)g * n + q) * d + dd] : 0.0f;
  }
  for (int e = tid; e < DMAX * TJ; e += TILED_THREADS) {
    const int dd = e / TJ, j = j0 + e % TJ;
    Zc_s[e] = (dd < d && j < m) ? Zg[(long)dd * m + j] : 0.0f;
  }
  for (int jj = tid; jj < TJ; jj += TILED_THREADS) {
    const int j = j0 + jj;
    mc_s[jj] = j < m ? mg[j] : 0.0f;
    ac_s[jj] = j < m ? ag[j] : 0.0f;
  }
  __syncthreads();  // the last block-wide barrier: from here the roles part

  if (warp >= CONSUMER_WARPS) {
    // ---- producers ----
    const int pt = tid - CONSUMER_WARPS * 32;
    // stage s0 + r into ring slot r % RING_STAGES: W rows of the stage,
    // columns j0 .. j0 + TJ, then the rows' points (DMAX x TK) and mask (TK);
    // m % 8 == 0, so a 16-byte chunk lies wholly inside or wholly past m
    auto stage_copy = [&](int r) {
      float* slot = ring + (r % RING_STAGES) * RING;
      const int i0 = (s0 + r) * TK;
#pragma unroll
      for (int k = 0; k < TK * TJ / 4 / PRODUCER_THREADS; ++k) {
        const int e = pt + k * PRODUCER_THREADS, row = e / (TJ / 4), c4 = e % (TJ / 4);
        const int i = i0 + row, j = j0 + 4 * c4;
        const bool in = i < m && j < m;
        cp_async16(slot + row * TJ + 4 * c4, in ? Wg + (long)i * m + j : Wg, in);
      }
      if (pt < (DMAX + 1) * (TK / 4)) {
        const int dd = pt / (TK / 4), i = i0 + 4 * (pt % (TK / 4));  // dd == DMAX: the mask
        const bool in = i < m && (dd < d || dd == DMAX);
        const float* src = dd == DMAX ? mg + i : Zg + (long)dd * m + i;
        cp_async16(slot + TK * TJ + dd * TK + 4 * (pt % (TK / 4)), in ? src : Wg, in);
      }
    };
    // this thread's query of the K slab and its rows (pt % KT) + KT r
    constexpr int KT = PRODUCER_THREADS / QT;  // threads a query
    static_assert(KT == 4, "kslab_rows' share");
    const int nk = pt / KT;
    float zk[DMAX];
#pragma unroll
    for (int dd = 0; dd < DMAX; ++dd) zk[dd] = zq_s[nk * DMAX + dd];
#pragma unroll
    for (int r = 0; r < RING_STAGES - 1; ++r) {
      if (r < n_stages) stage_copy(r);
      gpmpc::cp_async_commit();
    }
    for (int r = 0; r < n_stages; ++r) {
      const int buf = r & 1;
      // into the slot stage r - 1 was read from
      if (r + RING_STAGES - 1 < n_stages) stage_copy(r + RING_STAGES - 1);
      gpmpc::cp_async_commit();
      gpmpc::cp_async_wait<RING_STAGES - 1>();   // this thread's copies of stage r have landed
      bar_sync(BAR_PRODUCERS, PRODUCER_THREADS);  // everyone's have
      if (r >= 2) bar_sync(BAR_EMPTY + buf, TILED_THREADS);  // the consumers are done with buf
      const float* slot = ring + (r % RING_STAGES) * RING;
      double* W_b = Wd + buf * TK * LDW;
      double* A_b = Ad + buf * QT * LDA;
#pragma unroll
      for (int k = 0; k < TK * TJ / 2 / PRODUCER_THREADS; ++k) {
        const int e = pt + k * PRODUCER_THREADS;
        const float2 w = reinterpret_cast<const float2*>(slot)[e];
        *reinterpret_cast<double2*>(W_b + (e / (TJ / 2)) * LDW + 2 * (e % (TJ / 2))) =
            make_double2(w.x, w.y);
      }
      const float* Zr = slot + TK * TJ;
      const float* mr = Zr + DMAX * TK;
      double* A_row = A_b + nk * LDA;
      switch (d) {
        case 1: kslab_rows<1>(A_row, zk, inv_ell2, sf2, Zr, mr, nk, pt % KT); break;
        case 2: kslab_rows<2>(A_row, zk, inv_ell2, sf2, Zr, mr, nk, pt % KT); break;
        case 3: kslab_rows<3>(A_row, zk, inv_ell2, sf2, Zr, mr, nk, pt % KT); break;
        case 4: kslab_rows<4>(A_row, zk, inv_ell2, sf2, Zr, mr, nk, pt % KT); break;
        case 5: kslab_rows<5>(A_row, zk, inv_ell2, sf2, Zr, mr, nk, pt % KT); break;
        case 6: kslab_rows<6>(A_row, zk, inv_ell2, sf2, Zr, mr, nk, pt % KT); break;
        case 7: kslab_rows<7>(A_row, zk, inv_ell2, sf2, Zr, mr, nk, pt % KT); break;
        default: kslab_rows<8>(A_row, zk, inv_ell2, sf2, Zr, mr, nk, pt % KT); break;
      }
      __threadfence_block();  // the slabs before the arrival
      bar_arrive(BAR_FULL + buf, TILED_THREADS);
      bar_sync(BAR_PRODUCERS, PRODUCER_THREADS);  // everyone is done with this ring slot
    }
    gpmpc::cp_async_wait<0>();
    return;
  }

  // ---- consumers: warp (wm, wn) holds rows 32 wm .. and columns WN wn .. of V ----
  const int wm = warp & 1, wn = warp >> 1;
  double acc[4][NT][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = 0.0;
  for (int r = 0; r < n_stages; ++r) {
    const int buf = r & 1;
    bar_sync(BAR_FULL + buf, TILED_THREADS);
    const double* Aw = Ad + buf * QT * LDA + 32 * wm * LDA;
    const double* Bw = Wd + buf * TK * LDW + WN * wn;
#pragma unroll
    for (int k0 = 0; k0 < TK; k0 += MMA_K) warp_mma_step(acc, Aw, Bw, k0, lane);
    if (r + 2 < n_stages) {  // the producers refill buf for stage r + 2
      __threadfence_block();
      bar_arrive(BAR_EMPTY + buf, TILED_THREADS);
    }
  }

  // epilogue: sum_j V_nj k_j and sum_j k_j alpha_j over the lane's columns,
  // then over the row's four lanes, then over the column warps in order
  double quad[4], mean[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int nl = 32 * wm + frag_row(mt, lane);
    float zr[DMAX];
#pragma unroll
    for (int dd = 0; dd < DMAX; ++dd) zr[dd] = zq_s[nl * DMAX + dd];
    double qs = 0.0, ms = 0.0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jj = WN * wn + frag_col(nt, c, lane);
        const double kv = kval(zr, inv_ell2, d, sf2, Zc_s + jj, TJ, mc_s[jj]);
        qs = fma(acc[mt][nt][c], kv, qs);
        ms = fma(kv, (double)ac_s[jj], ms);
      }
    }
    qs += __shfl_xor_sync(0xffffffffu, qs, 1);
    qs += __shfl_xor_sync(0xffffffffu, qs, 2);
    ms += __shfl_xor_sync(0xffffffffu, ms, 1);
    ms += __shfl_xor_sync(0xffffffffu, ms, 2);
    quad[mt] = qs;
    mean[mt] = ms;
  }
  const bool row_writer = (lane & 3) == 0;
  if (wn > 0 && row_writer) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int nl = 32 * wm + frag_row(mt, lane);
      xq[(wn - 1) * QT + nl] = quad[mt];
      xm[(wn - 1) * QT + nl] = mean[mt];
    }
  }
  bar_sync(BAR_CONSUMERS, CONSUMER_WARPS * 32);
  if (wn == 0 && row_writer) {
    const long P = (long)col_tiles * (splits + 1);
    double* wq = ws + ((long)g * P + blockIdx.y) * n;
    double* wmean = ws + ((long)g * P + (long)col_tiles * splits + ct) * n;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int nl = 32 * wm + frag_row(mt, lane), q = q0 + nl;
      double qt = quad[mt], mt_sum = mean[mt];
#pragma unroll
      for (int w = 0; w < COLUMN_WARPS - 1; ++w) {
        qt += xq[w * QT + nl];
        mt_sum += xm[w * QT + nl];
      }
      if (q < n) {
        wq[q] = qt;
        if (split == 0) wmean[q] = mt_sum;
      }
    }
  }
}

// The partials of each query in a fixed order (quad: partial 0 .. quad_parts
// - 1, i.e. column tile by column tile, row range by row range; then the
// mean's), the clamp and the noise; float32 out.
constexpr int REDUCE_THREADS = 256;
__global__ void __launch_bounds__(REDUCE_THREADS)
    gp_tiled_reduce_kernel(const double* __restrict__ ws, const float* __restrict__ hyp, int n,
                           int d, int quad_parts, int parts, int include_noise,
                           float* __restrict__ mean_out, float* __restrict__ var_out) {
  const int g = blockIdx.y, q = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (q >= n) return;
  const double* w = ws + (long)g * parts * n + q;
  double quad = 0.0, mean = 0.0;
  for (int p = 0; p < quad_parts; ++p) quad += w[(long)p * n];
  for (int p = quad_parts; p < parts; ++p) mean += w[(long)p * n];
  const float* h = hyp + (long)g * (2 + d);
  float v = fmaxf((float)((double)h[0] - quad), 1e-12f);
  if (include_noise) v += h[1];
  mean_out[(long)g * n + q] = (float)mean;
  var_out[(long)g * n + q] = v;
}

// The fragment layout alone: D = A B (A 32 x PROBE_K, B PROBE_K x WN, D
// 32 x WN, all row-major float64) by one warp through warp_mma_step and
// frag_row/frag_col, with the tiled kernel's strides and K-slab columns.
constexpr int PROBE_K = 16;
constexpr int PROBE_N = WN;
__global__ void gp_dmma_probe_kernel(const double* __restrict__ A, const double* __restrict__ B,
                                     double* __restrict__ D) {
  __shared__ double As[32 * LDA];
  __shared__ double Bs[PROBE_K * LDW];
  const int lane = threadIdx.x;
  for (int e = lane; e < 32 * PROBE_K; e += 32) As[(e / PROBE_K) * LDA + a_col(e / PROBE_K, e % PROBE_K)] = A[e];
  for (int e = lane; e < PROBE_K * PROBE_N; e += 32) Bs[(e / PROBE_N) * LDW + e % PROBE_N] = B[e];
  __syncwarp();
  double acc[4][NT][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = 0.0;
#pragma unroll
  for (int k0 = 0; k0 < PROBE_K; k0 += MMA_K) warp_mma_step(acc, As, Bs, k0, lane);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        D[frag_row(mt, lane) * PROBE_N + frag_col(nt, c, lane)] = acc[mt][nt][c];
}

size_t bucket_smem(int m, int d) {
  return sizeof(float) * ((size_t)m * m + (size_t)(d + 2) * m + (size_t)m * QTILE);
}

template <int MB>
int launch_bucket(const float* z, const float* Zt, const float* alpha, const float* W,
                  const float* mask, const float* hyp, int G, int n, int m, int d,
                  int include_noise, float* mean, float* var, cudaStream_t stream) {
  const size_t smem = bucket_smem(m, d);
  cudaError_t err = cudaFuncSetAttribute(
      gp_posterior_kernel<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + QTILE - 1) / QTILE, G);
  gp_posterior_kernel<MB><<<grid, QTILE, smem, stream>>>(z, Zt, alpha, W, mask, hyp, n, m, d,
                                                         include_noise, mean, var);
  return (int)cudaGetLastError();
}

// The plan's split (ops/cuda_gp.py::gp_tiled_plan chooses it): the rows'
// stages in `splits` ranges of `per` stages, the last possibly shorter but
// none empty.
int launch_tiled(const float* z, const float* Zt, const float* alpha, const float* W,
                 const float* mask, const float* hyp, int G, int n, int m, int d,
                 int include_noise, int splits, int per, double* ws, float* mean, float* var,
                 cudaStream_t stream) {
  const int col_tiles = (m + TJ - 1) / TJ, stages = (m + TK - 1) / TK;
  if (splits < 1 || per < 1 || (long)(splits - 1) * per >= stages || (long)splits * per < stages ||
      ws == nullptr)
    return gpmpc::kUnsupported;
  cudaError_t err = cudaFuncSetAttribute(
      gp_posterior_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILED_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + QT - 1) / QT, col_tiles * splits, G);
  gp_posterior_tiled_kernel<<<grid, TILED_THREADS, TILED_SMEM, stream>>>(
      z, Zt, alpha, W, mask, hyp, n, m, d, splits, per, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((n + REDUCE_THREADS - 1) / REDUCE_THREADS, G);
  gp_tiled_reduce_kernel<<<rgrid, REDUCE_THREADS, 0, stream>>>(
      ws, hyp, n, d, col_tiles * splits, col_tiles * (splits + 1), include_noise, mean, var);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* cudaGetErrorString_wrapper(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// G GPs of m points each (m % 8 == 0), n queries each, d <= 8 dimensions.
// The wrapper names its plan: `bucket` 64 (m <= 64) or 128 (m <= 128) for
// the kernel row in registers, with `splits` 0 and no workspace; or 0 for
// the tiled kernel at any m, with the plan's `splits` ranges of `per`
// stages and a float64 workspace of (G, col_tiles (splits + 1), n);
// `shared_bytes` the block's shared memory. kUnsupported for any other shape
// or plan.
extern "C" int gp_posterior_launch(const float* z, const float* Zt, const float* alpha,
                                   const float* W, const float* mask, const float* hyp, int G,
                                   int n, int m, int d, int include_noise, int bucket, int splits,
                                   int per, int shared_bytes, double* ws, float* mean, float* var,
                                   void* stream) {
  if (G < 1 || n < 1 || m < JB || m % JB || d < 1 || d > DMAX) return gpmpc::kUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bucket == 0) {
    if ((size_t)shared_bytes != TILED_SMEM) return gpmpc::kUnsupported;
    return launch_tiled(z, Zt, alpha, W, mask, hyp, G, n, m, d, include_noise, splits, per, ws,
                        mean, var, s);
  }
  const int expected = m <= 64 ? 64 : m <= 128 ? 128 : 0;
  if (bucket != expected || splits != 0 || per != 0 || (size_t)shared_bytes != bucket_smem(m, d))
    return gpmpc::kUnsupported;
  if (bucket == 64)
    return launch_bucket<64>(z, Zt, alpha, W, mask, hyp, G, n, m, d, include_noise, mean, var, s);
  return launch_bucket<128>(z, Zt, alpha, W, mask, hyp, G, n, m, d, include_noise, mean, var, s);
}

// The tiled kernel's shared memory a block (ops/cuda_gp.py::TILED_SHARED_BYTES).
extern "C" int gp_tiled_shared_bytes() { return (int)TILED_SMEM; }

// D = A B through the tiled kernel's DMMA fragments (A 32 x 16, B 16 x 32,
// D 32 x 32, row-major float64), one warp: the layout check.
extern "C" int gp_dmma_probe_launch(const double* A, const double* B, double* D, void* stream) {
  gp_dmma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(A, B, D);
  return (int)cudaGetLastError();
}

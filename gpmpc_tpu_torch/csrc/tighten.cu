// Chance-constraint tightening in direct form: two kernels behind one entry point.
//
// Replaces: gpmpc_tpu/ops/pallas_tighten.py::tighten_lanes (_tighten_kernel_body).
// The reference runs, per scenario, the covariance recursion from cov_0 = 0:
//   t_x[k] = ppf * sqrt(diag cov_k),  t_u[k] = ppf * sqrt(diag(K cov_k K^T)),
//   cov_{k+1} = Acl cov_k Acl^T + Bd diag(D_k) Bd^T,   Acl = A + B K
// (the reference expands Acl cov Acl^T into four products), for k = 0..T-1,
// and t_x[T] from cov_T.
//
// Direct form. A, B, K and Bd are shared by every scenario and only the
// diagonal D varies, so the recursion unrolls to a sum that is linear in D:
//   cov_k = sum_{j<k} W_{k-1-j} diag(D_j) W_{k-1-j}^T,   W_m = Acl^m Bd,
// whose diagonals are
//   var_x[k, i] = sum_{j<k} sum_q W_{k-1-j}[i, q]^2 D[j, q],
//   var_u[k, u] = sum_{j<k} sum_q V_{k-1-j}[u, q]^2 D[j, q],   V_m = K W_m,
// and t = ppf * sqrt(max(var, 0)). It is the same function with no chain of T
// dependent steps per scenario; per output it is a triangular Toeplitz sum
// over (j, q), T (T + 1) / 2 * nd * (nx + nu) products per scenario.
//
// Precision. W_m grows like |Acl|^m: on the random A = I + 0.02 N(0, 1) of
// tests/test_torch_tighten.py::test_direct_tightening_matches_reference the
// tightening reaches ~1e18 at T = 512 (12x4). The weights are formed in
// float64 (from the float32 inputs; Acl in float64 too), squared and stored
// as float32, and the sums are float32. On that test's data the direct form
// is then within 3.0e-6 x max(1, max|t|) of the float32 recursion at T = 100
// and 512 and within the test's bar of 1e-5 of the reference's scan and
// Pallas kernel, at the three widths; with the powers formed in float32 it
// misses the bar at T = 512 (1.6e-5 at 4x1).
//
// What bounds it on an H100: at T = 25 neither the operations (~1,000 FMAs a
// scenario-stage at 12x4, ~52 MFLOP at B = 1024) nor the bytes (D in, t_x and
// t_u out, ~2 MB) keep the card busy for more than a microsecond, so the
// launches and the short dependent chain of the weights do. At long horizons
// the sums grow as T^2 (B = 256, T = 512, 12x4 with five disturbance rows:
// ~5.4 GFLOP, against ~0.8 for the recursion) and bound it. A plain mapping with one output column a thread
// loads a weight and two float4 broadcasts of D from shared memory for every
// 8 FMAs and reaches ~12 TFLOP/s, below a dense torch.matmul that does twice
// the products; register blocking and double-buffered staging (below) take
// it to about the matmul's time from T = 360 up.
//
// Design.
// (a) tighten_weights_kernel: W_m and V_m for m = 0..T-1 in float64, their
//     squares as float32 into a (T, nx + nu, nd) workspace the wrapper
//     allocates. The dependent chain is kept short by power blocking: each
//     block forms Acl^s for s <= S = min(32, T) by doubling (5 rounds), then
//     W_{S b} = (Acl^S)^b Bd (b < T / S steps, at most 32 at T = 1024), then
//     its S stages W_{S b + s} = Acl^s W_{S b} in parallel. One block per S
//     stages.
// (b) tighten_sums_kernel: register blocked, as a GEMM tile is. A thread
//     holds 4 consecutive stages k0..k0+3 of one output row r for 4
//     scenarios, 16 accumulators. The weights are Toeplitz in (k, j): at
//     stage j the thread's stages need W^2 at m = k0 - 1 - j .. k0 + 2 - j,
//     and at j + 1 the same window shifted by one row, so each step in j
//     loads one weight and one float4 broadcast of D from shared memory for
//     16 FMAs. A block is 128 threads over (stage group, row) of one column
//     block for 4 scenarios; per tile of stages j it stages its scenarios' D
//     rows ([j][q][scenario]) and the slab of squared weights its stages need
//     (one contiguous range of the table, rows past either end of the
//     triangle zero, so the loop has no branch), double buffered with
//     cp.async so that the next tile is in flight while one is summed. The
//     tile's length keeps both buffers near 48 KB (32 stages at 12x4 with
//     five disturbance rows, 128 at the narrow widths), so that four blocks
//     share an SM (a fixed tile of 128 stages would take 125 KB at 12x4 and
//     leave one block an SM). The grid's y walks the column blocks from the
//     last stage down, so the blocks with the longest sums start first. Every thread adds its terms
//     in a fixed order (tiles of j, then q, then j), so two runs give the
//     same bits (no atomics). It writes t_x (B, T+1, nx) and t_u (B, T, nu)
//     in the wrapper's layout. 4 x 4 a thread was the fastest of the
//     variants tried on an H100 (8 x 4, 8 x 8, 16 x 4 and 4 x 8 stages x
//     scenarios; column blocks paired heavy with light).
#include "lanes.cuh"

namespace {

constexpr int kPowerBlock = 32;    // S: stages per block of the weights kernel
constexpr int kWeightThreads = 256;
constexpr int kSumThreads = 128;   // threads a block of the sums kernel
constexpr int kSumStages = 4;      // consecutive stages k of one output row a thread
constexpr int kSumScenarios = 4;   // scenarios a thread and a block (a multiple of 4: float4 reads of D)
constexpr int kStageFloats = 6144;  // a staging buffer's target size (24 KB: 4 blocks an SM)
constexpr int kMaxStageTile = 128;

template <int NX, int NU>
__global__ void __launch_bounds__(kWeightThreads)
    tighten_weights_kernel(const float* __restrict__ A,   // (NX, NX)
                           const float* __restrict__ B,   // (NX, NU)
                           const float* __restrict__ K,   // (NU, NX)
                           const float* __restrict__ Bd,  // (NX, nd)
                           int T, int nd, int S,
                           float* __restrict__ wsq) {     // (T, NX + NU, nd)
  constexpr int NN = NX * NX;
  extern __shared__ double dsm[];
  double* P = dsm;                 // (S + 1) x NX x NX: P[s] = Acl^s
  double* Kd = P + (S + 1) * NN;   // NU x NX
  double* W = Kd + NU * NX;        // NX x nd: W_{S b}
  double* Wn = W + NX * nd;        // NX x nd
  const int tid = threadIdx.x;

  for (int e = tid; e < NN; e += blockDim.x) {
    const int i = e / NX, j = e % NX;
    double acl = A[e];
    for (int u = 0; u < NU; ++u) acl += (double)B[i * NU + u] * (double)K[u * NX + j];
    P[e] = i == j ? 1.0 : 0.0;
    P[NN + e] = acl;
  }
  for (int e = tid; e < NU * NX; e += blockDim.x) Kd[e] = K[e];
  for (int e = tid; e < NX * nd; e += blockDim.x) W[e] = Bd[e];
  __syncthreads();
  // P[p + 1 .. min(2p, S)] = P[p] P[1 .. ]
  for (int p = 1; p < S; p *= 2) {
    const int hi = min(2 * p, S);
    for (int e = tid; e < (hi - p) * NN; e += blockDim.x) {
      const int s = p + 1 + e / NN, i = (e % NN) / NX, j = e % NX;
      const double* X = P + p * NN;
      const double* Y = P + (s - p) * NN;
      double acc = 0.0;
#pragma unroll
      for (int m = 0; m < NX; ++m) acc += X[i * NX + m] * Y[m * NX + j];
      P[s * NN + i * NX + j] = acc;
    }
    __syncthreads();
  }
  // W_{S b} = P[S]^b Bd
  for (int step = 0; step < (int)blockIdx.x; ++step) {
    for (int e = tid; e < NX * nd; e += blockDim.x) {
      const int i = e / nd, q = e % nd;
      double acc = 0.0;
#pragma unroll
      for (int m = 0; m < NX; ++m) acc += P[S * NN + i * NX + m] * W[m * nd + q];
      Wn[e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < NX * nd; e += blockDim.x) W[e] = Wn[e];
    __syncthreads();
  }
  // W_{S b + s} = P[s] W_{S b} and V = K W, one (s, q) column a thread
  const int m0 = blockIdx.x * S;
  const int count = min(S, T - m0);
  for (int e = tid; e < count * nd; e += blockDim.x) {
    const int s = e / nd, q = e % nd;
    double w[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      double acc = 0.0;
#pragma unroll
      for (int m = 0; m < NX; ++m) acc += P[s * NN + i * NX + m] * W[m * nd + q];
      w[i] = acc;
    }
    float* out = wsq + (size_t)(m0 + s) * (NX + NU) * nd;
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i * nd + q] = (float)(w[i] * w[i]);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      double v = 0.0;
#pragma unroll
      for (int i = 0; i < NX; ++i) v += Kd[u * NX + i] * w[i];
      out[(NX + u) * nd + q] = (float)(v * v);
    }
  }
}

// A column block of the sums kernel: kSumThreads threads over (stage group,
// row), thread g taking row g % R of stage group g / R (stages
// k0 = (g / R) * kSumStages .. k0 + kSumStages - 1); ka and kb are the first
// and last stage of the block's groups.
struct ColumnBlock {
  int first, ka, kb;
  __device__ ColumnBlock(int cb, int R, int T) {
    const int groups = T / kSumStages + 1;  // stage groups covering k = 0..T
    first = cb * kSumThreads;
    ka = first / R * kSumStages;
    kb = (min((first + kSumThreads - 1) / R, groups - 1) + 1) * kSumStages - 1;
  }
};

// Rows of the slab of fixed size: those of the block's stages, beyond the
// tile's (a block's threads span at most (kSumThreads - 1) / R + 2 stage
// groups); the slab of the j-tile [j0, j1) holds rows m = ka - 1 - j1 ..
// kb - 1 - j0, the fixed ones plus one per stage of the tile.
__host__ __device__ __forceinline__ int slab_fixed_rows(int R) {
  return ((kSumThreads - 1) / R + 2) * kSumStages;
}

// Stages j a tile stages at once: as many as keep a buffer (the tile's D rows
// and its weight slab) near kStageFloats, so that 4 blocks fit an SM, and at
// least 16.
__host__ __device__ __forceinline__ int stage_tile_len(int R, int nd) {
  const int spare = kStageFloats - slab_fixed_rows(R) * R * nd;
  return max(16, min(kMaxStageTile, spare / (nd * (kSumScenarios + R))));
}

// Floats of one staging buffer (a D tile, then a weight slab), a multiple of 4
// so that the second buffer's D rows stay 16-byte aligned.
__host__ __device__ __forceinline__ int buffer_floats(int R, int nd, int tile) {
  return (tile * nd * kSumScenarios + (slab_fixed_rows(R) + tile) * R * nd + 3) / 4 * 4;
}

// Start the copies of the j-tile [j0, j1) into one buffer, then close the
// group: the block's scenarios' D rows ([j][q][scenario]) and the slab of
// squared weights, rows m = ka - 1 - j1 .. kb - 1 - j0 (one contiguous range
// of the (T, R, nd) table; rows outside [0, T) written as zeros).
template <int R>
__device__ __forceinline__ void stage_tile(const float* covdn, const float* wsq, int Bn, int T,
                                           int nd, int b0, const ColumnBlock& blk, int j0,
                                           int j1, float* Ds, float* Ws) {
  constexpr int SB = kSumScenarios;
  const int n_jq = (j1 - j0) * nd;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const float* src = covdn + (size_t)(b0 + s) * T * nd + (size_t)j0 * nd;
    for (int jq = threadIdx.x; jq < n_jq; jq += kSumThreads) {
      if (b0 + s < Bn)
        gpmpc::cp_async4(Ds + jq * SB + s, src + jq);
      else
        Ds[jq * SB + s] = 0.0f;
    }
  }
  const long lo = (long)(blk.ka - 1 - j1) * R * nd, n = (long)(blk.kb - j0) * R * nd - lo;
  const long total = (long)T * R * nd;
  for (int e = threadIdx.x; e < n; e += kSumThreads) {
    const long g = lo + e;
    if (g >= 0 && g < total)
      gpmpc::cp_async4(Ws + e, wsq + g);
    else
      Ws[e] = 0.0f;
  }
  gpmpc::cp_async_commit();
}

// Grid (scenario groups, column blocks): block (x, y) sums column block
// n_cb - 1 - y, so that the blocks with the longest sums start first, for the
// kSumScenarios scenarios from x * kSumScenarios, and writes t_x and t_u.
template <int NX, int NU>
__global__ void __launch_bounds__(kSumThreads)
    tighten_sums_kernel(const float* __restrict__ covdn,  // (Bn, T, nd)
                        const float* __restrict__ wsq,    // (T, NX + NU, nd)
                        const float* __restrict__ ppf_p,  // (1,)
                        int Bn, int T, int nd, int n_cb,
                        float* __restrict__ tx,           // (Bn, T + 1, NX)
                        float* __restrict__ tu) {         // (Bn, T, NU)
  constexpr int R = NX + NU;
  constexpr int CK = kSumStages;
  constexpr int SB = kSumScenarios;
  const int RN = R * nd;
  const int tile = stage_tile_len(R, nd);
  const int d_floats = tile * nd * SB, buf_floats = buffer_floats(R, nd, tile);
  extern __shared__ __align__(16) float sm[];
  const int b0 = blockIdx.x * SB;
  const ColumnBlock blk(n_cb - 1 - (int)blockIdx.y, R, T);
  const int g = blk.first + threadIdx.x;
  const int k0 = g / R * CK, r = g % R;
  const bool active = k0 <= T;

  float acc[CK][SB];
#pragma unroll
  for (int c = 0; c < CK; ++c)
#pragma unroll
    for (int s = 0; s < SB; ++s) acc[c][s] = 0.0f;

  // Tiles of `tile` stages j, double buffered: tile t + 1 is in flight
  // while tile t is summed.
  const int jmax = min(blk.kb, T);  // stage k sums j < k, and j < T
  if (jmax > 0)
    stage_tile<R>(covdn, wsq, Bn, T, nd, b0, blk, 0, min(tile, jmax), sm, sm + d_floats);
  for (int j0 = 0, buf = 0; j0 < jmax; j0 += tile, buf ^= 1) {
    const int j1 = min(j0 + tile, jmax);
    if (j1 < jmax) {
      float* next = sm + (buf ^ 1) * buf_floats;
      stage_tile<R>(covdn, wsq, Bn, T, nd, b0, blk, j1, min(j1 + tile, jmax), next,
                    next + d_floats);
      gpmpc::cp_async_wait<1>();
    } else {
      gpmpc::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ds = sm + buf * buf_floats;
    const int mlo = blk.ka - 1 - j1;
    const int jend = min(j1, k0 + CK - 1);
    if (active) {
      for (int q = 0; q < nd; ++q) {
        // w[c] = W^2 at m = k0 + c - 1 - j (zero where that stage sums no j);
        // each step in j shifts the window by one row and loads one weight.
        const float* wcol = Ds + d_floats - (long)mlo * RN + r * nd + q;  // row m at wcol[m * RN]
        float w[CK];
#pragma unroll
        for (int c = 0; c < CK; ++c) w[c] = wcol[(k0 + c - 1 - j0) * RN];
#pragma unroll 4
        for (int j = j0; j < jend; ++j) {
          const float4* d4 = reinterpret_cast<const float4*>(Ds + ((j - j0) * nd + q) * SB);
          float d[SB];
#pragma unroll
          for (int v = 0; v < SB / 4; ++v) {
            const float4 dv = d4[v];
            d[4 * v] = dv.x;
            d[4 * v + 1] = dv.y;
            d[4 * v + 2] = dv.z;
            d[4 * v + 3] = dv.w;
          }
#pragma unroll
          for (int c = 0; c < CK; ++c)
#pragma unroll
            for (int s = 0; s < SB; ++s) acc[c][s] = fmaf(w[c], d[s], acc[c][s]);
#pragma unroll
          for (int c = CK - 1; c > 0; --c) w[c] = w[c - 1];
          w[0] = wcol[(k0 - 2 - j) * RN];
        }
      }
    }
    __syncthreads();  // the buffer is staged again two tiles on
  }
  if (!active) return;
  const float ppf = ppf_p[0];
#pragma unroll
  for (int c = 0; c < CK; ++c) {
    const int k = k0 + c;
    if (k > T || (r >= NX && k == T)) break;
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      const int b = b0 + s;
      if (b >= Bn) break;
      const float t = ppf * sqrtf(fmaxf(acc[c][s], 0.0f));
      if (r < NX)
        tx[((size_t)b * (T + 1) + k) * NX + r] = t;
      else
        tu[((size_t)b * T + k) * NU + (r - NX)] = t;
    }
  }
}

// Shared memory of the sums kernel's block: two staging buffers.
size_t sums_shared_bytes(int R, int nd) {
  return 2 * sizeof(float) * buffer_floats(R, nd, stage_tile_len(R, nd));
}

}  // namespace

// Both kernels on `stream`, the weights then the sums; `wsq` is the
// (T, nx + nu, nd) float32 workspace of the squared weights.
extern "C" int tighten_launch(const float* covdn, const float* A, const float* B, const float* K,
                              const float* Bd, const float* ppf, int Bn, int T, int nd, int nx,
                              int nu, float* wsq, float* tx, float* tu, void* stream) {
  return gpmpc::dispatch_nx_nu(nx, nu, [&](auto nx_c, auto nu_c) {
    constexpr int NX = decltype(nx_c)::value, NU = decltype(nu_c)::value;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (Bn <= 0 || T < 0 || nd <= 0)
      return gpmpc::kUnsupported;
    if (T > 0) {
      const int S = min(kPowerBlock, T);
      const size_t wbytes = sizeof(double) * ((size_t)(S + 1) * NX * NX + NU * NX + 2 * NX * nd);
      cudaError_t err = cudaFuncSetAttribute(tighten_weights_kernel<NX, NU>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)wbytes);
      if (err != cudaSuccess) return (int)err;
      tighten_weights_kernel<NX, NU><<<(T + S - 1) / S, kWeightThreads, wbytes, s>>>(
          A, B, K, Bd, T, nd, S, wsq);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const size_t sbytes = sums_shared_bytes(NX + NU, nd);
    cudaError_t err = cudaFuncSetAttribute(
        tighten_sums_kernel<NX, NU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sbytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(tighten_sums_kernel<NX, NU>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    const int threads = (T / kSumStages + 1) * (NX + NU);  // a stage group of a row each
    const int n_cb = (threads + kSumThreads - 1) / kSumThreads;
    if (n_cb > 65535) return gpmpc::kUnsupported;
    const dim3 grid((Bn + kSumScenarios - 1) / kSumScenarios, n_cb);
    tighten_sums_kernel<NX, NU><<<grid, kSumThreads, sbytes, s>>>(covdn, wsq, ppf, Bn, T, nd,
                                                                  n_cb, tx, tu);
    return (int)cudaGetLastError();
  });
}

// Lane-wise matmul chains: the three kernels of the roofline probe.
//
// Replaces: scripts/bench_roofline.py::lanes_chain (body lanes_kernel),
// lanes_chain_bf16 (lanes_kernel_bf16) and lanes_chain_16 (lanes_kernel_16).
// Each takes N x N matrices in lanes layout (n_blocks, N, N, L), one scenario
// per lane and one independent (tile, stage) pair per n_blocks entry, and
// applies n_chain dependent rounds of
//   acc <- 0.5 * (acc @ acc) + 0.5 * acc
// to every matrix. They exist to be timed: the chain is the inner operation of
// the interior-point kernels, stripped of everything else, so its rate is what
// a mapping can reach on this card. The QP kernels (all three tiers are
// csrc/ocp_ip_resident.cuh) run a team of threads per scenario, each member
// owning rows of the products and reading the rows it needs from the team's
// shared memory as 16-byte broadcasts. lanes_chain_16 runs that mapping;
// lanes_chain and lanes_chain_bf16 keep the earlier one, one thread per
// scenario with both matrices in shared memory.
//
// What bounds them on an H100: the float32 (or packed bf16) FMA pipe. Device
// memory is read and written once (2 N^2 values per scenario against
// 2 N^3 n_chain operations).
//
// lanes_chain and lanes_chain_bf16 (chain_kernel): the TPU kernels hold all
// stages of a tile in one program; stages are independent, so here one block
// takes one (tile, stage) pair (and, where two buffers of the whole tile do
// not fit in shared memory or a tile is wider than 128 slots, a slice of its
// lanes: blockIdx.y) and one thread one 32-bit lane slot of it: one float32
// scenario, or two bf16 scenarios in one __nv_bfloat162. The matrix and its
// successor live in shared memory, because both in registers would be
// 2 N^2 = 288 values a thread at N = 12. Shared memory holds each row as
// quads of four columns, quad (i, q) of slot l at ((i * N / 4 + q) * Lb + l)
// * 16 bytes, so a row is N / 4 conflict-free 16-byte loads: with one 4-byte
// load an entry the kernel is bound by the count of shared-memory loads, not
// by FMAs (PERF.md has both versions' times). A round forms kRows output rows
// at a time: the kRows x N block of `acc` they need and their kRows x N sums
// sit in registers, each row k of the right operand is read once and used for
// kRows * N FMAs, then the block goes to the second buffer and the buffers
// swap. A thread touches only its own slot, so there is no synchronization.
//
//  * lanes_chain: float32, N = 12, six rows at a time (under 255 registers
//    without spills); 147 KB of shared memory at L = 128, one block an SM.
//  * lanes_chain_bf16: every multiply and add rounded to bf16, as the
//    reference's bf16 arithmetic rounds them: __hmul2_rn and __hadd2_rn, two
//    roundings a term. __hfma2 would round once and halve the operations; it
//    is not used because it computes a different function (the _rn forms also
//    keep ptxas from contracting the pair into an fma). Four rows at a time.
//
// lanes_chain_16 (team_chain16_kernel): float32, the 12 x 12 blocks embedded
// in 16 x 16, computed in full (the zero blocks are not skipped: the kernel
// is right for any input). Two buffers of 128 scenarios would not fit in a
// block's shared memory at N = 16, and one thread per scenario ran two warps
// an SM. Here a team of kTeam16 threads, inside one warp, takes one scenario:
// member m owns rows m R .. m R + R - 1 (R = 16 / kTeam16) and keeps them in
// registers from round to round. The scenario has ONE 16 x 16 buffer in
// shared memory (1 KB), in the quad layout above. A round: every member reads
// all 16 rows of the right operand and forms its rows' sums, then blends them
// into its registers; __syncwarp over the team;
// each member writes its rows; __syncwarp again, so the next round reads the
// whole new matrix. The members of a team read the same quad, so one 16-byte
// load of a warp serves 32 / kTeam16 scenarios as a broadcast. Every entry is
// formed in the order of the other kernels: s = a[i][0] b[0][j], fmaf over
// k = 1 .. 15, then 0.5 s + 0.5 a[i][j], so the result is the one-thread
// kernel's bit for bit. A block takes kLanes16 scenarios of a tile (fewer
// where that does not divide L): the constants are the fastest of the team
// sizes and block widths measured on the card (PERF.md).
#include <cuda_bf16.h>

#include "lanes.cuh"

namespace {

constexpr size_t kSmemLimit = 232448;  // bytes of shared memory one block may use on sm_90
constexpr int kMaxThreads = 128;       // slots a block takes at most

struct F32 {
  using T = float;
  static __device__ __forceinline__ T first(T a, T b) { return a * b; }
  static __device__ __forceinline__ T acc(T s, T a, T b) { return fmaf(a, b, s); }
  static __device__ __forceinline__ T blend(T s, T a) { return 0.5f * s + 0.5f * a; }
};

struct Bf16x2 {
  using T = __nv_bfloat162;
  static __device__ __forceinline__ T first(T a, T b) { return __hmul2_rn(a, b); }
  static __device__ __forceinline__ T acc(T s, T a, T b) { return __hadd2_rn(s, __hmul2_rn(a, b)); }
  static __device__ __forceinline__ T blend(T s, T a) {  // the halvings are exact, the sum rounds once
    const T half = __float2bfloat162_rn(0.5f);
    return __hadd2_rn(__hmul2_rn(half, s), __hmul2_rn(half, a));
  }
};

template <class T>
struct alignas(16) Quad {  // four neighbouring columns of one row of one slot
  T v[4];
};

// x, out (n_blocks, N, N, L) of Ops::T, L slots a tile; blockIdx.y picks the
// slice of blockDim.x slots. kRows output rows are formed together in
// registers.
template <class Ops, int N, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
    chain_kernel(const typename Ops::T* __restrict__ x, typename Ops::T* __restrict__ out,
                 int n_chain, int L) {
  using T = typename Ops::T;
  using Q4 = Quad<T>;
  constexpr int Q = N / 4;
  static_assert(N % 4 == 0 && N % kRows == 0, "rows are whole quads, row blocks tile the matrix");
  extern __shared__ float4 smem[];
  const int Lb = blockDim.x;
  const int lane = threadIdx.x;
  const long base = (long)blockIdx.x * N * N * L + blockIdx.y * Lb + lane;
  Q4* cur = reinterpret_cast<Q4*>(smem) + lane;
  Q4* nxt = cur + N * Q * Lb;
  for (int e = 0; e < N * Q; ++e) {
    const T* p = x + base + (long)(4 * e) * L;
    Q4 v;
#pragma unroll
    for (int c = 0; c < 4; ++c) v.v[c] = p[(long)c * L];
    cur[e * Lb] = v;
  }
  for (int round = 0; round < n_chain; ++round) {
#pragma unroll 1
    for (int i0 = 0; i0 < N; i0 += kRows) {
      T a[kRows][N], s[kRows][N];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const Q4 v = cur[((i0 + r) * Q + q) * Lb];
#pragma unroll
          for (int c = 0; c < 4; ++c) a[r][4 * q + c] = v.v[c];
        }
#pragma unroll
      for (int k = 0; k < N; ++k) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const Q4 b = cur[(k * Q + q) * Lb];
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              s[r][4 * q + c] = k == 0 ? Ops::first(a[r][0], b.v[c])
                                       : Ops::acc(s[r][4 * q + c], a[r][k], b.v[c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          Q4 v;
#pragma unroll
          for (int c = 0; c < 4; ++c) v.v[c] = Ops::blend(s[r][4 * q + c], a[r][4 * q + c]);
          nxt[((i0 + r) * Q + q) * Lb] = v;
        }
    }
    Q4* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int e = 0; e < N * Q; ++e) {
    const Q4 v = cur[e * Lb];
    T* p = out + base + (long)(4 * e) * L;
#pragma unroll
    for (int c = 0; c < 4; ++c) p[(long)c * L] = v.v[c];
  }
}

// A block takes the widest slice of the tile's L slots that divides L, is at
// most kMaxThreads wide and whose two buffers fit in shared memory.
template <class Ops, int N, int kRows>
int launch_chain(const void* x, void* out, int n_blocks, int L, int n_chain, void* stream) {
  using T = typename Ops::T;
  if (L < 1 || n_blocks < 1) return gpmpc::kUnsupported;
  int slices = 1;
  while (L % slices || L / slices > kMaxThreads ||
         sizeof(T) * 2 * N * N * (size_t)(L / slices) > kSmemLimit)
    ++slices;
  if (slices > 65535) return gpmpc::kUnsupported;
  const int Lb = L / slices;
  const size_t smem = sizeof(T) * 2 * N * N * (size_t)Lb;
  auto kernel = chain_kernel<Ops, N, kRows>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_blocks, slices), Lb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_chain, L);
  return (int)cudaGetLastError();
}

// ---- lanes_chain_16: a team of threads per scenario -------------------------------

constexpr int kTeam16 = 4;    // threads a scenario
constexpr int kLanes16 = 64;  // scenarios a block takes at most

// x, out (n_blocks, 16, 16, L) float32; block (blockIdx.x, blockIdx.y) takes
// lanes blockIdx.y * Lb .. + Lb - 1 of matrix blockIdx.x, Lb = blockDim.x /
// TEAM <= kLanes16; thread t is member t % TEAM of scenario t / TEAM, owning
// rows m R .. m R + R - 1 (R = 16 / TEAM): `a` holds them as the round's left
// operand, `nw` forms their sums and then the new rows.
// One block an SM at least: ptxas may then give a thread up to 255
// registers, which keeps both `a` and `nw` in registers (PERF.md, section 6).
__global__ void __launch_bounds__(kTeam16 * kLanes16, 1)
    team_chain16_kernel(const float* __restrict__ x, float* __restrict__ out, int n_chain,
                        int L) {
  constexpr int TEAM = kTeam16, N = 16, Q = N / 4, R = N / TEAM;
  static_assert(TEAM <= 32 && 32 % TEAM == 0, "a team lies inside one warp");
  using Q4 = Quad<float>;
  extern __shared__ float4 smem[];
  const int Lb = blockDim.x / TEAM;
  const int s = threadIdx.x / TEAM, m = threadIdx.x % TEAM;
  const unsigned team = ((1u << TEAM) - 1u) << ((threadIdx.x & 31) & ~(TEAM - 1));
  const long base = (long)blockIdx.x * N * N * L + blockIdx.y * Lb + s;
  Q4* buf = reinterpret_cast<Q4*>(smem) + s;  // quad (i, q) at buf[(i * Q + q) * Lb]
  float a[R][N], nw[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) nw[r][j] = x[base + (long)((m * R + r) * N + j) * L];
  auto store_rows = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        Q4 v;
#pragma unroll
        for (int c = 0; c < 4; ++c) v.v[c] = nw[r][4 * q + c];
        buf[((m * R + r) * Q + q) * Lb] = v;
      }
  };
  store_rows();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) a[r][j] = nw[r][j];
  __syncwarp(team);
  for (int round = 0; round < n_chain; ++round) {
#pragma unroll
    for (int kq = 0; kq < Q; ++kq) {  // k = 4 kq + kk
      float ak[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) ak[r][c] = a[r][4 * kq + c];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * kq + kk;
        // keeps nvcc from hoisting every load of the right operand above the
        // FMAs, which runs out of registers and spills
        if (kk == 0) asm volatile("" ::: "memory");
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const Q4 b = buf[(k * Q + q) * Lb];
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int r = 0; r < R; ++r)
              nw[r][4 * q + c] =
                  k == 0 ? ak[r][0] * b.v[c] : fmaf(ak[r][kk], b.v[c], nw[r][4 * q + c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < N; ++j) a[r][j] = nw[r][j] = 0.5f * nw[r][j] + 0.5f * a[r][j];
    __syncwarp(team);  // every member has read the old matrix
    store_rows();
    __syncwarp(team);  // the new matrix is whole before the next round reads it
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) out[base + (long)((m * R + r) * N + j) * L] = nw[r][j];
}

// A block takes the widest slice of the tile's L lanes that divides L and is
// at most kLanes16 wide.
int launch_team_chain16(const float* x, float* out, int n_blocks, int L, int n_chain,
                        void* stream) {
  if (L < 1 || n_blocks < 1) return gpmpc::kUnsupported;
  int slices = 1;
  while (L % slices || L / slices > kLanes16) ++slices;
  if (slices > 65535) return gpmpc::kUnsupported;
  const int Lb = L / slices;
  const size_t smem = sizeof(float) * 16 * 16 * (size_t)Lb;
  auto kernel = team_chain16_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_blocks, slices), Lb * kTeam16, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, n_chain, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (n_blocks, 12, 12, L) float32.
extern "C" int lanes_chain_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                  void* stream) {
  return launch_chain<F32, 12, 6>(x, out, n_blocks, L, n_chain, stream);
}

// x, out (n_blocks, 12, 12, L) bf16 with L even: a thread takes lanes 2 p and 2 p + 1.
extern "C" int lanes_chain_bf16_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                       void* stream) {
  if (L % 2) return gpmpc::kUnsupported;
  return launch_chain<Bf16x2, 12, 4>(x, out, n_blocks, L / 2, n_chain, stream);
}

// x, out (n_blocks, 16, 16, L) float32.
extern "C" int lanes_chain_16_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                     void* stream) {
  return launch_team_chain16(static_cast<const float*>(x), static_cast<float*>(out), n_blocks, L,
                             n_chain, stream);
}

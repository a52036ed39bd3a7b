// Lane-wise matmul chains: the three kernels of the roofline probe.
//
// Replaces: scripts/bench_roofline.py::lanes_chain (body lanes_kernel),
// lanes_chain_bf16 (lanes_kernel_bf16) and lanes_chain_16 (lanes_kernel_16).
// Each takes N x N matrices in lanes layout (n_blocks, N, N, L), one scenario
// per lane and one independent (tile, stage) pair per n_blocks entry, and
// applies n_chain dependent rounds of
//   acc <- 0.5 * (acc @ acc) + 0.5 * acc
// to every matrix. They exist to be timed: the chain is the inner operation of
// the interior-point kernels (csrc/ocp_ip.cuh: one thread per scenario, a
// serial chain of small products on operands in shared memory), stripped of
// everything else, so its rate is what that mapping can reach on this card.
//
// What bounds them on an H100: the float32 (or packed bf16) FMA pipe. Device
// memory is read and written once (2 N^2 values per scenario against
// 2 N^3 n_chain operations).
//
// Design: one kernel template for all three. The TPU kernels hold all stages
// of a tile in one program; stages are independent, so here one block takes
// one (tile, stage) pair (and, where two buffers of the whole tile do not fit
// in shared memory or a tile is wider than 128 slots, a slice of its lanes:
// blockIdx.y) and one thread one 32-bit lane slot of it: one float32 scenario,
// or two bf16 scenarios in one __nv_bfloat162. The matrix and its successor
// live in shared memory, because both in registers would be 2 N^2 = 288
// values a thread at N = 12. Shared memory holds each row as quads of four
// columns, quad (i, q) of slot l at ((i * N / 4 + q) * Lb + l) * 16 bytes, so
// a row is N / 4 conflict-free 16-byte loads: with one 4-byte load an entry
// the kernel is bound by the count of shared-memory loads, not by FMAs
// (PERF.md has both versions' times). A round forms kRows output rows at a
// time: the kRows x N block of `acc` they need and their kRows x N sums sit
// in registers, each row k of the right operand is read once and used for
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
//  * lanes_chain_16: float32, the 12 x 12 blocks embedded in 16 x 16. Two
//    16 x 16 x 128 float32 buffers are 262 KB, past the 227 KB a block may
//    use, so a block takes 64 lanes of its tile: the padding costs occupancy
//    (two warps an SM) as well as (16/12)^3 of the operations. Four rows at a
//    time, and a compiler barrier after eight rows of the right operand: left
//    alone, nvcc hoists all 64 of its 16-byte loads above the FMAs, runs out
//    of registers and spills (PERF.md has ptxas's report and both times).
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
// registers; kFence > 0 keeps the loads of the right operand from moving
// across every kFence-th row.
template <class Ops, int N, int kRows, int kFence>
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
        if (kFence > 0 && k > 0 && k % (kFence > 0 ? kFence : 1) == 0) asm volatile("" ::: "memory");
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
template <class Ops, int N, int kRows, int kFence>
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
  auto kernel = chain_kernel<Ops, N, kRows, kFence>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_blocks, slices), Lb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_chain, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (n_blocks, 12, 12, L) float32.
extern "C" int lanes_chain_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                  void* stream) {
  return launch_chain<F32, 12, 6, 0>(x, out, n_blocks, L, n_chain, stream);
}

// x, out (n_blocks, 12, 12, L) bf16 with L even: a thread takes lanes 2 p and 2 p + 1.
extern "C" int lanes_chain_bf16_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                       void* stream) {
  if (L % 2) return gpmpc::kUnsupported;
  return launch_chain<Bf16x2, 12, 4, 0>(x, out, n_blocks, L / 2, n_chain, stream);
}

// x, out (n_blocks, 16, 16, L) float32.
extern "C" int lanes_chain_16_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                     void* stream) {
  return launch_chain<F32, 16, 4, 8>(x, out, n_blocks, L, n_chain, stream);
}

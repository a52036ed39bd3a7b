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
// lanes_chain and lanes_chain_bf16 run one thread per scenario that keeps the
// whole matrix in registers as the right operand and reads only the left
// rows from shared memory, the lever ROADMAP.md's R1 names for the QP
// kernel's stages (operands in registers, shared memory to hand results on).
//
// What bounds them on an H100: the float32 (or packed bf16) FMA pipe. Device
// memory is read and written once (2 N^2 values per scenario against
// 2 N^3 n_chain operations).
//
// lanes_chain and lanes_chain_bf16 (chain_kernel): the TPU kernels hold all
// stages of a tile in one program; stages are independent, so here one block
// takes a slice of the lanes of one (tile, stage) pair (blockIdx.x the pair,
// blockIdx.y the slice) and one thread one 32-bit lane slot of it: one
// float32 scenario, or two bf16 scenarios in one __nv_bfloat162. The thread
// keeps the WHOLE N x N matrix in registers (144 32-bit values at N = 12) as
// the right operand of a round, and the slot has ONE N x N buffer in shared
// memory that holds the same matrix, as N / 4 quads of four columns a row
// (quad (i, q) of slot l at ((i * N / 4 + q) * Lb + l) * 16 bytes: a warp's
// 16-byte accesses are 512 contiguous bytes, conflict-free). New row i is
// s_j = a[i][0] a[0][j], then k = 1 .. N - 1 in that order, then the blend
// with a[i][j]: its left operand, old row i, is read from the buffer (a row
// ahead, while the row before is formed), every right operand comes from
// registers, and the new row goes into the buffer over old row i, which no
// later row of the round reads (they take row i from registers). After row
// N - 1 the thread reads the new matrix back into registers. That is 3 N^2 / 4
// = 108 shared accesses a round for N^3 = 1,728 terms, 16 terms to a 16-byte
// access, so the arithmetic pipe and not the shared-memory pipe sets the pace
// (the first design, both matrices in shared memory and several output rows
// at a time, moved 144 and 180 accesses a round). A thread touches only its
// own slot, so there is no synchronization, in a part warp too. Every index
// into `a` is a compile-time constant (k and j unrolled in full, kChainRows
// rows at a time), or nvcc would put `a` in local memory. Taking the left
// operand from registers as well needs the whole round unrolled (its row
// index must be a constant): measured, float32 ran as fast and bf16 spilled
// and ran at half the speed (PERF.md).
//
// Each entry is formed in the first design's order, term for term, so the
// output is that kernel's bit for bit (the halvings of the blend are exact, so
// contraction cannot change it). A block takes at most kChainSlots slots, and
// its shared memory (576 bytes a slot) is a quarter of the first design's two
// buffers: residency is set by registers, and narrow blocks spread the probe's
// 1,000 (float32) or 500 (bf16) warps over every SM in one wave. The slicing
// is decided in one place, cuda_chain.chain_geometry, which the launcher
// checks and takes.
//
//  * lanes_chain: float32, fmaf a term.
//  * lanes_chain_bf16: every multiply and add rounded to bf16, as the
//    reference's bf16 arithmetic rounds them: __hmul2_rn and __hadd2_rn, two
//    roundings and two instructions a term. __hfma2 would round once and halve
//    the instructions; it is not used because it computes a different function
//    (the _rn forms also keep ptxas from contracting the pair into an fma). So
//    no kernel of this function passes half the packed-bf16 FMA rate.
//
// lanes_chain_16 (team_chain16_kernel): float32, the 12 x 12 blocks embedded
// in 16 x 16, computed in full (the zero blocks are not skipped: the kernel
// is right for any input). One thread per scenario with both matrices in
// shared memory ran two warps an SM at N = 16, and a whole 16 x 16
// matrix is more registers than a thread has. Here a team of kTeam16
// threads, inside one warp, takes one scenario: member m owns rows
// m R .. m R + R - 1 (R = 16 / kTeam16) and keeps them in registers from
// round to round. The scenario has ONE 16 x 16 buffer in
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

// Both instantiations of chain_kernel: the slots a block takes at most
// (cuda_chain.CHAIN_SLOTS mirrors it), the blocks an SM must hold at that
// width (the launch bound's two numbers, so ptxas gives a thread at most
// 65,536 / (slots x blocks) = 255 registers), and the rows of a round
// unrolled together: the fastest without spills of the variants measured on
// the card (PERF.md, scripts/bench_chain_geometry_torch.py).
constexpr int kChainSlots = 64;
constexpr int kChainMinBlocks = 4;
constexpr int kChainRows = 4;

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

// x, out (n_blocks, 12, 12, L) of Ops::T, L slots a tile; block
// (blockIdx.x, blockIdx.y) takes slots blockIdx.y * Lb .. + Lb - 1 of matrix
// blockIdx.x, Lb = blockDim.x <= kChainSlots, one slot a thread; kChainRows
// rows of a round are unrolled together.
template <class Ops>
__global__ void __launch_bounds__(kChainSlots, kChainMinBlocks)
    chain_kernel(const typename Ops::T* __restrict__ x, typename Ops::T* __restrict__ out,
                 int n_chain, int L) {
  using T = typename Ops::T;
  using Q4 = Quad<T>;
  constexpr int N = 12, Q = N / 4;
  static_assert(N % kChainRows == 0, "the unrolled rows tile the matrix");
  extern __shared__ float4 smem[];
  const int Lb = blockDim.x;
  const long base = (long)blockIdx.x * N * N * L + (long)blockIdx.y * Lb + threadIdx.x;
  Q4* buf = reinterpret_cast<Q4*>(smem) + threadIdx.x;  // quad (i, q) at buf[(i * Q + q) * Lb]
  T a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      Q4 v;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v.v[c] = a[i][4 * q + c] = x[base + (long)(i * N + 4 * q + c) * L];
      buf[(i * Q + q) * Lb] = v;
    }
  auto load_row = [&](T* row, int i) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const Q4 v = buf[(i * Q + q) * Lb];
#pragma unroll
      for (int c = 0; c < 4; ++c) row[4 * q + c] = v.v[c];
    }
  };
#pragma unroll 1
  for (int round = 0; round < n_chain; ++round) {
    T next[N];  // the next row's left operand, loaded a row ahead
    load_row(next, 0);
#pragma unroll 1
    for (int i0 = 0; i0 < N; i0 += kChainRows) {
#pragma unroll
      for (int r = 0; r < kChainRows; ++r) {
        const int i = i0 + r;
        T l[N], s[N];  // old row i (the left operand), then new row i's sums
#pragma unroll
        for (int j = 0; j < N; ++j) l[j] = next[j];
        load_row(next, i + 1 < N ? i + 1 : i);  // old row i + 1 is not written yet
#pragma unroll
        for (int j = 0; j < N; ++j) s[j] = Ops::first(l[0], a[0][j]);
#pragma unroll
        for (int k = 1; k < N; ++k)
#pragma unroll
          for (int j = 0; j < N; ++j) s[j] = Ops::acc(s[j], l[k], a[k][j]);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          Q4 v;
#pragma unroll
          for (int c = 0; c < 4; ++c) v.v[c] = Ops::blend(s[4 * q + c], l[4 * q + c]);
          buf[(i * Q + q) * Lb] = v;  // no later row of this round reads old row i
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) load_row(a[i], i);  // the new matrix, the next right operand
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) out[base + (long)(i * N + j) * L] = a[i][j];
}

// Launches chain_kernel over n_blocks matrices of L slots, each split into
// `slices` blocks of slots_per_block threads with shared_bytes of shared
// memory: cuda_chain.chain_geometry's numbers, which must tile L, stay within
// kChainSlots and give one 12 x 12 buffer a slot, or nothing launches.
template <class Ops>
int launch_chain(const void* x, void* out, int n_blocks, int L, int n_chain, int slots_per_block,
                 int slices, int shared_bytes, void* stream) {
  using T = typename Ops::T;
  if (n_blocks < 1 || slots_per_block < 1 || slots_per_block > kChainSlots || slices < 1 ||
      slices > 65535 || (long)slots_per_block * slices != L ||
      (size_t)shared_bytes != sizeof(T) * 12 * 12 * (size_t)slots_per_block)
    return gpmpc::kUnsupported;
  auto kernel = chain_kernel<Ops>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_blocks, slices), slots_per_block, shared_bytes,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                n_chain, L);
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

// x, out (n_blocks, 12, 12, L) float32: a slot is a lane.
extern "C" int lanes_chain_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                  int slots_per_block, int slices, int shared_bytes,
                                  void* stream) {
  return launch_chain<F32>(x, out, n_blocks, L, n_chain, slots_per_block, slices, shared_bytes,
                           stream);
}

// x, out (n_blocks, 12, 12, L) bf16 with L even: a slot is lanes 2 p and
// 2 p + 1, so the geometry counts L / 2 slots.
extern "C" int lanes_chain_bf16_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                       int slots_per_block, int slices, int shared_bytes,
                                       void* stream) {
  if (L % 2) return gpmpc::kUnsupported;
  return launch_chain<Bf16x2>(x, out, n_blocks, L / 2, n_chain, slots_per_block, slices,
                              shared_bytes, stream);
}

// x, out (n_blocks, 16, 16, L) float32.
extern "C" int lanes_chain_16_launch(const void* x, void* out, int n_blocks, int L, int n_chain,
                                     void* stream) {
  return launch_team_chain16(static_cast<const float*>(x), static_cast<float*>(out), n_blocks, L,
                             n_chain, stream);
}

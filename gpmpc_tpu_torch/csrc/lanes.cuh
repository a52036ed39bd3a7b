// Shared helpers for the lanes-layout kernels of gpmpc_tpu_torch.
//
// Lanes layout: a tensor of shape (n_tiles, d0, d1, ..., L) holds one
// scenario per lane, scenario axis last, so element (tile, i, lane) lies at
// tile_base + i * L + lane. A kernel puts consecutive lanes in consecutive
// threads of a warp (threadIdx.x): neighbouring threads touch neighbouring
// addresses and every warp access is one coalesced 128-byte transaction.
// `lane_view` is the view of the simplest mapping, one block per tile and
// one thread per lane.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace gpmpc {

// Returned by a launcher for a shape or family it has no instantiation for.
// Not a cudaError_t value; the Python wrapper raises on it.
constexpr int kUnsupported = -1;

// The (state width, input width) pairs the tighten and OCP kernels are
// instantiated for: quadrotor (12, 4), cartpole (4, 1), two-link arm (4, 2).
// Calls f(NX, NU) with both as std::integral_constant, or returns
// kUnsupported for any other pair.
template <class F>
int dispatch_nx_nu(int nx, int nu, F&& f) {
  using std::integral_constant;
  if (nx == 12 && nu == 4) return f(integral_constant<int, 12>{}, integral_constant<int, 4>{});
  if (nx == 4 && nu == 1) return f(integral_constant<int, 4>{}, integral_constant<int, 1>{});
  if (nx == 4 && nu == 2) return f(integral_constant<int, 4>{}, integral_constant<int, 2>{});
  return kUnsupported;
}

// View of one lane of a lanes-layout tensor: element i of the per-lane
// flattened trailing block (everything between the tile and lane axes).
struct LaneView {
  float* base;  // points at (tile, 0, lane)
  int L;
  __device__ __forceinline__ float& operator[](int i) const { return base[(long)i * L]; }
};

struct ConstLaneView {
  const float* base;
  int L;
  __device__ __forceinline__ float operator[](int i) const { return base[(long)i * L]; }
};

// `per_lane` floats per scenario: offset of (tile, 0, lane).
__device__ __forceinline__ long lane_offset(int tile, int lane, long per_lane, int L) {
  return (long)tile * per_lane * L + lane;
}

__device__ __forceinline__ LaneView lane_view(float* p, long per_lane, int L) {
  return LaneView{p + lane_offset(blockIdx.x, threadIdx.x, per_lane, L), L};
}

__device__ __forceinline__ ConstLaneView lane_view(const float* p, long per_lane, int L) {
  return ConstLaneView{p + lane_offset(blockIdx.x, threadIdx.x, per_lane, L), L};
}

// Asynchronous 4-byte copies from global to shared memory (sm_80 and up):
// start one, close a group, and wait until at most N groups are still in flight.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace gpmpc

extern "C" const char* cudaGetErrorString_wrapper(int err);

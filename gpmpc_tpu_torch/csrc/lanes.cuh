// Shared helpers for the lanes-layout kernels of gpmpc_tpu_torch.
//
// Lanes layout: a tensor of shape (n_tiles, d0, d1, ..., L) holds one
// scenario per lane, scenario axis last. Each kernel runs one thread block
// per tile and one thread per lane, so thread `lane` of block `tile` reads
// element (tile, i, lane) at tile_base + i * L + lane: neighbouring threads
// touch neighbouring addresses and every warp access is one coalesced
// 128-byte transaction.
#pragma once

#include <cuda_runtime.h>

namespace gpmpc {

constexpr int NX = 12;  // quadrotor state width
constexpr int NU = 4;   // quadrotor input width

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

}  // namespace gpmpc

extern "C" const char* cudaGetErrorString_wrapper(int err);

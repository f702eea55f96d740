// Blocking and loads shared by the bit-plane GeMV sources
// (`bitplane_gemv.cu`, `experts_mma.cu`): a block of 8 warps owns a strip
// of 128 output columns, a lane 4 neighbouring columns, loaded as one
// 16-byte int4 a plane word.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;             // output columns per lane
constexpr int kStrip = 32 * kCols;   // output columns per block
constexpr int kMaxTiles = 8;         // tiles per block (B1's shared sums)

// 4 int32 words at p[0..3] (columns m..m+3), zero past M
__device__ __forceinline__ int4 load4(const int32_t* p, int m, int M,
                                      bool vec) {
  if (vec) return m < M ? __ldg(reinterpret_cast<const int4*>(p))
                        : make_int4(0, 0, 0, 0);
  int v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = m + c < M ? __ldg(p + c) : 0;
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 load4f(const float* p, int m, int M,
                                         bool vec) {
  if (vec) return m < M ? __ldg(reinterpret_cast<const float4*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = m + c < M ? __ldg(p + c) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

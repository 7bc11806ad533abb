// Warp-wide dot product shared by the dense kernels of this directory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kThreads = 256;            // threads per block in every kernel here
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// <x, w> over d floats, computed by one whole warp and returned to every
// lane. x is walked with 16-byte loads once its address is 16-byte aligned
// (a scalar head of at most three elements gets it there; rows of a (B, d)
// matrix with d % 4 != 0 start at any 4-byte offset). w uses 16-byte loads
// when it has the same alignment as x and four scalar loads otherwise. The
// lane-to-element mapping and the reduction tree are fixed, so repeated
// calls on the same inputs give the same bits.
__device__ __forceinline__ float warp_dot(const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          int d, int lane) {
  int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(x) & 15u)) & 15u) >> 2);
  if (head > d) head = d;
  float acc = 0.f;
  if (lane < head) acc = __ldg(x + lane) * __ldg(w + lane);
  const int n4 = (d - head) >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const float* wb = w + head;
  if ((reinterpret_cast<uintptr_t>(wb) & 15u) == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(wb);
#pragma unroll 4
    for (int k = lane; k < n4; k += 32) {
      const float4 a = __ldg(x4 + k);
      const float4 b = __ldg(w4 + k);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < n4; k += 32) {
      const float4 a = __ldg(x4 + k);
      const float* wk = wb + 4 * k;
      acc = fmaf(a.x, __ldg(wk), acc);
      acc = fmaf(a.y, __ldg(wk + 1), acc);
      acc = fmaf(a.z, __ldg(wk + 2), acc);
      acc = fmaf(a.w, __ldg(wk + 3), acc);
    }
  }
  for (int j = head + 4 * n4 + lane; j < d; j += 32) acc = fmaf(__ldg(x + j), __ldg(w + j), acc);
  return warp_sum(acc);
}

}  // namespace repro_torch

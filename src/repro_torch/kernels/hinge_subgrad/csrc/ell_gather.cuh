// Gather-dot over padded-ELL rows and the shared-memory bitmap of a
// touched-block map, shared by the sparse kernels of this directory: the
// gather-dot by ell_margins (sparse.cu) and ell_scores_prefetch
// (predict.cu), the bitmap's size by ell_margins_prefetch (sparse.cu),
// which builds and reads it in its own way, and the bitmap itself by
// ell_scores_prefetch.
//
// The TPU kernels contract only the d-blocks named in their map, so with a
// map one slot too short they lose the dropped blocks' entries. A kernel
// here keeps that meaning by building a bitmap of the map (one bit per
// d-block) in shared memory and counting an entry only if its block's bit
// is set. Both ways of building the map give distinct ids, so the bitmap holds exactly
// the set of blocks the TPU kernel's slot walk visits; sentinel slots
// (id >= n_d_blocks) set no bit.
#pragma once

#include "warp.cuh"

namespace repro_torch {

// Words of a bitmap over n_d_blocks blocks.
__host__ __device__ __forceinline__ int bitmap_words(int n_d_blocks) {
  return (n_d_blocks + 31) >> 5;
}

// Fill bitmap (bitmap_words(n_d_blocks) words of shared memory) with the
// ids[0, n_ids) that lie in [0, n_d_blocks). Every thread of the block calls
// it; it ends at a barrier. The atomics are integer ORs, so the result does
// not depend on their order.
__device__ __forceinline__ void build_block_bitmap(unsigned* bitmap, const int* __restrict__ ids,
                                                   int n_ids, int n_d_blocks) {
  const int words = bitmap_words(n_d_blocks);
  for (int q = threadIdx.x; q < words; q += static_cast<int>(blockDim.x)) bitmap[q] = 0u;
  __syncthreads();
  for (int j = threadIdx.x; j < n_ids; j += static_cast<int>(blockDim.x)) {
    const int bid = __ldg(ids + j);
    if (bid >= 0 && bid < n_d_blocks) atomicOr(bitmap + (bid >> 5), 1u << (bid & 31));
  }
  __syncthreads();
}

// sum_e v[e] * w[c[e]] over one row's k entries, by one whole warp (lanes
// stride over k, then a fixed shuffle tree); pad entries (v = 0) and columns
// outside [0, d) add nothing. With a bitmap, only entries whose d-block
// c[e] / blk_d is set count.
__device__ __forceinline__ float row_gather_dot(const int* __restrict__ c,
                                                const float* __restrict__ v,
                                                const float* __restrict__ w,
                                                int k, int d, int lane,
                                                const unsigned* bitmap, int blk_d) {
  float acc = 0.f;
  for (int e = lane; e < k; e += 32) {
    const float val = __ldg(v + e);
    const int col = __ldg(c + e);
    if (val == 0.f || static_cast<unsigned>(col) >= static_cast<unsigned>(d)) continue;
    if (bitmap != nullptr) {
      const int blk = col / blk_d;
      if (!((bitmap[blk >> 5] >> (blk & 31)) & 1u)) continue;
    }
    acc = fmaf(val, __ldg(w + col), acc);
  }
  return warp_sum(acc);
}

// Let kernel take smem bytes of dynamic shared memory (above 48 KB only
// after this opt-in).
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace repro_torch

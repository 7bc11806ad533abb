// Gather-dot over padded-ELL rows, shared by the sparse kernels of this
// directory: the margins kernel of sparse.cu (ell_margins and
// ell_margins_coeff without a map, ell_margins_prefetch and
// ell_margins_prefetch_coeff with one) and ell_scores_prefetch (predict.cu).
//
// A row is held tpr threads wide (margin_row_threads: the fewest whole warps
// whose kRowEntries registers each hold its k entries), slot j of lane l
// holding entry l + j * tpr of a wave, so that each load instruction of a
// warp reads 32 consecutive entries. A thread puts a wave's entries in
// flight at once (load_wave), then the W value of every slot that can count
// (gather_wave), and adds the slots it keeps in slot order with fmaf
// (add_wave): two dependent round trips a wave. Rows past 4 * 128 entries
// are walked in waves of tpr * kRowEntries.
//
// The TPU kernels contract only the d-blocks named in their map, so with a
// map one slot too short they lose the dropped blocks' entries. A kernel
// here keeps that meaning by building a bitmap of the map (one bit per
// d-block) in shared memory and keeping an entry only if its block's bit is
// set (wave_in_map). Both ways of building the map give distinct ids, so the
// bitmap holds exactly the set of blocks the TPU kernel's slot walk visits;
// sentinel slots (id >= n_d_blocks) set no bit. With a sound map every entry
// that can count is kept, so the sum is the same sequence of fmafs as
// without a map: the same bits.
#pragma once

#include "warp.cuh"

namespace repro_torch {

constexpr int kRowEntries = 4;       // entries a thread holds at once
constexpr int kMarginThreads = 128;  // most threads of a row, and of a margins block

// Words of a bitmap over n_d_blocks blocks.
__host__ __device__ __forceinline__ int bitmap_words(int n_d_blocks) {
  return (n_d_blocks + 31) >> 5;
}

// Threads of a row: the fewest whole warps (one, two or four) whose
// kRowEntries registers each hold the row's k entries; past 4 * 128
// entries four warps walk the row in waves of 512.
__host__ __device__ __forceinline__ int margin_row_threads(int k) {
  int t = 32;
  while (t < kMarginThreads && t * kRowEntries < k) t *= 2;
  return t;
}

// The shift that divides by blk_d when it is a power of two, else -1.
inline int block_shift(int blk_d) {
  int shift = 0;
  while ((1 << shift) < blk_d) ++shift;
  return (1 << shift) == blk_d ? shift : -1;
}

// The entries [s, s + tpr * kRowEntries) of a row, kRowEntries a thread
// (entry s + lane + j * tpr in slot j; past k or in a dead row, val 0).
__device__ __forceinline__ void load_wave(int (&c)[kRowEntries], float (&v)[kRowEntries],
                                          const int* __restrict__ cols,
                                          const float* __restrict__ vals, int k, int s,
                                          int lane, int tpr, bool live) {
#pragma unroll
  for (int j = 0; j < kRowEntries; ++j) {
    const int e = s + lane + j * tpr;
    const bool in = live && e < k;
    c[j] = in ? __ldg(cols + e) : 0;
    v[j] = in ? __ldg(vals + e) : 0.f;
  }
}

// Bit j set for each slot that can count: a nonzero value in a column of
// [0, d).
__device__ __forceinline__ unsigned wave_counts(const int (&c)[kRowEntries],
                                                const float (&v)[kRowEntries], int d) {
  unsigned use = 0u;
#pragma unroll
  for (int j = 0; j < kRowEntries; ++j) {
    if (v[j] != 0.f && static_cast<unsigned>(c[j]) < static_cast<unsigned>(d)) use |= 1u << j;
  }
  return use;
}

// The slots of `use` whose d-block col / blk_d (a shift by blk_shift when
// blk_d is a power of two) is set in the bitmap (the wrappers see to it
// that a column below d has its block below n_d_blocks).
__device__ __forceinline__ unsigned wave_in_map(const int (&c)[kRowEntries], unsigned use,
                                                const unsigned* bitmap, int blk_d,
                                                int blk_shift) {
  unsigned keep = 0u;
#pragma unroll
  for (int j = 0; j < kRowEntries; ++j) {
    if (!((use >> j) & 1u)) continue;
    const int blk = blk_shift >= 0 ? c[j] >> blk_shift : c[j] / blk_d;
    if ((bitmap[blk >> 5] >> (blk & 31)) & 1u) keep |= 1u << j;
  }
  return keep;
}

// Wi[col] of every slot of `use`, all in flight together; 0 elsewhere.
__device__ __forceinline__ void gather_wave(float (&w)[kRowEntries], const int (&c)[kRowEntries],
                                            unsigned use, const float* __restrict__ Wi) {
#pragma unroll
  for (int j = 0; j < kRowEntries; ++j) w[j] = ((use >> j) & 1u) ? __ldg(Wi + c[j]) : 0.f;
}

// acc plus, in slot order, val * W[col] of the slots of `keep`.
__device__ __forceinline__ float add_wave(float acc, unsigned keep,
                                          const float (&v)[kRowEntries],
                                          const float (&w)[kRowEntries]) {
#pragma unroll
  for (int j = 0; j < kRowEntries; ++j) {
    if ((keep >> j) & 1u) acc = fmaf(v[j], w[j], acc);
  }
  return acc;
}

// Set the bits of the map ids[0, n_ids) that lie in [0, n_d_blocks): the
// kSlots ids this thread loaded up front (bid, -1 for none; slot tid + q *
// nt), then every further slot from kSlots * nt on. Call between the barrier
// after the bitmap was zeroed and the one before it is read. The atomics
// are integer ORs, so the result does not depend on their order.
template <int kSlots>
__device__ __forceinline__ void set_map_bits(unsigned* bitmap, const int (&bid)[kSlots],
                                             const int* __restrict__ ids, int n_ids,
                                             int n_d_blocks, int tid, int nt) {
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    if (bid[q] >= 0 && bid[q] < n_d_blocks) atomicOr(bitmap + (bid[q] >> 5), 1u << (bid[q] & 31));
  }
  for (int j = kSlots * nt + tid; j < n_ids; j += nt) {  // a map wider than the slots
    const int id = __ldg(ids + j);
    if (id >= 0 && id < n_d_blocks) atomicOr(bitmap + (id >> 5), 1u << (id & 31));
  }
}

// Let kernel take smem bytes of dynamic shared memory (above 48 KB only
// after this opt-in).
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace repro_torch

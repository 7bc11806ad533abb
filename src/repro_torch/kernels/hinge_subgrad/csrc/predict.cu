// Serving kernels for Hopper (sm_90a): dense_scores and
// ell_scores_prefetch. Plain C entry points, loaded with ctypes by
// repro_torch/kernels/hinge_subgrad/predict.py; each returns
// cudaGetLastError() after its launch.
//
// dense_scores replaces src/repro/kernels/hinge_subgrad/predict.py
// dense_scores (pallas_call at :88): S = X W^T for a (B, d) query batch
// against (C, d) class weights, and labels = first-occurrence argmax over
// classes c < n_classes, in one launch. It reads 4(Bd + Cd) bytes and writes
// 4(BC + B) for 2BCd flops: at the C of a linear SVM (1 binary, a few
// one-vs-rest) HBM bandwidth bounds it. One warp per query row walks X with
// 16-byte loads (warp_dot) once per class; after the first class the row
// comes from L1/L2.
//
// ell_scores_prefetch replaces predict.py ell_scores_prefetch (pallas_call
// at :169): S[b, c] = sum_k vals[b, k] * W[c, cols[b, k]] over a (B, k)
// padded-ELL query batch, counting only the entries whose d-block
// (col / blk_d) is in the batch-wide touched-block map, and the same argmax.
// The TPU kernel walks the map slot by slot, DMAs one (Cp, blk_d) block of W
// per live slot, gathers with a one-hot matrix product and skips sentinel
// slots, which alias a zero block appended after W. Here the block builds a
// bitmap of the map in shared memory (ell_gather.cuh) and each warp gathers
// its row's entries directly: one warp per query row, lanes striding over k,
// a loop over classes, lane 0 writing S and the label. It moves
// 4(2Bk + BkC + n_blocks_max + BC + B) bytes for 2BkC flops, a few
// kilobytes at the serving buckets' shapes, so launch latency and the
// dependent index-then-weight loads bound it, not bandwidth.
//
// Both kernels take W as (C, d) unpadded: no 128-lane class padding and no
// zero landing block. The argmax runs over the first n_classes rows with a
// strict '>' scan, which keeps the first occurrence of a tie as jnp.argmax
// does; an all-pad row scores 0 everywhere and gets class 0. Fixed lane
// mappings and a fixed shuffle tree, no float atomics: a rerun gives the
// same bits.
#include <math.h>

#include "ell_gather.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kThreads)
dense_scores_kernel(const float* __restrict__ X, const float* __restrict__ W,
                    float* __restrict__ S, int* __restrict__ labels,
                    int B, int d, int C, int n_classes) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together, so the shuffles stay full
  const int lane = threadIdx.x & 31;
  const float* x = X + static_cast<size_t>(b) * d;
  float best = -INFINITY;
  int arg = 0;
  for (int c = 0; c < C; ++c) {
    const float s = warp_dot(x, W + static_cast<size_t>(c) * d, d, lane);
    if (lane == 0) {
      S[static_cast<size_t>(b) * C + c] = s;
      if (c < n_classes && s > best) {
        best = s;
        arg = c;
      }
    }
  }
  if (lane == 0) labels[b] = arg;
}

__global__ void __launch_bounds__(kThreads)
ell_scores_prefetch_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                           const float* __restrict__ W, const int* __restrict__ block_ids,
                           float* __restrict__ S, int* __restrict__ labels, int B, int k,
                           int d, int C, int n_classes, int n_blocks_max, int blk_d,
                           int n_d_blocks) {
  extern __shared__ unsigned bitmap[];  // one bit per d-block of the batch's map
  build_block_bitmap(bitmap, block_ids, n_blocks_max, n_d_blocks);
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // after the barriers; whole warps leave together
  const int lane = threadIdx.x & 31;
  const int* c = cols + static_cast<size_t>(b) * k;
  const float* v = vals + static_cast<size_t>(b) * k;
  float best = -INFINITY;
  int arg = 0;
  for (int cls = 0; cls < C; ++cls) {
    const float s = row_gather_dot(c, v, W + static_cast<size_t>(cls) * d, k, d, lane,
                                   bitmap, blk_d);
    if (lane == 0) {
      S[static_cast<size_t>(b) * C + cls] = s;
      if (cls < n_classes && s > best) {
        best = s;
        arg = cls;
      }
    }
  }
  if (lane == 0) labels[b] = arg;
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// X (B, d), W (C, d) float32 contiguous -> S (B, C) float32, labels (B,) int32.
extern "C" int dense_scores(const void* X, const void* W, void* S, void* labels,
                            int B, int d, int C, int n_classes, void* stream) {
  if (B > 0) {
    dense_scores_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(X), static_cast<const float*>(W),
        static_cast<float*>(S), static_cast<int*>(labels), B, d, C, n_classes);
  }
  return static_cast<int>(cudaGetLastError());
}

// cols, vals (B, k) int32 / float32, W (C, d), block_ids (n_blocks_max,) int32
// -> S (B, C) float32, labels (B,) int32, counting only the entries whose
// d-block is in block_ids; ids >= n_d_blocks are sentinels.
extern "C" int ell_scores_prefetch(const void* cols, const void* vals, const void* W,
                                   const void* block_ids, void* S, void* labels, int B, int k,
                                   int d, int C, int n_classes, int n_blocks_max, int blk_d,
                                   int n_d_blocks, void* stream) {
  const size_t smem = static_cast<size_t>(bitmap_words(n_d_blocks)) * sizeof(unsigned);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(ell_scores_prefetch_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B > 0) {
    ell_scores_prefetch_kernel<<<(B + kWarps - 1) / kWarps, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(W), static_cast<const int*>(block_ids),
        static_cast<float*>(S), static_cast<int*>(labels), B, k, d, C, n_classes,
        n_blocks_max, blk_d, n_d_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

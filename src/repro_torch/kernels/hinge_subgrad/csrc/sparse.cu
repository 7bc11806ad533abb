// Sparse (padded-ELL) Pegasos half-step kernels for Hopper (sm_90a):
// ell_margins, ell_grad_update (the sweep pair) and ell_margins_prefetch,
// ell_grad_update_prefetch (the touched-block pair). Plain C entry points,
// loaded with ctypes by repro_torch/kernels/hinge_subgrad/sparse.py; each
// returns cudaGetLastError() after its launch.
//
// Inputs are (m, B, k) minibatch planes: cols int32 and vals float32, with
// pad entries (col = 0, val = 0) and pad rows y = 0, both inert. W is the
// (m, d) weight plane with no padding. An entry whose column lies outside
// [0, d) adds nothing, as an index past the padded width matched no lane of
// the TPU kernels' one-hot blocks.
//
// Replaces src/repro/kernels/hinge_subgrad/sparse.py:
//   ell_margins               (pallas_call at :100, body :74)
//   ell_grad_update           (pallas_call at :138, body :122)
//   ell_margins_prefetch      (pallas_call at :210, body :172)
//   ell_grad_update_prefetch  (pallas_call at :259, body :234)
// The TPU kernels walk w in d-blocks and gather or scatter with a one-hot
// (B*k, blk_d) matrix product, the TPU's way to gather on its matrix unit;
// the prefetch pair scalar-prefetches a map of live block ids so that each
// grid step DMAs one live block, and aliases the map's sentinel slots to an
// all-zero block appended after w. Here a thread reads its own indices and
// gathers directly, so no one-hot, no DMA steering and no landing pad exist.
//
// What bounds them: at the paper's CCAT shape (m = 10, B = 1, k = 76) each
// launch moves a few kilobytes (and the sweep grad all of W, 1.9 MB), so
// launch latency and the dependent index-then-value loads bound the margin
// and prefetch kernels, and device-memory bandwidth the sweep grad.
//
// Design.
// * Margins, both schedules: one warp per (node, row). Lanes stride over k,
//   load (col, val), gather W[i, col], multiply-add; a fixed shuffle tree
//   reduces the warp; lane 0 writes y * sum. The prefetch kernel first
//   builds a bitmap of the node's map (n_d_blocks bits) in shared memory
//   and counts an entry only if its block col / blk_d is set, which is
//   exactly the set of entries the TPU kernel contracts: with a sound cap
//   this equals the sweep, with an undersized cap it drops what the TPU
//   kernel drops. Sentinel slots (id >= n_d_blocks) set no bit and so read
//   nothing of W.
// * Grad, both schedules: one block per (node, output tile of blk_d lanes),
//   which owns its slice of the output, so there are no atomics and the
//   result is deterministic by construction, as on the TPU. The block
//   stages the node's B*k pairs (lane in tile, coeff_b * val) in shared
//   memory, kChunk at a time, so B*k has no limit; each thread owns the
//   lanes tid + q * kThreads of the tile and adds, in entry order, the
//   contributions that land on them. Cost is O(B*k) per tile, as the TPU's
//   one-hot contraction is. The sweep grad then writes
//   (1 - s0) * w + s1 * g over all of W; the prefetch grad writes the raw
//   bucket G[i, j, :] (zero for a sentinel slot) and the wrapper folds it.
#include "ell_gather.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 1024;   // entries staged in shared memory at a time
constexpr int kMaxLanesPerThread = 4;
constexpr int kMaxTile = kThreads * kMaxLanesPerThread;   // largest blk_d

__global__ void __launch_bounds__(kThreads)
ell_margins_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                   const float* __restrict__ W, const float* __restrict__ y,
                   float* __restrict__ out, int m, int B, int k, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(m) * B) return;  // whole warps leave together
  const int i = static_cast<int>(row / B);
  const int lane = threadIdx.x & 31;
  const float dot = row_gather_dot(cols + row * k, vals + row * k,
                                   W + static_cast<size_t>(i) * d, k, d, lane, nullptr, 1);
  if (lane == 0) out[row] = __ldg(y + row) * dot;
}

__global__ void __launch_bounds__(kThreads)
ell_margins_prefetch_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                            const float* __restrict__ W, const float* __restrict__ y,
                            const int* __restrict__ block_ids, float* __restrict__ out,
                            int B, int k, int d, int n_blocks_max, int blk_d,
                            int n_d_blocks) {
  extern __shared__ unsigned bitmap[];  // one bit per d-block of this node
  const int i = blockIdx.y;
  build_block_bitmap(bitmap, block_ids + static_cast<size_t>(i) * n_blocks_max, n_blocks_max,
                     n_d_blocks);
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const long long row = static_cast<long long>(i) * B + b;
  const int lane = threadIdx.x & 31;
  const float dot = row_gather_dot(cols + row * k, vals + row * k,
                                   W + static_cast<size_t>(i) * d, k, d, lane, bitmap, blk_d);
  if (lane == 0) out[row] = __ldg(y + row) * dot;
}

// g[lane] for the lanes [base, base + lanes) of node i that this thread
// owns (lane = tid + q * kThreads): the sum, in entry order, of
// coeff_b * vals[b, e] over the node's entries with cols[b, e] == base + lane.
__device__ __forceinline__ void tile_scatter(const int* __restrict__ cols,
                                             const float* __restrict__ vals,
                                             const float* __restrict__ coeff,
                                             int B, int k, int base, int lanes,
                                             float (&acc)[kMaxLanesPerThread]) {
  __shared__ int s_lane[kChunk];
  __shared__ float s_contrib[kChunk];
  const long long n = static_cast<long long>(B) * k;
  for (long long s = 0; s < n; s += kChunk) {
    const int cnt = static_cast<int>(n - s < kChunk ? n - s : kChunk);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const long long flat = s + e;
      const int local = __ldg(cols + flat) - base;
      s_lane[e] = (static_cast<unsigned>(local) < static_cast<unsigned>(lanes)) ? local : -1;
      s_contrib[e] = __ldg(coeff + flat / k) * __ldg(vals + flat);
    }
    __syncthreads();
    for (int e = 0; e < cnt; ++e) {
      const int l = s_lane[e];
#pragma unroll
      for (int q = 0; q < kMaxLanesPerThread; ++q) {
        if (l == static_cast<int>(threadIdx.x) + q * kThreads) acc[q] += s_contrib[e];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ell_grad_update_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                       const float* __restrict__ W, const float* __restrict__ coeff,
                       float* __restrict__ out, int B, int k, int d, int blk_d,
                       float one_minus_s0, float s1) {
  const int i = blockIdx.y;
  const int base = blockIdx.x * blk_d;
  const int lanes = min(blk_d, d - base);
  const size_t plane = static_cast<size_t>(i) * B * k;
  float acc[kMaxLanesPerThread] = {0.f, 0.f, 0.f, 0.f};
  tile_scatter(cols + plane, vals + plane, coeff + static_cast<size_t>(i) * B, B, k,
               base, lanes, acc);
  const float* wi = W + static_cast<size_t>(i) * d + base;
  float* oi = out + static_cast<size_t>(i) * d + base;
#pragma unroll
  for (int q = 0; q < kMaxLanesPerThread; ++q) {
    const int lane = threadIdx.x + q * kThreads;
    if (lane < lanes) oi[lane] = one_minus_s0 * __ldg(wi + lane) + s1 * acc[q];
  }
}

__global__ void __launch_bounds__(kThreads)
ell_grad_update_prefetch_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                                const float* __restrict__ coeff,
                                const int* __restrict__ block_ids, float* __restrict__ G,
                                int B, int k, int n_blocks_max, int blk_d, int n_d_blocks) {
  const int i = blockIdx.y;
  const int j = blockIdx.x;
  const int bid = __ldg(block_ids + static_cast<size_t>(i) * n_blocks_max + j);
  float* g = G + (static_cast<size_t>(i) * n_blocks_max + j) * blk_d;
  if (bid < 0 || bid >= n_d_blocks) {  // sentinel slot: a zero bucket
    for (int lane = threadIdx.x; lane < blk_d; lane += kThreads) g[lane] = 0.f;
    return;  // uniform over the block: no thread is left at a barrier
  }
  const size_t plane = static_cast<size_t>(i) * B * k;
  float acc[kMaxLanesPerThread] = {0.f, 0.f, 0.f, 0.f};
  tile_scatter(cols + plane, vals + plane, coeff + static_cast<size_t>(i) * B, B, k,
               bid * blk_d, blk_d, acc);
#pragma unroll
  for (int q = 0; q < kMaxLanesPerThread; ++q) {
    const int lane = threadIdx.x + q * kThreads;
    if (lane < blk_d) g[lane] = acc[q];
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// cols, vals (m, B, k), W (m, d), y (m, B) -> out (m, B) = y * (X w).
extern "C" int ell_margins(const void* cols, const void* vals, const void* W,
                           const void* y, void* out, int m, int B, int k, int d,
                           void* stream) {
  const long long rows = static_cast<long long>(m) * B;
  if (rows > 0) {
    ell_margins_kernel<<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(W), static_cast<const float*>(y),
        static_cast<float*>(out), m, B, k, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// As ell_margins, counting only entries whose d-block (col / blk_d) is in the
// node's row of block_ids (m, n_blocks_max); ids >= n_d_blocks are sentinels.
extern "C" int ell_margins_prefetch(const void* cols, const void* vals, const void* W,
                                    const void* y, const void* block_ids, void* out,
                                    int m, int B, int k, int d, int n_blocks_max,
                                    int blk_d, int n_d_blocks, void* stream) {
  const size_t smem = static_cast<size_t>(bitmap_words(n_d_blocks)) * sizeof(unsigned);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(ell_margins_prefetch_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m > 0 && B > 0) {
    const dim3 grid((B + kWarps - 1) / kWarps, m);
    ell_margins_prefetch_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(W), static_cast<const float*>(y),
        static_cast<const int*>(block_ids), static_cast<float*>(out),
        B, k, d, n_blocks_max, blk_d, n_d_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// cols, vals (m, B, k), W (m, d), coeff (m, B) -> out (m, d) =
// (1 - s0) W + s1 scatter(coeff_b vals[b, e] -> cols[b, e]), in tiles of blk_d.
extern "C" int ell_grad_update(const void* cols, const void* vals, const void* W,
                               const void* coeff, void* out, int m, int B, int k, int d,
                               int blk_d, float s0, float s1, void* stream) {
  if (blk_d < 1 || blk_d > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0 && d > 0) {
    const dim3 grid((d + blk_d - 1) / blk_d, m);
    ell_grad_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(W), static_cast<const float*>(coeff),
        static_cast<float*>(out), B, k, d, blk_d, 1.f - s0, s1);
  }
  return static_cast<int>(cudaGetLastError());
}

// cols, vals (m, B, k), coeff (m, B), block_ids (m, n_blocks_max) ->
// G (m, n_blocks_max, blk_d): bucket j of node i holds the scatter of
// coeff_b vals[b, e] onto lanes cols[b, e] - block_ids[i, j] * blk_d.
extern "C" int ell_grad_update_prefetch(const void* cols, const void* vals,
                                        const void* coeff, const void* block_ids, void* G,
                                        int m, int B, int k, int n_blocks_max, int blk_d,
                                        int n_d_blocks, void* stream) {
  if (blk_d < 1 || blk_d > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0 && n_blocks_max > 0) {
    const dim3 grid(n_blocks_max, m);
    ell_grad_update_prefetch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(coeff), static_cast<const int*>(block_ids),
        static_cast<float*>(G), B, k, n_blocks_max, blk_d, n_d_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

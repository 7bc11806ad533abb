// Dense Pegasos half-step kernels for Hopper (sm_90a): fleet_half_step,
// margins and grad_update. Plain C entry points, loaded with ctypes by
// repro_torch/kernels/hinge_subgrad/hinge_subgrad.py; each returns
// cudaGetLastError() after its launch.
//
// fleet_half_step replaces src/repro/kernels/hinge_subgrad/hinge_subgrad.py
// fleet_half_step (pallas_call at :106, body _fleet_kernel at :80). Per node
// i: m_b = y_b <X_i[b], w_i>, coeff_b = 1[m_b < 1] y_b row_mask_b,
// W_half_i = (1 - s0) w_i + s1 (coeff^T X_i). It moves 4(mBd + 2md + mB + B)
// bytes for 4mBd flops, so HBM bandwidth bounds it: 0.30 us at the paper's
// (m, B, d) = (10, 1, 8315), about 1 MB. The TPU kernel kept the whole
// (B, d) tile in VMEM and fell back to two kernels above a VMEM budget. Here
// each node is a thread-block cluster of CL blocks (the wrapper picks the
// largest CL in {1, 2, 4, 8, 16} with m CL <= the SM count: 8 at m = 10,
// 80 blocks, where one block a node filled 10 SMs; on an H100 SXM clusters
// of 8 took 5.47 us there, of 16 5.61), each block an even share
// of the d columns:
//  * phase 1: the block's warps split its rows x column share evenly (a
//    row's share is cut into up to 8 pieces when B < 8, so B = 1 still uses
//    every warp), read X_i's slice once from HBM with coalesced scalar loads
//    (rows of d = 8,315 start at every 4-byte phase, so no alignment is
//    assumed), four a lane in flight at once, keep it in shared memory when
//    B x share fits, and leave each row's partial margin in the block's
//    shared memory; cluster.sync();
//  * every block then reads the CL partials of each row through distributed
//    shared memory (map_shared_rank), in rank order, so all blocks of a node
//    get the same margin bits and the same coeff, with no atomics;
//  * phase 2: each thread owns columns of the share and sums coeff_b X_i[b, j]
//    over b in order, from shared memory (or from L2 when the share does not
//    fit: no tile limit and no fallback). A block arrives at the cluster
//    barrier once it has read its peers' partials and waits on it only
//    before it exits, so its shared memory outlives every read of it while
//    phase 2 overlaps the barrier.
// Fixed orders everywhere: repeated runs are bit-identical.
//
// margins replaces hinge_subgrad.py margins (pallas_call at :63), vmapped
// over the nodes as the reference's unfused step runs it: y_i (X_i w_i) for
// the whole fleet's (m, B, d) minibatch in one launch. It moves 4(mBd + md +
// 2mB) bytes for 2mBd flops, so HBM bandwidth bounds it: 0.20 us at the
// paper's (10, 1, 8315), 665 KB. The cost is latency: one warp per row left
// 10 of 132 SMs working and each warp ~260 dependent passes over its row.
// So each (node, row) is a thread-block cluster of CL blocks (the wrapper's
// margins_cluster: the largest power of two up to 16 with at most two
// blocks an SM, so 16 at m B = 10 and at one row, 1 from 2 rows an SM up),
// each block an even share of d that its 256 threads stride over with
// coalesced scalar loads, four a lane in flight (no alignment is assumed);
// the warps' partials are summed in warp order in shared memory, each block
// pushes its sum into rank 0's shared memory, and rank 0 adds them in rank
// order. No atomics: reruns are bit-identical.
//
// grad_update replaces hinge_subgrad.py grad_update (pallas_call at :151),
// vmapped over the nodes as the reference's unfused step runs it: W_half_i =
// (1 - s0) w_i + s1 coeff_i^T X_i for the whole fleet's (m, B, d) minibatch
// in one launch (one node's (B, d) is the m = 1 case). It moves 4m(Bd + 2d +
// B) bytes for m(2Bd + 3d) flops, so HBM bandwidth bounds it: 0.30 us at the
// paper's (10, 1, 8315), 998 KB, against about 2 us for any launch, hence
// one launch for the fleet. Past the launch the cost at this size is each
// thread's chain of dependent instructions before its loads, so a node is a
// grid row (blockIdx.y) and no thread divides by d or walks a loop it does
// not need (tools/kernel_probes.py times blocks of 128 threads and B = 1
// through the rows kernel's loop). Two kernels, blocks of kGradThreads =
// 256 threads, one column a thread, ceil(d / 256) blocks a node:
//  * B = 1, the paper's runs: X, W and out share the flat (m d) layout, so
//    it is an elementwise pass (330 blocks at the paper's shape);
//  * B != 1: a thread sums its column over b in order, with kRows rows and
//    their coefficients in flight at once.
// Either way each element is g = a chain of fmaf over b from +0, and out =
// __fadd_rn(__fmul_rn(w, 1 - s0), __fmul_rn(s1, g)), the plain version's
// two roundings: the fleet launch is the per-node launches stacked, bit for
// bit. The TPU kernel's (8, 128) blocking and padding do not carry over:
// every edge is masked here.
#include <cooperative_groups.h>

#include <mutex>

#include "warp.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
constexpr int kPieceSlots = 16;  // row pieces when B < kWarps: B ceil(8 / B) <= 14
constexpr int kLoads = 4;        // loads a thread keeps in flight
constexpr int kRows = 4;         // rows of X a grad_update thread keeps in flight
constexpr int kGradThreads = kThreads;  // grad_update's block

// Start of part i of n items split into parts contiguous ranges, the first
// n % parts one item longer (python: predict.even_split).
__device__ __forceinline__ int split_start(int n, int parts, int i) {
  const int q = n / parts, r = n - q * parts;
  return i * q + (i < r ? i : r);
}

// Shared memory of one block, in floats: part (B), coeff (B), the row
// pieces' partials (kPieceSlots) and, when cached, X_i's slice (B x share).
__host__ __device__ constexpr size_t fleet_smem_floats(int B, int share, bool cache) {
  return 2 * static_cast<size_t>(B) + kPieceSlots +
         (cache ? static_cast<size_t>(B) * share : 0);
}

template <bool CACHE>
__global__ void __launch_bounds__(kThreads)
fleet_half_step_kernel(const float* __restrict__ X, const float* __restrict__ W,
                       const float* __restrict__ y, const float* __restrict__ row_mask,
                       float* __restrict__ out, int B, int d,
                       float one_minus_s0, float s1) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.x / CL;  // the node
  const int c0 = split_start(d, CL, rank);
  const int len = split_start(d, CL, rank + 1) - c0;  // this block's column share
  extern __shared__ float smem[];
  float* part = smem;               // (B,) this block's partial margin of each row
  float* coeff = part + B;          // (B,) the node's violator coefficients
  float* pieces = coeff + B;        // (kPieceSlots,)
  float* xs = pieces + kPieceSlots;  // (B, len) X_i's slice, when CACHE
  const float* Xi = X + static_cast<size_t>(i) * B * d + c0;
  const float* wi = W + static_cast<size_t>(i) * d + c0;
  const float* yi = y + static_cast<size_t>(i) * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // phase 1: unit u is piece p of row b; warp q takes units q, q + 8, ...
  const int P = B >= kWarps ? 1 : (kWarps + B - 1) / B;
  for (int u = warp; u < B * P; u += kWarps) {
    const int b = u / P, p = u - b * P;
    const int lo = split_start(len, P, p), hi = split_start(len, P, p + 1);
    const float* xr = Xi + static_cast<size_t>(b) * d;
    float acc = 0.f;
    for (int j0 = lo + lane; j0 < hi; j0 += 32 * kLoads) {
      float xv[kLoads], wv[kLoads];  // every load of the pass in flight at once
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int j = j0 + 32 * q;
        xv[q] = j < hi ? __ldg(xr + j) : 0.f;
        wv[q] = j < hi ? __ldg(wi + j) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int j = j0 + 32 * q;
        if (CACHE && j < hi) xs[static_cast<size_t>(b) * len + j] = xv[q];
        acc = fmaf(xv[q], wv[q], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      if (P == 1) part[b] = acc;
      else pieces[u] = acc;
    }
  }
  if (P > 1) {
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < B) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += pieces[threadIdx.x * P + p];
      part[threadIdx.x] = s;
    }
  }
  cluster.sync();  // every block's partials are written and visible to the cluster

  // the margins, every block the same: the CL partials of row b in rank order
  for (int b = threadIdx.x; b < B; b += kThreads) {
    float pr[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) pr[q] = q < CL ? cluster.map_shared_rank(part, q)[b] : 0.f;
    float dot = pr[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < CL) dot += pr[q];
    }
    const float yb = yi[b];
    coeff[b] = (yb * dot < 1.f ? yb : 0.f) * row_mask[b];
  }
  // done with the peers' partials: arrive now, wait before exiting
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();

  // phase 2: thread t owns columns t, t + 256, ... of the share
  for (int j0 = threadIdx.x; j0 < len; j0 += kThreads * kLoads) {
    float wv[kLoads], g[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = j0 + kThreads * q;
      wv[q] = j < len ? __ldg(wi + j) : 0.f;
      g[q] = 0.f;
    }
    for (int b = 0; b < B; ++b) {
      const float cb = coeff[b];
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int j = j0 + kThreads * q;
        if (j < len) {
          const float x = CACHE ? xs[static_cast<size_t>(b) * len + j]
                                : __ldg(Xi + static_cast<size_t>(b) * d + j);
          g[q] = fmaf(cb, x, g[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = j0 + kThreads * q;
      if (j < len) out[static_cast<size_t>(i) * d + c0 + j] = one_minus_s0 * wv[q] + s1 * g[q];
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");  // peers done with ours
}

// One cluster of CL blocks per row r (node r / B), each block a share of d.
// Each block pushes its partial into rank 0's shared memory; one cluster
// barrier after the loads (its arrival at entry proves every block has
// started, so rank 0's shared memory is live) and one after the pushes.
__global__ void __launch_bounds__(kThreads)
margins_cluster_kernel(const float* __restrict__ X, const float* __restrict__ W,
                       const float* __restrict__ y, float* __restrict__ out, int B, int d) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long r = blockIdx.x / CL;
  const int c0 = split_start(d, CL, rank);
  const int len = split_start(d, CL, rank + 1) - c0;
  const float* x = X + static_cast<size_t>(r) * d + c0;
  const float* w = W + static_cast<size_t>(r / B) * d + c0;
  __shared__ float warp_part[kWarps];
  __shared__ float parts[kMaxCluster];  // rank 0's: every block's partial, by rank
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  float acc = 0.f;
  for (int j0 = threadIdx.x; j0 < len; j0 += kThreads * kLoads) {
    float xv[kLoads], wv[kLoads];  // every load of the pass in flight at once
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = j0 + kThreads * q;
      xv[q] = j < len ? __ldg(x + j) : 0.f;
      wv[q] = j < len ? __ldg(w + j) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) acc = fmaf(xv[q], wv[q], acc);
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = acc;
  __syncthreads();
  float part = 0.f;
  if (threadIdx.x == 0) {
    part = warp_part[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) part += warp_part[q];
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // every block has started
  if (threadIdx.x == 0) *cluster.map_shared_rank(parts + rank, 0) = part;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");  // every push is in
  if (rank == 0 && threadIdx.x == 0) {
    float dot = parts[0];
    for (int q = 1; q < CL; ++q) dot += parts[q];
    out[r] = y[r] * dot;
  }
}

// B = 1: node blockIdx.y, column j = the thread's index in the node's
// blocks, element q = i d + j of the flat (m d) plane that X, W and out
// share: an elementwise pass. int indices: the C entry takes m d < 2^31 here.
__global__ void __launch_bounds__(kThreads)
grad_update_flat_kernel(const float* __restrict__ X, const float* __restrict__ W,
                        const float* __restrict__ coeff, float* __restrict__ out, int d,
                        float one_minus_s0, float s1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const int q = blockIdx.y * d + j;
  const float g = fmaf(__ldg(coeff + blockIdx.y), __ldg(X + q), 0.f);
  out[q] = __fadd_rn(__fmul_rn(__ldg(W + q), one_minus_s0), __fmul_rn(s1, g));
}

// B != 1, node blockIdx.y: thread t owns column j = its index in the node's
// blocks and sums it over b in order, the loads of kRows rows and their
// coefficients in flight at once.
__global__ void __launch_bounds__(kThreads)
grad_update_rows_kernel(const float* __restrict__ X, const float* __restrict__ W,
                        const float* __restrict__ coeff, float* __restrict__ out, int B, int d,
                        float one_minus_s0, float s1) {
  const int i = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const size_t row = static_cast<size_t>(i) * d + j;
  const float* xr = X + static_cast<size_t>(i) * B * d + j;
  const float* ci = coeff + static_cast<size_t>(i) * B;
  float g = 0.f;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    float x[kRows], c[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool in = b0 + r < B;
      c[r] = in ? __ldg(ci + b0 + r) : 0.f;
      x[r] = in ? __ldg(xr + static_cast<size_t>(b0 + r) * d) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (b0 + r < B) g = fmaf(c[r], x[r], g);
  }
  out[row] = __fadd_rn(__fmul_rn(__ldg(W + row), one_minus_s0), __fmul_rn(s1, g));
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

namespace {

// What launch_fleet<CACHE> has set up and checked on a device: the kernel's
// shared-memory ceiling and the largest cluster size known to fit with it.
// The training loop launches once an iteration with the same shape, so the
// attribute calls and the occupancy query run once, not every launch.
struct FleetReady {
  int dev = -1, cluster = 0;
  size_t smem = 0;
};
std::mutex fleet_mutex;

template <bool CACHE>
cudaError_t launch_fleet(const float* X, const float* W, const float* y, const float* row_mask,
                         float* out, int m, int B, int d, int CL, size_t smem, float s0,
                         float s1, int dev, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(fleet_half_step_kernel<CACHE>);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m * CL));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(CL);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    static FleetReady ready;
    std::lock_guard<std::mutex> lock(fleet_mutex);
    if (ready.dev != dev || ready.smem < smem || ready.cluster < CL) {
      cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e == cudaSuccess && CL > 8)
        e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      int fits = 0;  // a cluster that cannot be placed would fail at launch
      if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&fits, fn, &cfg);
      if (e != cudaSuccess) return e;
      if (fits < 1) return cudaErrorLaunchOutOfResources;
      ready = {dev, CL, smem};
    }
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, fleet_half_step_kernel<CACHE>, X, W, y, row_mask,
                                     out, B, d, 1.f - s0, s1);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// X (m, B, d), W (m, d), y (m, B), row_mask (B,) -> out (m, d); all float32,
// contiguous. s0 = lam * alpha, s1 = alpha / B, both formed in float32. Each
// node is a cluster of `cluster` blocks (1, 2, 4, 8 or 16; the wrapper's
// hinge_subgrad.fleet_cluster).
extern "C" int fleet_half_step(const void* X, const void* W, const void* y,
                               const void* row_mask, void* out, int m, int B, int d,
                               int cluster, float s0, float s1, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || d <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int share = (d + cluster - 1) / cluster;  // the largest column share
  const size_t cached = fleet_smem_floats(B, share, true) * sizeof(float);
  const size_t streamed = fleet_smem_floats(B, share, false) * sizeof(float);
  const float* Xf = static_cast<const float*>(X);
  const float* Wf = static_cast<const float*>(W);
  const float* yf = static_cast<const float*>(y);
  const float* mf = static_cast<const float*>(row_mask);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cached <= static_cast<size_t>(optin))
    e = launch_fleet<true>(Xf, Wf, yf, mf, of, m, B, d, cluster, cached, s0, s1, dev, st);
  else if (streamed <= static_cast<size_t>(optin))
    e = launch_fleet<false>(Xf, Wf, yf, mf, of, m, B, d, cluster, streamed, s0, s1, dev, st);
  else
    e = cudaErrorInvalidValue;  // B beyond the wrapper's limit
  return static_cast<int>(e);
}

// X (m, B, d), W (m, d), y (m, B) -> out (m, B) = y_i * (X_i w_i), each row
// a thread-block cluster of `cluster` blocks (1, 2, 4, 8 or 16; the
// wrapper's hinge_subgrad.margins_cluster).
extern "C" int margins(const void* X, const void* W, const void* y, void* out,
                       int m, int B, int d, int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(m) * B;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (rows * cluster > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* Xf = static_cast<const float*>(X);
  const float* Wf = static_cast<const float*>(W);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 8) {  // a non-portable cluster size: allowed once per device
    static int allowed_on = -1;
    static std::mutex mutex;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    std::lock_guard<std::mutex> lock(mutex);
    if (allowed_on != dev) {
      e = cudaFuncSetAttribute(reinterpret_cast<const void*>(margins_cluster_kernel),
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return static_cast<int>(e);
      allowed_on = dev;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, margins_cluster_kernel, Xf, Wf, yf, of, B, d);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// X (m, B, d), W (m, d), coeff (m, B) -> out (m, d) = (1 - s0) W_i + s1
// (coeff_i^T X_i) per node.
extern "C" int grad_update(const void* X, const void* W, const void* coeff, void* out, int m,
                           int B, int d, float s0, float s1, void* stream) {
  if (m <= 0 || d <= 0 || B < 0) return static_cast<int>(cudaGetLastError());
  if (m > 65535 || (B == 1 && static_cast<long long>(m) * d > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);  // the grid's y, and int indices
  const float* Xf = static_cast<const float*>(X);
  const float* Wf = static_cast<const float*>(W);
  const float* cf = static_cast<const float*>(coeff);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kGradThreads - 1) / kGradThreads, m);  // a thread a column
  if (B == 1)
    grad_update_flat_kernel<<<grid, kGradThreads, 0, st>>>(Xf, Wf, cf, of, d, 1.f - s0, s1);
  else
    grad_update_rows_kernel<<<grid, kGradThreads, 0, st>>>(Xf, Wf, cf, of, B, d, 1.f - s0, s1);
  return static_cast<int>(cudaGetLastError());
}

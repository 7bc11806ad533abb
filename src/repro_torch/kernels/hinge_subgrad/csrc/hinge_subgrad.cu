// Dense Pegasos half-step kernels for Hopper (sm_90a): fleet_half_step,
// margins and grad_update. Plain C entry points, loaded with ctypes by
// repro_torch/kernels/hinge_subgrad/hinge_subgrad.py; each returns
// cudaGetLastError() after its launch.
//
// fleet_half_step replaces src/repro/kernels/hinge_subgrad/hinge_subgrad.py
// fleet_half_step (pallas_call at :106, body _fleet_kernel at :80). Per node
// i: m_b = y_b <X_i[b], w_i>, coeff_b = 1[m_b < 1] y_b row_mask_b,
// W_half_i = (1 - s0) w_i + s1 (coeff^T X_i). It moves 4(mBd + 2md + mB + B)
// bytes for 4mBd flops, so HBM bandwidth bounds it. The TPU kernel kept the
// whole (B, d) tile in VMEM and fell back to two kernels above a VMEM budget;
// here one block per node streams X_i twice instead (phase 1 margins, one
// warp per row with 16-byte loads; phase 2 each thread owns columns and sums
// over b in a fixed order). The second read comes from L2 (the tile of the
// paper's reuters run is 33 KB), so there is no tile limit and no fallback.
// No atomics: repeated runs are bit-identical. With one block per node the
// grid is m blocks, 10 of the card's 132 SMs at the paper's m = 10.
//
// margins replaces hinge_subgrad.py margins (pallas_call at :63): y (X w) for
// one node's (B, d) minibatch, one warp per row. grad_update replaces
// hinge_subgrad.py grad_update (pallas_call at :151): (1 - s0) w + s1 coeff^T X,
// one thread per column with a fixed-order loop over B and the axpy fused.
// Both read X once and are bandwidth-bound; the TPU kernels' (8, 128)
// blocking and padding do not carry over: every edge is masked here.
#include "warp_dot.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kThreads)
fleet_half_step_kernel(const float* __restrict__ X, const float* __restrict__ W,
                       const float* __restrict__ y, const float* __restrict__ row_mask,
                       float* __restrict__ out, int B, int d,
                       float one_minus_s0, float s1) {
  extern __shared__ float coeff[];  // (B,) violator coefficients of this node
  const int i = blockIdx.x;
  const float* Xi = X + static_cast<size_t>(i) * B * d;
  const float* wi = W + static_cast<size_t>(i) * d;
  const float* yi = y + static_cast<size_t>(i) * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = warp; b < B; b += kWarps) {
    const float dot = warp_dot(Xi + static_cast<size_t>(b) * d, wi, d, lane);
    if (lane == 0) {
      const float yb = yi[b];
      coeff[b] = (yb * dot < 1.f ? yb : 0.f) * row_mask[b];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float g = 0.f;
    for (int b = 0; b < B; ++b) g = fmaf(coeff[b], Xi[static_cast<size_t>(b) * d + j], g);
    out[static_cast<size_t>(i) * d + j] = one_minus_s0 * wi[j] + s1 * g;
  }
}

__global__ void __launch_bounds__(kThreads)
margins_kernel(const float* __restrict__ X, const float* __restrict__ w,
               const float* __restrict__ y, float* __restrict__ out, int B, int d) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together, so the shuffles stay full
  const float dot = warp_dot(X + static_cast<size_t>(b) * d, w, d, threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) out[b] = y[b] * dot;
}

__global__ void __launch_bounds__(kThreads)
grad_update_kernel(const float* __restrict__ X, const float* __restrict__ w,
                   const float* __restrict__ coeff, float* __restrict__ out,
                   int B, int d, float one_minus_s0, float s1) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  float g = 0.f;
  for (int b = 0; b < B; ++b) g = fmaf(__ldg(coeff + b), __ldg(X + static_cast<size_t>(b) * d + j), g);
  out[j] = one_minus_s0 * w[j] + s1 * g;
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// X (m, B, d), W (m, d), y (m, B), row_mask (B,) -> out (m, d); all float32,
// contiguous. s0 = lam * alpha, s1 = alpha / B, both formed in float32.
extern "C" int fleet_half_step(const void* X, const void* W, const void* y,
                               const void* row_mask, void* out, int m, int B, int d,
                               float s0, float s1, void* stream) {
  const size_t smem = static_cast<size_t>(B) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fleet_half_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (m > 0 && d > 0) {
    fleet_half_step_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(X), static_cast<const float*>(W),
        static_cast<const float*>(y), static_cast<const float*>(row_mask),
        static_cast<float*>(out), B, d, 1.f - s0, s1);
  }
  return static_cast<int>(cudaGetLastError());
}

// X (B, d), w (d,), y (B,) -> out (B,) = y * (X w).
extern "C" int margins(const void* X, const void* w, const void* y, void* out,
                       int B, int d, void* stream) {
  if (B > 0) {
    margins_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(X), static_cast<const float*>(w),
        static_cast<const float*>(y), static_cast<float*>(out), B, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// X (B, d), w (d,), coeff (B,) -> out (d,) = (1 - s0) w + s1 (coeff^T X).
extern "C" int grad_update(const void* X, const void* w, const void* coeff, void* out,
                           int B, int d, float s0, float s1, void* stream) {
  if (d > 0) {
    grad_update_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(X), static_cast<const float*>(w),
        static_cast<const float*>(coeff), static_cast<float*>(out), B, d, 1.f - s0, s1);
  }
  return static_cast<int>(cudaGetLastError());
}

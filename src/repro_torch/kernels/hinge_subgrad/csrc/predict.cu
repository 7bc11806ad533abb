// Dense serving kernel for Hopper (sm_90a): dense_scores. Plain C entry
// point, loaded with ctypes by repro_torch/kernels/hinge_subgrad/predict.py;
// it returns cudaGetLastError() after its launch.
//
// Replaces src/repro/kernels/hinge_subgrad/predict.py dense_scores
// (pallas_call at :88): S = X W^T for a (B, d) query batch against (C, d)
// class weights, and labels = first-occurrence argmax over classes
// c < n_classes, in one launch. It reads 4(Bd + Cd) bytes and writes
// 4(BC + B) for 2BCd flops: at the C of a linear SVM (1 binary, a few
// one-vs-rest) HBM bandwidth bounds it. One warp per query row walks X with
// 16-byte loads (warp_dot) once per class; after the first class the row
// comes from L1/L2. The TPU kernel padded C to 128 lanes and masked the pad
// lanes out of the argmax; here W is (C, d) unpadded and the argmax runs over
// the first n_classes rows with a strict '>' scan, which keeps the first
// occurrence of a tie as jnp.argmax does.
#include <math.h>

#include "warp_dot.cuh"

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

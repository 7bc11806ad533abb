// RG-LRU linear recurrence for Hopper (sm_90a). Plain C entry point, loaded
// with ctypes by repro_torch/kernels/rglru_scan/rglru_scan.py; it returns
// cudaGetLastError() after its launch.
//
// Replaces src/repro/kernels/rglru_scan/rglru_scan.py rglru_scan
// (pallas_call at :51, _kernel at :26) and its wrapper ops.py
// linear_recurrence (:15): h_t = a_t h_{t-1} + b_t along S for every
// (batch, channel), with h_{-1} = 0 and the carry in f32. The TPU kernel
// walks (blk_s, blk_d) tiles with the carry in VMEM and its wrapper pads S
// and D with a = 1, b = 0 to whole blocks; here nothing is padded.
//
// Work: 2 flops and 12 bytes (a and b read, h written) per element, so the
// bytes bound it. One thread per (b, d) channel, 128 channels per block, so
// each step of a warp reads and writes 128 contiguous bytes per array. The
// thread walks S with the carry in a register; the loads of later steps do
// not depend on the carry, and the unrolled loop keeps several in flight.
// At B = 1, D = 4096 the grid is 32 blocks: most SMs idle, and a chunked
// scan (partial products per chunk, then a carry pass) is later work. Each
// step is a multiply then an add, each rounded, as the sequential oracle
// computes it (no fused multiply-add), and there are no atomics: a rerun
// gives the same bits.
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D + d;
  float carry = 0.f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const size_t i = base + static_cast<size_t>(t) * D;
    carry = __fadd_rn(__fmul_rn(__ldg(a + i), carry), __ldg(b + i));
    h[i] = carry;
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// a, b (B, S, D) float32 contiguous -> h (B, S, D) float32.
extern "C" int rglru_scan(const void* a, const void* b, void* h, int B, int S, int D,
                          void* stream) {
  if (B > 0 && S > 0 && D > 0) {
    const dim3 grid((D + kThreads - 1) / kThreads, B);
    rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h), S,
        D);
  }
  return static_cast<int>(cudaGetLastError());
}

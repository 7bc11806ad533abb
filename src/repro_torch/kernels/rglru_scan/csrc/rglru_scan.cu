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
// bytes bound it, and the chain along S is cheap (S dependent multiply-add
// pairs, about 20 us at S = 4096). What held the first kernel back was
// memory-level parallelism: a thread per channel in 128-channel blocks
// (64 blocks on 132 SMs at B = 2, D = 4096), each thread with a few loads
// in flight, about 0.5 MB for the card where the HBM rate and latency want
// 2-3 MB. So here:
// * a block is kChannels = 32 channels, one warp, a thread a channel: 256
//   blocks at (2, 4096, 4096), two on most SMs;
// * a and b are staged into a ring of kStages = 3 shared-memory stages of
//   kSteps = 32 steps x 32 channels each with cp.async, two stages (16 KB
//   a block, about 4 MB for the card) in flight ahead of the scan. Deeper
//   rings (4-6 stages, 16-64 steps) measured 2-14% slower at the path
//   shape on an H100;
//   The copies are 16 bytes (four channels) when D % 4 == 0 and both
//   inputs are 16-byte aligned (the wrapper checks and passes vec = 4),
//   else 4 bytes (vec = 1): one branch of this kernel, as D = 130 needs;
// * each thread walks the staged steps with the carry in a register, each
//   step __fadd_rn(__fmul_rn(a, carry), b), and stores h_t at once (a
//   warp's 32 stores are 128 contiguous bytes).
// The carry runs along S in the same order as the sequential oracle, each
// step a multiply then an add, each rounded (no fused multiply-add), and
// there are no atomics: the result equals the plain version bit for bit
// and a rerun gives the same bits. A chunked scan with a carry pass would
// round differently and read a and b twice.
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kChannels = 32;  // channels of a block: one warp, a thread each
constexpr int kSteps = 32;     // steps of a stage
constexpr int kStages = 3;     // stages of the ring

struct Stage {
  float a[kSteps][kChannels];
  float b[kSteps][kChannels];
};

template <int kVec>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
  }
}

// Copy the steps of tile `tile` (if it exists) of the block's channels
// [c0, c0 + lanes) into its stage, kVec floats a copy, and close the group
// (an empty group past the last tile keeps the wait counts uniform).
template <int kVec>
__device__ __forceinline__ void issue_tile(Stage* ring, const float* __restrict__ a,
                                           const float* __restrict__ b, size_t base, int S,
                                           int D, int lanes, int n_tiles, int tile) {
  if (tile < n_tiles) {
    Stage& st = ring[tile % kStages];
    const int t0 = tile * kSteps;
    const int steps = min(kSteps, S - t0);
    constexpr int kPerStep = kChannels / kVec;
    for (int q = threadIdx.x; q < steps * kPerStep; q += kChannels) {
      const int t = q / kPerStep;
      const int ch = (q % kPerStep) * kVec;
      if (ch < lanes) {
        const size_t g = base + static_cast<size_t>(t0 + t) * D + ch;
        copy_async<kVec>(&st.a[t][ch], a + g);
        copy_async<kVec>(&st.b[t][ch], b + g);
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kVec>
__global__ void __launch_bounds__(kChannels)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int D) {
  __shared__ __align__(16) Stage ring[kStages];
  const int c0 = blockIdx.x * kChannels;
  const int lanes = min(kChannels, D - c0);
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D + c0;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  const int me = threadIdx.x;
  for (int s = 0; s < kStages - 1; ++s) issue_tile<kVec>(ring, a, b, base, S, D, lanes, n_tiles, s);
  float carry = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // refill the stage the last tile was scanned from, then wait for this one
    issue_tile<kVec>(ring, a, b, base, S, D, lanes, n_tiles, tile + kStages - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncwarp();  // every lane's copies of this tile are visible
    const Stage& st = ring[tile % kStages];
    const int t0 = tile * kSteps;
    if (me < lanes) {
      float* hp = h + base + static_cast<size_t>(t0) * D + me;
      if (S - t0 >= kSteps) {
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          carry = __fadd_rn(__fmul_rn(st.a[t][me], carry), st.b[t][me]);
          hp[static_cast<size_t>(t) * D] = carry;
        }
      } else {
        for (int t = 0; t < S - t0; ++t) {
          carry = __fadd_rn(__fmul_rn(st.a[t][me], carry), st.b[t][me]);
          hp[static_cast<size_t>(t) * D] = carry;
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// a, b (B, S, D) float32 contiguous -> h (B, S, D) float32. vec: floats a
// copy moves, 4 (D % 4 == 0 and a, b 16-byte aligned) or 1.
extern "C" int rglru_scan(const void* a, const void* b, void* h, int B, int S, int D, int vec,
                          void* stream) {
  if (vec != 1 && (vec != 4 || D % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && S > 0 && D > 0) {
    const dim3 grid((D + kChannels - 1) / kChannels, B);
    const auto* fa = static_cast<const float*>(a);
    const auto* fb = static_cast<const float*>(b);
    auto* fh = static_cast<float*>(h);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec == 4) {
      rglru_scan_kernel<4><<<grid, kChannels, 0, st>>>(fa, fb, fh, S, D);
    } else {
      rglru_scan_kernel<1><<<grid, kChannels, 0, st>>>(fa, fb, fh, S, D);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

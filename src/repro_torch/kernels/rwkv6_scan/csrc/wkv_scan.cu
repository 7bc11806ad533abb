// RWKV-6 WKV recurrence for Hopper (sm_90a). Plain C entry point, loaded
// with ctypes by repro_torch/kernels/rwkv6_scan/rwkv6_scan.py; it returns
// cudaGetLastError() after its launch.
//
// Replaces src/repro/kernels/rwkv6_scan/rwkv6_scan.py wkv_scan (pallas_call
// at :62, _kernel at :32) and its wrapper ops.py wkv (:15): per (batch,
// head) with state S in R^{n x n}, S_0 = 0, for t along the sequence
//     out_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t.
// The TPU kernel keeps S in VMEM across (blk_s) time blocks and its wrapper
// pads S with w = 1, k = v = 0; here nothing is padded.
//
// Work: the function needs 5 n^2 + 5 n flops (the bonus term factors out
// as v_j sum_i r_i u_i k_i) and 20 n bytes (r, k, v, w read, out written)
// per step and head, about 16 flops per byte, so its bound is the bytes;
// at 80 blocks (B = 2, 40 heads) the step-to-step dependence through S and
// the barrier per step bound it instead (latency). Each thread here spends
// four operations per i either way, so the kernel keeps the unfactored form
// below. One block of n threads per (batch, head):
// thread j keeps column j of S in registers, so both updates
//     out_j = sum_i r_i (S_ij + u_i k_i v_j),   S_ij <- w_i S_ij + k_i v_j
// need no reduction across threads. r_t, k_t and w_t are staged in shared
// memory (double-buffered, one barrier per step), v_j stays in the thread,
// u is staged once, and each thread loads its four inputs of step t + 1
// before it computes step t. Fixed order, no atomics: a rerun gives the
// same bits.
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

template <int N>
__global__ void __launch_bounds__(N)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ out, int T, int H) {
  __shared__ float r_s[2][N], k_s[2][N], w_s[2][N], u_s[N];
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int j = threadIdx.x;
  const size_t step = static_cast<size_t>(H) * N;              // one time step
  const size_t base = (static_cast<size_t>(b) * T * H + h) * N + j;  // (b, 0, h, j)
  u_s[j] = u[h * N + j];
  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = 0.f;
  float rn = __ldg(r + base), kn = __ldg(k + base), vn = __ldg(v + base), wn = __ldg(w + base);
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    r_s[buf][j] = rn;
    k_s[buf][j] = kn;
    w_s[buf][j] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < T) {
      const size_t nxt = base + static_cast<size_t>(t + 1) * step;
      rn = __ldg(r + nxt);
      kn = __ldg(k + nxt);
      vn = __ldg(v + nxt);
      wn = __ldg(w + nxt);
    }
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float kv = k_s[buf][i] * vj;
      o += r_s[buf][i] * (S[i] + u_s[i] * kv);
      S[i] = w_s[buf][i] * S[i] + kv;
    }
    out[base + static_cast<size_t>(t) * step] = o;
  }
}

template <int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   void* out, int B, int T, int H, cudaStream_t stream) {
  wkv_scan_kernel<N><<<B * H, N, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<float*>(out), T,
      H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// r, k, v, w (B, T, H, n) float32 contiguous, u (H, n) -> out (B, T, H, n);
// n in {16, 32, 64}.
extern "C" int wkv_scan(const void* r, const void* k, const void* v, const void* w,
                        const void* u, void* out, int B, int T, int H, int n, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return static_cast<int>(launch<16>(r, k, v, w, u, out, B, T, H, s));
    case 32: return static_cast<int>(launch<32>(r, k, v, w, u, out, B, T, H, s));
    case 64: return static_cast<int>(launch<64>(r, k, v, w, u, out, B, T, H, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

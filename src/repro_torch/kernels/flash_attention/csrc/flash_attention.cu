// Flash attention forward for Hopper (sm_90a). Plain C entry point, loaded
// with ctypes by repro_torch/kernels/flash_attention/flash_attention.py; it
// returns cudaGetLastError() after its launch.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py
// flash_attention (pallas_call at :102, _kernel at :33) together with its
// GQA wrapper ops.py gqa_flash_attention (:21): out = softmax(q k^T / sqrt(dh)
// + mask) v per (batch, query head), the mask causal (k <= q) and/or a
// sliding band (k > q - window), accumulated in f32 with the online softmax
// and divided by max(l, 1e-30) at the end, the output in q's dtype.
//
// The TPU kernel takes (B*H, S, dh) planes that its wrapper makes with a
// moveaxis and a broadcast of the kv heads, pads S to its block and walks a
// sequential k axis with the running max, sum and accumulator in VMEM. Here
// the kernel reads the model's (B, S, H, dh) / (B, S, Hkv, dh) layout through
// its strides (no copy), takes kv head h / (H / Hkv) itself (GQA and MQA
// repeat nothing), masks the ragged end of S per element (no padding, any S)
// and keeps the running state in registers.
//
// Work: 4 dh flops per live (q, k) pair, f32 outside the tensor cores, and
// one read of q, k, v and one write of out. At the main path's shape
// (RecurrentGemma: S 4096, 16 heads of 256, window 2048) that is about 100
// flops per byte, so the f32 rate bounds it. This first kernel runs on the
// SIMT cores: a block takes 32 query rows of one head (4 warps of 8 rows),
// stages them in shared memory as f32, and walks the key tiles of 32 keys
// that the causal band and the window leave live; a tile wholly outside is
// never loaded. In a tile, lane j computes the scores of key j against the
// warp's 8 rows (q broadcast from shared memory, k as float4 rows padded
// against bank conflicts), the warp reduces max and sum with shuffles, and
// each lane accumulates dh/32 output dims of the 8 rows from the
// probabilities and the staged v tile. Fixed lane mappings and a fixed
// shuffle tree, no atomics: a rerun gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // query rows per block
constexpr int kBlockK = 32;              // keys per tile, one per lane
constexpr float kNegInf = -1e30f;        // the reference's mask fill
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

constexpr size_t smem_floats(int dh) {
  return static_cast<size_t>(kBlockQ) * dh + static_cast<size_t>(kBlockK) * (dh + 4) +
         static_cast<size_t>(kBlockK) * dh + static_cast<size_t>(kWarps) * kRows * kBlockK;
}

// Strides are in elements; the last dim (dh) is contiguous.
struct Layout {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int H, int Hkv,
                       Layout st, int causal, int window, float sm_scale) {
  constexpr int kPad = DH + 4;   // k row stride in shared memory
  constexpr int kDpl = DH / 32;  // output dims per lane: lane + 32 i
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (kBlockQ, DH)
  float* k_s = q_s + kBlockQ * DH;               // (kBlockK, kPad)
  float* v_s = k_s + kBlockK * kPad;             // (kBlockK, DH)
  float* p_s = v_s + kBlockK * DH;               // (kWarps, kRows, kBlockK)

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;

  for (int i = threadIdx.x; i < kBlockQ * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    q_s[i] = q0 + r < S ? load_f32(qp + (q0 + r) * st.qs + d) : 0.f;
  }

  // the keys any row of this block can see
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  const int row0 = q0 + warp * kRows;  // this warp's first query row
  const int row_last = min(row0 + kRows, S) - 1;

  float m[kRows], l[kRows], acc[kRows][kDpl];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = k_lo / kBlockK * kBlockK; t0 <= k_hi; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (the first time: q is staged)
    for (int i = threadIdx.x; i < kBlockK * DH; i += kThreads) {
      const int r = i / DH, d = i - r * DH;
      const bool in = t0 + r < S;
      k_s[r * kPad + d] = in ? load_f32(kp + (t0 + r) * st.ks + d) : 0.f;
      v_s[r * DH + d] = in ? load_f32(vp + (t0 + r) * st.vs + d) : 0.f;
    }
    __syncthreads();
    // does any (row, key) pair of this warp and tile survive the masks?
    const bool warp_live = row0 < S && (!causal || t0 <= row_last) &&
                           (!window || t0 + kBlockK - 1 > row0 - window);
    if (!warp_live) continue;  // warp-uniform; the next barrier is at the loop's top

    const int kj = t0 + lane;  // this lane's key
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * kPad;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(q_s + (warp * kRows + r) * DH + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }
    float* p_w = p_s + warp * kRows * kBlockK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = row0 + r;
      const bool live = kj < S && qi < S && (!causal || kj <= qi) && (!window || kj > qi - window);
      const float sc = live ? s[r] * sm_scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = live ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[r][i] *= corr;
      p_w[r * kBlockK + lane] = p;
    }
    __syncwarp();
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kDpl];
#pragma unroll
      for (int i = 0; i < kDpl; ++i) vv[i] = v_s[j * DH + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = p_w[r * kBlockK + j];
#pragma unroll
        for (int i = 0; i < kDpl; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
    __syncwarp();  // p_w is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + r;
    if (qi >= S) break;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + qi) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) store(orow + lane + 32 * i, acc[r][i] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int Hkv, const Layout& st, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats(DH) * sizeof(float);
  const void* fn = reinterpret_cast<const void*>(flash_attention_kernel<T, DH>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, st, causal, window, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                     int Hkv, int dh, const Layout& st, int causal, int window,
                     cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, Hkv, st, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, st, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, st, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, Hkv, st, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// q (B, S, H, dh), k and v (B, S, Hkv, dh) by strides in elements (dh
// contiguous), float32 (bf16 = 0) or bfloat16 (bf16 = 1); H % Hkv == 0,
// dh in {32, 64, 128, 256} -> o (B, S, H, dh) contiguous, in q's type.
// window 0 means no band.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int S, int H, int Hkv, int dh, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh, int causal,
                               int window, int bf16, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const Layout st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, dh, st, causal, window, s)
           : dispatch<float>(q, k, v, o, B, S, H, Hkv, dh, st, causal, window, s);
  return static_cast<int>(e);
}

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
// and keeps the running state in registers. Any head size from 1 to 256
// runs: the kernel is instantiated at DH in {32, 64, 96, 128, 256} and a
// head of dh < DH columns takes the next DH up, its columns dh .. DH - 1
// zero in shared memory (zero q and k columns leave q k^T unchanged, the
// extra output columns of P v are not stored). The rows are loaded with
// 16-byte cp.async when dh fills whole 16-byte chunks and every row is
// 16-byte aligned, element by element otherwise; ldmatrix and the m16n8k8
// tiles see only the padded DH, a multiple of 8.
//
// Work: 4 dh flops per live (q, k) pair and one read of q, k, v and one
// write of out; at the main path's shape (RecurrentGemma: S 4096, 16 heads
// of 256, window 2048) about 100 flops per byte, so the matrix rate bounds
// it. Both products run on the tensor cores with mma.sync m16n8k8 TF32
// (HMMA.1688.F32.TF32). wgmma would reach the card's full 495 TFLOP/s of
// TF32; mma.sync, about half of it, keeps P in registers between the
// products and lets each operand be split as its fragment is read, where
// wgmma would want both TF32 operands K-major in shared memory (v staged
// transposed). TF32 keeps 10 mantissa bits, about 3e-4 of error at this
// shape, so f32 inputs are split: x = hi + lo, hi = x rounded to TF32 as
// cvt.rna.tf32.f32 rounds it, lo = the remainder rounded the same way, and
// each product is lo*hi + hi*lo + hi*hi in one f32 accumulator (3xTF32,
// about 1e-7). Shared memory holds f32 only; q's and k's fragments come
// from ldmatrix, v's from 32-bit loads. bf16 inputs are exact in TF32:
// q k^T takes one product, and P v two (P, an f32 probability, split; v
// exact), so P keeps f32 accuracy and the output rounds to bf16 once, as
// the plain version's does.
//
// Blocking (f32, dh 256): a block of 8 warps takes 128 query rows of one
// head, 16 a warp (one m16 tile), staged as f32 rows padded by 16 bytes
// against bank conflicts (133 KB), and walks the 32-key tiles that the
// causal band and the window leave live, a tile wholly outside never
// loaded. K and V tiles (33 KB each) alternate on cp.async: the next K tile
// loads while the softmax and P v run, the next V tile while q k^T runs.
// 200 KB a block, one block an SM; the output accumulator (16 x 256 a warp)
// is 128 registers a thread. Each block reads about 68 K/V tiles, so a call
// at the path shape moves about 4.6 GB from L2 (1,024 blocks), against
// 13 GB for 32-row blocks. A warp skips the products of a tile none of its
// rows sees; the mask is applied per element only on tiles that cross the
// diagonal, the window edge or S. P stays in registers between the products:
// the accumulator of q k^T holds keys 2t and 2t+1 where the A fragment of
// P v wants keys t and t+4, so the k order of P v is permuted and v's rows
// are read in the same order. The heaviest query blocks launch first (grid
// z runs backwards over the positions), and the heads of one kv head run
// side by side, sharing its tiles in L2. Fixed order, no atomics: a rerun
// gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block, 16 per warp
constexpr int kBlockK = 32;           // keys per tile: four n8 tiles
constexpr int kNK = kBlockK / 8;
constexpr float kNegInf = -1e30f;     // the reference's mask fill
constexpr double kLog2e = 1.4426950408889634;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T> struct Is32 { static constexpr bool value = false; };
template <> struct Is32<float> { static constexpr bool value = true; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16* p) { *p = __float2bfloat16(0.f); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (half away from zero, the
// low 13 bits cleared), in two integer operations; cvt.rna itself compiles
// to a longer sequence that also guards NaN and infinity.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as TF32 hi (+ lo when SPLIT); an input that is exact in TF32 is taken as is.
template <bool SPLIT, bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
  } else {
    hi = tf32(x);
    if (SPLIT) lo = tf32(x - __uint_as_float(hi));
  }
}

// Four 8 x 16-byte matrices from shared memory, thread i addressing row i % 8
// of matrix i / 8; register j of lane l gets the 4-byte word l % 4 of row
// l / 4 of matrix j (for f32 rows: element (g, t)).
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a b for one m16n8k8 TF32 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

// Row stride in shared memory: dh plus 16 bytes.
template <typename T, int DH>
__host__ __device__ constexpr int ld_smem() { return DH + static_cast<int>(16 / sizeof(T)); }

template <typename T, int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBlockQ + 2 * kBlockK) * ld_smem<T, DH>() * sizeof(T);
}

// Columns [0, dh) of rows [row0, row0 + n) of one head (rows >= S as zeros)
// into shared memory: 16-byte cp.async when every row is 16-byte aligned and
// dh fills whole chunks (vec), else element by element. Columns dh .. DH - 1
// are never written here (zero_pad clears them once).
template <typename T, int DH>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, long long stride,
                                          int row0, int n, int S, int dh, int vec) {
  constexpr int LD = ld_smem<T, DH>();
  constexpr int kPer = static_cast<int>(16 / sizeof(T));  // elements a chunk
  if (vec) {  // dh a whole number of chunks: chunk c lies wholly below dh or wholly past it
    constexpr int kChunks = DH / kPer;  // chunks a padded row (a shift, not a division)
    for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      if (c * kPer >= dh) continue;  // the zero pad
      const bool in = row0 + r < S;
      cp_async16(dst + r * LD + c * kPer, src + (in ? row0 + r : 0) * stride + c * kPer, in);
    }
  } else {
    for (int i = threadIdx.x; i < n * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      if (row0 + r < S) dst[r * LD + c] = src[(row0 + r) * stride + c];
      else zero(dst + r * LD + c);
    }
  }
}

// Columns dh .. DH - 1 of the n rows at dst to zero.
template <typename T, int DH>
__device__ __forceinline__ void zero_pad(T* dst, int n, int dh) {
  constexpr int LD = ld_smem<T, DH>();
  const int w = DH - dh;
  for (int i = threadIdx.x; i < n * w; i += kThreads) {
    const int r = i / w;
    zero(dst + r * LD + dh + (i - r * w));
  }
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16(a); }

// Columns c and c + 1 (c even) of an output row of dh columns, those < dh:
// a pair store when dh is even (then c < dh means c + 1 < dh, and the pair
// is aligned), else element by element.
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int c, int dh, float a, float b) {
  if ((dh & 1) == 0) {
    if (c < dh) store2(row + c, a, b);
  } else {
    if (c < dh) store1(row + c, a);
    if (c + 1 < dh) store1(row + c + 1, b);
  }
}

// Strides are in elements; the last dim (dh) is contiguous.
struct Layout {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int H, int Hkv,
                       int dh, Layout st, int causal, int window, float scale_log2, int vec) {
  constexpr bool kF32 = Is32<T>::value;  // split the inputs; bf16 ones are exact
  constexpr int LD = ld_smem<T, DH>();
  constexpr int kND = DH / 8;  // n8 tiles of the output
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);  // (kBlockQ, LD)
  T* k_s = q_s + kBlockQ * LD;           // (kBlockK, LD)
  T* v_s = k_s + kBlockK * LD;           // (kBlockK, LD)

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;

  // the keys any row of this block can see
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  const int t_first = k_lo / kBlockK * kBlockK;

  if (dh < DH) zero_pad<T, DH>(q_s, kBlockQ + 2 * kBlockK, dh);  // q, k and v rows: contiguous
  load_rows<T, DH>(q_s, qp, st.qs, q0, kBlockQ, S, dh, vec);
  cp_commit();
  load_rows<T, DH>(k_s, kp, st.ks, t_first, kBlockK, S, dh, vec);
  cp_commit();
  load_rows<T, DH>(v_s, vp, st.vs, t_first, kBlockK, S, dh, vec);
  cp_commit();

  const int ra = q0 + warp * 16;  // this warp's rows ra .. rb
  const int rb = min(ra + 15, S - 1);
  const int row0 = ra + g, row1 = ra + g + 8;  // this thread's two rows
  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's keys only
  const T* qw = q_s + warp * 16 * LD;

  for (int t0 = t_first; t0 <= k_hi; t0 += kBlockK) {
    const bool more = t0 + kBlockK <= k_hi;
    cp_wait1();  // q and this K tile have landed (this V tile may not have)
    __syncthreads();
    // does any (row, key) pair of this warp and tile survive the masks, and
    // do all of them (no per-element mask)?
    const bool live = ra < S && (!causal || t0 <= rb) &&
                      (!window || t0 + kBlockK - 1 > ra - window);
    const bool full = t0 + kBlockK <= S && (!causal || t0 + kBlockK - 1 <= ra) &&
                      (!window || t0 > rb - window);
    float s[kNK][4];
#pragma unroll
    for (int n = 0; n < kNK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (live) {
#pragma unroll 4
      for (int kd = 0; kd < DH; kd += 8) {
        uint32_t ah[4], al[4], bh[kNK][2], bl[kNK][2];
        if constexpr (kF32) {
          // q's A fragment and two n8 tiles of k per ldmatrix: lane i
          // addresses row i % 8 of matrix i / 8
          const int mi = lane >> 3, r8 = lane & 7;
          uint32_t raw[4];
          ldmatrix4(raw, qw + (r8 + (mi & 1) * 8) * LD + kd + (mi >> 1) * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) split<true, false>(__uint_as_float(raw[j]), ah[j], al[j]);
#pragma unroll
          for (int n = 0; n < kNK; n += 2) {
            ldmatrix4(raw, k_s + ((n + (mi >> 1)) * 8 + r8) * LD + kd + (mi & 1) * 4);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              split<true, false>(__uint_as_float(raw[j]), bh[n + j / 2][j & 1], bl[n + j / 2][j & 1]);
          }
        } else {
          split<false, true>(to_f32(qw[g * LD + kd + t]), ah[0], al[0]);
          split<false, true>(to_f32(qw[(g + 8) * LD + kd + t]), ah[1], al[1]);
          split<false, true>(to_f32(qw[g * LD + kd + t + 4]), ah[2], al[2]);
          split<false, true>(to_f32(qw[(g + 8) * LD + kd + t + 4]), ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < kNK; ++n) {
            const T* kr = k_s + (n * 8 + g) * LD + kd + t;
            split<false, true>(to_f32(kr[0]), bh[n][0], bl[n][0]);
            split<false, true>(to_f32(kr[4]), bh[n][1], bl[n][1]);
          }
        }
        if (kF32) {
#pragma unroll
          for (int n = 0; n < kNK; ++n) mma(s[n], al, bh[n][0], bh[n][1]);
#pragma unroll
          for (int n = 0; n < kNK; ++n) mma(s[n], ah, bl[n][0], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kNK; ++n) mma(s[n], ah, bh[n][0], bh[n][1]);
      }
    }
    __syncthreads();  // every warp is done with this K tile
    if (more) load_rows<T, DH>(k_s, kp, st.ks, t0 + kBlockK, kBlockK, S, dh, vec);
    cp_commit();

    if (live) {
      // online softmax in base 2; s[n] holds keys t0 + 8n + 2t (+1) of rows
      // row0 (elements 0, 1) and row1 (2, 3)
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < kNK; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[n][j] * scale_log2;
          if (!full) {
            const int key = t0 + 8 * n + 2 * t + (j & 1);
            const int row = j < 2 ? row0 : row1;
            const bool ok = key < S && (!causal || key <= row) && (!window || key > row - window);
            if (!ok) x = kNegInf;
          }
          s[n][j] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < kNK; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float mm = j < 2 ? n0 : n1;
          s[n][j] = s[n][j] > 0.5f * kNegInf ? exp2f(s[n][j] - mm) : 0.f;
        }
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }
    }
    cp_wait1();  // this V tile has landed (the next K tile may not have)
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        // P's A fragment in the permuted key order: slot t = key 2t, slot
        // t + 4 = key 2t + 1
        uint32_t ph[4], pl[4];
        split<true, false>(s[kk][0], ph[0], pl[0]);
        split<true, false>(s[kk][2], ph[1], pl[1]);
        split<true, false>(s[kk][1], ph[2], pl[2]);
        split<true, false>(s[kk][3], ph[3], pl[3]);
        const T* vr = v_s + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split<kF32, !kF32>(to_f32(vr[n * 8]), bh0, bl0);
          split<kF32, !kF32>(to_f32(vr[LD + n * 8]), bh1, bl1);
          mma(acc[n], pl, bh0, bh1);
          if (kF32) mma(acc[n], ph, bl0, bl1);
          mma(acc[n], ph, bh0, bh1);
        }
      }
    }
    __syncthreads();  // every warp is done with this V tile
    if (more) load_rows<T, DH>(v_s, vp, st.vs, t0 + kBlockK, kBlockK, S, dh, vec);
    cp_commit();
  }

  l0 += __shfl_xor_sync(kFullMask, l0, 1);
  l0 += __shfl_xor_sync(kFullMask, l0, 2);
  l1 += __shfl_xor_sync(kFullMask, l1, 1);
  l1 += __shfl_xor_sync(kFullMask, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const long long bs = static_cast<long long>(b) * S;
  if (row0 < S) {
    T* orow = o + ((bs + row0) * H + h) * dh;
#pragma unroll
    for (int n = 0; n < kND; ++n) store_cols(orow, n * 8 + 2 * t, dh, acc[n][0] / d0, acc[n][1] / d0);
  }
  if (row1 < S) {
    T* orow = o + ((bs + row1) * H + h) * dh;
#pragma unroll
    for (int n = 0; n < kND; ++n) store_cols(orow, n * 8 + 2 * t, dh, acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <typename T>
bool aligned16(const void* p, const Layout& st, int which) {
  const long long s[3] = {which == 0 ? st.qb : which == 1 ? st.kb : st.vb,
                          which == 0 ? st.qs : which == 1 ? st.ks : st.vs,
                          which == 0 ? st.qh : which == 1 ? st.kh : st.vh};
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long x : s)
    if ((x * static_cast<long long>(sizeof(T))) % 16) return false;
  return true;
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int Hkv, int dh, const Layout& st, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>();
  const void* fn = reinterpret_cast<const void*>(flash_attention_kernel<T, DH>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const float scale_log2 = static_cast<float>(kLog2e / sqrt(static_cast<double>(dh)));
  const int vec = (dh * sizeof(T)) % 16 == 0 && aligned16<T>(q, st, 0) &&
                  aligned16<T>(k, st, 1) && aligned16<T>(v, st, 2);
  const dim3 grid(H, B, (S + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, dh, st, causal, window, scale_log2, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                     int Hkv, int dh, const Layout& st, int causal, int window,
                     cudaStream_t stream) {
  if (dh < 1) return cudaErrorInvalidValue;
  if (dh <= 32) return launch<T, 32>(q, k, v, o, B, S, H, Hkv, dh, st, causal, window, stream);
  if (dh <= 64) return launch<T, 64>(q, k, v, o, B, S, H, Hkv, dh, st, causal, window, stream);
  if (dh <= 96) return launch<T, 96>(q, k, v, o, B, S, H, Hkv, dh, st, causal, window, stream);
  if (dh <= 128) return launch<T, 128>(q, k, v, o, B, S, H, Hkv, dh, st, causal, window, stream);
  if (dh <= 256) return launch<T, 256>(q, k, v, o, B, S, H, Hkv, dh, st, causal, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// q (B, S, H, dh), k and v (B, S, Hkv, dh) by strides in elements (dh
// contiguous), float32 (bf16 = 0) or bfloat16 (bf16 = 1); H % Hkv == 0,
// 1 <= dh <= 256 -> o (B, S, H, dh) contiguous, in q's type.
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

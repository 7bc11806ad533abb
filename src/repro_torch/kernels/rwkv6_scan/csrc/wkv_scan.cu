// RWKV-6 WKV recurrence for Hopper (sm_90a). Plain C entry point, loaded
// with ctypes by repro_torch/kernels/rwkv6_scan/rwkv6_scan.py; it returns
// cudaGetLastError() after its launch.
//
// Replaces src/repro/kernels/rwkv6_scan/rwkv6_scan.py wkv_scan (pallas_call
// at :62, _kernel at :32) and its wrapper ops.py wkv (:15): per (batch,
// head) with state S in R^{n x n}, S_0 = 0, for t along the sequence
//     out_t[j] = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,
//     S_ij    <- w_i S_ij + k_i v_j,
// which is out_t = r_t (S + diag(u) k_t^T v_t), S <- diag(w_t) S + k_t^T v_t
// with the bonus term factored out. The TPU kernel keeps S in VMEM across
// (blk_s) time blocks and its wrapper pads S with w = 1, k = v = 0; here
// nothing is padded in memory.
//
// Work: 5 n^2 + 5 n flops and 20 n bytes (r, k, v, w read, out written) per
// step and head, about 16 flops per byte at n = 64, so the bytes bound it
// (125 us at RWKV6-3B's (2, 4096, 40, 64)). What holds a scan back is the
// step-to-step dependence through S, which keeps each column's work on one
// lane group for the whole sequence. The design (times at the path shape
// on an H100 SXM, from the variants that led to it):
//  * the columns of S are independent: column j needs r, k, w, u and v_j
//    only. A warp owns 16 columns of one (b, h): 4 column groups of 8
//    lanes, each lane R = NP / 8 rows of 4 columns in registers (NP = n
//    rounded up to 8 R, R a power of two up to 32: any n <= 256). A block
//    of 4 warps owns 64 columns: one block a head at n = 64, so r, k and w
//    are read once, and a warp on each of an SM's four schedulers
//    (blocks of 32 and 16 columns, which repeat the staging and the bonus
//    for fewer columns, took 0.66 and 0.76 ms with 32-step chunks);
//  * each r, k, w value a lane reads from shared memory serves its 4
//    columns (with one column a lane the 4 groups of a warp read each row 4
//    times and shared memory's 128 bytes a clock set the pace: 0.86 ms).
//    Rows go to lanes in runs of min(R, 4), so the 8 lanes of a group read
//    8 different 16-byte words of a row: no bank conflict. Per step and
//    element three operations: kv = k_i v_j, o = fma(r_i, S_ij, o),
//    S_ij = fma(w_i, S_ij, kv);
//  * the steps go in batches of 8: a lane keeps its 8 partial outputs of
//    each column and the 8 lanes of a group add them by a reduce-scatter (3
//    rounds of 4, 2 and 1 shuffles), after which lane g holds step g's
//    outputs. No step waits on a shuffle (one xor-tree a step: 1.19 ms);
//  * r, k, w (NP values a step) and the block's v columns for a chunk of TC
//    steps (TC = 64 up to NP = 64: 167 KB of shared memory, one block an
//    SM; 0.60 ms at TC = 32) land in shared memory by cp.async,
//    double-buffered: chunk c + 1 is in flight while chunk c is computed;
//  * each step's bonus scalar sum_i r_i u_i k_i is computed once for the
//    block, not once a column: a warp takes 8 steps, lanes over i, and a
//    reduce-scatter over lane bits 2-4 leaves step s in lanes 4s .. 4s + 3.
//    Two block barriers a chunk (the chunk landed; its bonus scalars), not
//    one a step. The outputs of a chunk are gathered in shared memory and
//    stored coalesced after the next barrier. (A producer warp that took the
//    loads, the bonus and the stores off the compute warps, handing stages
//    over by named barriers, ran no faster: 0.75-0.81 ms at 32 and 64
//    columns a block; five warps share four schedulers.)
//  * every column-block of a head reads the head's r, k and w: ceil(n / 64)
//    reads of them (one at n = 64).
// What is left: each warp runs 4096 dependent steps of about 130
// instructions (96 of them the update of its 32 state elements) at about
// half an instruction a clock, one warp a scheduler; 80 heads fill 80 of
// the 132 SMs. Splitting a head over more warps moves the limit to shared
// memory (8 columns a warp: 0.63-0.68 ms).
// Rows and columns past n are zero in shared memory (their S stays 0 and
// their outputs are not stored). Fixed lane mappings, a fixed shuffle tree
// and fixed-order sums, no atomics: a rerun gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kLanesPerCol = 8;                    // row groups of a column
constexpr int kColsPerLane = 4;
constexpr int kColsPerWarp = 32 / kLanesPerCol * kColsPerLane;  // 16
constexpr int kBlockCols = 64;                     // columns a block
constexpr int kWarps = kBlockCols / kColsPerWarp;  // 4
constexpr int kBatch = kLanesPerCol;               // steps a reduce-scatter
constexpr int kStages = 2;                         // double-buffered chunks
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// V consecutive floats of shared memory (V = 1, 2 or 4, 4V-byte aligned).
template <int V>
__device__ __forceinline__ void lds(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

// V consecutive floats into shared memory (V = 1, 2 or 4, 4V-byte aligned).
template <int V>
__device__ __forceinline__ void sts(float* p, const float (&x)[V]) {
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (V == 2) *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else *p = x[0];
}

// Reduce-scatter of x[0..8) over the 8 lanes whose ids differ in bits LO,
// LO + 1 and LO + 2: the return value of lane l is the sum over those lanes
// of x[s], s = those three bits of l read as a number. Fixed order.
template <int LO>
__device__ __forceinline__ float reduce_scatter8(const float (&x)[8], int lane) {
  const bool b2 = (lane >> (LO + 2)) & 1, b1 = (lane >> (LO + 1)) & 1, b0 = (lane >> LO) & 1;
  float y[4], z[2];
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // keep steps 4 b2 + s, send the others
    const float send = b2 ? x[s] : x[s + 4], keep = b2 ? x[s + 4] : x[s];
    y[s] = keep + __shfl_xor_sync(kFullMask, send, 4 << LO);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float send = b1 ? y[s] : y[s + 2], keep = b1 ? y[s + 2] : y[s];
    z[s] = keep + __shfl_xor_sync(kFullMask, send, 2 << LO);
  }
  const float send = b0 ? z[0] : z[1], keep = b0 ? z[1] : z[0];
  return keep + __shfl_xor_sync(kFullMask, send, 1 << LO);
}

struct Dims {
  int T, H, n, TC, nblk_j, vec;
};

// One stage in shared memory, in floats: r, k, w (TC x NP each), v's block
// columns (TC x 64), the outputs (TC x 68: the pad puts the 8 rows a group
// writes at once on different banks) and the bonus scalars (TC).
constexpr int kOutStride = kBlockCols + 4;
__host__ __device__ constexpr int stage_floats(int NP, int TC) {
  return TC * (3 * NP + kBlockCols + kOutStride + 1);
}

struct Stage {
  float *r, *k, *w, *v, *o, *bon;
};

__device__ __forceinline__ Stage stage_at(float* sm, int i, int NP, int TC) {
  float* base = sm + i * stage_floats(NP, TC);
  const int a = TC * NP;
  return {base, base + a, base + 2 * a, base + 3 * a, base + 3 * a + TC * kBlockCols,
          base + 3 * a + TC * (kBlockCols + kOutStride)};
}

// One chunk's inputs, steps [t0, t0 + len), into a stage.
__device__ __forceinline__ void load_chunk(const Stage& st, const float* __restrict__ r,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ w, size_t head0,
                                           int t0, int len, int j0, int NP, const Dims& dm) {
  const size_t step = static_cast<size_t>(dm.H) * dm.n;  // one time step of (B, T, H, n)
  float* dst[3] = {st.r, st.k, st.w};
  const float* src[3] = {r, k, w};
  const int jn = min(kBlockCols, dm.n - j0);  // this block's live columns
  if (dm.vec) {  // n % 4 == 0 and 16-byte aligned bases: whole 16-byte chunks
    const int q = dm.n >> 2, qv = jn >> 2;
    for (int i = threadIdx.x; i < len * q; i += blockDim.x) {
      const int t = i / q, c = 4 * (i - t * q);
      const size_t g = head0 + (t0 + t) * step + c;
#pragma unroll
      for (int a = 0; a < 3; ++a) cp_async16(dst[a] + t * NP + c, src[a] + g);
    }
    for (int i = threadIdx.x; i < len * qv; i += blockDim.x) {
      const int t = i / qv, c = 4 * (i - t * qv);
      cp_async16(st.v + t * kBlockCols + c, v + head0 + (t0 + t) * step + j0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < len * dm.n; i += blockDim.x) {
      const int t = i / dm.n, c = i - t * dm.n;
      const size_t g = head0 + (t0 + t) * step + c;
#pragma unroll
      for (int a = 0; a < 3; ++a) cp_async4(dst[a] + t * NP + c, src[a] + g);
    }
    for (int i = threadIdx.x; i < len * jn; i += blockDim.x) {
      const int t = i / jn, c = i - t * jn;
      cp_async4(st.v + t * kBlockCols + c, v + head0 + (t0 + t) * step + j0 + c);
    }
  }
}

// Each step's bonus scalar sum_i r_i u_i k_i: warp q takes the batches of
// 8 steps from 8q on, lane l the rows l + 32 m; step s of a batch ends in
// lanes 4s .. 4s + 3.
template <int NP>
__device__ __forceinline__ void bonus_chunk(const Stage& st, const float* u_s, int len, int warp,
                                            int warps, int lane) {
  constexpr int M = (NP + 31) / 32;  // rows a lane
  float uu[M];
#pragma unroll
  for (int m = 0; m < M; ++m) uu[m] = lane + 32 * m < NP ? u_s[lane + 32 * m] : 0.f;
  for (int b0 = warp * kBatch; b0 < len; b0 += warps * kBatch) {
    float p[kBatch];
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int t = min(b0 + s, len - 1);  // past len: a repeat, not stored
      p[s] = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = lane + 32 * m;
        if (NP >= 32 || i < NP) p[s] = fmaf(st.r[t * NP + i] * st.k[t * NP + i], uu[m], p[s]);
      }
    }
    float q = reduce_scatter8<2>(p, lane);
    q += __shfl_xor_sync(kFullMask, q, 1);
    q += __shfl_xor_sync(kFullMask, q, 2);
    const int t = b0 + (lane >> 2);
    if ((lane & 3) == 0 && t < len) st.bon[t] = q;
  }
}

// A chunk's outputs from its stage to out, coalesced.
__device__ __forceinline__ void store_chunk(const Stage& st, float* __restrict__ out,
                                            size_t head0, int t0, int len, int j0,
                                            const Dims& dm) {
  const size_t step = static_cast<size_t>(dm.H) * dm.n;
  const int jn = min(kBlockCols, dm.n - j0), os = kOutStride;
  if (dm.vec) {
    const int qv = jn >> 2;
    for (int i = threadIdx.x; i < len * qv; i += blockDim.x) {
      const int t = i / qv, c = 4 * (i - t * qv);
      *reinterpret_cast<float4*>(out + head0 + (t0 + t) * step + j0 + c) =
          *reinterpret_cast<const float4*>(st.o + t * os + c);
    }
  } else {
    for (int i = threadIdx.x; i < len * jn; i += blockDim.x) {
      const int t = i / jn, c = i - t * jn;
      out[head0 + (t0 + t) * step + j0 + c] = st.o[t * os + c];
    }
  }
}

// Steps t0 .. t0 + 7 of a chunk (those < len unless FULL) for this lane's R
// rows of columns col0 .. col0 + 3: S updated in place, and the columns'
// outputs (step t0 + g in lane g) left in the stage.
template <int R, bool FULL>
__device__ __forceinline__ void run_batch(float (&S)[R][kColsPerLane], const Stage& st,
                                          int t0, int len, int col0, int g, int lane) {
  constexpr int NP = kLanesPerCol * R;
  constexpr int V = R < 4 ? R : 4;  // rows of a run
  constexpr int Q = R / V;          // runs a lane
  float ob[kColsPerLane][kBatch];
#pragma unroll
  for (int s = 0; s < kBatch; ++s) {
    const int t = t0 + s;
    float o[kColsPerLane] = {};
    if (FULL || t < len) {
      float vv[kColsPerLane];
      lds<kColsPerLane>(vv, st.v + t * kBlockCols + col0);
      const float* rt = st.r + t * NP + V * g;
      const float* kt = st.k + t * NP + V * g;
      const float* wt = st.w + t * NP + V * g;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float rr[V], kk[V], ww[V];
        lds<V>(rr, rt + kLanesPerCol * V * q);
        lds<V>(kk, kt + kLanesPerCol * V * q);
        lds<V>(ww, wt + kLanesPerCol * V * q);
#pragma unroll
        for (int e = 0; e < V; ++e) {
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            float& x = S[q * V + e][c];
            const float kv = kk[e] * vv[c];
            o[c] = fmaf(rr[e], x, o[c]);
            x = fmaf(ww[e], x, kv);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) ob[c][s] = o[c];
  }
  float res[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) res[c] = reduce_scatter8<0>(ob[c], lane);
  const int t = t0 + g;
  if (FULL || t < len) {
    float vv[kColsPerLane];
    lds<kColsPerLane>(vv, st.v + t * kBlockCols + col0);
    const float b = st.bon[t];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) res[c] = fmaf(vv[c], b, res[c]);
    sts<kColsPerLane>(st.o + t * kOutStride + col0, res);
  }
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ out, Dims dm) {
  constexpr int NP = kLanesPerCol * R;  // rows, padded
  const int TC = dm.TC, n = dm.n;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* u_s = sm + kStages * stage_floats(NP, TC);  // (NP,)

  const int bh = blockIdx.x / dm.nblk_j;
  const int j0 = (blockIdx.x - bh * dm.nblk_j) * kBlockCols;
  const int b = bh / dm.H, h = bh - b * dm.H;
  const size_t head0 = static_cast<size_t>(b) * dm.T * dm.H * n + static_cast<size_t>(h) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int g = lane % kLanesPerCol;  // row group
  const int col0 = warp * kColsPerWarp + lane / kLanesPerCol * kColsPerLane;  // block-local
  const int n_chunks = (dm.T + TC - 1) / TC;
  const auto chunk_len = [&](int c) { return min(TC, dm.T - c * TC); };

  // zero both stages (rows and columns past n stay zero: the loads never
  // write them), then u
  for (int i = threadIdx.x; i < kStages * stage_floats(NP, TC); i += blockDim.x) sm[i] = 0.f;
  for (int i = threadIdx.x; i < NP; i += blockDim.x) u_s[i] = i < n ? u[h * n + i] : 0.f;
  __syncthreads();

  float S[R][kColsPerLane];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) S[i][c] = 0.f;
  }
  load_chunk(stage_at(sm, 0, NP, TC), r, k, v, w, head0, 0, chunk_len(0), j0, NP, dm);
  cp_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int len = chunk_len(c);
    const Stage st = stage_at(sm, c & 1, NP, TC);
    const Stage other = stage_at(sm, (c + 1) & 1, NP, TC);
    cp_wait_all();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c > 0) store_chunk(other, out, head0, (c - 1) * TC, TC, j0, dm);
    if (c + 1 < n_chunks)  // into the other stage's inputs: its outputs are not touched
      load_chunk(other, r, k, v, w, head0, (c + 1) * TC, chunk_len(c + 1), j0, NP, dm);
    cp_commit();
    bonus_chunk<NP>(st, u_s, len, warp, warps, lane);
    __syncthreads();  // the bonus scalars of chunk c
    int t0 = 0;
    for (; t0 + kBatch <= len; t0 += kBatch) run_batch<R, true>(S, st, t0, len, col0, g, lane);
    if (t0 < len) run_batch<R, false>(S, st, t0, len, col0, g, lane);
  }
  __syncthreads();  // the last chunk's outputs
  store_chunk(stage_at(sm, (n_chunks - 1) & 1, NP, TC), out, head0, (n_chunks - 1) * TC,
              chunk_len(n_chunks - 1), j0, dm);
}

template <int R>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, float* out, int B, Dims dm, cudaStream_t stream) {
  constexpr int NP = kLanesPerCol * R;
  dm.TC = NP <= 64 ? 64 : 4096 / NP;  // 64, 32 at NP = 128, 16 at 256
  const size_t smem =
      (static_cast<size_t>(kStages) * stage_floats(NP, dm.TC) + NP) * sizeof(float);
  const void* fn = reinterpret_cast<const void*>(wkv_scan_kernel<R>);
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(B) * dm.H * dm.nblk_j;
  wkv_scan_kernel<R><<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(r, k, v, w, u,
                                                                                 out, dm);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// r, k, v, w (B, T, H, n) float32 contiguous, u (H, n) -> out (B, T, H, n);
// 1 <= n <= 256.
extern "C" int wkv_scan(const void* r, const void* k, const void* v, const void* w,
                        const void* u, void* out, int B, int T, int H, int n, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 1 || n > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
                  aligned16(out);
  const Dims dm{T, H, n, 0, (n + kBlockCols - 1) / kBlockCols, vec};
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (n <= 8) e = launch<1>(rf, kf, vf, wf, uf, of, B, dm, s);
  else if (n <= 16) e = launch<2>(rf, kf, vf, wf, uf, of, B, dm, s);
  else if (n <= 32) e = launch<4>(rf, kf, vf, wf, uf, of, B, dm, s);
  else if (n <= 64) e = launch<8>(rf, kf, vf, wf, uf, of, B, dm, s);
  else if (n <= 128) e = launch<16>(rf, kf, vf, wf, uf, of, B, dm, s);
  else e = launch<32>(rf, kf, vf, wf, uf, of, B, dm, s);
  return static_cast<int>(e);
}

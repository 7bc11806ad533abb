// Serving kernels for Hopper (sm_90a): dense_scores and
// ell_scores_prefetch. Plain C entry points, loaded with ctypes by
// repro_torch/kernels/hinge_subgrad/predict.py; each returns
// cudaGetLastError() after its launch.
//
// dense_scores replaces src/repro/kernels/hinge_subgrad/predict.py
// dense_scores (pallas_call at :88): S = X W^T for a (B, d) query batch
// against (C, d) class weights, and labels = first-occurrence argmax over
// classes c < n_classes. It reads 4(Bd + Cd) bytes and writes 4(BC + B)
// for 2BCd flops: at the C of a linear SVM (1 binary, a few one-vs-rest)
// HBM bandwidth bounds it, so the design is a streaming GEMV:
//  * a persistent grid of one 512-thread block per SM (the wrapper passes
//    min(B, SMs) blocks). Block b takes a contiguous range of rows (the
//    first B % G blocks one row more), and its 16 warps split that span of
//    X evenly by 16-byte units, so a row may cross warps and B = 1 and the
//    serving buckets still use every warp of their blocks;
//  * X is read with aligned 16-byte loads whatever d is. W's class tile is
//    staged once per block in shared memory. Where four copies of it fit
//    without shrinking the class tile (C = 1 up to d of about 14,000),
//    copy p holds each class row shifted right by p elements, and a row
//    that starts p elements into an aligned chunk is dotted chunk by chunk
//    with copy p: no shuffle. Otherwise one copy is staged and each lane's
//    chunk is shifted onto W's quads with its right neighbour's chunk (one
//    shuffle a chunk);
//  * bytes in flight: batches of 8 (4 from 4 classes up) independent
//    16-byte loads a lane, L1::no_allocate, the next batch issued before
//    this one is used; while W is staged (its passes pipelined the same
//    way), the first four batches of each warp are prefetched to L2;
//  * X is read once for all the classes of a tile (C partial sums a lane,
//    tiles of up to 16 classes whose staged rows fit the shared-memory
//    budget; wider d is cut into column slabs whose partial scores add up
//    in S in slab order, one launch a slab and class tile);
//  * a row split between warps is summed from their partials in warp order
//    by one thread; fixed lane mappings and shuffle trees, no float atomics:
//    a rerun gives the same bits.
//
// ell_scores_prefetch replaces predict.py ell_scores_prefetch (pallas_call
// at :169): S[b, c] = sum_k vals[b, k] * W[c, cols[b, k]] over a (B, k)
// padded-ELL query batch, counting only the entries whose d-block
// (col / blk_d) is in the batch-wide touched-block map, and the same argmax.
// The TPU kernel walks the map slot by slot, DMAs one (Cp, blk_d) block of W
// per live slot, gathers with a one-hot matrix product and skips sentinel
// slots, which alias a zero block appended after W. It moves
// 4(2Bk + BkC + n_blocks_max + BC + B) bytes for 2BkC flops, a few
// kilobytes at the serving buckets' shapes, so launch latency and the chain
// of dependent round trips bound it, not bandwidth. Its design is the
// prefetch margins' (sparse.cu; the gather-dot and the bitmap are
// ell_gather.cuh's):
//  * a row is the fewest warps whose lanes hold its k entries four to a
//    thread, and a block holds kScoreThreads = 128 threads of rows (or one
//    row of more): the bucket batch (8 rows of one warp at k <= 128) is two
//    blocks, each building the bitmap of the whole map on its own SM. Of
//    one block of 8 warps, 2 of 4, 4 of 2 and 8 of 1, two blocks timed
//    fastest or tied at C = 1 and C = 4 (tools/kernel_probes.py);
//  * every thread puts its entries and three map slots in flight in one
//    round trip (384 slots a block: the top bucket's 259 in one), gathers W
//    of the first tile of classes while the bitmap is built, and adds only
//    after it is in: two round trips, where the walk of 32-entry rounds
//    behind the bitmap took up to seven, once per class;
//  * the classes go in tiles of kClassTile = 4 (one at C = 1), each entry
//    read once for all of them: the next tile's W is gathered from the same
//    registers (rows past 512 entries, in waves, read them again a tile);
//  * a power-of-two blk_d finds an entry's block by a shift;
//  * lanes add their entries in order, a fixed shuffle tree reduces a warp
//    and the row's first thread adds its warps' sums in warp order, then
//    scans the classes in order for the label.
//
// Both kernels take W as (C, d) unpadded: no 128-lane class padding and no
// zero landing block. The argmax runs over the first n_classes rows with a
// strict '>' scan, which keeps the first occurrence of a tie as jnp.argmax
// does; an all-pad row scores 0 everywhere and gets class 0, a row whose
// ranked scores are all -inf class 0 too. A row with a NaN among them gets
// nan_label, which the wrapper sets to the reference's pad-lane count
// 128 ceil(C / 128) (its _argmax_lanes finds no lane equal to a NaN maximum
// and returns the lane count): one isnan flag a row, raised in the same
// scan. Fixed lane mappings and a fixed shuffle tree, no float atomics: a
// rerun gives the same bits.
#include <math.h>

#include "ell_gather.cuh"

namespace repro_torch {
namespace {

constexpr int kDenseThreads = 512;
constexpr int kDenseWarps = kDenseThreads / 32;
constexpr int kMaxClassTile = 16;
constexpr size_t kSlotBytes = 2 * kDenseWarps * kMaxClassTile * sizeof(float);
constexpr size_t kStaticBytes = 4 * kDenseWarps * sizeof(long long);  // the warps' ranges
constexpr int kScoreThreads = 128;  // threads of a scores block, or one row's if more
constexpr int kScoreMapSlots = 3;   // map slots a scores thread loads up front: 384 a block
constexpr int kClassTile = 4;       // classes whose W a scores thread gathers at once
constexpr int kScoreBlockMax = kScoreThreads > kMarginThreads ? kScoreThreads : kMarginThreads;

__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// v of lane (lane + 1) % 32.
__device__ __forceinline__ float4 shfl_next4(float4 v, int lane) {
  const int src = (lane + 1) & 31;
  return make_float4(__shfl_sync(kFullMask, v.x, src), __shfl_sync(kFullMask, v.y, src),
                     __shfl_sync(kFullMask, v.z, src), __shfl_sync(kFullMask, v.w, src));
}

// The four row elements that start P elements into chunk c and run into n.
template <int P>
__device__ __forceinline__ float4 realign(float4 c, float4 n) {
  if (P == 1) return make_float4(c.y, c.z, c.w, n.x);
  if (P == 2) return make_float4(c.z, c.w, n.x, n.y);
  return make_float4(c.w, n.x, n.y, n.z);
}

// Start of part i of n items split into parts contiguous ranges, the first
// n % parts one item longer (python: predict.even_split).
__device__ __forceinline__ long long split_start(long long n, int parts, int i) {
  const long long q = n / parts, r = n - q * parts;
  return i * q + (i < r ? i : r);
}

// a / b for a >= 0, in 32 bits when a fits (a 64-bit division is a long
// software routine).
__device__ __forceinline__ long long div_small(long long a, int b) {
  return a < 0x7fffffffLL ? static_cast<long long>(static_cast<unsigned>(a) / static_cast<unsigned>(b))
                          : a / b;
}

// x with the elements i outside [lo, hi) zeroed.
__device__ __forceinline__ float4 keep(float4 x, int lo, int hi) {
  x.x = lo <= 0 && 0 < hi ? x.x : 0.f;
  x.y = lo <= 1 && 1 < hi ? x.y : 0.f;
  x.z = lo <= 2 && 2 < hi ? x.z : 0.f;
  x.w = lo <= 3 && 3 < hi ? x.w : 0.f;
  return x;
}

// acc[c] += <x, quad m of class row c>, rows `stride` quads apart.
template <int CT>
__device__ __forceinline__ void fma_classes(float4 x, const float4* __restrict__ w_s, int stride,
                                            int m, int ct, float (&acc)[CT]) {
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (c < ct) {
      const float4 w = w_s[c * stride + m];
      acc[c] = fmaf(x.x, w.x, acc[c]);
      acc[c] = fmaf(x.y, w.y, acc[c]);
      acc[c] = fmaf(x.z, w.z, acc[c]);
      acc[c] = fmaf(x.w, w.w, acc[c]);
    }
  }
}

// A row of the slab starts P elements into the aligned chunk k0. The two
// paths below walk its units [ma, mb), lane l taking units ma + l + 32 i in
// batches of U; the next batch's loads are issued before this one is used.
//
// Phased: W is staged in four copies, copy P shifted right by P elements, so
// unit m is chunk k0 + m of X (row elements 4m - P .. 4m + 3 - P, a row
// having n4 + 1 units) against quad m of copy P: every load aligned, no
// shuffle. A chunk is loaded only if it holds an element of the row.
template <int U>
__device__ __forceinline__ void load_phased(const float4* __restrict__ xa4, long long k0, int m0,
                                            int mb, int dslab, int P, int lane,
                                            float4 (&cur)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int m = m0 + 32 * u + lane;
    cur[u] = m < mb && 4 * m - P < dslab ? ld_stream(xa4 + k0 + m)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int CT, int U>
__device__ __forceinline__ void row_phased(const float4* __restrict__ xa4, long long k0, int ma,
                                           int mb, int dslab, int P, int nu,
                                           const float4* __restrict__ w_s, int ct, int lane,
                                           float (&acc)[CT]) {
  float4 cur[U];
  load_phased<U>(xa4, k0, ma, mb, dslab, P, lane, cur);
  for (int m0 = ma; m0 < mb; m0 += 32 * U) {
    const int m1 = m0 + 32 * U;
    float4 nxt[U];
    if (m1 < mb) load_phased<U>(xa4, k0, m1, mb, dslab, P, lane, nxt);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + 32 * u + lane;
      if (m < mb) {
        const int lo = P - 4 * m, hi = dslab + P - 4 * m;  // the row's elements of the chunk
        const float4 x = lo > 0 || hi < 4 ? keep(cur[u], lo, hi) : cur[u];
        fma_classes<CT>(x, w_s, nu, m, ct, acc);
      }
    }
    if (m1 < mb) {
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
  }
}

// Shifted (W in one copy, when four would shrink the class tile): unit m is
// quad m of W (n4 units a row); lane l's chunk k0 + m is shifted onto it with
// chunk k0 + m + 1, held by the next lane (lanes load one unit past mb for
// it), by lane 0 of the next slot, or loaded by the last lane itself.
template <int P, int U>
__device__ __forceinline__ void load_shifted(const float4* __restrict__ xa4, long long k0, int m0,
                                             int mb, int dslab, int lane, float4 (&cur)[U],
                                             float4& own) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int m = m0 + 32 * u + lane;
    cur[u] = m < mb || (P != 0 && m == mb && 4 * m - P < dslab) ? ld_stream(xa4 + k0 + m) : zero;
  }
  if (P != 0) {
    const int m = m0 + 32 * U;  // the unit after the last lane's
    own = lane == 31 && m <= mb && 4 * m - P < dslab ? ld_stream(xa4 + k0 + m) : zero;
  }
}

template <int CT, int P, int U>
__device__ __forceinline__ void row_shifted(const float4* __restrict__ xa4, long long k0, int ma,
                                            int mb, int dslab, int n4,
                                            const float4* __restrict__ w_s, int ct, int lane,
                                            float (&acc)[CT]) {
  float4 cur[U], own;
  load_shifted<P, U>(xa4, k0, ma, mb, dslab, lane, cur, own);
  for (int m0 = ma; m0 < mb; m0 += 32 * U) {
    const int m1 = m0 + 32 * U;
    float4 nc[U], no;
    if (m1 < mb) load_shifted<P, U>(xa4, k0, m1, mb, dslab, lane, nc, no);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + 32 * u + lane;
      float4 x = cur[u];
      if (P != 0) {
        // lane l reads lane l + 1 (mod 32); lane 0 sends the next slot's
        // chunk, which is lane 31's right neighbour
        const float4 send = u + 1 < U && lane == 0 ? cur[u + 1] : cur[u];
        float4 nx = shfl_next4(send, lane);
        if (u + 1 == U && lane == 31) nx = own;
        x = realign<P>(cur[u], nx);
      }
      if (m < mb) {
        const int hi = dslab - 4 * m;  // >= 1
        fma_classes<CT>(hi < 4 ? keep(x, 0, hi) : x, w_s, n4, m, ct, acc);
      }
    }
    if (m1 < mb) {
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nc[u];
      own = no;
    }
  }
}

// Write row r's scores of classes [c0, c0 + ct) (added to S's when
// accumulate) and, on the last launch, its label from the whole S row.
template <int CT>
__device__ __forceinline__ void finish_row(float* __restrict__ S, int* __restrict__ labels,
                                           long long r, const float (&vals)[CT], int C,
                                           int n_classes, int nan_label, int c0, int ct,
                                           int accumulate, int last) {
  float* srow = S + r * C;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (c < ct) srow[c0 + c] = accumulate ? srow[c0 + c] + vals[c] : vals[c];
  }
  if (!last) return;
  float best = -INFINITY;
  int arg = 0;
  bool nan = false;
  if (c0 == 0 && ct == C && !accumulate) {  // one launch: the scores are at hand
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < n_classes) {
        nan |= isnan(vals[c]);
        if (vals[c] > best) {
          best = vals[c];
          arg = c;
        }
      }
    }
  } else {
    for (int c = 0; c < n_classes; ++c) {
      const float s = srow[c];
      nan |= isnan(s);
      if (s > best) {
        best = s;
        arg = c;
      }
    }
  }
  labels[r] = nan ? nan_label : arg;
}

// One slab [j0, j0 + dslab) of the columns and one tile [c0, c0 + ct) of the
// classes, for every row.
template <int CT, bool PHASED>
__global__ void __launch_bounds__(kDenseThreads, 1)
dense_scores_kernel(const float* __restrict__ X, const float* __restrict__ W,
                    float* __restrict__ S, int* __restrict__ labels, int B, int d, int C,
                    int n_classes, int nan_label, int j0, int dslab, int c0, int ct,
                    int accumulate, int last) {
  constexpr int U = CT <= 2 ? 8 : 4;
  constexpr int kCopies = PHASED ? 4 : 1;
  extern __shared__ float4 smem4[];
  const int n4 = (dslab + 3) >> 2;
  const int nu = PHASED ? n4 + 1 : n4;  // units (quads) of a row, and of a staged class row
  float4* w_s = smem4;                                              // (copies, ct, nu) quads
  float* part = reinterpret_cast<float*>(w_s + kCopies * ct * nu);  // (2, warps, CT)
  __shared__ long long wq0[kDenseWarps], wq1[kDenseWarps], wfr[kDenseWarps], wlr[kDenseWarps];
  static_assert(sizeof(wq0) * 4 == kStaticBytes, "static shared memory");
  const long long r0 = split_start(B, gridDim.x, blockIdx.x);
  const long long r1 = split_start(B, gridDim.x, blockIdx.x + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (n4 == 0) {  // d == 0: every score is 0
    float zeros[CT] = {};
    for (long long r = r0 + threadIdx.x; r < r1; r += kDenseThreads)
      finish_row<CT>(S, labels, r, zeros, C, n_classes, nan_label, c0, ct, accumulate, last);
    return;
  }

  // X through its 16-byte aligned base: element e of X is element a0 + e of xa4
  const int a0 = static_cast<int>((reinterpret_cast<uintptr_t>(X) & 15u) >> 2);
  const float4* xa4 = reinterpret_cast<const float4*>(X - a0);
  // this warp's units [q0, q1) of the block's rows, its first and last
  // block-local rows; kept in shared memory for the combine
  const long long quads = (r1 - r0) * nu;
  const long long q0 = split_start(quads, kDenseWarps, warp);
  const long long q1 = split_start(quads, kDenseWarps, warp + 1);
  const long long fr = div_small(q0, nu), lr = q1 > q0 ? div_small(q1 - 1, nu) : fr;
  if (lane == 0) {
    wq0[warp] = q0;
    wq1[warp] = q1;
    wfr[warp] = fr;
    wlr[warp] = lr;
  }
  // the first four batches of this warp's first row toward L2 while W is staged
  if (q0 < q1) {
    const long long base = a0 + (r0 + fr) * d + j0;
    const int shift = PHASED ? static_cast<int>(base & 3) : 0;
    const int ma = static_cast<int>(q0 - fr * nu), mb = fr == lr ? static_cast<int>(q1 - lr * nu) : nu;
    for (int m = ma + lane; m < mb && m < ma + 128 * U; m += 32)
      if (4 * m - shift < dslab) prefetch_l2(xa4 + (base >> 2) + m);
  }

  // W's class tile into shared memory. Class c's row starts q_c elements
  // into an aligned chunk and covers nk_c chunks; its n_chunks slots are the
  // chunk before them, them, and chunks after (zero), the classes' slots one
  // flat range, each warp taking a run of 32 x kStage of it. A lane holds
  // one chunk and gets the next from the next lane (the last lane from lane
  // 0 of its next slot, or by its own load); the four shifts of the pair
  // are the quads of the four copies (copy p holds the row shifted right by
  // p, so shift s lands in copy (q_c - s) & 3), stored whole with the
  // elements outside the row zeroed: every quad of every copy, pads
  // included, is written once.
  constexpr int kStage = 8;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int n_chunks = n4 + 3;  // nk_c + 2 <= n4 + 3
  const int n_slots = ct * n_chunks;
  const int aq = static_cast<int>(((reinterpret_cast<uintptr_t>(W) >> 2) + j0) & 3);
  // slot f: class cls, its local slot li (chunk li - 1 of the row's first
  // aligned chunk, loaded for 1 <= li <= nk), the row's phase q
  const auto slot = [&](int f, int& li, int& q, int& nk, const float4*& row4) {
    int cls = 0;
#pragma unroll
    for (int c = 1; c < CT; ++c) cls += f >= c * n_chunks;
    li = f - cls * n_chunks;
    q = (aq + (c0 + cls) * (d & 3)) & 3;
    nk = (q + dslab + 3) >> 2;
    row4 = reinterpret_cast<const float4*>(W + (static_cast<long long>(c0 + cls) * d + j0 - q));
    return cls;
  };
  // one pass: this lane's slots f0 + 32 u, u < kStage (the last lane also
  // loads the chunk after its last slot)
  const auto load_pass = [&](int i0, float4 (&cur)[kStage], float4& own) {
    const int f0 = i0 + warp * 32 * kStage + lane;
    own = zero4;
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      int li, q, nk;
      const float4* row4;
      slot(f0 + 32 * u, li, q, nk, row4);
      const bool ok = f0 + 32 * u < n_slots;
      cur[u] = ok && li >= 1 && li <= nk ? __ldg(row4 + li - 1) : zero4;
      if (u == kStage - 1 && lane == 31 && ok && li + 1 <= nk) own = __ldg(row4 + li);
    }
  };
  constexpr int kPass = kDenseThreads * kStage;
  float4 cur[kStage], own;
  load_pass(0, cur, own);
  for (int i0 = 0; i0 < n_slots; i0 += kPass) {
    float4 nxt[kStage], nown;
    if (i0 + kPass < n_slots) load_pass(i0 + kPass, nxt, nown);  // in flight while this one is stored
    const int f0 = i0 + warp * 32 * kStage + lane;
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const float4 send = u + 1 < kStage && lane == 0 ? cur[u + 1] : cur[u];
      float4 nx = shfl_next4(send, lane);
      if (u + 1 == kStage && lane == 31) nx = own;
      // past the class's last slot the neighbour is the next class's first
      // slot, which is zero: what the chunk after would hold here
      if (f0 + 32 * u >= n_slots) continue;
      int li, q, nk;
      const float4* row4;
      const int cls = slot(f0 + 32 * u, li, q, nk, row4);
      float4* dst = w_s + cls * nu;  // copy p at dst + p * ct * nu
#pragma unroll
      for (int sh = 0; sh < 4; ++sh) {
        const int p = (q - sh) & 3;
        const int j4 = 4 * (li - 1) + sh - q + p;  // 4 x the quad's index in copy p
        if (p >= kCopies || j4 < 0 || j4 >= 4 * nu) continue;
        const float4 x = sh == 0 ? cur[u]
                       : sh == 1 ? realign<1>(cur[u], nx)
                       : sh == 2 ? realign<2>(cur[u], nx)
                                 : realign<3>(cur[u], nx);
        dst[p * ct * nu + (j4 >> 2)] = keep(x, p - j4, dslab + p - j4);
      }
    }
    if (i0 + kPass < n_slots) {
#pragma unroll
      for (int u = 0; u < kStage; ++u) cur[u] = nxt[u];
      own = nown;
    }
  }
  __syncthreads();

  if (q0 < q1) {
    for (long long rr = fr; rr <= lr; ++rr) {
      const int ma = rr == fr ? static_cast<int>(q0 - fr * nu) : 0;
      const int mb = rr == lr ? static_cast<int>(q1 - lr * nu) : nu;
      const long long base = a0 + (r0 + rr) * d + j0;
      const long long k0 = base >> 2;
      const int P = static_cast<int>(base & 3);
      float acc[CT] = {};
      if constexpr (PHASED) {
        row_phased<CT, U>(xa4, k0, ma, mb, dslab, P, nu, w_s + P * ct * nu, ct, lane, acc);
      } else {
        switch (P) {
          case 0: row_shifted<CT, 0, U>(xa4, k0, ma, mb, dslab, n4, w_s, ct, lane, acc); break;
          case 1: row_shifted<CT, 1, U>(xa4, k0, ma, mb, dslab, n4, w_s, ct, lane, acc); break;
          case 2: row_shifted<CT, 2, U>(xa4, k0, ma, mb, dslab, n4, w_s, ct, lane, acc); break;
          default: row_shifted<CT, 3, U>(xa4, k0, ma, mb, dslab, n4, w_s, ct, lane, acc); break;
        }
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] = warp_sum(acc[c]);
      if (lane == 0) {
        if (ma == 0 && mb == nu) {
          finish_row<CT>(S, labels, r0 + rr, acc, C, n_classes, nan_label, c0, ct, accumulate,
                         last);
        } else {  // split between warps: leave the partial for the combine
          float* slot = part + ((rr == fr ? 0 : 1) * kDenseWarps + warp) * CT;
#pragma unroll
          for (int c = 0; c < CT; ++c) slot[c] = acc[c];
        }
      }
    }
  }
  __syncthreads();

  // Thread t finishes each split row whose first unit lies in warp t's range,
  // adding the partials of the warps that share it in warp order.
  const int t = threadIdx.x;
  if (t >= kDenseWarps) return;
  const long long tq0 = wq0[t], tq1 = wq1[t];
  if (tq0 == tq1) return;
  const long long tfr = wfr[t], tlr = wlr[t];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long rr = i == 0 ? tfr : tlr;
    const bool mine = i == 0 ? tq0 == tfr * nu && tq1 < (tfr + 1) * nu
                             : tlr != tfr && tq1 < (tlr + 1) * nu;
    if (!mine) continue;
    float sum[CT] = {};
    for (int u = t; u < kDenseWarps; ++u) {
      if (wq0[u] == wq1[u]) continue;
      const long long ufr = wfr[u], ulr = wlr[u];
      if (ufr > rr) break;
      const int which = ufr == rr ? 0 : (ulr == rr ? 1 : -1);
      if (which < 0) continue;
      const float* slot = part + (which * kDenseWarps + u) * CT;
#pragma unroll
      for (int c = 0; c < CT; ++c) sum[c] += slot[c];
    }
    finish_row<CT>(S, labels, r0 + rr, sum, C, n_classes, nan_label, c0, ct, accumulate, last);
  }
}

// Scores of rows_per_block = blockDim.x / tpr query rows, tpr threads a row
// (margin_row_threads), against the classes in tiles of CT, and each row's
// label. Every thread first puts its row's first wave of entries and
// kScoreMapSlots slots of the batch's map in flight together, then gathers
// the first class tile's W for every entry that can count while the
// bitmap is zeroed; the map's bits are set between two barriers, and only
// then does it add. The next class tile's W is gathered from the same
// entry registers (a row of more than one wave reads its entries again for
// each tile). Dead rows (b >= B) and entries past k take part in the
// barriers with val 0. The launch bounds ask for one block an SM at least:
// with the block size alone ptxas kept the C = 1 kernel in 32 registers and
// spilled, 0.2 us a call at the serving shape (tools/kernel_probes.py).
template <int CT>
__global__ void __launch_bounds__(kScoreBlockMax, 1)
ell_scores_prefetch_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                           const float* __restrict__ W, const int* __restrict__ block_ids,
                           float* __restrict__ S, int* __restrict__ labels, int B, int k,
                           int d, int C, int n_classes, int nan_label, int n_blocks_max,
                           int blk_d, int blk_shift, int n_d_blocks, int tpr) {
  extern __shared__ unsigned bitmap[];  // one bit per d-block of the batch's map
  __shared__ float partial[2][kScoreBlockMax / 32][CT];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & (tpr - 1);
  const int b = blockIdx.x * (nt / tpr) + tid / tpr;
  const bool live = b < B;
  const size_t row = live ? b : 0;
  const int* c_row = cols + row * k;
  const float* v_row = vals + row * k;
  int c[kRowEntries];
  float v[kRowEntries], w[CT][kRowEntries];
  load_wave(c, v, c_row, v_row, k, 0, lane, tpr, live);
  int bid[kScoreMapSlots];
#pragma unroll
  for (int q = 0; q < kScoreMapSlots; ++q) {
    const int slot = tid + q * nt;
    bid[q] = slot < n_blocks_max ? __ldg(block_ids + slot) : -1;
  }
  for (int q = tid; q < bitmap_words(n_d_blocks); q += nt) bitmap[q] = 0u;
  // W of classes [c0, c0 + ct) at the slots of `use`
  const auto gather_tile = [&](unsigned use, int c0, int ct) {
#pragma unroll
    for (int ci = 0; ci < CT; ++ci) {
      const float* Wc = W + static_cast<size_t>(ci < ct ? c0 + ci : 0) * d;
      gather_wave(w[ci], c, ci < ct ? use : 0u, Wc);
    }
  };
  const int wave = tpr * kRowEntries;
  gather_tile(wave_counts(c, v, d), 0, C < CT ? C : CT);
  __syncthreads();  // the bitmap is zero
  set_map_bits(bitmap, bid, block_ids, n_blocks_max, n_d_blocks, tid, nt);
  __syncthreads();  // the bitmap holds the batch's map
  unsigned keep = wave_in_map(c, wave_counts(c, v, d), bitmap, blk_d, blk_shift);
  float best = -INFINITY;
  int arg = 0;
  bool nan = false;
  for (int c0 = 0, t = 0; c0 < C; c0 += CT, ++t) {
    const int ct = C - c0 < CT ? C - c0 : CT;
    if (c0 > 0) {
      if (k > wave) {  // the registers hold the last wave: the first again
        load_wave(c, v, c_row, v_row, k, 0, lane, tpr, live);
        keep = wave_in_map(c, wave_counts(c, v, d), bitmap, blk_d, blk_shift);
      }
      gather_tile(keep, c0, ct);
    }
    float acc[CT];
#pragma unroll
    for (int ci = 0; ci < CT; ++ci) acc[ci] = ci < ct ? add_wave(0.f, keep, v, w[ci]) : 0.f;
    for (int s = wave; s < k; s += wave) {
      load_wave(c, v, c_row, v_row, k, s, lane, tpr, live);
      keep = wave_in_map(c, wave_counts(c, v, d), bitmap, blk_d, blk_shift);
      gather_tile(keep, c0, ct);
#pragma unroll
      for (int ci = 0; ci < CT; ++ci)
        if (ci < ct) acc[ci] = add_wave(acc[ci], keep, v, w[ci]);
    }
#pragma unroll
    for (int ci = 0; ci < CT; ++ci)
      if (ci < ct) acc[ci] = warp_sum(acc[ci]);
    if (tpr > 32) {  // the row's warps, summed in warp order by its first thread
      if ((tid & 31) == 0) {
#pragma unroll
        for (int ci = 0; ci < CT; ++ci) partial[t & 1][tid >> 5][ci] = acc[ci];
      }
      __syncthreads();  // a tile's partials; the other buffer's readers are done
      if (lane == 0) {
#pragma unroll
        for (int ci = 0; ci < CT; ++ci) {
          acc[ci] = 0.f;
          for (int q = 0; q < tpr / 32; ++q) acc[ci] += partial[t & 1][(tid >> 5) + q][ci];
        }
      }
    }
    if (live && lane == 0) {  // S, and the label's scan in class order
#pragma unroll
      for (int ci = 0; ci < CT; ++ci) {
        const int cls = c0 + ci;
        if (ci < ct) S[row * C + cls] = acc[ci];
        if (ci < ct && cls < n_classes) {
          nan |= isnan(acc[ci]);
          if (acc[ci] > best) {
            best = acc[ci];
            arg = cls;
          }
        }
      }
    }
  }
  if (live && lane == 0) labels[b] = nan ? nan_label : arg;
}

struct DenseArgs {
  const float* X;
  const float* W;
  float* S;
  int* labels;
  int B, d, C, n_classes, nan_label, n_blocks, j0, dslab, c0, ct, accumulate, last;
};

template <int CT, bool PHASED>
cudaError_t launch_dense(const DenseArgs& a, cudaStream_t stream) {
  const int n4 = (a.dslab + 3) / 4;
  const size_t units = static_cast<size_t>(PHASED ? 4 : 1) * a.ct * (PHASED ? n4 + 1 : n4);
  const size_t smem = units * 16 + kSlotBytes;
  const void* fn = reinterpret_cast<const void*>(dense_scores_kernel<CT, PHASED>);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return e;
  dense_scores_kernel<CT, PHASED><<<a.n_blocks, kDenseThreads, smem, stream>>>(
      a.X, a.W, a.S, a.labels, a.B, a.d, a.C, a.n_classes, a.nan_label, a.j0, a.dslab, a.c0,
      a.ct, a.accumulate, a.last);
  return cudaGetLastError();
}

template <bool PHASED>
cudaError_t launch_tile(const DenseArgs& a, cudaStream_t stream) {
  if (a.ct <= 1) return launch_dense<1, PHASED>(a, stream);
  if (a.ct <= 2) return launch_dense<2, PHASED>(a, stream);
  if (a.ct <= 4) return launch_dense<4, PHASED>(a, stream);
  if (a.ct <= 8) return launch_dense<8, PHASED>(a, stream);
  return launch_dense<16, PHASED>(a, stream);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// X (B, d), W (C, d) float32 contiguous -> S (B, C) float32, labels (B,) int32
// (nan_label for a row with a NaN among its first n_classes scores), over
// n_blocks blocks (one wave: min(B, SMs)). One launch when every class's
// padded row fits the shared-memory budget, as at every width the paper's
// datasets have (d <= 47,236 at C = 1).
extern "C" int dense_scores(const void* X, const void* W, void* S, void* labels,
                            int B, int d, int C, int n_classes, int nan_label, int n_blocks,
                            void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long budget = static_cast<long long>(optin) - static_cast<long long>(kSlotBytes) -
                           static_cast<long long>(kStaticBytes);
  const long long slab_quads = budget / 16;  // one class row of a slab fits
  DenseArgs a{static_cast<const float*>(X), static_cast<const float*>(W), static_cast<float*>(S),
              static_cast<int*>(labels), B, d, C, n_classes, nan_label, n_blocks, 0, 0, 0, 0, 0, 0};
  const auto tile_cap = [](long long fit) { return fit < kMaxClassTile ? fit : kMaxClassTile; };
  for (int j0 = 0; j0 == 0 || j0 < d; j0 += static_cast<int>(4 * slab_quads)) {
    const int dslab = static_cast<int>(d - j0 < 4 * slab_quads ? d - j0 : 4 * slab_quads);
    const long long n4 = (dslab + 3) / 4;
    // W in four shifted copies (no shuffles) unless that shrinks the class tile
    const long long fit_one = tile_cap(n4 > 0 ? budget / (16 * n4) : kMaxClassTile);
    const long long fit_four = tile_cap(budget / (64 * (n4 + 1)));
    const bool phased = (C < fit_four ? C : fit_four) == (C < fit_one ? C : fit_one);
    const long long fit = phased ? fit_four : fit_one;
    for (int c0 = 0; c0 < C; c0 += static_cast<int>(fit)) {
      a.j0 = j0;
      a.dslab = dslab;
      a.c0 = c0;
      a.ct = static_cast<int>(C - c0 < fit ? C - c0 : fit);
      a.accumulate = j0 > 0;
      a.last = j0 + dslab >= d && c0 + a.ct >= C;
      e = phased ? launch_tile<true>(a, static_cast<cudaStream_t>(stream))
                 : launch_tile<false>(a, static_cast<cudaStream_t>(stream));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// cols, vals (B, k) int32 / float32, W (C, d), block_ids (n_blocks_max,) int32
// -> S (B, C) float32, labels (B,) int32 (nan_label for a row with a NaN among
// its first n_classes scores), counting only the entries whose d-block is in
// block_ids; ids >= n_d_blocks are sentinels.
extern "C" int ell_scores_prefetch(const void* cols, const void* vals, const void* W,
                                   const void* block_ids, void* S, void* labels, int B, int k,
                                   int d, int C, int n_classes, int nan_label, int n_blocks_max,
                                   int blk_d, int n_d_blocks, void* stream) {
  if (blk_d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = C == 1 ? ell_scores_prefetch_kernel<1>
                             : ell_scores_prefetch_kernel<kClassTile>;
  const size_t smem = static_cast<size_t>(bitmap_words(n_d_blocks)) * sizeof(unsigned);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B > 0) {
    const int tpr = margin_row_threads(k);
    const int fit = kScoreThreads / tpr > 1 ? kScoreThreads / tpr : 1;
    const int rows = B < fit ? B : fit;
    kernel<<<(B + rows - 1) / rows, rows * tpr, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(W), static_cast<const int*>(block_ids),
        static_cast<float*>(S), static_cast<int*>(labels), B, k, d, C, n_classes, nan_label,
        n_blocks_max, blk_d, block_shift(blk_d), n_d_blocks, tpr);
  }
  return static_cast<int>(cudaGetLastError());
}

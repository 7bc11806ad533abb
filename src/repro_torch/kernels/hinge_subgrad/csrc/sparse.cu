// Sparse (padded-ELL) Pegasos half-step kernels for Hopper (sm_90a):
// ell_margins, ell_grad_update (the sweep pair) and ell_margins_prefetch,
// ell_grad_update_prefetch (the touched-block pair), each margins kernel
// also with the violator coefficients and the touched-block grad also
// folded into W, as second entries, and the whole prefetch half-step in
// one kernel (ell_grad_update_fused). Plain C entry points,
// loaded with ctypes by repro_torch/kernels/hinge_subgrad/sparse.py; each
// returns cudaGetLastError() after its launch.
//
// Inputs are (m, B, k) minibatch planes: cols int32 and vals float32, with
// pad entries (col = 0, val = 0) and pad rows y = 0, both inert. W is the
// (m, d) weight plane with no padding. An entry whose column lies outside
// [0, d) adds nothing, as an index past the padded width matched no lane of
// the TPU kernels' one-hot blocks.
//
// Replaces src/repro/kernels/hinge_subgrad/sparse.py:
//   ell_margins               (pallas_call at :100, body :74), as two entries:
//                             the margins, and the margins with the coefficients
//   ell_grad_update           (pallas_call at :138, body :122)
//   ell_margins_prefetch      (pallas_call at :210, body :172), as two entries:
//                             the margins, and the margins with the coefficients
//   ell_grad_update_prefetch  (pallas_call at :259, body :234), as two entries:
//                             the buckets G, and G folded into W
// ell_grad_update_fused is, on the prefetch path, the counterpart of both
// prefetch kernels (sparse.py:210 and :259) and of the block map before them
// (jnp in the reference, ops.py), in one kernel.
// The TPU kernels walk w in d-blocks and gather or scatter with a one-hot
// (B*k, blk_d) matrix product, the TPU's way to gather on its matrix unit;
// the prefetch pair scalar-prefetches a map of live block ids so that each
// grid step DMAs one live block, and aliases the map's sentinel slots to an
// all-zero block appended after w. Here a thread reads its own indices and
// gathers directly, so no one-hot, no DMA steering and no landing pad exist.
//
// What bounds them: at the paper's CCAT shape (m = 10, B = 1, k = 76) each
// launch moves a few kilobytes (and the sweep grad all of W, 1.9 MB), so
// launch latency and the dependent index-then-value loads bound the margin
// and prefetch kernels, and device-memory bandwidth the sweep grad. At
// kdda's width (d = 20.2 M) W is 809 MB, and its stream bounds the fused
// half-step.
//
// Design.
// * Margins, four entries over one kernel (ell_margins_prefetch_kernel):
//   with or without a map, and each with or without the violator
//   coefficient (margin < 1) ? y : 0 of each row, which the path's grad
//   reads, so the comparison, fill and where launches around the margins
//   go. At CCAT (B = 1, k = 76) the work is a launch and a few kilobytes, so
//   the cost is the chain of dependent round trips and, at this size, each
//   load instruction. A block holds a few rows, each the fewest warps whose
//   lanes hold its k entries four to a thread (one warp at k = 76; the
//   layout and the gather-dot are ell_gather.cuh's). Every thread puts its
//   entries and its row's y in flight at once, then W for every entry that
//   can count, and adds: two round trips where a lane-strided walk of three
//   32-entry rounds took up to six. With a map (the prefetch entries) each
//   thread also puts two map slots in flight with its entries (64 ids a
//   warp; wider maps read the rest later), gathers W while the bitmap of
//   the node's map (n_d_blocks bits, shared memory) is built, and counts an
//   entry only if its block col / blk_d is set: exactly the set of entries
//   the TPU kernel contracts, so with an undersized cap it drops what the
//   TPU kernel drops. A power-of-two blk_d finds an entry's block by a
//   shift, not a division. Measured at CCAT on an H100
//   (tools/kernel_probes.py at 1715dbd), of about 2.7-2.9 us: a division
//   costs 0.16 us, four map slots a thread instead of two 0.06-0.07, and
//   four consecutive entries a thread gain nothing consistent (-0.08 and
//   -0.01). Without a map there is no bitmap, no map and no barrier, and
//   every entry that can count is kept: with a sound map the two sums are
//   the same sequence of fmafs, so the sweep's margins are the prefetch
//   entries' bit for bit. At CCAT that launch takes what a bare warp a node
//   loading its entries, then W, takes (2.35 us; the lane-strided walk it
//   replaced 3.16). Lanes add their entries in order, a fixed
//   shuffle tree reduces a warp and the row's first thread adds its warps'
//   sums in warp order: no float atomics, reruns are bit-identical.
// * Sweep grad: one block per (node, tile of kTileLanes = 1,024 columns), which
//   owns its slice of the output, so there are no atomics and the result is
//   deterministic by construction, as on the TPU. It runs the prefetch
//   grad's scatter (scatter_own, below) with every column of the tile live:
//   each of the node's entries is read once per block, and the W tile is
//   copied to shared memory by cp.async (16-byte copies when d % 4 == 0 and
//   W is 16-byte aligned, as at CCAT's d = 47,236) while the entries are
//   read. Then each thread writes the lanes it copied, as
//   __fadd_rn(__fmul_rn(w, 1 - s0), __fmul_rn(s1, g)) at every lane (g = +0
//   where no entry lands, so w = -0 comes out +0, as in the plain version).
//   Each lane's sum runs in entry order whatever the tiling, so the tile is
//   the kernel's own: the reference's blk_d does not shape it. At CCAT the
//   launch moves 3.8 MB (a bound of 1.13 us), so the cost is the launch and
//   the round trips: the entries' and W's overlap, and no thread walks
//   entries that land elsewhere.
// * Prefetch grad, two entries over one scatter (scatter_own). At CCAT a
//   node has 76 entries and 36 buckets of 128 lanes, so the work is the
//   launch and one chain of dependent loads; reading each entry once per
//   bucket (36 times) and walking every staged entry in every thread was
//   what cost. Here a block owns a set of lanes, reads each of its node's
//   entries once (one entry a thread a round: col, val and coeff loads in
//   flight together, the first round's issued before the block reads the
//   map, so the two round trips overlap), finds the entry's lane in its set
//   once, keeps the entries that land there compacted in entry order (warp
//   ballots and a prefix over the warps), and adds them into a
//   shared-memory row in entry order: each entry by the thread that found
//   it when no two kept entries of a round share a lane (an integer
//   atomicMin per lane tells), else by the lane's owner walking the round's
//   kept entries in order. CCAT's frequent features crowd the first
//   blocks, so one block keeps most of a node's 76 entries, and a walk over
//   them (one warp adding one entry after another) was most of the G
//   entry's time. No float atomics: reruns are bit-identical.
//   The G entry (ell_grad_update_prefetch) gives a block up to kMaxSlots
//   map slots (kTileLanes lanes) and writes the raw buckets G[i, j, :], a
//   sentinel slot's as zeros, with coalesced stores. The fused entry
//   (ell_grad_update_prefetch_fold) gives a block kTileLanes columns of W
//   (copied to shared memory by cp.async while the entries are read),
//   marks which of their d-blocks are in the node's map, and writes
//   W_half = (1 - s0) w everywhere plus s1 g at the live blocks' lanes
//   below d, each lane as __fadd_rn(__fmul_rn(w, 1 - s0), __fmul_rn(s1, g))
//   with g summed as the G entry sums it: bit for bit the G entry followed
//   by the plain fold (sparse.py's fold_buckets), in one launch that reads
//   W and the entries once and writes W_half once (3.8 MB at CCAT, a
//   bandwidth bound of 1.13 us; the launch and two round trips cost more).
// * The fused half-step (ell_grad_update_fused), the prefetch schedule's
//   whole half-step (ops.py routes every prefetch call to it). What
//   bounds it is one read of W and one write of W_half, 2 m d 4 B: 3.78 MB
//   at CCAT (1.13 us at 3.35 TB/s), where the launch bounds it in practice,
//   and 1.62 GB at kdda (d = 20,216,830: 482.8 us), where the stream of W
//   does. At the paper's B = 1 the two-kernel route also built the
//   touched-block map in about 16 small PyTorch launches (a segmented radix
//   sort among them), so the host's dispatch, not the device, paced the
//   half-step. Here one launch does it all. Every block builds its node's
//   map from the entries themselves (a bitmap of the live d-blocks, cut to
//   the n_blocks_max lowest, as the map's ascending ids are, by a one-warp
//   walk of the whole bitmap only when more blocks are live), computes all
//   B margins and coefficients of its node with the margins kernel's layout
//   and sequence of fmafs, then folds a run of W's tiles as the fold kernel
//   does. Every block holds what it needs, so no block waits for another,
//   and W_half is bit for bit the map, ell_margins_prefetch_coeff and
//   ell_grad_update_prefetch_fold in turn (each lane's sum runs in entry
//   order whatever the tiling). The grid is about one wave: the wrapper asks
//   how many blocks fit on the card at this shared memory (the occupancy
//   query) and gives each node that many over m blocks, each folding an even
//   run of the node's ceil(d / kTileLanes) tiles. So the map and margins
//   cost once per block, not once per tile: at CCAT (47 tiles a node) a
//   block folds one tile; at kdda (19,743 tiles a node, a 4,936-word
//   bitmap) about 300, where a block a tile would rebuild the map 197,430
//   times a call (7.81-7.87 ms, 16.4x the bound).
//   Within the run, a tile's copy starts while the one before is folded
//   (two buffers), a bitmap of the node's tiles lets the block skip the
//   scatter of a tile no entry falls in (most of kdda's: 36 entries a node),
//   and a barrier a tile keeps the block's warps on one tile. Measured on an
//   H100: 5.1-5.4 us a call at CCAT against the route's 44-45 us of kernels
//   in 16 launches; at kdda 630 us, against the 539 us of torch.mul's
//   stream over the same (10, d) array.
//   Each block's map and margins grow with B k, so the kernel adds about
//   3.9 us of device a row at CCAT where the route adds 2.9 (the scatter's
//   walk over shared lanes, in both, most of it), and the route's kernels
//   cost less from about 4,000 entries on; the route's call still took
//   longer on the host at every B up to 64 measured (45-251 us against
//   333-716).
#include "ell_gather.cuh"

namespace repro_torch {
namespace {

constexpr int kTileLanes = kThreads * 4;  // lanes a grad block owns, four a thread
constexpr int kMaxSlots = 8;          // map slots a G-entry block owns
constexpr int kMapSlots = 2;          // map slots a prefetch-margins thread loads up front
constexpr int kStages = 2;            // W tiles a fused half-step block has in shared memory

// Margins of rows_per_block = blockDim.x / tpr rows of node blockIdx.y, tpr
// threads a row (margin_row_threads); with kCoeff also the violator
// coefficient (margin < 1) ? y : 0 of each row, as torch.where computes it
// (a NaN margin gives 0). Every thread first puts its first wave of
// entries and its row's y in flight together, with kMap also kMapSlots
// slots of the node's map, then gathers the wave's W (with kMap while it
// zeroes the bitmap; the map's bits are set between two barriers) and only
// then adds. Without kMap every entry that can count is kept, and there is
// no bitmap, no map and no barrier but the warps' sum at tpr > 32. Dead rows
// (b >= B) and entries past k take part in the barriers with val 0.
template <bool kCoeff, bool kMap>
__global__ void __launch_bounds__(kMarginThreads)
ell_margins_prefetch_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                            const float* __restrict__ W, const float* __restrict__ y,
                            const int* __restrict__ block_ids, float* __restrict__ out,
                            float* __restrict__ coeff, int B, int k, int d, int n_blocks_max,
                            int blk_d, int blk_shift, int n_d_blocks, int tpr) {
  extern __shared__ unsigned bitmap[];  // with kMap: one bit per d-block of this node
  __shared__ float partial[kMarginThreads / 32];
  const int i = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & (tpr - 1);
  const int b = blockIdx.x * (nt / tpr) + tid / tpr;
  const bool live = b < B;
  const long long row = static_cast<long long>(i) * B + (live ? b : 0);
  const int* c_row = cols + row * k;
  const float* v_row = vals + row * k;
  const float* Wi = W + static_cast<size_t>(i) * d;
  int c[kRowEntries];
  float v[kRowEntries], w[kRowEntries];
  load_wave(c, v, c_row, v_row, k, 0, lane, tpr, live);
  const float yb = live && lane == 0 ? __ldg(y + row) : 0.f;
  const int* ids = block_ids + static_cast<size_t>(i) * n_blocks_max;
  int bid[kMapSlots];
  if constexpr (kMap) {
#pragma unroll
    for (int q = 0; q < kMapSlots; ++q) {
      const int j = tid + q * nt;
      bid[q] = j < n_blocks_max ? __ldg(ids + j) : -1;
    }
    for (int q = tid; q < bitmap_words(n_d_blocks); q += nt) bitmap[q] = 0u;
  }
  unsigned use = wave_counts(c, v, d);
  gather_wave(w, c, use, Wi);
  if constexpr (kMap) {
    __syncthreads();  // the bitmap is zero
    set_map_bits(bitmap, bid, ids, n_blocks_max, n_d_blocks, tid, nt);
    __syncthreads();  // the bitmap holds the node's map
  }
  float acc = add_wave(0.f, kMap ? wave_in_map(c, use, bitmap, blk_d, blk_shift) : use, v, w);
  for (int s = tpr * kRowEntries; s < k; s += tpr * kRowEntries) {
    load_wave(c, v, c_row, v_row, k, s, lane, tpr, live);
    use = wave_counts(c, v, d);
    gather_wave(w, c, use, Wi);
    acc = add_wave(acc, kMap ? wave_in_map(c, use, bitmap, blk_d, blk_shift) : use, v, w);
  }
  acc = warp_sum(acc);
  if (tpr > 32) {  // the row's warps, summed in warp order by its first thread
    if ((tid & 31) == 0) partial[tid >> 5] = acc;
    __syncthreads();
    if (lane == 0) {
      acc = 0.f;
      for (int q = 0; q < tpr / 32; ++q) acc += partial[(tid >> 5) + q];
    }
  }
  if (live && lane == 0) {
    const float mg = yb * acc;
    out[row] = mg;
    if (kCoeff) coeff[row] = mg < 1.f ? yb : 0.f;
  }
}

// One round's kept entries, compacted in entry order.
struct KeptEntries {
  int lane[kThreads];
  float contrib[kThreads];
  int per_warp[kWarps];
};

// Entry e of a node's n = B k entries (col -1 past the end): column, value
// and its row's coefficient, loaded together.
struct Entry {
  int col;
  float val, c;
};

// A row's coefficient: from device memory (written by a margins kernel) or
// from shared memory (formed in the same block).
struct GlobalCoeff {
  const float* p;
  __device__ __forceinline__ float operator()(long long b) const { return __ldg(p + b); }
};
struct SharedCoeff {
  const float* p;
  __device__ __forceinline__ float operator()(long long b) const { return p[b]; }
};

template <class Coeff>
__device__ __forceinline__ Entry load_entry(const int* __restrict__ cols,
                                            const float* __restrict__ vals, const Coeff& coeff,
                                            int k, long long n, long long e) {
  if (e >= n) return {-1, 0.f, 0.f};
  return {__ldg(cols + e), __ldg(vals + e), coeff(e / k)};
}

// acc[0, n_lanes) (shared memory) = per lane, the sum in entry order of
// coeff_b * vals[b, e] over the node's entries that own(col) maps to that
// lane (own gives -1 for an entry outside this block's lanes). Pad entries
// (val = 0) are skipped: each would add +-0, which changes no sum. Every
// entry is read once, a round of kThreads at a time; `first` is this
// thread's entry of the first round, which the caller loads before its own
// set-up so that the two loads overlap. claim (n_lanes ints of shared
// memory) marks, per lane, the first kept entry of the round that lands
// there (an integer atomicMin on the entry's place in the round). When no
// two kept entries of a round share a lane (always so for one row, whose
// columns are distinct), each entry is added by the thread that found it;
// otherwise every thread walks the round's kept entries in order and adds
// those on its lanes l (l % kThreads == thread), so each lane's sum runs in
// entry order either way. The caller may read any lane after the return.
template <class Own, class Coeff>
__device__ __forceinline__ void scatter_own(const int* __restrict__ cols,
                                            const float* __restrict__ vals, const Coeff& coeff,
                                            int B, int k, Entry first, const Own& own, float* acc,
                                            int* claim, int n_lanes, KeptEntries& kept) {
  for (int l = threadIdx.x; l < n_lanes; l += kThreads) {
    acc[l] = 0.f;
    claim[l] = kThreads;
  }
  const long long n = static_cast<long long>(B) * k;
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const int me = static_cast<int>(threadIdx.x);
  for (long long s = 0; s < n; s += kThreads) {
    const Entry en = s == 0 ? first : load_entry(cols, vals, coeff, k, n, s + me);
    int lane = -1;
    float v = 0.f;
    if (en.val != 0.f) {
      lane = own(en.col);
      v = __fmul_rn(en.c, en.val);
    }
    const unsigned keep = __ballot_sync(kFullMask, lane >= 0);
    if (wl == 0) kept.per_warp[warp] = __popc(keep);
    __syncthreads();  // the counts are in; acc, claim and the last round are settled
    int at = 0, total = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int c = kept.per_warp[q];
      at += q < warp ? c : 0;
      total += c;
    }
    if (lane >= 0) {
      at += __popc(keep & ((1u << wl) - 1u));
      kept.lane[at] = lane;
      kept.contrib[at] = v;
      atomicMin(claim + lane, at);
    }
    __syncthreads();
    const bool shared_lane = lane >= 0 && claim[lane] != at;
    if (!__syncthreads_or(shared_lane)) {
      if (lane >= 0) acc[lane] = __fadd_rn(acc[lane], v);
    } else {
      for (int q = 0; q < total; ++q) {
        const int l = kept.lane[q];
        if ((l & (kThreads - 1)) == me) acc[l] = __fadd_rn(acc[l], kept.contrib[q]);
      }
    }
    if (lane >= 0) claim[lane] = kThreads;  // every read of claim was before the barrier
  }
  __syncthreads();
}

// The G entry's lanes: slot q of the block's ns slots (ids, sentinels as -1)
// at lane col - id * blk_d.
struct SlotLanes {
  const int* ids;
  int ns, blk_d;
  __device__ __forceinline__ int operator()(int col) const {
    if (col < 0) return -1;
    const int blk = col / blk_d;
    for (int q = 0; q < ns; ++q) {
      if (ids[q] == blk) return q * blk_d + (col - blk * blk_d);
    }
    return -1;
  }
};

// The fused entry's lanes: columns [c0, c0 + lanes) of W whose d-block is
// live (live[blk - b0], the node's map restricted to the tile).
struct TileLanes {
  const unsigned char* live;
  int c0, lanes, b0, blk_d;
  __device__ __forceinline__ int operator()(int col) const {
    const int l = col - c0;
    if (static_cast<unsigned>(l) >= static_cast<unsigned>(lanes)) return -1;
    return live[col / blk_d - b0] ? l : -1;
  }
};

// The sweep grad's lanes: columns [c0, c0 + lanes) of W, every one.
struct ColumnLanes {
  int c0, lanes;
  __device__ __forceinline__ int operator()(int col) const {
    const int l = col - c0;
    return static_cast<unsigned>(l) < static_cast<unsigned>(lanes) ? l : -1;
  }
};

// Sweep grad over columns [c0, c0 + kTileLanes) of node blockIdx.y. Thread
// t copies W's lanes l = t V + q V kThreads, ..., + V - 1 (V floats a copy;
// V = 4 needs W's and out's rows 16-byte aligned) and later writes those
// same lanes, so its own cp.async.wait_all is the only wait on the copy.
template <int V>
__global__ void __launch_bounds__(kThreads)
ell_grad_update_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                       const float* __restrict__ W, const float* __restrict__ coeff,
                       float* __restrict__ out, int B, int k, int d, float one_minus_s0,
                       float s1) {
  __shared__ __align__(16) float acc[kTileLanes];
  __shared__ int claim[kTileLanes];
  __shared__ __align__(16) float w_tile[kTileLanes];
  __shared__ KeptEntries kept;
  const int i = blockIdx.y;
  const int c0 = blockIdx.x * kTileLanes;
  const int lanes = min(kTileLanes, d - c0);
  const float* wi = W + static_cast<size_t>(i) * d + c0;
  for (int l = threadIdx.x * V; l < lanes; l += kThreads * V) {  // in flight while the entries are read
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(w_tile + l));
    if constexpr (V == 4) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(wi + l) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(wi + l) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const size_t plane = static_cast<size_t>(i) * B * k;
  const GlobalCoeff ci{coeff + static_cast<size_t>(i) * B};
  const Entry first = load_entry(cols + plane, vals + plane, ci, k,
                                 static_cast<long long>(B) * k, threadIdx.x);
  scatter_own(cols + plane, vals + plane, ci, B, k, first, ColumnLanes{c0, lanes}, acc, claim,
              lanes, kept);
  asm volatile("cp.async.wait_all;" ::: "memory");  // this thread's lanes of W have landed
  float* oi = out + static_cast<size_t>(i) * d + c0;
  for (int l = threadIdx.x * V; l < lanes; l += kThreads * V) {
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      o[e] = __fadd_rn(__fmul_rn(w_tile[l + e], one_minus_s0), __fmul_rn(s1, acc[l + e]));
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(oi + l) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      oi[l] = o[0];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ell_grad_update_prefetch_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                                const float* __restrict__ coeff,
                                const int* __restrict__ block_ids, float* __restrict__ G,
                                int B, int k, int n_blocks_max, int blk_d, int n_d_blocks,
                                int slots) {
  __shared__ float acc[kTileLanes];
  __shared__ int claim[kTileLanes];
  __shared__ KeptEntries kept;
  __shared__ int ids[kMaxSlots];
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * slots;
  const int ns = min(slots, n_blocks_max - j0);
  const size_t plane = static_cast<size_t>(i) * B * k;
  const GlobalCoeff ci{coeff + static_cast<size_t>(i) * B};
  const Entry first = load_entry(cols + plane, vals + plane, ci, k,
                                 static_cast<long long>(B) * k, threadIdx.x);
  if (static_cast<int>(threadIdx.x) < ns) {
    const int bid = __ldg(block_ids + static_cast<size_t>(i) * n_blocks_max + j0 + threadIdx.x);
    ids[threadIdx.x] = (bid >= 0 && bid < n_d_blocks) ? bid : -1;  // a sentinel matches nothing
  }
  __syncthreads();
  const int n_lanes = ns * blk_d;
  scatter_own(cols + plane, vals + plane, ci, B, k, first,
              SlotLanes{ids, ns, blk_d}, acc, claim, n_lanes, kept);
  float* g = G + (static_cast<size_t>(i) * n_blocks_max + j0) * blk_d;
  for (int l = threadIdx.x; l < n_lanes; l += kThreads) g[l] = acc[l];
}

__global__ void __launch_bounds__(kThreads)
ell_grad_update_prefetch_fold_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                                     const float* __restrict__ coeff,
                                     const int* __restrict__ block_ids,
                                     const float* __restrict__ W, float* __restrict__ out,
                                     int B, int k, int d, int n_blocks_max, int blk_d,
                                     int n_d_blocks, float one_minus_s0, float s1) {
  __shared__ float acc[kTileLanes];
  __shared__ int claim[kTileLanes];
  __shared__ float w_tile[kTileLanes];
  __shared__ KeptEntries kept;
  __shared__ unsigned char live[kTileLanes];  // the tile's d-blocks: at most one a lane
  const int i = blockIdx.y;
  const int c0 = blockIdx.x * kTileLanes;
  const int lanes = min(kTileLanes, d - c0);
  const int b0 = c0 / blk_d;
  const int nb = (c0 + lanes - 1) / blk_d - b0 + 1;
  // W's tile copied to shared memory in the background (each thread its own
  // lanes), while the entries and the map are read
  const float* wi = W + static_cast<size_t>(i) * d + c0;
  for (int l = threadIdx.x; l < lanes; l += kThreads) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(w_tile + l));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(wi + l) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const size_t plane = static_cast<size_t>(i) * B * k;
  const GlobalCoeff ci{coeff + static_cast<size_t>(i) * B};
  const Entry first = load_entry(cols + plane, vals + plane, ci, k,
                                 static_cast<long long>(B) * k, threadIdx.x);
  const int* row = block_ids + static_cast<size_t>(i) * n_blocks_max;
  const int bid0 = static_cast<int>(threadIdx.x) < n_blocks_max ? __ldg(row + threadIdx.x) : -1;
  for (int q = threadIdx.x; q < nb; q += kThreads) live[q] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < n_blocks_max; j += kThreads) {
    const int bid = j == static_cast<int>(threadIdx.x) ? bid0 : __ldg(row + j);
    if (bid >= b0 && bid - b0 < nb && bid < n_d_blocks) live[bid - b0] = 1;
  }
  __syncthreads();
  scatter_own(cols + plane, vals + plane, ci, B, k, first,
              TileLanes{live, c0, lanes, b0, blk_d}, acc, claim, lanes, kept);
  asm volatile("cp.async.wait_all;" ::: "memory");  // this thread's lanes of W have landed
  float* oi = out + static_cast<size_t>(i) * d + c0;
  for (int l = threadIdx.x; l < lanes; l += kThreads) {
    const float decayed = __fmul_rn(w_tile[l], one_minus_s0);
    oi[l] = live[(c0 + l) / blk_d - b0] ? __fadd_rn(decayed, __fmul_rn(s1, acc[l])) : decayed;
  }
}

// The fused half-step's lanes: columns [c0, c0 + lanes) of W whose d-block
// is set in the node's bitmap of kept blocks.
struct KeptLanes {
  const unsigned* kept;
  int c0, lanes, blk_d, blk_shift;
  __device__ __forceinline__ bool has(int col) const {
    const int blk = blk_shift >= 0 ? col >> blk_shift : col / blk_d;
    return (kept[blk >> 5] >> (blk & 31)) & 1u;
  }
  __device__ __forceinline__ int operator()(int col) const {
    const int l = col - c0;
    if (static_cast<unsigned>(l) >= static_cast<unsigned>(lanes)) return -1;
    return has(col) ? l : -1;
  }
};

// Keep the n_blocks_max lowest set bits of bitmap[0, nw), clear the rest:
// one warp walks the words 32 at a time with a running count of the set
// bits below. Call from all 32 lanes of one warp.
__device__ __forceinline__ void keep_lowest(unsigned* bitmap, int nw, int n_blocks_max) {
  const int lane = threadIdx.x & 31;
  int below = 0;
  for (int base = 0; base < nw; base += 32) {
    const int q = base + lane;
    unsigned word = q < nw ? bitmap[q] : 0u;
    const int cnt = __popc(word);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    const int room = n_blocks_max - (below + incl - cnt);  // slots left before this word
    if (room <= 0) {
      word = 0u;
    } else {
      while (__popc(word) > room) word &= ~(1u << (31 - __clz(word)));  // drop the highest
    }
    if (q < nw) bitmap[q] = word;
    below += __shfl_sync(kFullMask, incl, 31);
  }
}

// Start the copy of W's tile t (row Wi, kTileLanes columns) into dst in the
// background, each thread its own lanes, as one commit group; past the
// block's last tile t_end the group is empty, so that every wait counts the
// same groups.
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ Wi, int t,
                                          int t_end, int d) {
  if (t < t_end) {
    const int c0 = t * kTileLanes;
    const int lanes = min(kTileLanes, d - c0);
    for (int l = threadIdx.x; l < lanes; l += kThreads) {
      const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst + l));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(at), "l"(Wi + c0 + l)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The whole sparse half-step of node blockIdx.y over its run of W's tiles
// (kTileLanes columns each), tiles [blockIdx.x tiles_per_block, + tiles_per_
// block): the node's touched-block map, its margins and violator
// coefficients, once, then for each tile of the run the fold of its kept
// entries into the tile. Every block of the node builds the same map and the
// same coefficients, so no block waits for another. The map is a bitmap (one
// bit per d-block, dynamic shared memory) of the blocks some live entry (val
// != 0, column in [0, n_d_blocks blk_d)) touches, cut to the n_blocks_max
// lowest (keep_lowest, only when more are set): the set ell_block_map's
// ascending ids hold, sentinels aside. The margins are ell_margins_prefetch
// _kernel's rows (margin_row_threads, the same waves and sums) against that
// bitmap, kThreads / tpr rows a pass; the coefficients (B floats after the
// bitmaps) are its (margin < 1) ? y : 0; the fold is the fold kernel's, with
// the bitmap in place of its map's live flags. A second bitmap marks the
// node's tiles that some live entry's column below d falls in: a tile with no
// mark gets no entry, so its scatter is skipped and its lanes fold g = +0,
// the value the scatter leaves in a lane no entry reaches. W's tiles stream
// through kStages buffers: each tile's copy starts kStages - 1 tiles ahead
// (the first before the map), and each thread waits only for its own lanes.
__global__ void __launch_bounds__(kThreads)
ell_grad_update_fused_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                             const float* __restrict__ W, const float* __restrict__ y,
                             float* __restrict__ out, int B, int k, int d, int n_blocks_max,
                             int blk_d, int blk_shift, int n_d_blocks, int tpr,
                             int tiles_per_block, float one_minus_s0, float s1) {
  extern __shared__ unsigned bitmap[];  // kept d-blocks, then busy tiles, then B coefficients
  __shared__ float acc[kTileLanes];
  __shared__ int claim[kTileLanes];
  __shared__ float w_tile[kStages][kTileLanes];
  __shared__ KeptEntries kept;
  __shared__ float partial[kWarps];
  __shared__ int n_set;  // distinct d-blocks marked
  const int nw = bitmap_words(n_d_blocks);
  const int n_tiles = (d + kTileLanes - 1) / kTileLanes;
  const int nt = bitmap_words(n_tiles);
  unsigned* busy = bitmap + nw;
  float* coeff = reinterpret_cast<float*>(busy + nt);
  const int i = blockIdx.y;
  const int tid = threadIdx.x;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  const float* Wi = W + static_cast<size_t>(i) * d;
  // the run's first tiles copied in the background while the entries are
  // read and the margins taken
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) copy_tile(w_tile[q], Wi, t_begin + q, t_end, d);
  const size_t plane = static_cast<size_t>(i) * B * k;
  const int* ci = cols + plane;
  const float* vi = vals + plane;
  const long long n = static_cast<long long>(B) * k;
  // this thread's entry of the first round (its coefficient set once known)
  Entry first{-1, 0.f, 0.f};
  if (tid < n) first = {__ldg(ci + tid), __ldg(vi + tid), 0.f};
  for (int q = tid; q < nw + nt; q += kThreads) bitmap[q] = 0u;
  if (tid == 0) n_set = 0;
  __syncthreads();  // the bitmaps are zero
  const long long span = static_cast<long long>(n_d_blocks) * blk_d;
  for (long long e = tid; e < n; e += kThreads) {
    const int col = e == tid ? first.col : __ldg(ci + e);
    const float val = e == tid ? first.val : __ldg(vi + e);
    if (val != 0.f && col >= 0 && col < span) {
      const int blk = blk_shift >= 0 ? col >> blk_shift : col / blk_d;
      const unsigned bit = 1u << (blk & 31);
      if (!(atomicOr(bitmap + (blk >> 5), bit) & bit)) atomicAdd(&n_set, 1);
    }
    if (val != 0.f && col >= 0 && col < d) {
      const int t = col / kTileLanes;
      atomicOr(busy + (t >> 5), 1u << (t & 31));
    }
  }
  __syncthreads();  // the bitmaps hold every live block and tile
  if (n_set > n_blocks_max) {  // the same in every thread
    if (tid < 32) keep_lowest(bitmap, nw, n_blocks_max);
    __syncthreads();  // the bitmap holds the kept blocks
  }
  const int rows = kThreads / tpr;
  const int lane = tid & (tpr - 1);
  for (int b0 = 0; b0 < B; b0 += rows) {
    const int b = b0 + tid / tpr;
    const bool live = b < B;
    const long long row = live ? b : 0;
    int c[kRowEntries];
    float v[kRowEntries], w[kRowEntries];
    float sum = 0.f;
    for (int s = 0; s < k; s += tpr * kRowEntries) {
      load_wave(c, v, ci + row * k, vi + row * k, k, s, lane, tpr, live);
      const unsigned use = wave_counts(c, v, d);
      gather_wave(w, c, use, Wi);
      sum = add_wave(sum, wave_in_map(c, use, bitmap, blk_d, blk_shift), v, w);
    }
    const float yb = live && lane == 0 ? __ldg(y + static_cast<size_t>(i) * B + row) : 0.f;
    sum = warp_sum(sum);
    if (tpr > 32) {  // the row's warps, summed in warp order by its first thread
      if ((tid & 31) == 0) partial[tid >> 5] = sum;
      __syncthreads();
      if (lane == 0) {
        sum = 0.f;
        for (int q = 0; q < tpr / 32; ++q) sum += partial[(tid >> 5) + q];
      }
      __syncthreads();  // partial is read before the next pass writes it
    }
    if (live && lane == 0) {
      const float mg = yb * sum;
      coeff[b] = mg < 1.f ? yb : 0.f;
    }
  }
  __syncthreads();  // the coefficients are in
  if (tid < n) first.c = coeff[tid / k];
  float* oi = out + static_cast<size_t>(i) * d;
  for (int t = t_begin; t < t_end; ++t) {
    const int j = t - t_begin;
    // the block's warps stay on one tile, so the device memory sees each
    // tile's 4 KB read and written together (measured at kdda on an H100:
    // 630 us a call with this barrier, 910 without)
    __syncthreads();
    copy_tile(w_tile[(j + kStages - 1) % kStages], Wi, t + kStages - 1, t_end, d);
    const int c0 = t * kTileLanes;
    const int lanes = min(kTileLanes, d - c0);
    const KeptLanes own{bitmap, c0, lanes, blk_d, blk_shift};
    const bool hit = (busy[t >> 5] >> (t & 31)) & 1u;  // the same in every thread
    if (hit) scatter_own(ci, vi, SharedCoeff{coeff}, B, k, first, own, acc, claim, lanes, kept);
    // this thread's lanes of tile t have landed; later tiles' copies run on
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    const float* wt = w_tile[j % kStages];
    for (int l = tid; l < lanes; l += kThreads) {
      const float decayed = __fmul_rn(wt[l], one_minus_s0);
      const float g = hit ? acc[l] : 0.f;
      oi[c0 + l] = own.has(c0 + l) ? __fadd_rn(decayed, __fmul_rn(s1, g)) : decayed;
    }
  }
}

// Tiles of kTileLanes columns in a row of d columns.
inline int fused_tiles(int d) { return (d + kTileLanes - 1) / kTileLanes; }

// Dynamic shared memory of ell_grad_update_fused_kernel: the kept-block and
// busy-tile bitmaps, then B coefficients.
size_t fused_smem(int B, int d, int n_d_blocks) {
  return (static_cast<size_t>(bitmap_words(n_d_blocks)) + bitmap_words(fused_tiles(d)) + B) *
         sizeof(unsigned);
}

template <bool kCoeff, bool kMap>
int launch_margins(const void* cols, const void* vals, const void* W, const void* y,
                   const void* block_ids, void* out, void* coeff, int m, int B, int k, int d,
                   int n_blocks_max, int blk_d, int n_d_blocks, void* stream) {
  const auto kernel = ell_margins_prefetch_kernel<kCoeff, kMap>;
  const size_t smem = kMap ? static_cast<size_t>(bitmap_words(n_d_blocks)) * sizeof(unsigned) : 0;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m > 0 && B > 0) {
    const int tpr = margin_row_threads(k);
    const int rows = B < kMarginThreads / tpr ? B : kMarginThreads / tpr;
    const dim3 grid((B + rows - 1) / rows, m);
    kernel<<<grid, rows * tpr, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(W), static_cast<const float*>(y),
        static_cast<const int*>(block_ids), static_cast<float*>(out),
        static_cast<float*>(coeff), B, k, d, n_blocks_max, blk_d,
        kMap ? block_shift(blk_d) : -1, n_d_blocks, tpr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// cols, vals (m, B, k), W (m, d), y (m, B) -> out (m, B) = y * (X w).
extern "C" int ell_margins(const void* cols, const void* vals, const void* W,
                           const void* y, void* out, int m, int B, int k, int d,
                           void* stream) {
  return launch_margins<false, false>(cols, vals, W, y, nullptr, out, nullptr, m, B, k, d, 0, 1,
                                      0, stream);
}

// As ell_margins, also writing coeff (m, B) = (out < 1) ? y : 0.
extern "C" int ell_margins_coeff(const void* cols, const void* vals, const void* W,
                                 const void* y, void* out, void* coeff, int m, int B, int k,
                                 int d, void* stream) {
  return launch_margins<true, false>(cols, vals, W, y, nullptr, out, coeff, m, B, k, d, 0, 1, 0,
                                     stream);
}

// As ell_margins, counting only entries whose d-block (col / blk_d) is in the
// node's row of block_ids (m, n_blocks_max); ids >= n_d_blocks are sentinels.
extern "C" int ell_margins_prefetch(const void* cols, const void* vals, const void* W,
                                    const void* y, const void* block_ids, void* out,
                                    int m, int B, int k, int d, int n_blocks_max,
                                    int blk_d, int n_d_blocks, void* stream) {
  return launch_margins<false, true>(cols, vals, W, y, block_ids, out, nullptr, m, B, k, d,
                                     n_blocks_max, blk_d, n_d_blocks, stream);
}

// As ell_margins_prefetch, also writing coeff (m, B) = (out < 1) ? y : 0.
extern "C" int ell_margins_prefetch_coeff(const void* cols, const void* vals, const void* W,
                                          const void* y, const void* block_ids, void* out,
                                          void* coeff, int m, int B, int k, int d,
                                          int n_blocks_max, int blk_d, int n_d_blocks,
                                          void* stream) {
  return launch_margins<true, true>(cols, vals, W, y, block_ids, out, coeff, m, B, k, d,
                                    n_blocks_max, blk_d, n_d_blocks, stream);
}

// cols, vals (m, B, k), W (m, d), coeff (m, B) -> out (m, d) =
// (1 - s0) W + s1 scatter(coeff_b vals[b, e] -> cols[b, e]), a block per
// (node, kTileLanes columns). vec is the W copies' and stores' width (the
// wrapper's _build.copy_width): 4 only with d % 4 == 0 and W and out
// 16-byte aligned, else 1.
extern "C" int ell_grad_update(const void* cols, const void* vals, const void* W,
                               const void* coeff, void* out, int m, int B, int k, int d,
                               int vec, float s0, float s1, void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (vec != 1 && (vec != 4 || d % 4 != 0 || !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0 && d > 0) {
    const dim3 grid((d + kTileLanes - 1) / kTileLanes, m);
    const int* c = static_cast<const int*>(cols);
    const float* v = static_cast<const float*>(vals);
    const float* w = static_cast<const float*>(W);
    const float* cf = static_cast<const float*>(coeff);
    float* o = static_cast<float*>(out);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec == 4)
      ell_grad_update_kernel<4><<<grid, kThreads, 0, st>>>(c, v, w, cf, o, B, k, d, 1.f - s0, s1);
    else
      ell_grad_update_kernel<1><<<grid, kThreads, 0, st>>>(c, v, w, cf, o, B, k, d, 1.f - s0, s1);
  }
  return static_cast<int>(cudaGetLastError());
}

// cols, vals (m, B, k), coeff (m, B), block_ids (m, n_blocks_max) ->
// G (m, n_blocks_max, blk_d): bucket j of node i holds the scatter of
// coeff_b vals[b, e] onto lanes cols[b, e] - block_ids[i, j] * blk_d.
extern "C" int ell_grad_update_prefetch(const void* cols, const void* vals,
                                        const void* coeff, const void* block_ids, void* G,
                                        int m, int B, int k, int n_blocks_max, int blk_d,
                                        int n_d_blocks, void* stream) {
  if (blk_d < 1 || blk_d > kTileLanes) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = kTileLanes / blk_d;  // whole buckets in a block's lanes, at least one
  const int slots = fit < 1 ? 1 : (fit > kMaxSlots ? kMaxSlots : fit);
  if (m > 0 && n_blocks_max > 0) {
    const dim3 grid((n_blocks_max + slots - 1) / slots, m);
    ell_grad_update_prefetch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(coeff), static_cast<const int*>(block_ids),
        static_cast<float*>(G), B, k, n_blocks_max, blk_d, n_d_blocks, slots);
  }
  return static_cast<int>(cudaGetLastError());
}

// As ell_grad_update_prefetch, folded into W (m, d): out (m, d) =
// (1 - s0) W everywhere, plus s1 G at the live buckets' lanes below d.
extern "C" int ell_grad_update_prefetch_fold(const void* cols, const void* vals,
                                             const void* coeff, const void* block_ids,
                                             const void* W, void* out, int m, int B, int k,
                                             int d, int n_blocks_max, int blk_d, int n_d_blocks,
                                             float s0, float s1, void* stream) {
  if (blk_d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0 && d > 0) {
    const dim3 grid((d + kTileLanes - 1) / kTileLanes, m);
    ell_grad_update_prefetch_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(coeff), static_cast<const int*>(block_ids),
        static_cast<const float*>(W), static_cast<float*>(out), B, k, d, n_blocks_max, blk_d,
        n_d_blocks, 1.f - s0, s1);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of ell_grad_update_fused on the current device: the
// tiles of a row of d columns into *tiles, and into *resident how many
// blocks the card holds at once at this shape's dynamic shared memory (the
// occupancy query times the multiprocessors), 0 where a block cannot have
// that much. The wrapper's grid rule (sparse.py's fused_grid) takes both.
extern "C" int ell_grad_update_fused_shape(int B, int d, int n_d_blocks, int* tiles,
                                           int* resident) {
  if (B < 1 || d < 1 || n_d_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  *tiles = fused_tiles(d);
  *resident = 0;
  const size_t smem = fused_smem(B, d, n_d_blocks);
  const void* kernel = reinterpret_cast<const void*>(ell_grad_update_fused_kernel);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess || smem + attr.sharedSizeBytes > static_cast<size_t>(optin))
    return static_cast<int>(e);
  e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_grad_update_fused_kernel,
                                                      kThreads, smem);
  *resident = per_sm * sms;
  return static_cast<int>(e);
}

// cols, vals (m, B, k), W (m, d), y (m, B) -> out (m, d): the sparse
// half-step of every node in one launch, bit for bit the touched-block map
// of n_blocks_max slots (ell_block_map), then ell_margins_prefetch_coeff and
// ell_grad_update_prefetch_fold, a block per (node, run of tiles_per_block
// tiles of kTileLanes columns).
extern "C" int ell_grad_update_fused(const void* cols, const void* vals, const void* W,
                                     const void* y, void* out, int m, int B, int k, int d,
                                     int n_blocks_max, int blk_d, int n_d_blocks,
                                     int tiles_per_block, float s0, float s1, void* stream) {
  if (blk_d < 1 || B < 1 || k < 1 || n_d_blocks < 1 || tiles_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fused_smem(B, d, n_d_blocks);
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(ell_grad_update_fused_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m > 0 && d > 0) {
    const dim3 grid((fused_tiles(d) + tiles_per_block - 1) / tiles_per_block, m);
    ell_grad_update_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(W), static_cast<const float*>(y), static_cast<float*>(out), B,
        k, d, n_blocks_max, blk_d, block_shift(blk_d), n_d_blocks, margin_row_threads(k),
        tiles_per_block, 1.f - s0, s1);
  }
  return static_cast<int>(cudaGetLastError());
}

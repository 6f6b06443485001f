// Scatter-add of per-ray row cotangents into the triangle row table:
// out[idx[r], k] = sum of dvals[k, r] over the rays r with idx[r] = row.
//
// Replaces the TPU kernel `_scatter_rows_kernel`
// (montecarlopathtracer_tpu/ops/intersect_pallas.py, entry
// `scatter_rows`), which built the sum as a one-hot matmul on the MXU
// from a bf16 term split of the cotangents, one ray tile per sequential
// grid step, so its sums came out in a fixed order. The plain PyTorch
// version is `scatter_rows_ref` in ops/scatter_rows.py (index_add_).
//
// What bounds it on an H100: bytes. An 800x600 segment reads 480,000 x 48
// floats (92 MB) of cotangents and 1.9 MB of indices and writes a table of
// T x 192 bytes; ~0.03 ms at 3.35 TB/s. The hard part is the many rays
// per row: in a Cornell box tens of thousands of rays hit one wall
// triangle, and adding them with atomics serializes on the same 48
// addresses and adds in no fixed order.
//
// What the design does about it: group, then sum, with no atomics on the
// table and every sum in a fixed order, so two calls give bit-equal
// tables, as the TPU kernel's do. It works tile by tile in ray order, as
// the TPU kernel's grid did, so that each sum reads a small window of
// each column: after a sort of all rays by row, 32 consecutive sorted
// rays of an incoherent bounce read 48 x 32 scattered sectors, ~7x the
// bytes, and that sum took most of the scatter's time.
// A. Each tile of 4,096 consecutive rays sorts its hitting rays by row,
//    stably, with an LSD counting sort written here (no library sort): one
//    pass of <= 10-bit digits for T <= 1,024 (the Cornell box's 652), two
//    for T <= 2^20 (the bunny's 81,932), three up to the contract's limit.
//    Equal digits in a warp are grouped with __match_any_sync, so counts
//    are integer adds by one lane and ranks follow lane order. Rays with
//    idx = -1 (and any index outside [0, T)) are dropped.
// B. Per (tile, 4 columns): thread i owns the tile's sorted entries
//    [16 i, 16 i + 16); it adds its entries of each run of equal rows in
//    order in f64, a block segmented scan in a fixed tree order completes
//    the runs that cross threads, and each run's sum is rounded to f32
//    into a partial table [tile, column, run]. The tile's 16 KB window of
//    each column is read coalesced into shared memory (the next column's
//    loads in flight meanwhile), and the sorted entries read it there:
//    gathers straight from L1 cost one transaction per lane.
// C. One warp per row adds the partials of the tiles that hold the row
//    (a bitmap per tile, then a search of the tile's run list), in tile
//    order, in f64, and writes the row once, 0 where no ray hit.
// Error: f64 sums, one f32 rounding per tile's partial (their magnitudes
// add up to at most sum |dvals|) and one at the end: ~eps32 x sum |dvals|
// per entry, inside the 16 x eps32 x sum |dvals| of
// testing.compare_scatter (sequential f32 chains over 36,000 rays are
// not). Every entry of `out` is written once; the caller allocates it
// with torch.empty, and the workspace needs no zeroing (each tile clears
// its own row bitmap).
// Grid sizes follow from R and T alone: no device queries, three
// launches.
//
// The small-table path (scatter_rows_small_launch; the wrapper takes it
// for T <= T_SMALL, ops/scatter_rows.py). With a few dozen rows the sort
// buys nothing: a tile of 4,096 rays holds at most T runs, and at T = 32
// (the Cornell box) the three kernels above took ~116 us a call on an
// H100 against a 28-us floor for the 92 MB of cotangents, the sum kernel
// streaming at ~1.2 TB/s and the combine running 32 warps on 132 SMs.
// Two kernels instead, no sort, no run lists, no search:
// S1. One block per SM (`blocks` from the wrapper: 132, fewer for small
//     R), 8 warps (fewer as T grows: small_warps). The block's rays are a contiguous
//     range of 32-ray chunks; its warps take them in turn. A warp stages a
//     chunk's 48 x 32 values with 16-byte loads that leave no line in L1
//     (the next chunk's loads in flight while it adds this one) into its
//     own shared-memory window, then walks the chunk ray by ray with lane
//     l owning columns l and 32 + l: the row is the same for every lane,
//     so the lanes add the ray's 48 values into 48 different f64 bins of
//     the warp's own [T][48], and no two lanes or warps touch one bin.
//     The walk has no branch on the row (a ray whose idx is outside
//     [0, T) adds 0 into row 0), so the adds of consecutive rays overlap:
//     on an H100 a walk that branched to add each run of equal rows in
//     registers first was bound by its chain of dependent instructions,
//     at ~60 us a call against this walk's ~42. The block then sums its
//     warps' bins in warp order into its partial [T][48], kept in f64.
// S2. Every (row, column) pair is summed over the blocks' partials by the
//     lanes of one block's warps (each warp a stride of the blocks, then
//     the warps in order), in f64, rounded once, every entry of `out`
//     written once.
// What bounds it: bytes, as above; and the bins, T x 48 x 8 bytes a warp
// beside a 7-KB stage, in 227 KB of shared memory: 8 warps up to T = 46,
// 4 at T = 128 (the path's limit), and fewer warps overlap less. Error:
// f64 throughout, one rounding; the order is fixed, so two calls give
// bit-equal tables. T_SMALL (ops/scatter_rows.py) is 128, the path's
// limit, since it beat the sort path up to there on an H100 (700 W),
// device ms a call at R = 480,000 on one segment's cotangents of the
// published Cornell box: T = 32 0.041 against 0.110; the rows spread
// over T = 64 0.047 against 0.117, over T = 128 0.061 against 0.122.
//
// Contract (that of scatter_rows): idx i32[R] (-1 = adds nothing),
// dvals f32[48, R]; out f32[T, 48]; `work` holds
// scatter_rows_workspace(R, T) bytes, 256-byte aligned (the small path:
// blocks x T x 48 doubles).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kCols = 48;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                  // threads per block of the three kernels
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                    // rays per tile
constexpr int kPerThread = kTile / kThreads;   // sorted entries per thread (16)
constexpr int kWarpSteps = kTile / kWarps / 32;  // 32-entry steps per warp in the sort (16)
constexpr int kMaxDigitBits = 10;
constexpr int kMaxBuckets = 1 << kMaxDigitBits;
constexpr int kColGroup = 4;                   // columns per block of the sum kernel
constexpr int kBatch = 8;                      // tiles whose partials the combine loads together

// The sort's digits and passes for rows [0, T).
struct Digits {
  int passes, bits;
};

__host__ __device__ inline Digits digits_of(int T) {
  int nbits = 1;
  while (nbits < 31 && ((T - 1) >> nbits) != 0) ++nbits;
  const int passes = (nbits + kMaxDigitBits - 1) / kMaxDigitBits;
  return {passes, (nbits + passes - 1) / passes};
}

// Block-wide exclusive scan of one int per thread (kThreads of them);
// `total` receives the sum. `scratch` holds kWarps ints.
__device__ __forceinline__ int block_exclusive_scan(int x, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) scratch[w] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const int c = scratch[v];
    before += v < w ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + incl - x;
}

// A. Each tile of kTile consecutive rays sorts its hitting rays by row,
// stably: an LSD counting sort in 1-3 passes of <= 10-bit digits, in the
// tile's own region of the (row, ray) buffers. Per pass each warp counts
// its 512 entries' digits (__match_any_sync groups equal digits, so the
// counts are integer adds by one lane), the block scans (digit, warp) in
// that order, and each warp writes its entries in order, ranking equal
// digits among its lanes. Rays with idx outside [0, T) (idx = -1) are
// dropped by the first pass. The tile's count goes to tile_n, and its
// row bitmap is cleared for kernel B.
__global__ void __launch_bounds__(kThreads)
scatter_rows_sort_kernel(const int* __restrict__ idx, int R, int T, int* __restrict__ keys0,
                         int* __restrict__ ids0, int* __restrict__ keys1, int* __restrict__ ids1,
                         int* __restrict__ tile_n, unsigned* __restrict__ bitmap, int words) {
  __shared__ int off[kWarps][kMaxBuckets];
  __shared__ int scratch[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int base = blockIdx.x * kTile;
  const Digits dg = digits_of(T);
  const int nb = 1 << dg.bits;
  const unsigned below = (1u << lane) - 1u;
  for (int q = threadIdx.x; q < words; q += kThreads) bitmap[(size_t)blockIdx.x * words + q] = 0u;
  int len = min(kTile, R - base);  // entries of this pass's input
  for (int p = 0; p < dg.passes; ++p) {
    const int* kin = p == 0 ? idx + base : ((p & 1) ? keys0 : keys1) + base;
    const int* iin = ((p & 1) ? ids0 : ids1) + base;
    int* kout = ((p & 1) ? keys1 : keys0) + base;
    int* iout = ((p & 1) ? ids1 : ids0) + base;
    const int shift = p * dg.bits;
    int kr[kWarpSteps], ir[kWarpSteps];  // the warp's entries, all loads in flight together
#pragma unroll
    for (int s = 0; s < kWarpSteps; ++s) {
      const int i = (w * kWarpSteps + s) * 32 + lane;
      const int k = i < len ? kin[i] : -1;
      kr[s] = (p > 0 || (k >= 0 && k < T)) ? k : -1;
      ir[s] = p == 0 ? base + i : (i < len ? iin[i] : 0);
    }
    for (int b = threadIdx.x; b < nb; b += kThreads)
#pragma unroll
      for (int v = 0; v < kWarps; ++v) off[v][b] = 0;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kWarpSteps; ++s) {
      const int d = kr[s] < 0 ? -1 : (kr[s] >> shift) & (nb - 1);
      const unsigned peers = __match_any_sync(kFull, d);
      if (d >= 0 && lane == __ffs(peers) - 1) off[w][d] += __popc(peers);
    }
    __syncthreads();
    // Digit totals, scanned over digits; thread t owns digits t, t + 256, ...
    // in blocks of four consecutive digits.
    int mine = 0;
#pragma unroll
    for (int q = 0; q < kMaxBuckets / kThreads; ++q) {
      const int b = threadIdx.x * (kMaxBuckets / kThreads) + q;
      if (b < nb)
#pragma unroll
        for (int v = 0; v < kWarps; ++v) mine += off[v][b];
    }
    int n_kept;
    int run = block_exclusive_scan(mine, scratch, n_kept);
#pragma unroll
    for (int q = 0; q < kMaxBuckets / kThreads; ++q) {
      const int b = threadIdx.x * (kMaxBuckets / kThreads) + q;
      if (b < nb) {
#pragma unroll
        for (int v = 0; v < kWarps; ++v) {
          const int c = off[v][b];
          off[v][b] = run;
          run += c;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kWarpSteps; ++s) {
      const int d = kr[s] < 0 ? -1 : (kr[s] >> shift) & (nb - 1);
      const unsigned peers = __match_any_sync(kFull, d);
      if (d >= 0) {
        const int pos = off[w][d] + __popc(peers & below);
        kout[pos] = kr[s];
        iout[pos] = ir[s];
      }
      __syncwarp();
      if (d >= 0 && lane == __ffs(peers) - 1) off[w][d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();  // this pass's output is the next one's input
    len = n_kept;
  }
  if (threadIdx.x == 0) tile_n[blockIdx.x] = len;
}

// (value, starts-a-segment) pairs of a segmented inclusive scan: a
// segment start drops what came before it.
struct Seg {
  double v;
  int f;
};

__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {
  return {b.f ? b.v : a.v + b.v, a.f | b.f};
}

// Block-wide segmented inclusive scan over one Seg per thread, in a fixed
// tree order. `scratch` holds kWarps Segs.
__device__ __forceinline__ Seg block_seg_scan(Seg x, Seg* scratch) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg y = {__shfl_up_sync(kFull, x.v, off), __shfl_up_sync(kFull, x.f, off)};
    if (lane >= off) x = seg_combine(y, x);
  }
  if (lane == 31) scratch[w] = x;
  __syncthreads();
  Seg carry = {0.0, 0};
  bool have = false;
  for (int v = 0; v < w; ++v) {
    carry = have ? seg_combine(carry, scratch[v]) : scratch[v];
    have = true;
  }
  __syncthreads();
  return have ? seg_combine(carry, x) : x;
}

// B. Block (tile, column group): the sum of every run of equal rows of
// the tile's sorted list over kColGroup columns. Thread i owns the sorted
// entries [16 i, 16 i + 16); it adds its entries of each run in order in
// f64, and a block segmented scan over the threads completes the runs
// that cross threads. Each run's sum is rounded to f32 into
// part[tile][column][ordinal] (ordinal: the run's place in the tile);
// blockIdx.y = 0 also lists the runs' rows and sets the tile's row
// bitmap. The values come from the tile's 16 KB
// window of each column, staged in shared memory by coalesced loads.
__global__ void __launch_bounds__(kThreads)
scatter_rows_sum_kernel(const int* __restrict__ keys, const int* __restrict__ ids,
                        const int* __restrict__ tile_n, const float* __restrict__ dvals, int R,
                        int cap, float* __restrict__ part, int* __restrict__ run_rows,
                        int* __restrict__ run_n, unsigned* __restrict__ bitmap, int words) {
  __shared__ int scratch[kWarps];
  __shared__ Seg seg_scratch[kWarps];
  __shared__ double hand[kThreads];  // each thread's inclusive scan value
  __shared__ float window[kTile];    // the tile's values of the current column
  const int b = blockIdx.x, base = b * kTile;
  const int n = tile_n[b];
  const int e0 = threadIdx.x * kPerThread;
  int kr[kPerThread], ir[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = e0 + q;
    kr[q] = e < n ? keys[base + e] : -1;
    ir[q] = e < n ? ids[base + e] : 0;
  }
  const int before = (e0 > 0 && e0 <= n) ? keys[base + e0 - 1] : -1;
  const int after = e0 + kPerThread < n ? keys[base + e0 + kPerThread] : -1;
  // Run starts and ends among the thread's entries, as bit masks.
  unsigned starts = 0, ends = 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    if (e0 + q >= n) break;
    const int prev = q == 0 ? before : kr[q - 1];
    const int next = q + 1 < kPerThread ? kr[q + 1] : after;
    if (kr[q] != prev) starts |= 1u << q;
    if (kr[q] != next) ends |= 1u << q;
  }
  int runs;
  const int ord0 = block_exclusive_scan(__popc(starts), scratch, runs);
  if (blockIdx.y == 0) {
    int o = ord0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (starts & (1u << q)) {
        run_rows[(size_t)b * cap + o++] = kr[q];
        atomicOr(bitmap + (size_t)b * words + (kr[q] >> 5), 1u << (kr[q] & 31));
      }
    }
    if (threadIdx.x == 0) run_n[b] = runs;
  }
  const int m = max(0, min(n - e0, kPerThread));  // the thread's entries
  // The thread's first run began in an earlier thread; its last one goes
  // on into a later thread.
  const bool open_first = m > 0 && !(starts & 1u);
  const bool open_last = m > 0 && !(ends & (1u << (m - 1)));
  // The tile's window of a column, read coalesced (thread i takes rays
  // base + i, base + i + 256, ...); the next column's loads are in flight
  // while the current one is summed.
  const int span = min(kTile, R - base);
  float next[kPerThread];
  auto load_window = [&](int k) {
    const float* col = dvals + (size_t)k * R + base;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = q * kThreads + threadIdx.x;
      next[q] = i < span ? __ldg(col + i) : 0.0f;
    }
  };
  load_window(blockIdx.y * kColGroup);
  for (int c = 0; c < kColGroup; ++c) {
    const int k = blockIdx.y * kColGroup + c;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) window[q * kThreads + threadIdx.x] = next[q];
    __syncthreads();
    if (c + 1 < kColGroup) load_window(k + 1);
    float v[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) v[q] = q < m ? window[ir[q] - base] : 0.0f;
    float* out = part + ((size_t)b * kCols + k) * cap;
    double acc = 0.0, first = 0.0;
    bool in_first = open_first, first_done = false;
    int o = ord0 - 1;  // the ordinal of the run in progress
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (q >= m) break;
      if (starts & (1u << q)) {
        ++o;
        in_first = false;
      }
      acc += static_cast<double>(v[q]);
      if (ends & (1u << q)) {
        if (in_first) {  // completed below, with what the earlier threads hold
          first = acc;
          first_done = true;
        } else {
          out[o] = static_cast<float>(acc);
        }
        acc = 0.0;
        in_first = false;
      }
    }
    // Handed on: the open run's sum so far, which starts a segment of the
    // scan unless it is the run this thread received.
    const bool through = open_first && !first_done && open_last;
    const Seg incl = block_seg_scan({open_last ? acc : 0.0, through ? 0 : 1}, seg_scratch);
    hand[threadIdx.x] = incl.v;
    __syncthreads();
    if (first_done) out[ord0 - 1] = static_cast<float>(hand[threadIdx.x - 1] + first);
    __syncthreads();
  }
}

// First position of `rows` [0, n) (ascending) holding a row >= t.
__device__ __forceinline__ int lower_bound(const int* __restrict__ rows, int n, int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// C. One warp per row t: the tiles that hold t (their bitmaps), each
// tile's run of t (a search of its run list), and the sum of those runs'
// partials over the tiles in order, in f64, rounded once; kBatch tiles'
// loads are issued before their adds. A row no ray hits gets 0. Every entry of
// `out` is written here, once.
__global__ void __launch_bounds__(kThreads)
scatter_rows_combine_kernel(const float* __restrict__ part, const int* __restrict__ run_rows,
                            const int* __restrict__ run_n, const unsigned* __restrict__ bitmap,
                            int words, int ntiles, int cap, int T, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;
  const bool hi = lane < kCols - 32;  // the lane also owns column lane + 32
  double acc0 = 0.0, acc1 = 0.0;
  for (int b0 = 0; b0 < ntiles; b0 += 32) {
    const int b = b0 + lane;
    const bool has = b < ntiles && ((bitmap[(size_t)b * words + (t >> 5)] >> (t & 31)) & 1u);
    const int j = has ? lower_bound(run_rows + (size_t)b * cap, run_n[b], t) : 0;
    unsigned mask = __ballot_sync(kFull, has);
    while (mask) {
      float v0[kBatch], v1[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const bool any = mask != 0;
        const int src = any ? __ffs(mask) - 1 : 0;
        mask &= mask - 1;
        const int jb = __shfl_sync(kFull, j, src);
        const float* p = part + (size_t)(b0 + src) * kCols * cap + jb;
        v0[q] = any ? p[(size_t)lane * cap] : 0.0f;
        v1[q] = any && hi ? p[(size_t)(lane + 32) * cap] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {  // adding a missing tile's 0 changes nothing
        acc0 += static_cast<double>(v0[q]);
        acc1 += static_cast<double>(v1[q]);
      }
    }
  }
  out[(size_t)t * kCols + lane] = static_cast<float>(acc0);
  if (hi) out[(size_t)t * kCols + 32 + lane] = static_cast<float>(acc1);
}

// The small-table path (see the note at the head of this file).
constexpr int kChunk = 32;                            // rays a warp stages at a time
constexpr int kPitch = 36;                            // floats a staged column (see S1)
constexpr int kStageFloats = kCols * kPitch + kChunk; // a chunk's values, then its rows
constexpr int kStageBytes = kStageFloats * 4;         // 7,040
constexpr int kSmallWarps = 8;                        // warps of a block, at most
constexpr int kSmallMaxT = 128;                       // four warps' bins still fit
constexpr int kSmemMax = 232448;                      // dynamic shared memory a block may take on sm_90
constexpr int kSmemKeep = 199680;                     // ... leaving 60 KB of L1 (see small_warps)
constexpr int kMergeWarps = 16;                       // warps of a block of the combine

// Warps of a block for T rows: as many as fit in kSmemKeep bytes, at most
// eight, or four where fewer would fit there. Measured on an H100 at
// R = 480,000 (S1 alone, us): T = 32 with 4-12 warps 45.5, 42.1, 39.4,
// 39.1, 37.9, 38.3, 38.3, 42.3, 43.1 (the last two above kSmemKeep);
// T = 64 with 3-7 warps 58.2, 47.4, 44.4, 41.4, 46.2; T = 128 with 2-4
// warps 88.6, 61.9, 51.5.
int small_warps(int T) {
  const int per = kStageBytes + T * kCols * 8;
  const int w = kSmemKeep / per >= 4 ? kSmemKeep / per : kSmemMax / per;
  return w < kSmallWarps ? w : kSmallWarps;
}

size_t small_smem(int T) { return (size_t)small_warps(T) * (kStageBytes + T * kCols * 8); }

// Rays [r, r + 4) of one column, 0 past R: one 16-byte load that leaves
// no line in L1 (the shared memory holds the bins) where the column is
// 16-byte aligned (kVec), else four.
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ col, long long r, int R) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kVec) {
    if (r < R)
      asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
                   : "l"(col + r));
  } else {
    if (r < R) x.x = __ldg(col + r);
    if (r + 1 < R) x.y = __ldg(col + r + 1);
    if (r + 2 < R) x.z = __ldg(col + r + 2);
    if (r + 3 < R) x.w = __ldg(col + r + 3);
  }
  return x;
}

// S1. Block b: the per-row sums of its rays, [T][48] in f64, into part[b]
// (see the note at the head of this file). A chunk's 48 x 32 values
// arrive as 12 16-byte loads a lane (lane l: rays 4 (l % 8) .. + 3 of
// columns l / 8, l / 8 + 4, ...) and are staged column by column with a
// pitch of 36 floats, so that both the quads' stores and a lane's reads
// of four rays of its column touch every bank once. Then, ray by ray,
// each lane adds its columns' values into the warp's bins of the ray's
// row: the row is the same for every lane, so no two lanes add into one
// bin, and there is no branch on the row, so the adds of consecutive
// rays overlap. A ray with idx outside [0, T) adds 0 into row 0.
template <bool kVec>
__global__ void __launch_bounds__(kSmallWarps * 32)
scatter_rows_bin_kernel(const int* __restrict__ idx, const float* __restrict__ dvals, int R,
                        int T, double* __restrict__ part) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int tk = T * kCols;
  double* bins = smem + (size_t)w * tk;
  float* stage = reinterpret_cast<float*>(smem + (size_t)nw * tk) + w * kStageFloats;
  int* rows = reinterpret_cast<int*>(stage + kCols * kPitch);
  for (int p = lane; p < tk; p += 32) bins[p] = 0.0;
  const long long chunks = ((long long)R + kChunk - 1) / kChunk;
  const int c0 = (int)(chunks * blockIdx.x / gridDim.x);
  const int c1 = (int)(chunks * (blockIdx.x + 1) / gridDim.x);
  const int quad = lane & 7, cg = lane >> 3;
  // Chunk c: lane l's ray's row (0 when it adds nothing), whether it
  // adds, and the lane's 12 quads.
  float4 v[kCols / 4];
  int row = 0;
  bool adds = false;
  auto load = [&](int c) {
    const long long r0 = (long long)c * kChunk;
    const int k = r0 + lane < R ? __ldg(idx + r0 + lane) : -1;
    adds = k >= 0 && k < T;
    row = adds ? k : 0;
#pragma unroll
    for (int s = 0; s < kCols / 4; ++s)
      v[s] = load_quad<kVec>(dvals + (size_t)(4 * s + cg) * R, r0 + 4 * quad, R);
  };
  const bool two = lane < kCols - 32;  // the lane also owns column 32 + lane
  int c = c0 + w;
  if (c < c1) load(c);
  for (; c < c1; c += nw) {
    __syncwarp();  // the previous chunk's reads of the stage are done
#pragma unroll
    for (int s = 0; s < kCols / 4; ++s)
      *reinterpret_cast<float4*>(stage + (4 * s + cg) * kPitch + 4 * quad) = v[s];
    rows[lane] = row;
    const unsigned added = __ballot_sync(kFull, adds);
    __syncwarp();
    if (c + nw < c1) load(c + nw);
#pragma unroll
    for (int g = 0; g < kChunk / 4; ++g) {
      const int4 t = *reinterpret_cast<const int4*>(rows + 4 * g);
      const float4 x = *reinterpret_cast<const float4*>(stage + lane * kPitch + 4 * g);
      float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (two) y = *reinterpret_cast<const float4*>(stage + (32 + lane) * kPitch + 4 * g);
      const int ts[4] = {t.x, t.y, t.z, t.w};
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = (added >> (4 * g + e)) & 1u;
        double* bin = bins + ts[e] * kCols;
        bin[lane] += in ? static_cast<double>(xs[e]) : 0.0;
        if (two) bin[32 + lane] += in ? static_cast<double>(ys[e]) : 0.0;
      }
    }
  }
  __syncthreads();
  double* out = part + (size_t)blockIdx.x * tk;
  for (int p = threadIdx.x; p < tk; p += blockDim.x) {
    double s = 0.0;
    for (int u = 0; u < nw; ++u) s += smem[(size_t)u * tk + p];
    out[p] = s;
  }
}

// S2. Block i: pairs p in [32 i, 32 i + 32) of the [T][48] table; warp w
// adds part[b][p] for b = w, w + kMergeWarps, ... in order (four loads in
// flight), then the warps' sums in warp order; rounded once into out[p].
__global__ void __launch_bounds__(kMergeWarps * 32)
scatter_rows_merge_kernel(const double* __restrict__ part, int nparts, int tk,
                          float* __restrict__ out) {
  __shared__ double sums[kMergeWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (p < tk) {
    const double* col = part + p;
    int b = w;
    for (; b + 3 * kMergeWarps < nparts; b += 4 * kMergeWarps) {
      double x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = __ldg(col + (size_t)(b + q * kMergeWarps) * tk);
#pragma unroll
      for (int q = 0; q < 4; ++q) s += x[q];
    }
    for (; b < nparts; b += kMergeWarps) s += __ldg(col + (size_t)b * tk);
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && p < tk) {
    double t = 0.0;
#pragma unroll
    for (int u = 0; u < kMergeWarps; ++u) t += sums[u][lane];
    out[p] = static_cast<float>(t);
  }
}

struct Layout {
  int ntiles, cap, words;
  size_t keys[2], ids[2], tile_n, run_n, run_rows, bitmap, part, bytes;
};

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// The workspace's layout for R rays and T rows.
Layout layout(int R, int T) {
  Layout L;
  L.ntiles = R > 0 ? (R + kTile - 1) / kTile : 1;
  L.cap = T < kTile ? T : kTile;  // runs per tile
  L.words = (T + 31) / 32;
  const size_t nt = L.ntiles, rays = (size_t)L.ntiles * kTile;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at = align256(at + bytes);
    return here;
  };
  for (int b = 0; b < 2; ++b) {
    L.keys[b] = take(rays * sizeof(int));
    L.ids[b] = take(rays * sizeof(int));
  }
  L.tile_n = take(nt * sizeof(int));
  L.run_n = take(nt * sizeof(int));
  L.run_rows = take(nt * L.cap * sizeof(int));
  L.bitmap = take(nt * L.words * sizeof(unsigned));
  L.part = take(nt * kCols * L.cap * sizeof(float));
  L.bytes = at;
  return L;
}

}  // namespace

// Bytes of workspace that scatter_rows_launch needs for R rays and T rows.
extern "C" size_t scatter_rows_workspace(int R, int T) { return layout(R, T).bytes; }

// Launches the tile sort, the run sums and the combine on `stream`;
// returns the first CUDA error so the caller can raise on a refused launch.
extern "C" int scatter_rows_launch(const int* idx, const float* dvals, int R, int T, float* out,
                                   void* work, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L = layout(R, T);
  char* w = static_cast<char*>(work);
  auto at = [&](size_t off) { return reinterpret_cast<int*>(w + off); };
  // The sorted (row, ray) pairs end in buffer 0 after an odd number of
  // passes and in buffer 1 after an even one.
  const int last = (digits_of(T).passes - 1) & 1;
  unsigned* bitmap = reinterpret_cast<unsigned*>(w + L.bitmap);
  scatter_rows_sort_kernel<<<L.ntiles, kThreads, 0, s>>>(
      idx, R, T, at(L.keys[0]), at(L.ids[0]), at(L.keys[1]), at(L.ids[1]), at(L.tile_n), bitmap,
      L.words);
  scatter_rows_sum_kernel<<<dim3(L.ntiles, kCols / kColGroup), kThreads, 0, s>>>(
      at(L.keys[last]), at(L.ids[last]), at(L.tile_n), dvals, R, L.cap,
      reinterpret_cast<float*>(w + L.part), at(L.run_rows), at(L.run_n), bitmap, L.words);
  scatter_rows_combine_kernel<<<(T + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      reinterpret_cast<const float*>(w + L.part), at(L.run_rows), at(L.run_n), bitmap, L.words,
      L.ntiles, L.cap, T, out);
  return static_cast<int>(cudaGetLastError());
}

// Lets the small path's S1 take its dynamic shared memory (above 48 KB)
// on the current device; called once a device, before any launch, never
// inside a CUDA graph's capture.
extern "C" int scatter_rows_small_init() {
  cudaError_t err = cudaFuncSetAttribute(scatter_rows_bin_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scatter_rows_bin_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return static_cast<int>(err);
}

// Launches the small path's S1 over `blocks` blocks and S2 on `stream`
// (T in [1, 128]; `work` holds blocks x T x 48 doubles); returns the
// first CUDA error.
extern "C" int scatter_rows_small_launch(const int* idx, const float* dvals, int R, int T,
                                         float* out, void* work, int blocks, void* stream) {
  if (T < 1 || T > kSmallMaxT || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(work);
  const int tk = T * kCols;
  const bool vec = R % 4 == 0 && reinterpret_cast<size_t>(dvals) % 16 == 0;
  const dim3 grid(blocks), block(small_warps(T) * 32);
  if (vec)
    scatter_rows_bin_kernel<true><<<grid, block, small_smem(T), s>>>(idx, dvals, R, T, part);
  else
    scatter_rows_bin_kernel<false><<<grid, block, small_smem(T), s>>>(idx, dvals, R, T, part);
  scatter_rows_merge_kernel<<<(tk + 31) / 32, kMergeWarps * 32, 0, s>>>(part, blocks, tk, out);
  return static_cast<int>(cudaGetLastError());
}

// Nearest-hit selection by a front-to-back walk over Morton chunks of
// triangles, one ray tile per block, one ray per thread.
//
// Replaces the TPU kernel `_traverse_kernel`
// (montecarlopathtracer_tpu/ops/traverse_pallas.py, entry
// `traverse_select`). The plain PyTorch version is `traverse_select_ref`
// in ops/traverse_walk.py: brute f32 selection over the same
// Morton-permuted table.
//
// The triangle axis is in Morton order, so chunk j (triangles
// 128 j .. 128 j + 127) is spatially tight and has an AABB
// [clo[j], chi[j]]. `tile_chunk_order` (ops/traverse_walk.py, torch
// ops) gives each tile of 128 rays its list of reachable chunks sorted
// by tmin, a lower bound on the hit distance of any of the tile's rays
// in that chunk. The block walks that list:
//
// - per lane, a slab test of the ray segment [0, best t] against the
//   chunk's box, widened by a small margin (the TPU kernel's
//   `_slab_reach` has none, so a hit that grazes a box face could be
//   skipped); `__syncthreads_or` skips the chunk when no lane reaches it
//   (the slab test, the staging and the pair test are those of
//   nearest_common.cuh, shared with the culling B1c and B4c);
// - a reached chunk's 12 geometry floats per triangle (rows[:, 0:12])
//   are staged in shared memory as three float4 each, and every reaching
//   lane tests all of them with B1's accept test (IEEE division,
//   explicit comparisons so that NaN never wins);
// - the winner is the least (t, index) pair: a tie at equal t in a chunk
//   visited later still goes to the smaller index, as brute selection's
//   does (the TPU kernel let such ties differ per tile);
// - the walk stops when the next chunk's tmin exceeds
//   max(best t over live lanes) * (1 + 1e-6) + 1e-6 (the TPU kernel's
//   early exit, whose slack absorbs the ~1e-7 length error of a bounce
//   direction), and at once for a tile with no live lane.
//
// Every thread reaches each barrier: lanes that are not live take part
// in the block votes and do no other work.
//
// What bounds it on an H100: the pair tests of the chunks that are
// visited (~15 FMAs and one division each, as in B1) and, on incoherent
// bounce tiles, the per-position slab tests and barriers. A chunk's
// geometry is read from global memory once per block that visits it.
//
// Contract: rows f32[T, 48] (Morton order); clo/chi f32[nc, 3] with
// nc = ceil(T / 128); pos/dir f32[3, R]; live bool[R]; order i32[nt, nc],
// tmin f32[nt, nc], n_reach i32[nt] with nt = ceil(R / 128). Output
// idx i32[R]: the winner's index in the Morton order, -1 for a miss and
// for a lane that is not live. With `visits` non-null, visits[tile] is
// the number of list positions walked and visits[nt + tile] the number
// of chunks whose triangles were tested.

#include <cuda_runtime.h>

#include <climits>

#include "nearest_common.cuh"
#include "segment_common.cuh"

namespace {

using namespace seg;

constexpr int kThreads = 128;  // rays per block = rays per tile

__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float* __restrict__ rows, int T, const float* __restrict__ clo,
                const float* __restrict__ chi, int nc, const float* __restrict__ pos,
                const float* __restrict__ dir, const bool* __restrict__ live, int R,
                const int* __restrict__ order, const float* __restrict__ tmin,
                const int* __restrict__ n_reach, int* __restrict__ idx_out,
                int* __restrict__ visits) {
  __shared__ float4 geom[kChunk * 3];

  const int tile = blockIdx.x;
  const int r = tile * kThreads + threadIdx.x;
  const bool act = r < R && live[r];
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  if (r < R) {
    o = load3(pos, R, r);
    d = load3(dir, R, r);
  }
  const Slab slab = make_slab(o, d);

  Hit best = {kBig, 0.0f, 0.0f, INT_MAX};
  const int n = n_reach[tile];
  const int* ord = order + static_cast<size_t>(tile) * nc;
  const float* tm = tmin + static_cast<size_t>(tile) * nc;
  int walked = 0, tested = 0;
  for (int p = 0; p < n; ++p) {
    const int j = ord[p];
    const bool reach = act && slab_reach(slab, clo, chi, j, best.t);
    ++walked;
    if (__syncthreads_or(reach)) {
      ++tested;
      const int base = j * kChunk;
      const int cnt = min(kChunk, T - base);
      stage_geometry(geom, rows, 48, base, cnt);
      __syncthreads();
      if (reach) test_tile<false, false>(geom, cnt, base, o, d, best);
      __syncthreads();
    }
    // Early exit: tmin is sorted ascending and lower-bounds every hit
    // in the chunks after p, so once it passes every live lane's best t
    // (with slack) nothing later can win.
    const bool more = p + 1 < n && act && tm[p + 1] <= best.t * (1.0f + 1e-6f) + 1e-6f;
    if (!__syncthreads_or(more)) break;
  }
  if (visits != nullptr && threadIdx.x == 0) {
    visits[tile] = walked;
    visits[gridDim.x + tile] = tested;
  }
  if (r < R) idx_out[r] = best.t < kBig ? best.i : -1;
}

}  // namespace

// Launches the walk on `stream`, one block per tile of 128 rays;
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int traverse_select_launch(const float* rows, int T, const float* clo,
                                      const float* chi, int nc, const float* pos,
                                      const float* dir, const bool* live, int R,
                                      const int* order, const float* tmin, const int* n_reach,
                                      int* idx, int* visits, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    traverse_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, T, clo, chi, nc, pos, dir, live, R, order, tmin, n_reach, idx, visits);
  }
  return static_cast<int>(cudaGetLastError());
}

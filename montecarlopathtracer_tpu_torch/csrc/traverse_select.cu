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
//   skipped); `__syncthreads_or` skips the chunk when no lane reaches it;
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

#include "segment_common.cuh"

namespace {

using namespace seg;

constexpr int kThreads = 128;  // rays per block = rays per tile
constexpr int kChunk = 128;    // triangles per Morton chunk

// The box margin: a relative 1e-5 of the box's coordinates plus an
// absolute 1e-5, far above the f32 rounding of a hit point or a slab
// distance, so a chunk whose box a hit grazes is never skipped.
__device__ __forceinline__ float margin(float lo, float hi) {
  return 1e-5f * (1.0f + fmaxf(fabsf(lo), fabsf(hi)));
}

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
  // Slab-test reciprocals; an axis with |d| < 1e-12 is tested by
  // containment instead.
  const float dd[3] = {d.x, d.y, d.z}, oo[3] = {o.x, o.y, o.z};
  float inv[3];
  bool flat[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    flat[k] = fabsf(dd[k]) < 1e-12f;
    inv[k] = 1.0f / (flat[k] ? 1.0f : dd[k]);
  }

  float best_t = kBig;
  int best_i = INT_MAX;
  const int n = n_reach[tile];
  const int* ord = order + static_cast<size_t>(tile) * nc;
  const float* tm = tmin + static_cast<size_t>(tile) * nc;
  int walked = 0, tested = 0;
  for (int p = 0; p < n; ++p) {
    const int j = ord[p];
    bool reach = act;
    if (act) {
      float tn = -kBig, tf = kBig;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float lo0 = clo[3 * j + k], hi0 = chi[3 * j + k];
        const float m = margin(lo0, hi0);
        const float lo = lo0 - m, hi = hi0 + m;
        if (flat[k]) {
          if (oo[k] < lo || oo[k] > hi) tn = kBig, tf = -kBig;
        } else {
          const float t0 = (lo - oo[k]) * inv[k], t1 = (hi - oo[k]) * inv[k];
          tn = fmaxf(tn, fminf(t0, t1));
          tf = fminf(tf, fmaxf(t0, t1));
        }
      }
      reach = tn <= tf && tf >= 0.0f && tn <= best_t;
    }
    ++walked;
    if (__syncthreads_or(reach)) {
      ++tested;
      const int base = j * kChunk;
      const int cnt = min(kChunk, T - base);
      for (int q = threadIdx.x; q < 3 * cnt; q += kThreads) {
        geom[q] = reinterpret_cast<const float4*>(rows + static_cast<size_t>(base + q / 3) * 48)[q % 3];
      }
      __syncthreads();
      if (reach) {
        for (int k = 0; k < cnt; ++k) {
          const float4 gx = geom[3 * k], gy = geom[3 * k + 1], gz = geom[3 * k + 2];
          const float opx = gx.x * o.x + gx.y * o.y + gx.z * o.z + gx.w;
          const float opy = gy.x * o.x + gy.y * o.y + gy.z * o.z + gy.w;
          const float opz = gz.x * o.x + gz.y * o.y + gz.z * o.z + gz.w;
          const float dpx = gx.x * d.x + gx.y * d.y + gx.z * d.z;
          const float dpy = gy.x * d.x + gy.y * d.y + gy.z * d.z;
          const float w = gz.x * d.x + gz.y * d.y + gz.z * d.z;
          const float t = -opz / w;
          const float beta = opx + t * dpx;
          const float gamma = opy + t * dpy;
          const int i = base + k;
          if (beta > 0.0f && gamma > 0.0f && t > 0.0f && 1.0f - (beta + gamma) > 0.0f &&
              (t < best_t || (t == best_t && i < best_i))) {
            best_t = t;
            best_i = i;
          }
        }
      }
      __syncthreads();
    }
    // Early exit: tmin is sorted ascending and lower-bounds every hit
    // in the chunks after p, so once it passes every live lane's best t
    // (with slack) nothing later can win.
    const bool more = p + 1 < n && act && tm[p + 1] <= best_t * (1.0f + 1e-6f) + 1e-6f;
    if (!__syncthreads_or(more)) break;
  }
  if (visits != nullptr && threadIdx.x == 0) {
    visits[tile] = walked;
    visits[gridDim.x + tile] = tested;
  }
  if (r < R) idx_out[r] = best_t < kBig ? best_i : -1;
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

// Nearest-hit selection shared by every kernel that tests rays against
// triangles: the whole segment B1/B1l/B1c (segment_fused.cu), the
// split-path intersector B4/B4c (nearest_shade.cu), the fused
// intersector's index kernel B7 (nearest_triangle.cu) and the traversal
// walk B5 (traverse_select.cu, which visits chunks in its own order).
//
// One thread per ray. A block stages the 12 geometry floats of
// kChunk triangles at a time in shared memory (three float4 each:
// [m_k0 m_k1 m_k2 -m_a_k] for k = 0..2), so each triangle is read from
// global memory once per block and broadcast to its threads. The pair
// test is the reference's accept test in plain f32 with an IEEE
// division: beta > 0, gamma > 0, t > 0, 1 - (beta + gamma) > 0, written
// as explicit comparisons so that a NaN (zero geometry, a parallel ray)
// never wins. Chunk culling (B1c, B4c, B5) slab-tests each lane's
// segment [0, best t] against the chunk's box widened by a small margin.

#pragma once

#include <cuda_runtime.h>

#include "segment_common.cuh"

namespace seg {

constexpr int kChunk = 128;  // triangles per shared-memory tile = per Morton chunk

// A lane's best hit so far: distance, barycentrics, triangle index.
struct Hit {
  float t, beta, gamma;
  int i;
};

// Slab-test constants of one ray; an axis with |d| < 1e-12 is tested by
// containment instead of by its reciprocal.
struct Slab {
  float o[3], inv[3];
  bool flat[3];
};

__device__ __forceinline__ Slab make_slab(V3 o, V3 d) {
  const float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
  Slab s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.o[k] = oo[k];
    s.flat[k] = fabsf(dd[k]) < 1e-12f;
    s.inv[k] = 1.0f / (s.flat[k] ? 1.0f : dd[k]);
  }
  return s;
}

// The box margin: a relative 1e-5 of the box's coordinates plus an
// absolute 1e-5, far above the f32 rounding of a hit point or a slab
// distance, so a chunk whose box a hit grazes is never skipped (the TPU
// kernels' `_slab_reach` has no margin).
__device__ __forceinline__ float box_margin(float lo, float hi) {
  return 1e-5f * (1.0f + fmaxf(fabsf(lo), fabsf(hi)));
}

// True when the ray's segment [0, tmax] can enter the widened box of
// chunk j (clo/chi f32[nc, 3]).
__device__ __forceinline__ bool slab_reach(const Slab& s, const float* __restrict__ clo,
                                           const float* __restrict__ chi, int j, float tmax) {
  float tn = -kBig, tf = kBig;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo0 = clo[3 * j + k], hi0 = chi[3 * j + k];
    const float m = box_margin(lo0, hi0);
    const float lo = lo0 - m, hi = hi0 + m;
    if (s.flat[k]) {
      if (s.o[k] < lo || s.o[k] > hi) tn = kBig, tf = -kBig;
    } else {
      const float t0 = (lo - s.o[k]) * s.inv[k], t1 = (hi - s.o[k]) * s.inv[k];
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
  }
  return tn <= tf && tf >= 0.0f && tn <= tmax;
}

// Stage the geometry of triangles [base, base + n) of a table with
// `stride` floats per row (its first 12 floats are the geometry) into
// shared memory. Rows must be 16-byte aligned.
__device__ __forceinline__ void stage_geometry(float4* geom, const float* __restrict__ table,
                                               int stride, int base, int n) {
  for (int q = threadIdx.x; q < 3 * n; q += blockDim.x) {
    geom[q] = reinterpret_cast<const float4*>(table + static_cast<size_t>(base + q / 3) * stride)[q % 3];
  }
}

// Test one lane against the n staged triangles base .. base + n - 1.
// kDzTest: also reject |d'_z| <= 1e-12 explicitly (the TPU kernel
// `_nearest_kernel` does; the others rely on NaN and inf comparisons).
// kOrdered: every earlier tile held smaller indices, so a strict `<` on
// t keeps the smallest index of a tie; otherwise (B5 visits chunks front
// to back, not in index order) an equal t goes to the smaller index.
template <bool kDzTest, bool kOrdered>
__device__ __forceinline__ void test_tile(const float4* geom, int n, int base, V3 o, V3 d,
                                          Hit& h) {
  for (int k = 0; k < n; ++k) {
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
        (!kDzTest || fabsf(w) > 1e-12f) &&
        (t < h.t || (!kOrdered && t == h.t && i < h.i))) {
      h = {t, beta, gamma, i};
    }
  }
}

// The nearest accepted triangle of each lane of the block, over the T
// triangles of `table`, scanned in ascending order one staged tile at a
// time. Lanes with act = false test nothing and come back with t = kBig.
// With kCull (clo/chi f32[ceil(T / kChunk), 3], the table in Morton
// order), a lane tests a tile only when its segment [0, best t] reaches
// the tile's chunk box, and the block skips a tile that no lane reaches
// (lanes that are not live vote no). `tested` is the number of tiles
// the block tested. Every thread of the block must call this: it holds
// the block's barriers.
template <bool kCull, bool kDzTest>
__device__ __forceinline__ Hit nearest_in_block(float4* geom, const float* __restrict__ table,
                                                int stride, int T, V3 o, V3 d, bool act,
                                                const float* __restrict__ clo,
                                                const float* __restrict__ chi, int& tested) {
  Hit h = {kBig, 0.0f, 0.0f, -1};
  tested = 0;
  if (!__syncthreads_or(act)) return h;
  const Slab s = make_slab(o, d);  // dead code without kCull
  for (int base = 0; base < T; base += kChunk) {
    bool test = act;
    if constexpr (kCull) {
      test = act && slab_reach(s, clo, chi, base / kChunk, h.t);
      if (!__syncthreads_or(test)) continue;
    }
    ++tested;
    const int n = min(kChunk, T - base);
    stage_geometry(geom, table, stride, base, n);
    __syncthreads();
    if (test) test_tile<kDzTest, true>(geom, n, base, o, d, h);
    __syncthreads();
  }
  return h;
}

}  // namespace seg

// Nearest-hit pieces shared by the selection kernels: the exact
// ray-triangle pair test that decides every winner (`pair_test`), the
// slab test of chunk culling and of the traversal walk's tree
// (`slab_box`), and the one-ray-per-thread loop `nearest_in_block`, the
// control of the sphere rejection (nearest_triangle.cu).
//
// The pair test is the reference's accept test in plain f32 with an IEEE
// division: beta > 0, gamma > 0, t > 0, 1 - (beta + gamma) > 0, written
// as explicit comparisons so that a NaN (zero geometry, a parallel ray)
// never wins. Every selection calls this one function (B1/B1l/B1c,
// B4/B4c and B7 through sphere_select.cuh's `select_two`, B5's leaves in
// traverse_select.cu, the control loop here), so their winners agree bit
// for bit.
//
// `nearest_in_block`: one thread per ray; a block stages the 12 geometry
// floats of kChunk triangles at a time in shared memory (three float4
// each: [m_k0 m_k1 m_k2 -m_a_k] for k = 0..2), so each triangle is read
// from global memory once per block and broadcast to its threads. What
// bounds it on an H100 is the ~40 f32 operations of every ray x triangle
// pair; `select_two` runs the same selection in about half its time
// behind sphere_select.cuh's division-free rejection, and this loop stays
// as the bit-for-bit control of that rejection.
//
// Chunk culling (B1c, B4c) slab-tests each lane's segment [0, best t]
// against a chunk's box widened by a small margin and by its triangles'
// sphere slack for the lane's |o| (`chunk_entry`), as the walk's tree (B5)
// widens its nodes (`slab_box`'s ext): the exact test accepts hits up to
// that slack outside an ill-conditioned triangle, so a box without it can
// lose a winner.

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

// The entry distance tn of the ray into the box [lo, hi] widened by
// box_margin + ext on every side, and whether its segment [0, tmax]
// reaches that box.
__device__ __forceinline__ bool slab_box(const Slab& s, const float lo_[3], const float hi_[3],
                                         float ext, float tmax, float& tn_out) {
  float tn = -kBig, tf = kBig;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float m = box_margin(lo_[k], hi_[k]) + ext;
    const float lo = lo_[k] - m, hi = hi_[k] + m;
    if (s.flat[k]) {
      if (s.o[k] < lo || s.o[k] > hi) tn = kBig, tf = -kBig;
    } else {
      const float t0 = (lo - s.o[k]) * s.inv[k], t1 = (hi - s.o[k]) * s.inv[k];
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
  }
  tn_out = tn;
  return tn <= tf && tf >= 0.0f && tn <= tmax;
}

// |o| in f32 with each operation rounded as written (no FMA), as
// ops/cull.py's emulation of the culled loop computes it.
__device__ __forceinline__ float norm_rn(V3 o) {
  return __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(o.x, o.x), __fmul_rn(o.y, o.y)), __fmul_rn(o.z, o.z)));
}

// The entry distance tn of a ray with |o| = on into the box of chunk j
// (clo/chi f32[nc, 3]) widened by box_margin and by the chunk's slack
// (cslack f32[nc, 2]: ext, the largest sphere slack K0 - rho of its
// triangles, and grow, their largest growth per unit of |o|; see
// sphere_select.cuh's `triangle_sphere_split`), and whether its segment
// [0, tmax] reaches that box. `slab_box`'s test with every operation
// rounded as written (no FMA), so that ops/cull.py's plain emulation of the
// culled loop (`chunk_entry`, `cull_visits`) orders and counts the chunks
// bit for bit as the kernels do.
__device__ __forceinline__ bool chunk_entry(const Slab& s, const float* __restrict__ clo,
                                            const float* __restrict__ chi,
                                            const float* __restrict__ cslack, int j, float on,
                                            float tmax, float& tn_out) {
  const float ext = __fadd_rn(__fmul_rn(__ldg(cslack + 2 * j + 1), on), __ldg(cslack + 2 * j));
  float tn = -kBig, tf = kBig;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo_ = __ldg(clo + 3 * j + k), hi_ = __ldg(chi + 3 * j + k);
    const float m =
        __fadd_rn(__fmul_rn(1e-5f, __fadd_rn(1.0f, fmaxf(fabsf(lo_), fabsf(hi_)))), ext);
    const float lo = __fsub_rn(lo_, m), hi = __fadd_rn(hi_, m);
    if (s.flat[k]) {
      if (s.o[k] < lo || s.o[k] > hi) tn = kBig, tf = -kBig;
    } else {
      const float t0 = __fmul_rn(__fsub_rn(lo, s.o[k]), s.inv[k]);
      const float t1 = __fmul_rn(__fsub_rn(hi, s.o[k]), s.inv[k]);
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
  }
  tn_out = tn;
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

// One ray against one triangle's geometry rows gx, gy, gz: t, beta,
// gamma, w = d'_z, and whether the pair passes the accept test without
// the comparison to the best t (NaN fails). Every selection loop calls
// this one function, so their winners agree bit for bit.
struct Pair {
  float t, beta, gamma, w;
  bool inside;
};

__device__ __forceinline__ Pair pair_test(float4 gx, float4 gy, float4 gz, V3 o, V3 d) {
  const float opx = gx.x * o.x + gx.y * o.y + gx.z * o.z + gx.w;
  const float opy = gy.x * o.x + gy.y * o.y + gy.z * o.z + gy.w;
  const float opz = gz.x * o.x + gz.y * o.y + gz.z * o.z + gz.w;
  const float dpx = gx.x * d.x + gx.y * d.y + gx.z * d.z;
  const float dpy = gy.x * d.x + gy.y * d.y + gy.z * d.z;
  const float w = gz.x * d.x + gz.y * d.y + gz.z * d.z;
  const float t = -opz / w;
  const float beta = opx + t * dpx;
  const float gamma = opy + t * dpy;
  return {t, beta, gamma, w,
          beta > 0.0f && gamma > 0.0f && t > 0.0f && 1.0f - (beta + gamma) > 0.0f};
}

// Test one lane against the n staged triangles base .. base + n - 1, in
// ascending order after every earlier tile: a strict `<` on t keeps the
// smallest index of a tie. kDzTest: also reject |d'_z| <= 1e-12
// explicitly (the TPU kernels `_nearest_kernel` and
// `_nearest_shade_culled_kernel` do; the others rely on NaN and inf
// comparisons).
template <bool kDzTest>
__device__ __forceinline__ void test_tile(const float4* geom, int n, int base, V3 o, V3 d,
                                          Hit& h) {
  for (int k = 0; k < n; ++k) {
    const Pair p = pair_test(geom[3 * k], geom[3 * k + 1], geom[3 * k + 2], o, d);
    if (p.inside && (!kDzTest || fabsf(p.w) > 1e-12f) && p.t < h.t) {
      h = {p.t, p.beta, p.gamma, base + k};
    }
  }
}

// The nearest accepted triangle of each lane of the block, over the T
// triangles of `table`, scanned in ascending order one staged tile at a
// time. Lanes with act = false test nothing and come back with t = kBig.
// Every thread of the block must call this: it holds the block's
// barriers.
template <bool kDzTest>
__device__ __forceinline__ Hit nearest_in_block(float4* geom, const float* __restrict__ table,
                                                int stride, int T, V3 o, V3 d, bool act) {
  Hit h = {kBig, 0.0f, 0.0f, -1};
  if (!__syncthreads_or(act)) return h;
  for (int base = 0; base < T; base += kChunk) {
    const int n = min(kChunk, T - base);
    stage_geometry(geom, table, stride, base, n);
    __syncthreads();
    if (act) test_tile<kDzTest>(geom, n, base, o, d, h);
    __syncthreads();
  }
  return h;
}

}  // namespace seg

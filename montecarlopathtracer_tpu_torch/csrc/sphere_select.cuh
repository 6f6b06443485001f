// The selection loop of the whole segment B1/B1l/B1c (segment_fused.cu),
// the split path's intersector B4/B4c (nearest_shade.cu) and the fused
// intersector's index B7 (nearest_triangle.cu): the nearest accepted
// triangle of two rays per thread over a whole row table, behind a
// division-free rejection by each triangle's widened bounding sphere.
// The traversal walk B5 (traverse_select.cu) tests its leaves with the
// same sphere, precomputed once per table (`triangle_sphere_split`).
//
// What bounds it on an H100: f32 arithmetic over the ray x triangle
// pairs. The sphere test is 17 operations a pair; the exact test of
// nearest_common.cuh's `pair_test` (six dot products, an IEEE division,
// beta and gamma, four compares, ~40 operations) runs only on the pairs
// that pass it.
//
// What the design does about it:
// - a division-free rejection first. Each block derives a bounding
//   sphere of every triangle from its geometry rows (the vertices are
//   m^-1 (m_a + {0, e1, e2})), widened by a slack that covers the f32
//   rounding of the sphere itself and of the exact test for the origins
//   of the block's rays (see `triangle_sphere`); a pair whose ray line
//   misses the widened sphere cannot be accepted. The test is 17
//   operations without a branch, and in the Cornell box few pairs and
//   few warps pass it. Only a pair that passes runs the exact test,
//   unchanged, so the winners, t, beta and gamma are the bits of the one-
//   ray-per-thread loop `nearest_in_block` over the same `pair_test`
//   (nearest_triangle.cu keeps it as the control of this rejection);
// - the table staged once per block when it fits in 48 KB of dynamic
//   shared memory (T <= 760, 64 bytes a triangle: geometry and sphere;
//   the Cornell box's 652 take 41.7 KB, so five blocks fit on an SM): one
//   barrier, then each warp runs through all triangles without another.
//   A larger table goes through a ring of two 128-triangle tiles filled by
//   cp.async, so the next tile loads while the current one is tested;
// - two rays per thread (rays r and r + 128 of a 256-ray block) and the
//   spheres of four triangles at a time, so each sphere read from shared
//   memory serves two rays and eight independent tests interleave;
// - the regen pass B1r (regen_pass.cu), whose blocks run many steps,
//   stages the whole table once (`stage_whole`, its spheres widened for a
//   bound on |o| over the pass) and runs each step without a barrier
//   (`select_staged`); its tail traces a ray with g threads, each a
//   strided share (`test_strided`), reduced by (t, index) (`wide_min`).
// B7 runs the loop on its [T, 12] geometry table (kStride = 12). kDzTest
// adds the explicit |d'_z| > 1e-12 test of the TPU kernels
// `_nearest_kernel` and `_nearest_shade_culled_kernel`. Selection runs in
// plain f32: no tensor cores (TF32 or bf16 picks wrong winners near
// edges) and IEEE division (compile without --use_fast_math).
//
// The culled loop (`select_culled`, B1c and B4c, and the entries B10c and
// B11 over B4c) takes the triangles in Morton order with one box per
// 128-triangle chunk, widened by the chunk's sphere slack for the lane's
// |o| (nearest_common.cuh's `chunk_entry`). Its unit is the warp, and no
// barrier stands inside its chunk loop:
// - a block of two warps takes one group of 128 rays, each warp 64
//   consecutive rays (lane l: rays 64 w + l and 64 w + 32 + l); the warps
//   vote apart, and a warp none of whose rays reaches a chunk skips it
//   (`__any_sync` over the lanes' own slab tests against [0, best t]); a
//   block frees its slot on the SM as soon as its two warps are done;
// - nearest chunk first: for each window of 32 chunks the warp takes, per
//   chunk, the least entry distance tn of the rays that reach it (one
//   `__reduce_min_sync` per chunk, a lane per chunk), sorts the 32 keys
//   across the lanes (a bitonic network of shuffles) and visits the chunks
//   in that order, each lane testing its slab again with its best t by
//   then; out of index order a hit wins on the least (t, index) pair,
//   brute selection's rule, so the winners are B4's bit for bit;
// - the triangles come from a table of 64-byte records built once per
//   table (`triangle_record`: the sphere's center and K0, then the three
//   geometry rows), with the radius K0 + grow |o| of the ray's own |o| and
//   the chunk's grow (B5's 19-operation test), so no block rebuilds a
//   sphere, read through the read-only path (on an H100 twice as fast at
//   1,332 rows as staging them whole in shared memory);
// - `tested` counts, per group of 128 rays, the chunks that either of its
//   warps tested: each warp ORs its votes of a window into the group's
//   bits in shared memory, counted after the loop;
// - in the regen pass B1rc alone (`select_culled<kDzTest, true>`), a leaf
//   that few of the warp's rays reach is tested ray by ray across a
//   half-warp (`test_pairs`) instead of by every lane for both its rays.

#pragma once

#include <cuda_runtime.h>

#include "nearest_common.cuh"
#include "segment_common.cuh"

namespace seg {

constexpr int kSelThreads = 128;              // threads per block; each takes two rays
constexpr int kSelRays = 2 * kSelThreads;     // rays per block: r and r + kSelThreads
constexpr int kWholeMax = 760;                // triangles staged at once: 64 B each, < 48 KB
constexpr int kUnroll = 4;                    // triangles whose spheres are tested together
constexpr int kTileFloat4 = 7 * kChunk;       // the ring: two tiles of geometry, one of spheres
constexpr float kShrink = 1.0f - 0x1p-18f;
constexpr unsigned kAll = 0xffffffffu;       // a full warp's mask

// One ray of a thread: origin, direction, d.d and d.d (1 - 2^-18) for
// the sphere test, and its best hit so far.
struct Ray {
  V3 o, d;
  float dd, ddp;
  Hit h;
};

__device__ __forceinline__ Ray make_ray(V3 o, V3 d) {
  Ray r;
  r.o = o;
  r.d = d;
  r.dd = dot(d, d);
  r.ddp = r.dd * kShrink;
  r.h = {kBig, 0.0f, 0.0f, -1};
  return r;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 axpy(float s, V3 a, V3 b) {
  return {s * a.x + b.x, s * a.y + b.y, s * a.z + b.z};
}

// What the widened bounding sphere of one triangle needs from its
// geometry rows g_k = [m_k | -m_a_k]: center, rho (the radius of the
// exact sphere), E = 2^-16 kappa, |c|, n_inv = |m^-1|_F, |m_a|, and
// whether the triangle is well-conditioned (kappa < 2^16).
//
// The rows map a point p to (beta, gamma, z') = m p - m_a, so the
// vertices are A = m^-1 m_a, B = A + m^-1 e_x and C = A + m^-1 e_y; the
// columns of m^-1 are the cross products of the rows over det m. The
// slack: the exact test accepts a pair only if its (beta, gamma) lie in
// the unit triangle, and its f32 values of o', d', t, beta, gamma differ
// from the real ones by at most ~10 u kappa (2|o| + |X| + |m^-1| |m_a|) in
// world units, X the hit point and kappa = |m|_F |m^-1|_F; the sphere
// computed here in f32 is off by ~10 u kappa |m^-1| (|m_a| + 1) (u =
// 2^-24). With E = 2^-16 kappa the radius rho + E (2|o| + |c| + rho +
// |m^-1| (|m_a| + 1)) covers both with a factor of 8 and more; it is
// raised by 2^-16 more against its own rounding and that of the test. A
// triangle with kappa >= 2^16, a zero determinant or any non-finite value
// gets an infinite radius: every ray tests it exactly (`triangle_sphere`
// makes one exception, the all-zero row).
struct SphereParts {
  V3 ctr;
  float rho, E, cn, n_inv, an;
  bool ok;
};

__device__ __forceinline__ SphereParts sphere_parts(float4 g0, float4 g1, float4 g2) {
  const V3 r0 = {g0.x, g0.y, g0.z}, r1 = {g1.x, g1.y, g1.z}, r2 = {g2.x, g2.y, g2.z};
  const V3 a = {-g0.w, -g1.w, -g2.w};
  const V3 c0 = cross3(r1, r2), c1 = cross3(r2, r0), c2 = cross3(r0, r1);
  const float inv = 1.0f / dot(r0, c0);
  const V3 ex = {c0.x * inv, c0.y * inv, c0.z * inv};
  const V3 ey = {c1.x * inv, c1.y * inv, c1.z * inv};
  const V3 va = axpy(a.z, c2, axpy(a.y, c1, V3{a.x * c0.x, a.x * c0.y, a.x * c0.z}));
  const V3 A = {va.x * inv, va.y * inv, va.z * inv};
  const V3 mid = {(ex.x + ey.x) / 3.0f, (ex.y + ey.y) / 3.0f, (ex.z + ey.z) / 3.0f};
  SphereParts p;
  p.ctr = {A.x + mid.x, A.y + mid.y, A.z + mid.z};
  const V3 db = {ex.x - mid.x, ex.y - mid.y, ex.z - mid.z};
  const V3 dc = {ey.x - mid.x, ey.y - mid.y, ey.z - mid.z};
  p.rho = sqrtf(fmaxf(dot(mid, mid), fmaxf(dot(db, db), dot(dc, dc))));
  const float n_m = sqrtf(dot(r0, r0) + dot(r1, r1) + dot(r2, r2));
  p.n_inv = sqrtf(dot(c0, c0) + dot(c1, c1) + dot(c2, c2)) * fabsf(inv);
  const float kappa = n_m * p.n_inv;
  p.E = kappa * 0x1p-16f;
  p.cn = sqrtf(dot(p.ctr, p.ctr));
  p.an = sqrtf(dot(a, a));
  p.ok = kappa < 0x1p16f;
  return p;
}

// Whether all 12 geometry floats of a row are zero (+0 or -0): the
// padding rows of a table padded to a multiple of 128 (and the rows of a
// zero-area triangle, whose transform is zero).
__device__ __forceinline__ bool zero_geometry(float4 g0, float4 g1, float4 g2) {
  const unsigned bits = __float_as_uint(g0.x) | __float_as_uint(g0.y) | __float_as_uint(g0.z) |
                        __float_as_uint(g0.w) | __float_as_uint(g1.x) | __float_as_uint(g1.y) |
                        __float_as_uint(g1.z) | __float_as_uint(g1.w) | __float_as_uint(g2.x) |
                        __float_as_uint(g2.y) | __float_as_uint(g2.z) | __float_as_uint(g2.w);
  return (bits & 0x7fffffffu) == 0u;
}

// The widened sphere of one triangle for rays whose origins have
// |o| <= omax: its center and the square of its radius (+inf when the
// triangle is ill-conditioned or not finite). A row whose geometry is
// all zero gets a NaN center (its x), which `sphere_hit` fails for every
// ray (v = c - o and so b and v.v are NaN, and NaN compares false), so
// no ray tests it exactly. That drops no winner: `pair_test` can never
// accept such a row. Each of o'_z = gz.o + gz.w and w = d'_z = gz.d is a
// sum of products with a zero factor, so it is +-0 where o (for o'_z) or
// d (for w) is finite and NaN where it is not (0 x inf); t = -o'_z / w is
// then +-0 / +-0 or has a NaN operand, so t is NaN and `t > 0` fails, for
// every ray and with or without kDzTest. (The culling boxes' slack,
// ops/cull.py::chunk_slack, skips such rows by the same rule.)
__device__ void triangle_sphere(float4 g0, float4 g1, float4 g2, float omax, float4& s) {
  const SphereParts p = sphere_parts(g0, g1, g2);
  const float K = (p.rho + p.E * (2.0f * omax + p.cn + p.rho + p.n_inv * (p.an + 1.0f))) *
                  (1.0f + 0x1p-16f);
  if (p.ok && K < 0x1p60f) {
    s = make_float4(p.ctr.x, p.ctr.y, p.ctr.z, K * K);
  } else {
    s = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));  // +inf
  }
  // Set after that choice, not as a branch before it: the branch slowed
  // the compiled selection loop of B7 (nearest_triangle.cu).
  if (zero_geometry(g0, g1, g2)) s.x = __int_as_float(0x7fc00000);  // NaN
}

// The same sphere split for a table computed once for all rays: center
// and K0 = the radius at |o| = 0 (s.w, +inf when the triangle gets an
// infinite radius), and e = the radius' growth per unit of |o|, so that a
// ray with |o| = on takes the radius fmaf(e, on, K0) (e = 0 with an
// infinite K0). slack = K0 - rho: how far beyond the triangle the exact
// test can accept a hit for |o| = 0 (+inf with an infinite K0).
__device__ void triangle_sphere_split(float4 g0, float4 g1, float4 g2, float4& s, float& e,
                                      float& slack) {
  const SphereParts p = sphere_parts(g0, g1, g2);
  const float K0 = (p.rho + p.E * (p.cn + p.rho + p.n_inv * (p.an + 1.0f))) * (1.0f + 0x1p-16f);
  if (p.ok && K0 < 0x1p60f) {
    s = make_float4(p.ctr.x, p.ctr.y, p.ctr.z, K0);
    e = 2.0f * p.E * (1.0f + 0x1p-16f);
    slack = K0 - p.rho;
  } else {
    s = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));  // +inf
    e = 0.0f;
    slack = s.w;
  }
}

// False only if the ray's line misses the widened sphere of center c and
// squared radius w: then no point of the triangle is near enough to the
// ray for the exact test to accept it. With v = c - o, b = v.d: the
// squared distance of c from the line times d.d is v.v d.d - b^2,
// computed here within 14 u v.v d.d; the factor (1 - 2^-18) on d.d covers
// that, and the 2^-16 on the radius the rounding of r^2 d.d. NaN fails.
// No branch: the tests of both rays of a thread and of kUnroll triangles
// interleave.
__device__ __forceinline__ bool sphere_hit(float cx, float cy, float cz, float w,
                                           const Ray& r) {
  const float vx = cx - r.o.x, vy = cy - r.o.y, vz = cz - r.o.z;
  const float b = vx * r.d.x + vy * r.d.y + vz * r.d.z;
  const float vv = vx * vx + vy * vy + vz * vz;
  return fmaf(-b, b, vv * r.ddp) <= w * r.dd;
}

// The sphere s (center, r^2) of `triangle_sphere`.
__device__ __forceinline__ bool sphere_pass(float4 s, const Ray& r) {
  return sphere_hit(s.x, s.y, s.z, s.w, r);
}

// The exact pair test, that of nearest_common.cuh's `test_tile`
// (ascending order): the same `pair_test`.
template <bool kDzTest>
__device__ __forceinline__ void exact_test(const float4* g, int i, Ray& r) {
  const Pair p = pair_test(g[0], g[1], g[2], r.o, r.d);
  if (p.inside && (!kDzTest || fabsf(p.w) > 1e-12f) && p.t < r.h.t)
    r.h = {p.t, p.beta, p.gamma, i};
}

// Test both rays (where ta, tb) against the n staged triangles base ..
// base + n - 1 in ascending order: the sphere tests of kUnroll triangles
// first, then the exact tests of the pairs that passed, triangle by
// triangle (each ray's exact tests stay in ascending order). A ray with
// fa (fb) set skips the spheres and tests every triangle exactly.
template <bool kDzTest>
__device__ __forceinline__ void test_range(const float4* geom, const float4* sph, int n,
                                           int base, Ray& ra, bool ta, Ray& rb, bool tb,
                                           bool fa = false, bool fb = false) {
  const unsigned all = (1u << kUnroll) - 1u;
  const unsigned live_a = ta ? all : 0u, live_b = tb ? all : 0u;
  const unsigned force_a = fa ? all : 0u, force_b = fb ? all : 0u;
  int k = 0;
  for (; k + kUnroll <= n; k += kUnroll) {
    float4 s[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) s[j] = sph[k + j];
    unsigned ma = 0, mb = 0;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      ma |= static_cast<unsigned>(sphere_pass(s[j], ra)) << j;
      mb |= static_cast<unsigned>(sphere_pass(s[j], rb)) << j;
    }
    ma = (ma | force_a) & live_a;
    mb = (mb | force_b) & live_b;
    if (ma | mb) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (ma & (1u << j)) exact_test<kDzTest>(geom + 3 * (k + j), base + k + j, ra);
        if (mb & (1u << j)) exact_test<kDzTest>(geom + 3 * (k + j), base + k + j, rb);
      }
    }
  }
  for (; k < n; ++k) {
    const float4 s = sph[k];
    if (ta && (fa || sphere_pass(s, ra))) exact_test<kDzTest>(geom + 3 * k, base + k, ra);
    if (tb && (fb || sphere_pass(s, rb))) exact_test<kDzTest>(geom + 3 * k, base + k, rb);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start the copy of the geometry of triangles [base, base + n) of a
// table of kStride floats per row (its first 12 the geometry) into geom.
template <int kStride>
__device__ __forceinline__ void stage_async(float4* geom, const float* __restrict__ rows, int base,
                                            int n) {
  for (int q = threadIdx.x; q < 3 * n; q += kSelThreads)
    cp_async16(geom + q, rows + static_cast<size_t>(base + q / 3) * kStride + 4 * (q % 3));
  cp_async_commit();
}

__device__ __forceinline__ void make_spheres(const float4* geom, float4* sph, int n, float omax) {
  for (int k = threadIdx.x; k < n; k += kSelThreads)
    triangle_sphere(geom[3 * k], geom[3 * k + 1], geom[3 * k + 2], omax, sph[k]);
}

// Bytes of dynamic shared memory a block of `select_two` takes for a
// T-triangle table.
__host__ __device__ constexpr int select_smem_bytes(int T) {
  return (T <= kWholeMax ? 4 * T : kTileFloat4) * static_cast<int>(sizeof(float4));
}

// The nearest accepted triangle of both rays of every thread of a block
// of kSelThreads threads, over the T triangles of the [T, kStride] table
// `rows` (see the notes at the top; rows 16-byte aligned). act_a / act_b:
// the ray is live; a ray that is not tests nothing and keeps t = kBig.
// tested_a / tested_b: the chunks each group of 128 rays tested (all of
// them when the group has a live ray). Every thread of the block must
// call this: it holds the block's barriers.
template <bool kDzTest, int kStride = 48>
__device__ __forceinline__ void select_two(const float* __restrict__ rows, int T, Ray& ra,
                                           bool act_a, Ray& rb, bool act_b, int& tested_a,
                                           int& tested_b) {
  extern __shared__ float4 smem[];
  __shared__ int omax_bits;  // the block's largest finite |o| of a live ray, as bits
  tested_a = tested_b = 0;
  if (threadIdx.x == 0) omax_bits = 0;
  const bool any_a = __syncthreads_or(act_a), any_b = __syncthreads_or(act_b);
  if (!any_a && !any_b) return;
  const float on_a = sqrtf(dot(ra.o, ra.o)), on_b = sqrtf(dot(rb.o, rb.o));
  // Non-negative floats order as their bits; an infinite or NaN origin
  // never passes the exact test, so it needs no room in the spheres.
  if (act_a && on_a < kBig) atomicMax(&omax_bits, __float_as_int(on_a));
  if (act_b && on_b < kBig) atomicMax(&omax_bits, __float_as_int(on_b));
  const int nc = (T + kChunk - 1) / kChunk;
  tested_a = any_a ? nc : 0;
  tested_b = any_b ? nc : 0;
  const bool whole = T <= kWholeMax;
  float4* geom = smem;
  float4* sph = smem + (whole ? 3 * T : 6 * kChunk);
  if (whole) {
    stage_async<kStride>(geom, rows, 0, T);
    cp_async_wait<0>();
    __syncthreads();
    make_spheres(geom, sph, T, __int_as_float(omax_bits));
    __syncthreads();
  } else {
    stage_async<kStride>(geom, rows, 0, min(kChunk, T));
  }
  for (int j = 0; j < nc; ++j) {
    const int base = j * kChunk, n = min(kChunk, T - base);
    if (whole) {
      test_range<kDzTest>(geom + 3 * base, sph + base, n, base, ra, act_a, rb, act_b);
      continue;
    }
    // The ring: tile j + 1 loads while tile j is tested.
    float4* tile = geom + (j & 1) * 3 * kChunk;
    if (j + 1 < nc) {
      stage_async<kStride>(geom + ((j + 1) & 1) * 3 * kChunk, rows, base + kChunk,
                           min(kChunk, T - base - kChunk));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    make_spheres(tile, sph, n, __int_as_float(omax_bits));
    __syncthreads();
    test_range<kDzTest>(tile, sph, n, base, ra, act_a, rb, act_b);
    __syncthreads();  // before the ring refills this tile and the spheres
  }
}

// The whole table (T <= kWholeMax) staged once for many selections, by a
// block that keeps its shared memory across them (the regen pass B1r):
// the geometry, then the spheres widened for origins with |o| <= omax
// (`triangle_sphere`), at smem[0 .. 3T) and smem[3T .. 4T), the layout of
// select_two's whole branch. Every thread of the block must call it.
template <int kStride = 48>
__device__ __forceinline__ void stage_whole(const float* __restrict__ rows, int T, float omax) {
  extern __shared__ float4 smem[];
  stage_async<kStride>(smem, rows, 0, T);
  cp_async_wait<0>();
  __syncthreads();
  make_spheres(smem, smem + 3 * T, T, omax);
  __syncthreads();
}

// Whether a ray's finite |o| exceeds the bound omax that staged spheres
// were widened for (a NaN or infinite |o| never passes the exact test).
__device__ __forceinline__ bool beyond_bound(V3 o, float omax) {
  const float on = sqrtf(dot(o, o));
  return on < kBig && on > omax;
}

// A step of select_two's whole branch over the table stage_whole staged,
// without a barrier: the same sphere and exact tests in the same order,
// so the same winners, t, beta and gamma (the spheres only reject pairs
// the exact test cannot accept; a larger omax widens them, and no
// winner depends on how far). A live ray whose finite |o| exceeds omax
// (a bound the staged spheres do not cover) tests every triangle
// exactly instead; returns how many of the thread's two rays did.
template <bool kDzTest>
__device__ __forceinline__ int select_staged(int T, float omax, Ray& ra, bool act_a, Ray& rb,
                                             bool act_b) {
  extern __shared__ float4 smem[];
  const bool fa = act_a && beyond_bound(ra.o, omax), fb = act_b && beyond_bound(rb.o, omax);
  if (act_a || act_b)
    test_range<kDzTest>(smem, smem + 3 * T, T, 0, ra, act_a, rb, act_b, fa, fb);
  return static_cast<int>(fa) + static_cast<int>(fb);
}

// One ray against the staged triangles q, q + g, q + 2g, ... of a T-row
// table (stage_whole's layout), in ascending order: a thread's share of
// a ray that g threads test together (the regen pass's tail). Each
// thread's best hit is the least (t, index) of its share, so the least
// (t, index) over the g threads (`wide_min`) is select_two's winner.
template <bool kDzTest>
__device__ __forceinline__ void test_strided(int T, int q, int g, Ray& r, bool force) {
  extern __shared__ float4 smem[];
  const float4* geom = smem;
  const float4* sph = smem + 3 * T;
  const unsigned all = (1u << kUnroll) - 1u, forced = force ? all : 0u;
  int k = q;
  for (; k + (kUnroll - 1) * g < T; k += kUnroll * g) {
    float4 s[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) s[j] = sph[k + j * g];
    unsigned m = forced;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) m |= static_cast<unsigned>(sphere_pass(s[j], r)) << j;
    if (m) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (m & (1u << j)) exact_test<kDzTest>(geom + 3 * (k + j * g), k + j * g, r);
    }
  }
  for (; k < T; k += g)
    if (force || sphere_pass(sph[k], r)) exact_test<kDzTest>(geom + 3 * k, k, r);
}

// The least (t, index) hit over the aligned groups of g lanes of a warp
// (g a power of two up to 32); every lane of the warp must call it.
__device__ __forceinline__ void wide_min(Hit& h, int g) {
  for (int m = 1; m < g; m <<= 1) {
    const float t = __shfl_xor_sync(kAll, h.t, m), b = __shfl_xor_sync(kAll, h.beta, m);
    const float c = __shfl_xor_sync(kAll, h.gamma, m);
    const int i = __shfl_xor_sync(kAll, h.i, m);
    if (t < h.t || (t == h.t && i < h.i)) h = {t, b, c, i};
  }
}

// One live ray's segment after its selection: the winner's shading row
// read once from global memory (all zero on a miss: t = kBig, beta =
// gamma = 0), then segment_common.cuh's `segment_epilogue` in registers.
// The whole segment's epilogue, shared by B1/B1l/B1c (segment_fused.cu)
// and the regen pass B1r (regen_pass.cu).
__device__ __forceinline__ SegState segment_after_select(const float* __restrict__ rows,
                                                         const Ray& ray, V3 tp_in, V3 rs_in,
                                                         float v1, float v2, float vrr, Flags f,
                                                         SegOptions opt) {
  const Hit best = ray.h;
  const bool hit = best.t < kBig;
  float sh[24];
  if (hit) {
    const float4* row = reinterpret_cast<const float4*>(rows + (size_t)best.i * 48 + 12);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float4 v = row[q];
      sh[4 * q] = v.x, sh[4 * q + 1] = v.y, sh[4 * q + 2] = v.z, sh[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 24; ++q) sh[q] = 0.0f;
  }
  return segment_epilogue(ray.o, ray.d, tp_in, rs_in, hit, hit ? best.t : kBig,
                          hit ? best.beta : 0.0f, hit ? best.gamma : 0.0f, sh, v1, v2, vrr, f,
                          opt);
}

// ---- The culled loop (B1c, B4c) ----

constexpr int kCullThreads = 64;  // threads per block of the culled loop: 128 rays
constexpr int kWindow = 32;  // chunks a warp orders at once: one key per lane
constexpr int kLeaf = 16;    // triangles per leaf box inside a chunk
constexpr int kCullUnroll = 8;  // records whose spheres are tested together

// The rays of thread threadIdx.x: r and r + 128 of the block's 256 for
// the full loop; for the culled loop, whose blocks of two warps take one
// group of 128 rays, 64 consecutive rays per warp (lane l of warp w:
// 64 w + l and 64 w + 32 + l).
template <bool kCull>
__device__ __forceinline__ void ray_slots(int& ra_i, int& rb_i) {
  if constexpr (kCull) {
    ra_i = blockIdx.x * 2 * kCullThreads + 64 * (threadIdx.x / 32) + threadIdx.x % 32;
    rb_i = ra_i + 32;
  } else {
    ra_i = blockIdx.x * kSelRays + threadIdx.x;
    rb_i = ra_i + kSelThreads;
  }
}

// The 64-byte record of one triangle (four float4): its widened sphere
// split for per-ray radii (`triangle_sphere_split`: center and K0, +inf
// when the triangle is ill-conditioned or not finite), with a NaN center
// for an all-zero row as `triangle_sphere` gives it (no ray tests such a
// row exactly), then its three geometry rows. Returns the sphere.
__device__ __forceinline__ float4 triangle_record(float4 g0, float4 g1, float4 g2, float4* rec) {
  float4 s;
  float e, slack;
  triangle_sphere_split(g0, g1, g2, s, e, slack);
  if (zero_geometry(g0, g1, g2)) s.x = __int_as_float(0x7fc00000);  // NaN
  rec[0] = s;
  rec[1] = g0;
  rec[2] = g1;
  rec[3] = g2;
  return s;
}

// A chunk's sort key from the entry distance tn: the floats' order as
// unsigned ints (-0 taken as +0). The caller puts the chunk's place in its
// window into the low five bits, so the keys of a window are distinct.
__device__ __forceinline__ unsigned entry_key(float tn) {
  const unsigned u = __float_as_uint(__fadd_rn(tn, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The 32 keys of a warp, one per lane, sorted ascending across the lanes
// (a bitonic network: 15 compare-exchanges by shuffle).
__device__ __forceinline__ unsigned warp_sort(unsigned key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned other = __shfl_xor_sync(kAll, key, j);
      const bool keep_min = ((lane & k) == 0) == ((lane & j) == 0);
      key = keep_min ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// False only if the ray misses the record's sphere with the radius
// K0 + grow |o| (grow >= the triangle's own growth).
__device__ __forceinline__ bool record_pass(float4 s, float grow, float on, const Ray& r) {
  const float K = fmaf(grow, on, s.w);
  return sphere_hit(s.x, s.y, s.z, K * K, r);
}

// One leaf's n <= kLeaf records (triangles base .. base + n - 1) for
// both rays (where ta, tb): the sphere tests of all its pairs first, kCullUnroll
// records at a time, into one mask per lane (bit k: ray a and record k,
// bit kLeaf + k: ray b); then each lane runs the exact tests of its own
// mask, one pair per step, so that a step of the warp serves a pair of
// every lane that has one left (lanes needing other records do not wait
// for each other's). Chunks and pairs come out of index order, so the
// least (t, index) pair wins (in index order the same bits as
// `exact_test`'s strict <).
template <bool kDzTest>
__device__ __forceinline__ void test_records(const float4* __restrict__ rec, int n, int base,
                                             float grow, Ray& ra, float on_a, bool ta, Ray& rb,
                                             float on_b, bool tb) {
  static_assert(2 * kLeaf <= 32, "a leaf's pairs fill one mask");
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < kLeaf; k += kCullUnroll) {
    float4 s[kCullUnroll];
#pragma unroll
    for (int j = 0; j < kCullUnroll; ++j)
      if (k + j < n) s[j] = __ldg(rec + 4 * (k + j));
#pragma unroll
    for (int j = 0; j < kCullUnroll; ++j) {
      if (k + j < n) {
        m |= static_cast<unsigned>(record_pass(s[j], grow, on_a, ra)) << (k + j);
        m |= static_cast<unsigned>(record_pass(s[j], grow, on_b, rb)) << (kLeaf + k + j);
      }
    }
  }
  constexpr unsigned kLow = (1u << kLeaf) - 1u;
  m &= (ta ? kLow : 0u) | (tb ? kLow << kLeaf : 0u);
  while (m != 0u) {
    const int bit = __ffs(m) - 1;
    m &= m - 1u;
    const bool second = bit >= kLeaf;
    const int k = bit - (second ? kLeaf : 0), i = base + k;
    const float4* g = rec + 4 * k + 1;
    Hit h = second ? rb.h : ra.h;
    const Pair p = pair_test(__ldg(g), __ldg(g + 1), __ldg(g + 2), second ? rb.o : ra.o,
                             second ? rb.d : ra.d);
    if (p.inside && (!kDzTest || fabsf(p.w) > 1e-12f) && (p.t < h.t || (p.t == h.t && i < h.i)))
      h = {p.t, p.beta, p.gamma, i};
    if (second) {
      rb.h = h;
    } else {
      ra.h = h;
    }
  }
}

// The pair path's threshold: a leaf that fewer than kPairFrom of the
// warp's 64 rays reach takes `test_pairs`, one that more reach
// `test_records`. Per leaf, test_records costs each lane 32 sphere tests
// (~19 operations each, ~610 issue slots) whatever the reach, plus its
// serial exact tests; test_pairs costs per two reaching rays ~21 shuffles
// (each at a quarter of the f32 rate: ~84 slots), one sphere test, an
// exact test where a record passes and the (t, index) reduction where
// one accepts (~100 slots more), so ~185 a step of two rays: the two meet
// near 2 x 610 / 185 ~ 7 rays, higher where test_records' serial exact
// tests add up. On an H100, on smallpt's pass (1024x768, 16 spp, RR),
// the voted leaves' reach is bimodal: 79 % reached by one or two rays, 5 %
// by all 64, 0.3 % by 10 to 21; a sweep of kPairFrom over 6, 10, 14 and
// 21 put the pass at 106.4, 105.0-105.1, 105.0-105.5 and 105.1-105.3 ms
// (64 always per-lane: 161.4), so any value from 10 to 21 does, and 21
// leaves the per-lane path every leaf that a third of the warp reaches.
constexpr int kPairFrom = 21;

// The leaves the culled loop's pair instance tested, summed by each lane
// over its warp's selections: those its vote took (`visits`) and those of
// them that `test_pairs` took.
struct LeafCounts {
  long long visits, pair;
};

// h becomes c where c is the lesser (t, index) pair.
__device__ __forceinline__ void keep_least(Hit& h, Hit c) {
  if (c.t < h.t || (c.t == h.t && c.i < h.i)) h = c;
}

// One leaf's n <= kLeaf records (triangles base .. base + n - 1) against
// the warp's rays that reach it (bit l of ma: lane l's ray a, of mb: its
// ray b), two (ray, leaf) pairs at a time, one per half-warp: the pair's
// owner lane hands its ray over by shuffle, lane j of the half tests
// record j (the sphere of `record_pass`, then `pair_test` where that
// passes, with the ray's own |o|), the half's least (t, index) goes back
// to the owner, which keeps it by test_records' rule (nothing goes back
// where no lane accepted a hit, as for most pairs). So a ray's winner
// is the least (t, index) pair over the same accepted pairs as in
// test_records, bit for bit, at the cost of the pairs that reach the leaf
// and not of the 32 of every lane. Pair 1 is never pair 0's lane's other
// ray, so no lane hands over both of its rays at once. Every lane of the
// warp calls it (ma, mb warp-uniform).
template <bool kDzTest>
__device__ __forceinline__ void test_pairs(const float4* __restrict__ rec, int n, int base,
                                           float grow, Ray& ra, float on_a, unsigned ma,
                                           Ray& rb, float on_b, unsigned mb) {
  static_assert(2 * kLeaf == 32, "a leaf's records fill a half-warp");
  const int lane = threadIdx.x % 32, half = lane / kLeaf, j = lane % kLeaf;
  const bool mine = j < n;
  const float4 s = mine ? __ldg(rec + 4 * j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* g = rec + 4 * j + 1;
  const float inf = __int_as_float(0x7f800000);
  unsigned long long m = ma | (static_cast<unsigned long long>(mb) << 32);
  while (m != 0ull) {
    const int p0 = __ffsll(static_cast<long long>(m)) - 1;
    m &= m - 1ull;
    const unsigned long long rest = m & ~(1ull << (p0 ^ 32));
    const int p1 = __ffsll(static_cast<long long>(rest)) - 1;  // -1: half 1 idles
    m &= ~(rest & (0ull - rest));
    const int p = half ? p1 : p0, src = p & 31;
    const bool give_b = p0 == lane + 32 || p1 == lane + 32;
    Ray r;
    r.o = {__shfl_sync(kAll, give_b ? rb.o.x : ra.o.x, src),
           __shfl_sync(kAll, give_b ? rb.o.y : ra.o.y, src),
           __shfl_sync(kAll, give_b ? rb.o.z : ra.o.z, src)};
    r.d = {__shfl_sync(kAll, give_b ? rb.d.x : ra.d.x, src),
           __shfl_sync(kAll, give_b ? rb.d.y : ra.d.y, src),
           __shfl_sync(kAll, give_b ? rb.d.z : ra.d.z, src)};
    const float on = __shfl_sync(kAll, give_b ? on_b : on_a, src);
    r.dd = dot(r.d, r.d);
    r.ddp = r.dd * kShrink;
    Hit c = {inf, 0.0f, 0.0f, 0x7fffffff};
    if (mine && p >= 0 && record_pass(s, grow, on, r)) {
      const Pair q = pair_test(__ldg(g), __ldg(g + 1), __ldg(g + 2), r.o, r.d);
      if (q.inside && (!kDzTest || fabsf(q.w) > 1e-12f)) c = {q.t, q.beta, q.gamma, base + j};
    }
    // Most pairs accept no hit: then neither owner has anything to keep.
    if (!__any_sync(kAll, c.t < inf)) continue;
    // The half's least (t, index), then the other half's.
    float t = c.t;
    int i = c.i;
#pragma unroll
    for (int x = 1; x < kLeaf; x <<= 1) {
      const float to = __shfl_xor_sync(kAll, t, x);
      const int io = __shfl_xor_sync(kAll, i, x);
      if (to < t || (to == t && io < i)) t = to, i = io;
    }
    const float tx = __shfl_xor_sync(kAll, t, kLeaf);
    const int ix = __shfl_xor_sync(kAll, i, kLeaf);
    const float t0 = half ? tx : t, t1 = half ? t : tx;
    const int i0 = half ? ix : i, i1 = half ? i : ix;
    // Each winner's beta and gamma from its lane (lane 0 or 16 where none won).
    const int w0 = t0 < inf ? i0 - base : 0, w1 = t1 < inf ? kLeaf + i1 - base : kLeaf;
    const float b0 = __shfl_sync(kAll, c.beta, w0), c0 = __shfl_sync(kAll, c.gamma, w0);
    const float b1 = __shfl_sync(kAll, c.beta, w1), c1 = __shfl_sync(kAll, c.gamma, w1);
    // The owners keep the result by test_records' rule (no winner: t = inf never passes it).
    if (p0 == lane) keep_least(ra.h, {t0, b0, c0, i0});
    if (p0 == lane + 32) keep_least(rb.h, {t0, b0, c0, i0});
    if (p1 == lane) keep_least(ra.h, {t1, b1, c1, i1});
    if (p1 == lane + 32) keep_least(rb.h, {t1, b1, c1, i1});
  }
}

// Whether the segment [0, tmax] of a ray (slab s, sphere radii grown
// by ext = grow |o|) reaches leaf box l: lo = leaves[4 l], hi = leaves[4 l
// + 1] (a 64-byte row of `cull_records_launch`: the box of the leaf's
// spheres at |o| = 0, empty when every row of the leaf is all zero).
__device__ __forceinline__ bool leaf_reach(const float4* __restrict__ leaves, int l,
                                           const Slab& s, float ext, float tmax) {
  const float4 lo = __ldg(leaves + 4 * l), hi = __ldg(leaves + 4 * l + 1);
  if (!(lo.x <= hi.x)) return false;  // an empty leaf
  const float l3[3] = {lo.x, lo.y, lo.z}, h3[3] = {hi.x, hi.y, hi.z};
  float tn;
  return slab_box(s, l3, h3, ext, tmax, tn);
}

// One chunk's n records (triangles base .. base + n - 1, base a multiple
// of kLeaf) for both rays (where ta, tb), a leaf of kLeaf triangles at a
// time: a leaf whose box no ray of the warp reaches with its best t by
// then is skipped, and a lane tests a leaf only if its own ray reaches it.
// kPair: a leaf that fewer than kPairFrom of the warp's rays reach takes
// `test_pairs` instead of `test_records` (the same winners), and `lc`
// adds the leaves tested and those test_pairs took.
template <bool kDzTest, bool kPair>
__device__ __forceinline__ void test_chunk(const float4* __restrict__ rec,
                                           const float4* __restrict__ leaves, int n, int base,
                                           float grow, Ray& ra, const Slab& sa, float on_a,
                                           bool ta, Ray& rb, const Slab& sb, float on_b,
                                           bool tb, LeafCounts* lc) {
  const float ext_a = grow * on_a, ext_b = grow * on_b;
  for (int k = 0; k < n; k += kLeaf) {
    const int l = (base + k) / kLeaf;
    const bool la = ta && leaf_reach(leaves, l, sa, ext_a, ra.h.t);
    const bool lb = tb && leaf_reach(leaves, l, sb, ext_b, rb.h.t);
    if constexpr (kPair) {
      const unsigned ma = __ballot_sync(kAll, la), mb = __ballot_sync(kAll, lb);
      if ((ma | mb) == 0u) continue;
      lc->visits += 1;
      if (__popc(ma) + __popc(mb) < kPairFrom) {
        lc->pair += 1;
        test_pairs<kDzTest>(rec + 4 * k, min(kLeaf, n - k), base + k, grow, ra, on_a, ma, rb,
                            on_b, mb);
        continue;
      }
    } else {
      if (!__any_sync(kAll, la || lb)) continue;
    }
    test_records<kDzTest>(rec + 4 * k, min(kLeaf, n - k), base + k, grow, ra, on_a, la, rb,
                          on_b, lb);
  }
}

// float4s of the culled loop's vote bits: one bit per chunk for the
// block's group of 128 rays.
__host__ __device__ constexpr int cull_vote_float4s(int T) {
  return (((T + kChunk - 1) / kChunk + kWindow - 1) / kWindow + 3) / 4;
}

// Bytes of dynamic shared memory a block of `select_culled` takes for a
// T-triangle table: the vote bits.
__host__ __device__ constexpr int cull_smem_bytes(int T) {
  return cull_vote_float4s(T) * static_cast<int>(sizeof(float4));
}

// The nearest accepted triangle of both rays of every thread (slots of
// `ray_slots<true>`: a block of kCullThreads threads is one group of 128
// rays) over the records `rec` f32[T + ceil(T / 16), 16] of a
// Morton-ordered table (`triangle_record`, then the leaf boxes of
// `cull_records_launch`), culled by the chunks' boxes clo/chi f32[nc, 3]
// and slack cslack f32[nc, 2] (see the notes at the top), read through
// the read-only path. tested: the chunks that either warp of the block
// tested. kPair (the regen pass B1rc alone): the leaves of few reaching
// rays take `test_pairs`, and `leaves` adds the warp's LeafCounts.
// Every thread of the block must call this: it holds the block's
// barriers (before and after the chunk loop, none inside it).
template <bool kDzTest, bool kPair = false>
__device__ __forceinline__ void select_culled(const float4* __restrict__ rec, int T, Ray& ra,
                                              bool act_a, Ray& rb, bool act_b,
                                              const float* __restrict__ clo,
                                              const float* __restrict__ chi,
                                              const float* __restrict__ cslack, int& tested,
                                              LeafCounts* leaves = nullptr) {
  extern __shared__ float4 smem[];
  const int nc = (T + kChunk - 1) / kChunk, nwords = (nc + kWindow - 1) / kWindow;
  unsigned* votes = reinterpret_cast<unsigned*>(smem);  // [nwords]
  tested = 0;
  for (int q = threadIdx.x; q < nwords; q += kCullThreads) votes[q] = 0u;
  if (!__syncthreads_or(act_a || act_b)) return;
  const int lane = threadIdx.x % 32;
  const float on_a = norm_rn(ra.o), on_b = norm_rn(rb.o);
  // A NaN or overflowing |o| widens the spheres to the largest finite
  // radius or more (the exact test decides).
  const float son_a = fminf(on_a, kBig), son_b = fminf(on_b, kBig);
  const Slab sa = make_slab(ra.o, ra.d), sb = make_slab(rb.o, rb.d);
  for (int w0 = 0; w0 < nc; w0 += kWindow) {
    const int nw = min(kWindow, nc - w0);
    // Lane q: the least tn of the warp's rays that reach chunk w0 + q.
    unsigned key = ~0u;
    for (int q = 0; q < nw; ++q) {
      float tn;
      unsigned k = ~0u;
      if (act_a && chunk_entry(sa, clo, chi, cslack, w0 + q, on_a, ra.h.t, tn))
        k = entry_key(tn);
      if (act_b && chunk_entry(sb, clo, chi, cslack, w0 + q, on_b, rb.h.t, tn))
        k = min(k, entry_key(tn));
      k = __reduce_min_sync(kAll, k);
      if (lane == q) key = k;
    }
    if (key != ~0u) key = (key & ~31u) | static_cast<unsigned>(lane);
    key = warp_sort(key, lane);
    unsigned voted = 0u;
    for (int p = 0; p < nw; ++p) {
      const unsigned kp = __shfl_sync(kAll, key, p);
      if (kp == ~0u) break;  // no ray of the warp reached the rest
      const int q = static_cast<int>(kp & 31u), j = w0 + q;
      float tn;
      const bool ta = act_a && chunk_entry(sa, clo, chi, cslack, j, on_a, ra.h.t, tn);
      const bool tb = act_b && chunk_entry(sb, clo, chi, cslack, j, on_b, rb.h.t, tn);
      if (!__any_sync(kAll, ta || tb)) continue;
      voted |= 1u << q;
      const int base = j * kChunk;
      test_chunk<kDzTest, kPair>(rec + 4 * base, rec + 4 * T, min(kChunk, T - base), base,
                                 __ldg(cslack + 2 * j + 1), ra, sa, son_a, ta, rb, sb, son_b,
                                 tb, leaves);
    }
    if (lane == 0 && voted != 0u) atomicOr(votes + w0 / kWindow, voted);
  }
  __syncthreads();
  for (int q = 0; q < nwords; ++q) tested += __popc(votes[q]);
}

// Writes the per-group `tested` counts of one block of select_two (groups
// of 128 rays: 2 blockIdx.x and 2 blockIdx.x + 1) when tested_out is not
// null; a block of select_culled writes its group's, blockIdx.x
// (`store_tested_culled`).
__device__ __forceinline__ void store_tested(int* __restrict__ tested_out, int R, int tested_a,
                                             int tested_b) {
  if (tested_out != nullptr && threadIdx.x == 0) {
    const int groups = (R + kSelThreads - 1) / kSelThreads;
    if (2 * blockIdx.x < groups) tested_out[2 * blockIdx.x] = tested_a;
    if (2 * blockIdx.x + 1 < groups) tested_out[2 * blockIdx.x + 1] = tested_b;
  }
}

__device__ __forceinline__ void store_tested_culled(int* __restrict__ tested_out, int tested) {
  if (tested_out != nullptr && threadIdx.x == 0) tested_out[blockIdx.x] = tested;
}

}  // namespace seg

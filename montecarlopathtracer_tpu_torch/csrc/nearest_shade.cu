// Nearest hit per ray with the winner's values and shading row, and no
// epilogue: the split path's intersector.
//
// Replaces the TPU kernel `_mega_kernel_v4`
// (montecarlopathtracer_tpu/ops/intersect_pallas.py, entry
// `nearest_shade_full`), without (B4) and with (`cull=True`, B4c) chunk
// culling. The plain PyTorch version is `nearest_shade_full_ref` in
// ops/nearest_shade.py. The TPU kernels of the superseded entries
// `nearest_shade`, `nearest_shade2`, `nearest_shade_streamed` (with and
// without cull) and `nearest_shade_culled` (B8-B11) compute the same
// function in other layouts; ops/nearest_variants.py unpacks their
// layouts into this kernel's row table and launches it. For them the
// launch argument `dz_test` adds the explicit |d'_z| > 1e-12 test of
// `_nearest_shade_culled_kernel` (a template instance); the entries
// regrid their chunk boxes to this kernel's 128-triangle tiles.
//
// What bounds it on an H100: as B1's selection, f32 arithmetic over the
// ray x triangle pairs (with culling, over the pairs of the chunks each
// warp tests): the 17-operation sphere test on every pair (19 with
// culling: the radius grows with the ray's |o|), the ~40-operation exact
// test on the pairs inside a sphere. The outputs are 37 floats per ray
// (idx, tbg, the 32-float shading row): 71 MB, 0.021 ms of writes at
// 3.35 TB/s, for 480,000 rays.
//
// What the design does about it: B1's selection without its epilogue,
// the loops of sphere_select.cuh that segment_fused.cu runs (so B1's
// winners are B4's and B1c's are B4c's, `tested` included): `select_two`
// (B4) rejects a pair by each triangle's widened bounding sphere without
// a division, and only a pair inside it runs nearest_common.cuh's exact
// `pair_test`; the table is staged once per block (a cp.async ring of two
// 128-triangle tiles above 760 triangles); two rays per thread; strict
// `<` in ascending order (the smallest index wins a tie), explicit
// comparisons so NaN never wins. `select_culled` (B4c) makes the warp the
// unit of culling: each warp visits the chunks its rays reach, nearest
// first, over 64-byte triangle records that `cull_records_launch` builds
// once per table, and a hit wins on the least (t, index) pair. The sphere
// rejection drops only pairs that the exact test would drop, so the
// winners are those of the one-ray-per-thread loop `nearest_in_block`
// that B7 (nearest_triangle.cu) keeps: with `dz_test` and no cull, B4's
// idx is B7's bit for bit. The winner's shading row is read once per ray
// from global memory as eight float4 and written lane-major, so each of
// the 32 output rows is one coalesced store per warp. The TPU kernel's
// one-hot MXU row fetch and its split-bf16 contraction are TPU-only and
// not ported.
//
// Contract (that of nearest_shade_full): rows f32[T, 48]; pos/dir
// f32[3, R]; live bool[R]; with cull, the table in Morton order,
// clo/chi f32[nc, 3] and cslack f32[nc, 2] (the chunks' boxes and slack),
// nc = ceil(T / 128), and rec f32[T + ceil(T / 16), 16] its records. Outputs idx i32[R]
// (-1 = miss), tbg f32[4, R] = (t or 3e38, beta * hit, gamma * hit, hit)
// and shade f32[32, R] = rows[idx, 12:44] (0 on a miss); with `tested`
// non-null, tested[g] = the chunks that the group of rays
// [128 g, 128 g + 128) tested. A lane that is not live comes back as a
// miss (the TPU kernel computed such lanes' winners when their tile had a
// live lane; the integrator reads neither).

#include <cuda_runtime.h>

#include "segment_common.cuh"
#include "sphere_select.cuh"

namespace {

using namespace seg;

// One ray's outputs (see the contract).
__device__ __forceinline__ void store_hit(const float* __restrict__ rows, int r, int R,
                                          const Hit& best, int* __restrict__ idx_out,
                                          float* __restrict__ tbg, float* __restrict__ shade) {
  const bool hit = best.t < kBig;  // lanes that are not live tested nothing
  const size_t R_ = static_cast<size_t>(R);
  idx_out[r] = hit ? best.i : -1;
  tbg[r] = hit ? best.t : kBig;
  tbg[R_ + r] = hit ? best.beta : 0.0f;
  tbg[2 * R_ + r] = hit ? best.gamma : 0.0f;
  tbg[3 * R_ + r] = hit ? 1.0f : 0.0f;
  const float4* row = reinterpret_cast<const float4*>(rows + (size_t)max(best.i, 0) * 48 + 12);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (hit) v = row[q];
    shade[(4 * q) * R_ + r] = v.x;
    shade[(4 * q + 1) * R_ + r] = v.y;
    shade[(4 * q + 2) * R_ + r] = v.z;
    shade[(4 * q + 3) * R_ + r] = v.w;
  }
}

template <bool kCull, bool kDzTest>
__global__ void __launch_bounds__(kSelThreads)
nearest_shade_kernel(const float* __restrict__ rows, int T, const float* __restrict__ pos,
                     const float* __restrict__ dir, const bool* __restrict__ live, int R,
                     const float* __restrict__ clo, const float* __restrict__ chi,
                     const float* __restrict__ cslack, const float4* __restrict__ rec,
                     int* __restrict__ idx_out, float* __restrict__ tbg,
                     float* __restrict__ shade, int* __restrict__ tested_out) {
  int ra_i, rb_i;
  ray_slots<kCull>(ra_i, rb_i);
  const bool in_a = ra_i < R, in_b = rb_i < R;
  const bool act_a = in_a && live[ra_i], act_b = in_b && live[rb_i];
  const V3 o0 = {0.0f, 0.0f, 0.0f}, d0 = {0.0f, 0.0f, 1.0f};
  Ray ra = make_ray(in_a ? load3(pos, R, ra_i) : o0, in_a ? load3(dir, R, ra_i) : d0);
  Ray rb = make_ray(in_b ? load3(pos, R, rb_i) : o0, in_b ? load3(dir, R, rb_i) : d0);

  // Every thread reaches every barrier: no return before the selection ends.
  if constexpr (kCull) {
    int tested;
    select_culled<kDzTest>(rec, T, ra, act_a, rb, act_b, clo, chi, cslack, tested);
    store_tested_culled(tested_out, tested);
  } else {
    int tested_a, tested_b;
    select_two<kDzTest>(rows, T, ra, act_a, rb, act_b, tested_a, tested_b);
    store_tested(tested_out, R, tested_a, tested_b);
  }
  if (in_a) store_hit(rows, ra_i, R, ra.h, idx_out, tbg, shade);
  if (in_b) store_hit(rows, rb_i, R, rb.h, idx_out, tbg, shade);
}

// One triangle per thread: its record for the culled loop; per leaf of
// kLeaf consecutive threads (a part of a warp): the box of its spheres at |o| = 0 (center
// -+ K0; infinite where a radius is; all-zero rows left out, and an empty
// box, lo > hi, when no other row is left), as rows T + leaf of `rec`
// (lo xyz 0, hi xyz 0, then zeros).
__global__ void __launch_bounds__(256)
cull_records_kernel(const float* __restrict__ rows, int T, float4* __restrict__ rec) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  if (i < T) {
    const float4* g = reinterpret_cast<const float4*>(rows + static_cast<size_t>(i) * 48);
    const float4 g0 = g[0], g1 = g[1], g2 = g[2];
    const float4 s = triangle_record(g0, g1, g2, rec + 4 * static_cast<size_t>(i));
    if (!zero_geometry(g0, g1, g2)) {
      const float c[3] = {s.x, s.y, s.z};
#pragma unroll
      for (int k = 0; k < 3; ++k) lo[k] = c[k] - s.w, hi[k] = c[k] + s.w;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int off = kLeaf / 2; off > 0; off /= 2) {
      lo[k] = fminf(lo[k], __shfl_xor_sync(kAll, lo[k], off));
      hi[k] = fmaxf(hi[k], __shfl_xor_sync(kAll, hi[k], off));
    }
  }
  const int leaf = i / kLeaf;
  if (threadIdx.x % kLeaf == 0 && leaf * kLeaf < T) {
    float4* box = rec + 4 * (static_cast<size_t>(T) + leaf);
    box[0] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    box[1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
    box[2] = box[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace

// Launches the selection on `stream` (the cull instance when `cull` is
// set, over the records `rec` of `cull_records_launch`; the |d'_z| test
// when `dz_test` is set); returns cudaGetLastError() so the
// caller can raise on a refused launch.
extern "C" int nearest_shade_launch(const float* rows, int T, const float* pos,
                                    const float* dir, const bool* live, int R, const float* clo,
                                    const float* chi, const float* cslack, const float* rec,
                                    int cull, int dz_test, int* idx, float* tbg,
                                    float* shade, int* tested, void* stream) {
  if (R > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float4* rec4 = reinterpret_cast<const float4*>(rec);
    if (cull) {
      auto kernel = dz_test ? nearest_shade_kernel<true, true> : nearest_shade_kernel<true, false>;
      const int bytes = seg::cull_smem_bytes(T);
      kernel<<<(R + 2 * seg::kCullThreads - 1) / (2 * seg::kCullThreads), seg::kCullThreads,
               bytes, st>>>(rows, T, pos, dir, live, R, clo, chi, cslack, rec4, idx, tbg, shade,
                            tested);
    } else {
      auto kernel = dz_test ? nearest_shade_kernel<false, true> : nearest_shade_kernel<false, false>;
      kernel<<<(R + seg::kSelRays - 1) / seg::kSelRays, seg::kSelThreads,
               seg::select_smem_bytes(T), st>>>(rows, T, pos, dir, live, R, clo, chi, cslack,
                                                 rec4, idx, tbg, shade, tested);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Builds the culled loop's records rec f32[T + ceil(T / 16), 16] of the
// row table rows f32[T, 48] on `stream` (the triangles' records, then the
// leaf boxes); returns cudaGetLastError().
extern "C" int cull_records_launch(const float* rows, int T, float* rec, void* stream) {
  if (T > 0)
    cull_records_kernel<<<(T + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, T, reinterpret_cast<float4*>(rec));
  return static_cast<int>(cudaGetLastError());
}

// The largest table (rows) that the selection loop stages whole; larger
// ones take the tile ring (sphere_select.cuh).
extern "C" int nearest_shade_whole_max() { return seg::kWholeMax; }

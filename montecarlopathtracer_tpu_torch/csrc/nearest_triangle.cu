// Index of the nearest accepted triangle per ray: the fused
// intersector's selection.
//
// Replaces the TPU kernel `_nearest_kernel`
// (montecarlopathtracer_tpu/ops/intersect_pallas.py, entry
// `nearest_triangle`), B7. The plain PyTorch version is
// `nearest_triangle_ref` in ops/nearest_shade.py. `intersect_fused`
// there recomputes (t, beta, gamma, point) of the winner with
// differentiable torch ops (`refine_hit`).
//
// What bounds it on an H100: f32 arithmetic over the ray x triangle
// pairs, as for B4: the 17-operation sphere test on every pair, the
// ~40-operation exact test (an IEEE division among them) on the pairs
// inside a sphere; it writes 4 bytes per ray.
//
// What the design does about it: the selection loop of B1 and B4,
// sphere_select.cuh's `select_two` (the division-free sphere rejection,
// the table staged once per block or through a cp.async ring, two rays
// per thread, strict `<` in ascending order so the smallest index wins a
// tie), on this kernel's own table: a geometry table f32[T, 12]
// (`pack_geom_rows`: [m_k0 m_k1 m_k2 -m_a_k] for k = 0..2) whose rows are
// zero for invalid triangles, as the TPU kernel's w f32[6, 8, T] columns
// are. It keeps `_nearest_kernel`'s explicit |d'_z| > 1e-12 test, which B1
// leaves to NaN and inf comparisons. Every ray in range is live.
//
// The control: `nearest_triangle_control_launch` runs the same selection
// on nearest_common.cuh's one-ray-per-thread loop `nearest_in_block`,
// without the sphere rejection. B7 and B4 with `dz_test` must equal it
// bit for bit, which shows that the rejection drops no pair that the
// exact test accepts. No path launches it: card tests and chip_smoke.py
// do.
//
// Contract: geom f32[T, 12]; pos/dir f32[3, R]. Output idx i32[R],
// -1 for a miss.

#include <cuda_runtime.h>

#include "nearest_common.cuh"
#include "segment_common.cuh"
#include "sphere_select.cuh"

namespace {

using namespace seg;

constexpr int kControlThreads = 128;  // rays per block of the control

__global__ void __launch_bounds__(kSelThreads)
nearest_triangle_kernel(const float* __restrict__ geom_table, int T,
                        const float* __restrict__ pos, const float* __restrict__ dir, int R,
                        int* __restrict__ idx_out) {
  const int ra_i = blockIdx.x * kSelRays + threadIdx.x, rb_i = ra_i + kSelThreads;
  const bool in_a = ra_i < R, in_b = rb_i < R;
  const V3 o0 = {0.0f, 0.0f, 0.0f}, d0 = {0.0f, 0.0f, 1.0f};
  Ray ra = make_ray(in_a ? load3(pos, R, ra_i) : o0, in_a ? load3(dir, R, ra_i) : d0);
  Ray rb = make_ray(in_b ? load3(pos, R, rb_i) : o0, in_b ? load3(dir, R, rb_i) : d0);

  // Every thread reaches every barrier: no return before the selection ends.
  int tested_a, tested_b;
  select_two<true, 12>(geom_table, T, ra, in_a, rb, in_b, tested_a, tested_b);
  if (in_a) idx_out[ra_i] = ra.h.t < kBig ? ra.h.i : -1;
  if (in_b) idx_out[rb_i] = rb.h.t < kBig ? rb.h.i : -1;
}

__global__ void __launch_bounds__(kControlThreads)
nearest_triangle_control_kernel(const float* __restrict__ geom_table, int T,
                                const float* __restrict__ pos, const float* __restrict__ dir,
                                int R, int* __restrict__ idx_out) {
  __shared__ float4 geom[kChunk * 3];

  const int r = blockIdx.x * kControlThreads + threadIdx.x;
  const bool in_range = r < R;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  if (in_range) {
    o = load3(pos, R, r);
    d = load3(dir, R, r);
  }
  const Hit best = nearest_in_block<true>(geom, geom_table, 12, T, o, d, in_range);
  if (in_range) idx_out[r] = best.t < kBig ? best.i : -1;
}

}  // namespace

// Launches B7 on `stream`; returns cudaGetLastError() so the caller can
// raise on a refused launch.
extern "C" int nearest_triangle_launch(const float* geom, int T, const float* pos,
                                       const float* dir, int R, int* idx, void* stream) {
  if (R > 0) {
    const int blocks = (R + seg::kSelRays - 1) / seg::kSelRays;
    nearest_triangle_kernel<<<blocks, seg::kSelThreads, seg::select_smem_bytes(T),
                              static_cast<cudaStream_t>(stream)>>>(geom, T, pos, dir, R, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the control (the one-ray-per-thread loop) on `stream`; returns
// cudaGetLastError().
extern "C" int nearest_triangle_control_launch(const float* geom, int T, const float* pos,
                                               const float* dir, int R, int* idx,
                                               void* stream) {
  if (R > 0) {
    const int blocks = (R + kControlThreads - 1) / kControlThreads;
    nearest_triangle_control_kernel<<<blocks, kControlThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(geom, T, pos, dir,
                                                                           R, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

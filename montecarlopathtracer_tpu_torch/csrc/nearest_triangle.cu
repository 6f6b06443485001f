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
// What bounds it on an H100: the f32 pair tests, ~15 FMAs and one IEEE
// division per ray x triangle pair, as B1 and B4; it writes 4 bytes per
// ray.
//
// What the design does about it: the selection of nearest_common.cuh
// (shared with B1, B4 and B5), one thread per ray, the geometry of 128
// triangles at a time staged in shared memory, strict `<` in ascending
// order (smallest index wins a tie). The TPU kernel reads the
// transforms as w f32[6, 8, T] for its MXU contraction; this one reads
// the same values as a geometry table f32[T, 12] (`pack_geom_rows`:
// [m_k0 m_k1 m_k2 -m_a_k] for k = 0..2) whose rows are zero for invalid
// triangles, as w's columns are. It keeps `_nearest_kernel`'s explicit
// |d'_z| > 1e-12 test, which B1 leaves to NaN and inf comparisons.
//
// Contract: geom f32[T, 12]; pos/dir f32[3, R]. Output idx i32[R],
// -1 for a miss.

#include <cuda_runtime.h>

#include "nearest_common.cuh"
#include "segment_common.cuh"

namespace {

using namespace seg;

constexpr int kThreads = 128;  // rays per block

__global__ void __launch_bounds__(kThreads)
nearest_triangle_kernel(const float* __restrict__ geom_table, int T,
                        const float* __restrict__ pos, const float* __restrict__ dir, int R,
                        int* __restrict__ idx_out) {
  __shared__ float4 geom[kChunk * 3];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < R;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  if (in_range) {
    o = load3(pos, R, r);
    d = load3(dir, R, r);
  }
  int tested;
  const Hit best = nearest_in_block<false, true>(geom, geom_table, 12, T, o, d, in_range,
                                                 nullptr, nullptr, tested);
  if (in_range) idx_out[r] = best.t < kBig ? best.i : -1;
}

}  // namespace

// Launches the selection on `stream`; returns cudaGetLastError() so the
// caller can raise on a refused launch.
extern "C" int nearest_triangle_launch(const float* geom, int T, const float* pos,
                                       const float* dir, int R, int* idx, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    nearest_triangle_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        geom, T, pos, dir, R, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

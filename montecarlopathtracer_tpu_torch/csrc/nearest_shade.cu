// Nearest hit per ray with the winner's values and shading row, and no
// epilogue: the split path's intersector.
//
// Replaces the TPU kernel `_mega_kernel_v4`
// (montecarlopathtracer_tpu/ops/intersect_pallas.py, entry
// `nearest_shade_full`), without (B4) and with (`cull=True`, B4c) chunk
// culling. The plain PyTorch version is `nearest_shade_full_ref` in
// ops/nearest_shade.py.
//
// What bounds it on an H100: as B1 (segment_fused.cu), the f32 pair
// tests, ~15 FMAs and one IEEE division per ray x triangle pair (per
// pair of the tested chunks with culling); the outputs are 37 floats per
// ray (idx, tbg, the 32-float shading row), 0.3 ms of writes at
// 3.35 TB/s for 480,000 rays.
//
// What the design does about it: B1's selection with its epilogue left
// out (nearest_common.cuh, shared with B1, B5 and B7): one thread per
// ray, the geometry of 128 triangles at a time staged in shared memory,
// strict `<` in ascending order (smallest index wins a tie), explicit
// comparisons so NaN never wins, culling as a template instance chosen
// by the launch argument `cull`. The winner's shading row is read once
// per ray from global memory as eight float4 and written lane-major, so
// each of the 32 output rows is one coalesced store per warp. The TPU
// kernel's one-hot MXU row fetch and its split-bf16 contraction are
// TPU-only and not ported.
//
// Contract (that of nearest_shade_full): rows f32[T, 48]; pos/dir
// f32[3, R]; live bool[R]; with cull, the table in Morton order and
// clo/chi f32[nc, 3], nc = ceil(T / 128). Outputs idx i32[R] (-1 =
// miss), tbg f32[4, R] = (t or 3e38, beta * hit, gamma * hit, hit) and
// shade f32[32, R] = rows[idx, 12:44] (0 on a miss); with `tested`
// non-null, tested[block] = the chunks the block of 128 rays tested.
// A lane that is not live comes back as a miss (the TPU kernel computed
// such lanes' winners when their tile had a live lane; the integrator
// reads neither).

#include <cuda_runtime.h>

#include "nearest_common.cuh"
#include "segment_common.cuh"

namespace {

using namespace seg;

constexpr int kThreads = 128;  // rays per block

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
nearest_shade_kernel(const float* __restrict__ rows, int T, const float* __restrict__ pos,
                     const float* __restrict__ dir, const bool* __restrict__ live, int R,
                     const float* __restrict__ clo, const float* __restrict__ chi,
                     int* __restrict__ idx_out, float* __restrict__ tbg,
                     float* __restrict__ shade, int* __restrict__ tested_out) {
  __shared__ float4 geom[kChunk * 3];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < R;
  const bool act = in_range && live[r];
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  if (in_range) {
    o = load3(pos, R, r);
    d = load3(dir, R, r);
  }

  // Every thread reaches every barrier: no return before the selection ends.
  int tested;
  const Hit best = nearest_in_block<kCull, false>(geom, rows, 48, T, o, d, act, clo, chi, tested);
  if (tested_out != nullptr && threadIdx.x == 0) tested_out[blockIdx.x] = tested;
  if (!in_range) return;

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

}  // namespace

// Launches the selection on `stream` (the cull instance when `cull` is
// set); returns cudaGetLastError() so the caller can raise on a refused
// launch.
extern "C" int nearest_shade_launch(const float* rows, int T, const float* pos,
                                    const float* dir, const bool* live, int R, const float* clo,
                                    const float* chi, int cull, int* idx, float* tbg,
                                    float* shade, int* tested, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    auto kernel = cull ? nearest_shade_kernel<true> : nearest_shade_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, T, pos, dir, live, R, clo, chi, idx, tbg, shade, tested);
  }
  return static_cast<int>(cudaGetLastError());
}

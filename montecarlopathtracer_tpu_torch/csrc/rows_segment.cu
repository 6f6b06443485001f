// One path segment from a known winner per ray: winner recompute, BSDF
// sampling and state update, one ray per thread.
//
// Replaces the TPU kernel `_rows_segment_kernel`
// (montecarlopathtracer_tpu/ops/segment_fused.py, entry
// `rows_segment_fwd`), the epilogue of the traversal path: the walk
// (traverse_select.cu) picks each ray's winner, and this kernel finishes
// the segment. Scalar flags (B6) or per-lane flags (`lane_flags=True`,
// B6l, the regenerating wavefront on the traversal path). The plain
// PyTorch version is `rows_segment_ref` in ops/segment_fused.py
// (`segment_core_rows` on the gathered rows).
//
// Where the TPU kernel took the winners' rows gathered beforehand as
// fullT f32[48, R], this kernel reads `rows[idx]` itself: the 12
// geometry floats and 21 shading floats of the winner's row, as float4
// loads, straight from the [T, 48] table. No [48, R] copy is made.
//
// What bounds it on an H100: memory. Per ray it reads ~130 B of ray
// state, uniforms and flags, the 132 B it needs of its winner's row
// (scattered: rays of a warp hit different triangles, so each row read is
// its own few sectors; the table, 15.7 MB for the 81,932-triangle bunny,
// fits the 50 MB L2) and writes 52 B; the arithmetic is the recompute
// (~20 flops and one IEEE division) and one BSDF sample.
//
// Recompute (`_recompute_rows`): t = -o'_z / d'_z where |d'_z| > 1e-12,
// else BIG; beta = o'_x + t d'_x, gamma = o'_y + t d'_y; on a miss
// (idx = -1) t = BIG, beta = gamma = 0 and the shading row is zero.
// Lanes that are not live pass their state through.
//
// Contract: rows f32[T, 48]; idx i32[R] (-1 = miss); pos/dir/tput/res
// f32[3, R]; live bool[R]; u1/u2/urr f32[R]; flags f32[3, 1] or, with
// lane_flags, f32[3, R]. Outputs npos/ndir/ntput/nres f32[3, R], still
// f32[R].

#include <cuda_runtime.h>

#include "segment_common.cuh"

namespace {

using namespace seg;

constexpr int kThreads = 256;  // rays per block

__global__ void __launch_bounds__(kThreads)
rows_segment_kernel(const float* __restrict__ rows, const int* __restrict__ idx,
                    const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ tput, const float* __restrict__ res,
                    const bool* __restrict__ live, const float* __restrict__ u1,
                    const float* __restrict__ u2, const float* __restrict__ urr,
                    const float* __restrict__ flags, int lane_flags, int R, SegOptions opt,
                    float* __restrict__ npos, float* __restrict__ ndir,
                    float* __restrict__ ntput, float* __restrict__ nres,
                    float* __restrict__ still_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const V3 o = load3(pos, R, r), d = load3(dir, R, r);
  const V3 tp_in = load3(tput, R, r), rs_in = load3(res, R, r);
  if (!live[r]) {
    store3(npos, R, r, o);
    store3(ndir, R, r, d);
    store3(ntput, R, r, tp_in);
    store3(nres, R, r, rs_in);
    still_out[r] = 0.0f;
    return;
  }
  const int i = idx[r];
  const bool hit = i >= 0;
  float g[12], sh[24];
  if (hit) {
    const float4* row = reinterpret_cast<const float4*>(rows + static_cast<size_t>(i) * 48);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 v = row[q];
      g[4 * q] = v.x, g[4 * q + 1] = v.y, g[4 * q + 2] = v.z, g[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float4 v = row[3 + q];
      sh[4 * q] = v.x, sh[4 * q + 1] = v.y, sh[4 * q + 2] = v.z, sh[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 12; ++q) g[q] = 0.0f;
#pragma unroll
    for (int q = 0; q < 24; ++q) sh[q] = 0.0f;
  }
  float t = kBig, beta = 0.0f, gamma = 0.0f;
  if (hit) {
    float op[3], dp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      op[k] = g[4 * k] * o.x + g[4 * k + 1] * o.y + g[4 * k + 2] * o.z + g[4 * k + 3];
      dp[k] = g[4 * k] * d.x + g[4 * k + 1] * d.y + g[4 * k + 2] * d.z;
    }
    t = fabsf(dp[2]) > 1e-12f ? -op[2] / dp[2] : kBig;
    beta = op[0] + t * dp[0];
    gamma = op[1] + t * dp[1];
  }
  const SegState out = segment_epilogue(o, d, tp_in, rs_in, hit, t, beta, gamma, sh, u1[r],
                                        u2[r], urr[r], read_flags(flags, lane_flags, R, r), opt);
  store3(npos, R, r, out.pos);
  store3(ndir, R, r, out.dir);
  store3(ntput, R, r, out.tput);
  store3(nres, R, r, out.res);
  still_out[r] = out.still ? 1.0f : 0.0f;
}

}  // namespace

// Launches one segment epilogue on `stream`; returns cudaGetLastError()
// so the caller can raise on a refused launch.
extern "C" int rows_segment_launch(const float* rows, const int* idx, const float* pos,
                                   const float* dir, const float* tput, const float* res,
                                   const bool* live, const float* u1, const float* u2,
                                   const float* urr, const float* flags, int lane_flags, int R,
                                   int mode_rr, float illum, float eps_offset, int refract_kd,
                                   int phong_reflect, float* npos, float* ndir, float* ntput,
                                   float* nres, float* still, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    const SegOptions opt = {mode_rr, illum, eps_offset, refract_kd, phong_reflect};
    rows_segment_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, idx, pos, dir, tput, res, live, u1, u2, urr, flags, lane_flags, R, opt, npos,
        ndir, ntput, nres, still);
  }
  return static_cast<int>(cudaGetLastError());
}

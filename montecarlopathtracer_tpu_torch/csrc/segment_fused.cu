// One whole path segment per ray: nearest hit, BSDF sampling and state
// update, in one kernel launch.
//
// Replaces the TPU kernel `_mega_segment_kernel`
// (montecarlopathtracer_tpu/ops/segment_fused.py, entry
// `mega_segment_fwd`; its chunk loop is `_v4_init_tile` /
// `_v4_process_chunk` in ops/intersect_pallas.py, its cull test
// `_slab_reach`), with scalar flags (B1) or per-lane flags
// (`lane_flags=True`, B1l, the regenerating wavefront's), and with or
// without chunk culling (`cull=True`, B1c). The plain PyTorch version of
// the same function is `mega_segment_ref` in ops/segment_fused.py.
//
// What bounds it on an H100: f32 FMA and one IEEE division over all
// ray x triangle pairs. On the 800x600 Cornell box with both spheres
// that is 480,000 rays x 652 triangles = 3.1e8 pairs per segment, each
// ~15 FMAs for the primed coordinates and barycentrics plus the
// division and four compares; the epilogue and the 108 bytes of ray
// state moved per ray are small beside it. With culling, the pairs of
// the chunks each block tests.
//
// What the design does about it: one thread per ray, so a ray's best
// hit lives in registers for the whole triangle loop; the block stages
// the geometry of 128 triangles at a time in shared memory and scans
// them in ascending order with a strict `<` on t, which is the JAX
// kernel's tie rule (smallest index wins) (nearest_common.cuh, shared
// with B4, B5 and B7). The winner's shading row is then read straight
// from global memory once per ray, and the epilogue
// (segment_common.cuh, shared with rows_segment.cu) runs in registers.
// Per-lane flags cost one more coalesced read of 12 bytes per ray.
// Culling (a template instance chosen by the launch argument `cull`)
// takes the triangles in Morton order with one box per 128-triangle
// chunk: each lane slab-tests the chunk's box against its segment
// [0, best t], and the block skips a chunk no lane reaches. Selection
// runs in plain f32: no tensor cores (TF32 or bf16 picks wrong winners
// near edges), IEEE division and the precise powf/sinf/cosf (compile
// without --use_fast_math: Ns = 1000 lobes and grazing Fresnel need
// them).
//
// Contract (that of mega_segment_fwd): rows f32[T, 48] = geometry 12 |
// shading 32 | pad 4; pos/dir/tput/res f32[3, R]; live bool[R];
// u1/u2/urr f32[R]; flags f32[3, 1] or, with lane_flags, f32[3, R] =
// [final_gather, do_rr, hard_kill]; with cull, clo/chi f32[nc, 3],
// nc = ceil(T / 128). Outputs idx i32[R] (-1 = miss), npos/ndir/ntput/
// nres f32[3, R], still f32[R]; with `tested` non-null, tested[block] =
// the 128-triangle chunks the block of 128 rays tested. Lanes that are
// not live pass their state through with idx = -1.

#include <cuda_runtime.h>

#include "nearest_common.cuh"
#include "segment_common.cuh"

namespace {

using namespace seg;

constexpr int kThreads = 128;  // rays per block

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
mega_segment_kernel(const float* __restrict__ rows, int T,
                    const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ tput, const float* __restrict__ res,
                    const bool* __restrict__ live, const float* __restrict__ u1,
                    const float* __restrict__ u2, const float* __restrict__ urr,
                    const float* __restrict__ flags, int lane_flags, int R, SegOptions opt,
                    const float* __restrict__ clo, const float* __restrict__ chi,
                    int* __restrict__ idx_out, float* __restrict__ npos,
                    float* __restrict__ ndir, float* __restrict__ ntput,
                    float* __restrict__ nres, float* __restrict__ still_out,
                    int* __restrict__ tested_out) {
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

  const V3 tp_in = load3(tput, R, r);
  const V3 rs_in = load3(res, R, r);
  if (!act) {
    idx_out[r] = -1;
    store3(npos, R, r, o);
    store3(ndir, R, r, d);
    store3(ntput, R, r, tp_in);
    store3(nres, R, r, rs_in);
    still_out[r] = 0.0f;
    return;
  }

  // Winner values; a miss has t = BIG, beta = gamma = 0 and an all-zero
  // shading row.
  const bool hit = best.t < kBig;
  idx_out[r] = hit ? best.i : -1;
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
  const SegState out = segment_epilogue(
      o, d, tp_in, rs_in, hit, hit ? best.t : kBig, hit ? best.beta : 0.0f,
      hit ? best.gamma : 0.0f, sh, u1[r], u2[r], urr[r], read_flags(flags, lane_flags, R, r),
      opt);
  store3(npos, R, r, out.pos);
  store3(ndir, R, r, out.dir);
  store3(ntput, R, r, out.tput);
  store3(nres, R, r, out.res);
  still_out[r] = out.still ? 1.0f : 0.0f;
}

}  // namespace

// Launches one segment on `stream` (the cull instance when `cull` is
// set); returns cudaGetLastError() so the caller can raise on a refused
// launch.
extern "C" int mega_segment_launch(const float* rows, int T, const float* pos,
                                   const float* dir, const float* tput, const float* res,
                                   const bool* live, const float* u1, const float* u2,
                                   const float* urr, const float* flags, int lane_flags, int R,
                                   int mode_rr, float illum, float eps_offset, int refract_kd,
                                   int phong_reflect, const float* clo, const float* chi,
                                   int cull, int* idx, float* npos, float* ndir, float* ntput,
                                   float* nres, float* still, int* tested, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    const SegOptions opt = {mode_rr, illum, eps_offset, refract_kd, phong_reflect};
    auto kernel = cull ? mega_segment_kernel<true> : mega_segment_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, T, pos, dir, tput, res, live, u1, u2, urr, flags, lane_flags, R, opt, clo, chi,
        idx, npos, ndir, ntput, nres, still, tested);
  }
  return static_cast<int>(cudaGetLastError());
}

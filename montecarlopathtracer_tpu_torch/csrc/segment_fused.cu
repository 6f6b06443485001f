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
// What bounds it on an H100: f32 arithmetic over all ray x triangle
// pairs. On the 800x600 Cornell box with both spheres that is 480,000
// rays x 652 triangles = 3.1e8 pairs per segment, each behind a sphere
// test of 17 operations, with the exact test (~40 operations) only on the
// pairs that pass it; the epilogue and the 108 bytes of ray state moved
// per ray are small beside them. With culling, the pairs of the chunks
// each warp tests.
//
// What the design does about it: the selection is sphere_select.cuh's
// `select_two`, shared with the split path's intersector B4
// (nearest_shade.cu): a division-free rejection by each triangle's
// widened bounding sphere in front of nearest_common.cuh's unchanged
// `pair_test`, the table staged once per block (a cp.async ring of two
// tiles above 760 triangles), two rays per thread; culling is its
// `select_culled`, shared with B4c, a template instance chosen by the
// launch argument `cull`: each warp visits the chunks its rays reach,
// nearest first, over the records of nearest_shade.cu's
// `cull_records_launch`. The winner's shading row is read from global
// memory once per ray, and the epilogue
// (segment_common.cuh, shared with rows_segment.cu) runs in registers, in
// plain f32 with the precise powf/sinf/cosf (compile without
// --use_fast_math: Ns = 1000 lobes and grazing Fresnel need them).
// Per-lane flags cost one more coalesced read of 12 bytes per ray.
//
// Contract (that of mega_segment_fwd): rows f32[T, 48] = geometry 12 |
// shading 32 | pad 4; pos/dir/tput/res f32[3, R]; live bool[R];
// u1/u2/urr f32[R]; flags f32[3, 1] or, with lane_flags, f32[3, R] =
// [final_gather, do_rr, hard_kill]; with cull, clo/chi f32[nc, 3] and
// cslack f32[nc, 2] (the chunks' boxes and slack), nc = ceil(T / 128),
// and rec f32[T + ceil(T / 16), 16] the table's records.
// Outputs idx i32[R] (-1 = miss), npos/ndir/ntput/nres f32[3, R], still
// f32[R]; with `tested` non-null, tested[g] = the 128-triangle chunks
// that the group of rays [128 g, 128 g + 128) tested.
// Lanes that are not live pass their state through with idx = -1.

#include <cuda_runtime.h>

#include "segment_common.cuh"
#include "sphere_select.cuh"

namespace {

using namespace seg;

constexpr int kThreads = kSelThreads;  // threads per block; each takes two rays

// The epilogue of one ray after the selection (see the contract).
__device__ __forceinline__ void finish_ray(
    const float* __restrict__ rows, int r, int R, bool act, const Ray& ray,
    const float* __restrict__ tput, const float* __restrict__ res, const float* __restrict__ u1,
    const float* __restrict__ u2, const float* __restrict__ urr, const float* __restrict__ flags,
    int lane_flags, const SegOptions& opt, int* __restrict__ idx_out, float* __restrict__ npos,
    float* __restrict__ ndir, float* __restrict__ ntput, float* __restrict__ nres,
    float* __restrict__ still_out) {
  const V3 tp_in = load3(tput, R, r);
  const V3 rs_in = load3(res, R, r);
  if (!act) {
    idx_out[r] = -1;
    store3(npos, R, r, ray.o);
    store3(ndir, R, r, ray.d);
    store3(ntput, R, r, tp_in);
    store3(nres, R, r, rs_in);
    still_out[r] = 0.0f;
    return;
  }

  idx_out[r] = ray.h.t < kBig ? ray.h.i : -1;
  const SegState out = segment_after_select(rows, ray, tp_in, rs_in, u1[r], u2[r], urr[r],
                                            read_flags(flags, lane_flags, R, r), opt);
  store3(npos, R, r, out.pos);
  store3(ndir, R, r, out.dir);
  store3(ntput, R, r, out.tput);
  store3(nres, R, r, out.res);
  still_out[r] = out.still ? 1.0f : 0.0f;
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
mega_segment_kernel(const float* __restrict__ rows, int T,
                    const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ tput, const float* __restrict__ res,
                    const bool* __restrict__ live, const float* __restrict__ u1,
                    const float* __restrict__ u2, const float* __restrict__ urr,
                    const float* __restrict__ flags, int lane_flags, int R, SegOptions opt,
                    const float* __restrict__ clo, const float* __restrict__ chi,
                    const float* __restrict__ cslack, const float4* __restrict__ rec,
                    int* __restrict__ idx_out, float* __restrict__ npos,
                    float* __restrict__ ndir, float* __restrict__ ntput,
                    float* __restrict__ nres, float* __restrict__ still_out,
                    int* __restrict__ tested_out) {
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
    select_culled<false>(rec, T, ra, act_a, rb, act_b, clo, chi, cslack, tested);
    store_tested_culled(tested_out, tested);
  } else {
    int tested_a, tested_b;
    select_two<false>(rows, T, ra, act_a, rb, act_b, tested_a, tested_b);
    store_tested(tested_out, R, tested_a, tested_b);
  }
  if (in_a)
    finish_ray(rows, ra_i, R, act_a, ra, tput, res, u1, u2, urr, flags, lane_flags, opt, idx_out,
               npos, ndir, ntput, nres, still_out);
  if (in_b)
    finish_ray(rows, rb_i, R, act_b, rb, tput, res, u1, u2, urr, flags, lane_flags, opt, idx_out,
               npos, ndir, ntput, nres, still_out);
}

}  // namespace

// Launches one segment on `stream` (the cull instance when `cull` is
// set, over the records `rec` of nearest_shade.cu's `cull_records_launch`);
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int mega_segment_launch(const float* rows, int T, const float* pos,
                                   const float* dir, const float* tput, const float* res,
                                   const bool* live, const float* u1, const float* u2,
                                   const float* urr, const float* flags, int lane_flags, int R,
                                   int mode_rr, float illum, float eps_offset, int refract_kd,
                                   int phong_reflect, const float* clo, const float* chi,
                                   const float* cslack, const float* rec, int cull, int* idx,
                                   float* npos, float* ndir, float* ntput, float* nres,
                                   float* still, int* tested, void* stream) {
  if (R > 0) {
    const SegOptions opt = {mode_rr, illum, eps_offset, refract_kd, phong_reflect};
    auto kernel = cull ? mega_segment_kernel<true> : mega_segment_kernel<false>;
    const int bytes = cull ? seg::cull_smem_bytes(T) : seg::select_smem_bytes(T);
    const int threads = cull ? seg::kCullThreads : kThreads;
    kernel<<<(R + 2 * threads - 1) / (2 * threads), threads, bytes,
             static_cast<cudaStream_t>(stream)>>>(
        rows, T, pos, dir, tput, res, live, u1, u2, urr, flags, lane_flags, R, opt, clo, chi,
        cslack, reinterpret_cast<const float4*>(rec), idx, npos, ndir, ntput, nres, still,
        tested);
  }
  return static_cast<int>(cudaGetLastError());
}

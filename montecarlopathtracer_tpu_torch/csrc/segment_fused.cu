// One whole path segment per ray: nearest hit, BSDF sampling and state
// update, in one kernel launch.
//
// Replaces the TPU kernel `_mega_segment_kernel`
// (montecarlopathtracer_tpu/ops/segment_fused.py, entry
// `mega_segment_fwd`; its chunk loop is `_v4_init_tile` /
// `_v4_process_chunk` in ops/intersect_pallas.py) in its non-cull form,
// with scalar flags (B1) or per-lane flags (`lane_flags=True`, B1l, the
// regenerating wavefront's). The plain PyTorch version of the same
// function is `mega_segment_ref` in ops/segment_fused.py.
//
// What bounds it on an H100: f32 FMA and one IEEE division over all
// ray x triangle pairs. On the 800x600 Cornell box with both spheres
// that is 480,000 rays x 652 triangles = 3.1e8 pairs per segment, each
// ~15 FMAs for the primed coordinates and barycentrics plus the
// division and four compares; the epilogue and the 108 bytes of ray
// state moved per ray are small beside it.
//
// What the design does about it: one thread per ray, so a ray's best
// hit lives in registers for the whole triangle loop; the block stages
// the 12 geometry floats of each triangle (rows[:, 0:12]) in shared
// memory as three float4, one tile of kTriTile triangles at a time, so
// every triangle is read from global memory once per block and then
// broadcast to all of the block's threads. Triangles are scanned in
// ascending order with a strict `<` on t, which is the JAX kernel's tie
// rule (smallest index wins). The winner's shading row is then read
// straight from global memory once per ray, and the epilogue
// (segment_common.cuh, shared with rows_segment.cu) runs in registers.
// Per-lane flags cost one more coalesced read of 12 bytes per ray,
// chosen by a launch argument. Selection runs in plain
// f32: no tensor cores (TF32 or bf16 picks wrong winners near edges),
// IEEE division and the precise powf/sinf/cosf (compile without
// --use_fast_math: Ns = 1000 lobes and grazing Fresnel need them).
//
// Contract (that of mega_segment_fwd): rows f32[T, 48] = geometry 12 |
// shading 32 | pad 4; pos/dir/tput/res f32[3, R]; live bool[R];
// u1/u2/urr f32[R]; flags f32[3, 1] or, with lane_flags, f32[3, R] =
// [final_gather, do_rr, hard_kill].
// Outputs idx i32[R] (-1 = miss), npos/ndir/ntput/nres f32[3, R],
// still f32[R]. Lanes that are not live pass their state through with
// idx = -1.

#include <cuda_runtime.h>

#include "segment_common.cuh"

namespace {

using namespace seg;

constexpr int kThreads = 128;  // rays per block
constexpr int kTriTile = 128;  // triangles per shared-memory tile

__global__ void __launch_bounds__(kThreads)
mega_segment_kernel(const float* __restrict__ rows, int T,
                    const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ tput, const float* __restrict__ res,
                    const bool* __restrict__ live, const float* __restrict__ u1,
                    const float* __restrict__ u2, const float* __restrict__ urr,
                    const float* __restrict__ flags, int lane_flags, int R, SegOptions opt,
                    int* __restrict__ idx_out, float* __restrict__ npos,
                    float* __restrict__ ndir, float* __restrict__ ntput,
                    float* __restrict__ nres, float* __restrict__ still_out) {
  __shared__ float4 geom[kTriTile * 3];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < R;
  const bool act = in_range && live[r];
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  if (in_range) {
    o = load3(pos, R, r);
    d = load3(dir, R, r);
  }

  float best_t = kBig, best_b = 0.0f, best_g = 0.0f;
  int best_i = -1;
  // Every thread reaches every barrier: no return before the loop ends.
  if (__syncthreads_or(act)) {
    for (int base = 0; base < T; base += kTriTile) {
      const int n = min(kTriTile, T - base);
      for (int j = threadIdx.x; j < 3 * n; j += kThreads) {
        geom[j] = reinterpret_cast<const float4*>(rows + (size_t)(base + j / 3) * 48)[j % 3];
      }
      __syncthreads();
      if (act) {
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
          // Explicit comparisons, never fminf: fminf drops NaN, and a
          // zero-geometry or parallel triangle gives t = NaN or inf.
          if (beta > 0.0f && gamma > 0.0f && t > 0.0f && 1.0f - (beta + gamma) > 0.0f &&
              t < best_t) {
            best_t = t;
            best_i = base + k;
            best_b = beta;
            best_g = gamma;
          }
        }
      }
      __syncthreads();
    }
  }
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
  const bool hit = best_t < kBig;
  idx_out[r] = hit ? best_i : -1;
  float sh[24];
  if (hit) {
    const float4* row = reinterpret_cast<const float4*>(rows + (size_t)best_i * 48 + 12);
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
      o, d, tp_in, rs_in, hit, hit ? best_t : kBig, hit ? best_b : 0.0f, hit ? best_g : 0.0f, sh,
      u1[r], u2[r], urr[r], read_flags(flags, lane_flags, R, r), opt);
  store3(npos, R, r, out.pos);
  store3(ndir, R, r, out.dir);
  store3(ntput, R, r, out.tput);
  store3(nres, R, r, out.res);
  still_out[r] = out.still ? 1.0f : 0.0f;
}

}  // namespace

// Launches one segment on `stream`; returns cudaGetLastError() so the
// caller can raise on a refused launch.
extern "C" int mega_segment_launch(const float* rows, int T, const float* pos,
                                   const float* dir, const float* tput, const float* res,
                                   const bool* live, const float* u1, const float* u2,
                                   const float* urr, const float* flags, int lane_flags, int R,
                                   int mode_rr, float illum, float eps_offset, int refract_kd,
                                   int phong_reflect, int* idx, float* npos, float* ndir,
                                   float* ntput, float* nres, float* still, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    const SegOptions opt = {mode_rr, illum, eps_offset, refract_kd, phong_reflect};
    mega_segment_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, T, pos, dir, tput, res, live, u1, u2, urr, flags, lane_flags, R, opt, idx, npos,
        ndir, ntput, nres, still);
  }
  return static_cast<int>(cudaGetLastError());
}

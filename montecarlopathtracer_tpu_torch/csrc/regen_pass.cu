// A whole pass of the regenerating wavefront in one launch (B1r): every
// step of every lane, with its draws, flags, segment, bookkeeping and
// regenerated camera rays, inside the kernel.
//
// Replaces the JAX package's device program for a regen pass,
// `render_regen_planar` (montecarlopathtracer_tpu/render/regen.py): a
// `lax.while_loop` under `jit` whose body runs the per-lane-flag segment
// kernel `_mega_segment_kernel` (ops/segment_fused.py, B1l) and lets XLA
// fuse the bookkeeping around it. The plain PyTorch version of the same
// function is `regen_pass_ref` in ops/regen_pass.py: the host loop over
// one B1l segment per step.
//
// The loop's lanes are independent: lane i is pinned to pixel i of the
// band, its draws are element i of counter-based streams (threefry.cuh,
// bit-equal to ops/rng.py), and a lane that has finished its quota only
// passes its state through. So a block runs the loop body (JAX
// regen.py:127-163) for its own lanes, step after step, and stops as soon
// as none of them is live, without changing any other lane's result:
// - the draws u1, u2 and (RR only) urr of step s are element i of the
//   streams (s-1)*4 + {0, 1, 3}, the camera jitter of step 0 of
//   (1<<30) and (1<<30)+1 and that of step s of (1<<30)+2s and
//   (1<<30)+2s+1, under keys folded on the host (`keys` u32[steps, 5, 2],
//   ops/regen_pass.py::pass_keys);
// - the per-lane flags come from the lane's path depth as
//   TraceConfig.lane_flags makes them: fixed [depth == max_depth, 0, 0],
//   RR [0, rr <= depth < 3 rr, depth >= 3 rr];
// - the segment is B1l's: sphere_select.cuh's `select_two` (128 threads,
//   two rays each) or `select_culled` (64 threads, 128 rays, the lane map
//   of `ray_slots<true>`), then `segment_after_select` (the winner's
//   shading row and segment_common.cuh's `segment_epilogue`), the same
//   functions as segment_fused.cu's, so a block's winners and outputs are
//   those of B1l on its lanes;
// - the bookkeeping: a path that ended adds its radiance to the lane's
//   sum (`accum`, an IEEE add as torch's), and the lane restarts with a
//   fresh camera ray, tput 1 and res 0 until it has done `spp` samples;
// - the camera ray is Camera.generate_rays_soa (scene/camera.py) in
//   torch's operation order on the card, each operation rounded as
//   written (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, so nvcc
//   contracts none into an FMA). torch on the card divides by a Python
//   number as a multiply by its f32 reciprocal, so x / W is x * (1 / W)
//   here (`inv_w`, `inv_h`, computed on the host).
// Outputs: accum f32[3, R], the sum over the lane's spp samples (the
// caller divides), and steps i32[blocks], the steps each block ran
// (spp * num_segments + 1, one more than any block can run, if the
// backstop stopped it with a lane still live: every path ends within
// num_segments segments, so that never happens).
//
// What bounds it on an H100: the selection's f32 arithmetic, as B1l's:
// every step tests each live lane against every triangle's sphere (17
// operations a pair) and runs the exact test on the pairs inside; summed
// over a pass, the live lane-steps x T x 17. Its bytes (the table, the
// outputs) are small beside that.
//
// What the design does about it: it takes the host out of the loop, so
// the card runs only the segments (B1l's ~0.24 ms a step on average) and
// not ~53 torch ops and three launches a step behind a sync every eight.
// The ray state (pos, dir, tput, res f32[3, R], scratch from the caller)
// stays in global memory, read and written each step by the thread that
// owns the lane (coalesced, as B1l's), so the registers stay where
// `select_two` needs them; the lane's live flag, depth and sample count
// are registers. A block restages the table each step inside the
// selection loop, as B1l does per launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "segment_common.cuh"
#include "sphere_select.cuh"
#include "threefry.cuh"

// What a launch takes by value besides the pointers (the launcher's C
// interface takes a host pointer to it; ops/regen_pass.py's _Args).
struct RegenArgs {
  int R, T, width, y0, spp, max_steps, max_depth, rr_depth;
  float jitter, inv_w, inv_h;  // the camera's jitter, 1 / width, 1 / height (f32)
  seg::SegOptions opt;
};

namespace {

using namespace seg;

constexpr int kKeyWords = 10;  // a step's folded keys: u1, u2, urr, jitter x, jitter y

// One lane's registers: live, path depth, samples completed.
struct Lane {
  bool live;
  int depth, done;
};

// Camera.generate_rays_soa of band lane r (pixel (r % W, r / W + y0))
// with uniforms ux, uy in [0, 1): jitter j = 2 u - 1. `cam` f32[14] =
// eye, right, up, forward, tan_half_x, tan_half_y.
__device__ __forceinline__ void camera_ray(const float* __restrict__ cam, const RegenArgs& a,
                                           int r, float ux, float uy, V3& o, V3& d) {
  const float x = __int2float_rn(r % a.width), y = __int2float_rn(r / a.width + a.y0);
  const float jx = __fsub_rn(__fmul_rn(ux, 2.0f), 1.0f);
  const float jy = __fsub_rn(__fmul_rn(uy, 2.0f), 1.0f);
  const float bx = __fadd_rn(x, __fmul_rn(jx, a.jitter));
  const float by = __fadd_rn(y, __fmul_rn(jy, a.jitter));
  const float dx = __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(2.0f, bx), a.inv_w), 1.0f),
                             __ldg(cam + 12));
  const float dy = __fmul_rn(__fsub_rn(1.0f, __fmul_rn(__fmul_rn(2.0f, by), a.inv_h)),
                             __ldg(cam + 13));
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    c[k] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(cam + 3 + k), dx), __fmul_rn(__ldg(cam + 6 + k), dy)),
                     __ldg(cam + 9 + k));
  // torch.sum over the 3 rows: ((x0 + x1) + x2), then the IEEE root.
  const float n = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1])), __fmul_rn(c[2], c[2])));
  d = make(__fdiv_rn(c[0], n), __fdiv_rn(c[1], n), __fdiv_rn(c[2], n));
  o = make(__ldg(cam), __ldg(cam + 1), __ldg(cam + 2));
}

// A fresh path for lane r: the camera ray of the jitter keys k[6..9],
// tput 1, res 0.
__device__ __forceinline__ void start_path(const float* __restrict__ cam, const RegenArgs& a,
                                           const uint32_t* __restrict__ k, int r,
                                           float* __restrict__ pos, float* __restrict__ dir,
                                           float* __restrict__ tput, float* __restrict__ res) {
  const float ux = tf::uniform(__ldg(k + 6), __ldg(k + 7), static_cast<uint32_t>(r));
  const float uy = tf::uniform(__ldg(k + 8), __ldg(k + 9), static_cast<uint32_t>(r));
  V3 o, d;
  camera_ray(cam, a, r, ux, uy, o, d);
  store3(pos, a.R, r, o);
  store3(dir, a.R, r, d);
  store3(tput, a.R, r, make(1.0f, 1.0f, 1.0f));
  store3(res, a.R, r, make(0.0f, 0.0f, 0.0f));
}

// TraceConfig.lane_flags of a lane at path depth `depth`.
__device__ __forceinline__ Flags depth_flags(int depth, const RegenArgs& a) {
  if (a.opt.mode_rr)
    return {false, depth >= a.rr_depth && depth < 3 * a.rr_depth, depth >= 3 * a.rr_depth};
  return {depth == a.max_depth, false, false};
}

// One live lane's step after its selection: its draws, the segment's
// epilogue, then the bookkeeping of the loop body.
__device__ __forceinline__ void lane_step(const float* __restrict__ rows,
                                          const float* __restrict__ cam, const RegenArgs& a,
                                          const uint32_t* __restrict__ k, int r, const Ray& ray,
                                          Lane& lane, float* __restrict__ pos,
                                          float* __restrict__ dir, float* __restrict__ tput,
                                          float* __restrict__ res, float* __restrict__ accum) {
  const int R = a.R;
  const uint32_t ctr = static_cast<uint32_t>(r);
  const float v1 = tf::uniform(__ldg(k), __ldg(k + 1), ctr);
  const float v2 = tf::uniform(__ldg(k + 2), __ldg(k + 3), ctr);
  const float vrr = a.opt.mode_rr ? tf::uniform(__ldg(k + 4), __ldg(k + 5), ctr) : 0.0f;
  const SegState out = segment_after_select(rows, ray, load3(tput, R, r), load3(res, R, r), v1,
                                            v2, vrr, depth_flags(lane.depth, a), a.opt);
  if (out.still) {  // res is unchanged on a path that goes on
    store3(pos, R, r, out.pos);
    store3(dir, R, r, out.dir);
    store3(tput, R, r, out.tput);
    lane.depth += 1;
    return;
  }
  const V3 s = load3(accum, R, r);
  store3(accum, R, r,
         make(__fadd_rn(s.x, out.res.x), __fadd_rn(s.y, out.res.y), __fadd_rn(s.z, out.res.z)));
  lane.done += 1;
  if (lane.done < a.spp) {
    start_path(cam, a, k, r, pos, dir, tput, res);
    lane.depth = 0;
  } else {
    lane.live = false;
  }
}

template <bool kCull>
__global__ void __launch_bounds__(kSelThreads)
regen_pass_kernel(const float* __restrict__ rows, const float* __restrict__ clo,
                  const float* __restrict__ chi, const float* __restrict__ cslack,
                  const float4* __restrict__ rec, const uint32_t* __restrict__ keys,
                  const float* __restrict__ cam, const RegenArgs a, float* __restrict__ pos,
                  float* __restrict__ dir, float* __restrict__ tput, float* __restrict__ res,
                  float* __restrict__ accum, int* __restrict__ steps_out) {
  int ra_i, rb_i;
  ray_slots<kCull>(ra_i, rb_i);
  Lane la = {ra_i < a.R, 0, 0}, lb = {rb_i < a.R, 0, 0};
  const V3 zero = make(0.0f, 0.0f, 0.0f);
  if (la.live) {
    start_path(cam, a, keys, ra_i, pos, dir, tput, res);
    store3(accum, a.R, ra_i, zero);
  }
  if (lb.live) {
    start_path(cam, a, keys, rb_i, pos, dir, tput, res);
    store3(accum, a.R, rb_i, zero);
  }
  const V3 d0 = make(0.0f, 0.0f, 1.0f);
  int ran = 0;
  // Every thread reaches every barrier: the loop's exit is block-uniform.
  for (int step = 1;; ++step) {
    if (!__syncthreads_or(la.live || lb.live)) break;
    if (step >= a.max_steps) {  // the backstop, with a lane still live
      ran = a.max_steps;
      break;
    }
    Ray ra = make_ray(la.live ? load3(pos, a.R, ra_i) : zero, la.live ? load3(dir, a.R, ra_i) : d0);
    Ray rb = make_ray(lb.live ? load3(pos, a.R, rb_i) : zero, lb.live ? load3(dir, a.R, rb_i) : d0);
    if constexpr (kCull) {
      int tested;
      select_culled<false>(rec, a.T, ra, la.live, rb, lb.live, clo, chi, cslack, tested);
    } else {
      int tested_a, tested_b;
      select_two<false>(rows, a.T, ra, la.live, rb, lb.live, tested_a, tested_b);
    }
    const uint32_t* k = keys + static_cast<size_t>(step) * kKeyWords;
    if (la.live) lane_step(rows, cam, a, k, ra_i, ra, la, pos, dir, tput, res, accum);
    if (lb.live) lane_step(rows, cam, a, k, rb_i, rb, lb, pos, dir, tput, res, accum);
    ran = step;
  }
  if (threadIdx.x == 0) steps_out[blockIdx.x] = ran;
}

}  // namespace

// Blocks of one launch for R lanes: 256 lanes a block, 128 with `cull`.
extern "C" int regen_pass_blocks(int R, int cull) {
  const int lanes = cull ? 2 * seg::kCullThreads : seg::kSelRays;
  return (R + lanes - 1) / lanes;
}

// Runs one regen pass on `stream` (the culled instance when `cull` is
// set, over the records `rec` of nearest_shade.cu's
// `cull_records_launch`); `state` is scratch f32[4, 3, R] (pos, dir,
// tput, res). Returns cudaGetLastError() so the caller can raise on a
// refused launch.
extern "C" int regen_pass_launch(const float* rows, const float* clo, const float* chi,
                                 const float* cslack, const float* rec, int cull,
                                 const uint32_t* keys, const float* cam, const RegenArgs* args,
                                 float* state, float* accum, int* steps, void* stream) {
  const RegenArgs a = *args;
  if (a.R > 0) {
    const size_t n = 3 * static_cast<size_t>(a.R);
    auto kernel = cull ? regen_pass_kernel<true> : regen_pass_kernel<false>;
    const int bytes = cull ? seg::cull_smem_bytes(a.T) : seg::select_smem_bytes(a.T);
    const int threads = cull ? seg::kCullThreads : seg::kSelThreads;
    kernel<<<regen_pass_blocks(a.R, cull), threads, bytes, static_cast<cudaStream_t>(stream)>>>(
        rows, clo, chi, cslack, reinterpret_cast<const float4*>(rec), keys, cam, a, state,
        state + n, state + 2 * n, state + 3 * n, accum, steps);
  }
  return static_cast<int>(cudaGetLastError());
}

// A whole pass of the regenerating wavefront (B1r): every step of every
// lane, with its draws, flags, segment, bookkeeping and regenerated camera
// rays, inside one launch.
//
// Replaces the JAX package's device program for a regen pass,
// `render_regen_planar` (montecarlopathtracer_tpu/render/regen.py): a
// `lax.while_loop` under `jit` whose body runs the per-lane-flag segment
// kernel `_mega_segment_kernel` (ops/segment_fused.py, B1l) and lets XLA
// fuse the bookkeeping around it. The plain PyTorch version of the same
// function is `regen_pass_ref` in ops/regen_pass.py: the host loop over
// one B1l segment per step; `regen_pass_scheduled` there runs this
// kernel's schedule in plain torch.
//
// The loop's lanes are independent: lane i is pinned to pixel i of the
// band, and its step s (1, 2, ... from its first) is the global step s of
// JAX's loop, since a lane is live at every step until it is done. So a
// lane's step depends on nothing but its own state and step:
// - the draws u1, u2 and (RR only) urr of step s are element i of the
//   streams (s-1)*4 + {0, 1, 3}, the camera jitter of step 0 of
//   (1<<30) and (1<<30)+1 and that of step s of (1<<30)+2s and
//   (1<<30)+2s+1, under keys folded on the host (`keys` u32[steps, 5, 2],
//   ops/regen_pass.py::pass_keys);
// - the per-lane flags come from the lane's path depth as
//   TraceConfig.lane_flags makes them: fixed [depth == max_depth, 0, 0],
//   RR [0, rr <= depth < 3 rr, depth >= 3 rr];
// - the segment is B1l's: sphere_select.cuh's whole-table selection
//   (`select_staged`, `select_two` above kWholeMax rows) or
//   `select_culled`, then `segment_after_select` (the winner's shading row
//   and segment_common.cuh's `segment_epilogue`), the functions of
//   segment_fused.cu, so the winners and outputs are B1l's;
// - the bookkeeping: a path that ended adds its radiance to the lane's
//   sum (`accum`, an IEEE add as torch's), and the lane restarts with a
//   fresh camera ray, tput 1 and res 0 until it has done `spp` samples;
// - the camera ray is Camera.generate_rays_soa (scene/camera.py) in
//   torch's operation order on the card, each operation rounded as
//   written (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, so nvcc
//   contracts none into an FMA). torch on the card divides by a Python
//   number as a multiply by its f32 reciprocal, so x / W is x * (1 / W)
//   here (`inv_w`, `inv_h`, computed on the host).
// A lane's result therefore does not depend on which slot or block runs
// it, nor when. Outputs: accum f32[3, R], the sum over the lane's spp
// samples (the caller divides), and lane_steps i32[R], the step at which
// the lane's last path ended (max_steps if the backstop
// retired it with a path live: every path ends within num_segments
// segments, so that never happens).
//
// What bounds it on an H100: the selection's f32 arithmetic, as B1l's:
// every step tests each live lane against every triangle's sphere (17
// operations a pair) and runs the exact test (~40 more) on the pairs
// inside; summed over a pass, the live lane-steps x T x 17 plus the exact
// pairs. Its bytes (the table, the outputs) are small beside that.
//
// What held the first design back (one launch, lane i pinned to slot i of
// block i / 256 until the block's last lane was done): a finished lane kept
// its slot, and its warp ran the whole triangle loop for it anyway. In
// the Cornell box at RR 32 spp the blocks ran 145 to 326 steps, and only
// 0.724 of the slot-steps were live lanes'; the wave tail and the idle
// slots are one loss. Each step also restaged the table and rebuilt its
// spheres (three barriers), since the spheres' slack followed the block's
// largest |o|.
//
// What this design does about it:
// - a persistent grid (the blocks that fit on the card at once), whose
//   slots pull lanes from a device-side work list behind one counter:
//   each warp's free slots take the list's next entries with one
//   atomicAdd a step. A lane's whole state is in the slot's registers
//   while it holds it, from its first step to its last;
// - the list's order: entry i is lane order[i] (i32[R], a permutation),
//   or lane i without one. Since a lane's result does not depend on when
//   it runs, the order changes only the schedule. The Renderer hands
//   B1r's lanes out longest first, by the previous pass's lane_steps
//   (ops/regen_pass.py::longest_first; B1rc, measured slower so, keeps
//   row order): in row order the last lanes fetched were the frame's
//   bottom rows, often its longest, and the pass's end waited on them
//   while the other slots emptied; longest first, the lanes still
//   running when the list runs dry are short ones;
// - the block decides, with one vote a step: each warp's live count and
//   whether it saw the list spent, written to a double buffer in shared
//   memory behind one barrier;
// - the tail: a block whose list is spent and whose live lanes are at
//   most kWideMax packs them through shared memory and traces each with
//   g = 128 / live threads (a power of two, 1 to 32), each a strided
//   share of the table, the group's least (t, index) the winner (the
//   serial loop's, bit for bit). Its last lanes, which set the pass's
//   end, then step up to 32 times faster;
// - the whole table (T <= kWholeMax) staged once a launch, with spheres
//   widened for a pass-wide bound on |o| (computed on the card by the
//   wrapper from the eye and the vertices, `origin_bound`), then a
//   barrier-free step of select_two's whole branch (`select_staged`). A
//   live ray beyond the bound tests every triangle exactly and is counted
//   (`overflow`, expected 0). Larger tables keep select_two's ring; the
//   culled instance keeps `select_culled` over its records, which stages
//   nothing per step, and no tail mode.
// Resumable lanes handed on between queued launches (rounds) were
// measured too and cost more than they saved (PERF.md §6), so a pass is
// one launch.
// Counters in device memory (ops/regen_pass.py's STATS): block-steps,
// slot-steps, live lane-steps, overflow lane-steps, the culled vote's
// chunks x live lanes, the blocks that ran a step, the culled instance's
// leaves tested by a warp and those of them that took the pair path, and
// the card's clock at the first block start, the first spent list and the
// last block end.
//
// The culled instance's leaves: a warp's rays reach few of the leaves
// that its vote takes after the first bounce (in smallpt's closed box 5.0
// of its 64 rays a voted leaf, one or two for 79 % of them), so a leaf
// that fewer than kPairFrom of them reach is tested by `test_pairs`
// (sphere_select.cuh): each reaching ray against the leaf's 16 records
// across a half-warp, in place of every lane testing all 16 records for
// both its rays; the winners stay B1l's.

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
constexpr int kWideMax = kSelThreads;  // lanes traced wide at most: a thread a lane or more
constexpr int kStats = 11;     // counters (ops/regen_pass.py STATS)
enum Stat { kBlockSteps, kSlotSteps, kLiveSteps, kOverflow, kVoteChunks, kBlocks, kLeafVisits,
            kPairLeaves, kStart, kSpent, kEnd };

// The card's clock (ns); the first start and first spent list are kept
// as the largest ~t, the last end as the largest t.
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A slot's lane, in registers: its band lane (-1: the slot is empty), its
// path depth, samples completed and own step, and its ray's state.
struct Slot {
  int id, depth, done, step;
  V3 pos, dir, tput, res;
};

// A lane traced wide: its ray, and whether its |o| exceeds the staged
// spheres' bound (then it tests every triangle exactly).
struct WideRay {
  V3 o, d;
  bool force;
};

// What a pass keeps in global memory.
struct Scratch {
  float* accum;                   // f32[3, R]
  int* lane_steps;                // i32[R]
  int* head;                      // the work list's fetch counter
  const int* order;               // i32[R]: the list's lanes in order (null: 0 .. R-1)
  unsigned long long* stats;      // u64[kStats]
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

// A fresh path for the slot's lane: the camera ray of the jitter keys
// k[6..9], tput 1, res 0.
__device__ __forceinline__ void start_path(const float* __restrict__ cam, const RegenArgs& a,
                                           const uint32_t* __restrict__ k, Slot& s) {
  const uint32_t ctr = static_cast<uint32_t>(s.id);
  const float ux = tf::uniform(__ldg(k + 6), __ldg(k + 7), ctr);
  const float uy = tf::uniform(__ldg(k + 8), __ldg(k + 9), ctr);
  camera_ray(cam, a, s.id, ux, uy, s.pos, s.dir);
  s.tput = make(1.0f, 1.0f, 1.0f);
  s.res = make(0.0f, 0.0f, 0.0f);
}

// TraceConfig.lane_flags of a lane at path depth `depth`.
__device__ __forceinline__ Flags depth_flags(int depth, const RegenArgs& a) {
  if (a.opt.mode_rr)
    return {false, depth >= a.rr_depth && depth < 3 * a.rr_depth, depth >= 3 * a.rr_depth};
  return {depth == a.max_depth, false, false};
}

// Puts lane `id` into an empty slot at its step 0, with accum zeroed.
__device__ __forceinline__ void take(Slot& s, int id, const float* __restrict__ cam,
                                     const RegenArgs& a, const uint32_t* __restrict__ keys,
                                     const Scratch& sc) {
  s.id = id;
  s.depth = s.done = s.step = 0;
  start_path(cam, a, keys, s);
  store3(sc.accum, a.R, id, make(0.0f, 0.0f, 0.0f));
}

// The warp's empty slots (while its block has not seen the list spent)
// take the next entries of the work list, each lane order[i] (lane i
// without an order), with one atomicAdd; `spent` is set when the list
// ran short. Every lane of the warp calls it.
__device__ __forceinline__ void fetch(Slot& sa, Slot& sb, bool& spent,
                                      const float* __restrict__ cam, const RegenArgs& a,
                                      const uint32_t* __restrict__ keys, const Scratch& sc) {
  const int lane = threadIdx.x % 32;
  const bool na = sa.id < 0 && !spent, nb = sb.id < 0 && !spent;
  const unsigned ba = __ballot_sync(kAll, na), bb = __ballot_sync(kAll, nb);
  const int n = __popc(ba) + __popc(bb);
  if (n == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(sc.head, n);
  base = __shfl_sync(kAll, base, 0);
  const unsigned below = (1u << lane) - 1u;
  if (na) {
    const int i = base + __popc(ba & below);
    if (i < a.R) take(sa, sc.order ? __ldg(sc.order + i) : i, cam, a, keys, sc);
  }
  if (nb) {
    const int i = base + __popc(ba) + __popc(bb & below);
    if (i < a.R) take(sb, sc.order ? __ldg(sc.order + i) : i, cam, a, keys, sc);
  }
  if (base + n > a.R) spent = true;
}

// One live lane's step after its selection: its draws (keys of its own
// next step), the segment's epilogue, then the bookkeeping of the loop
// body; a lane that has done its samples leaves the slot.
__device__ __forceinline__ void lane_step(const float* __restrict__ rows,
                                          const float* __restrict__ cam, const RegenArgs& a,
                                          const uint32_t* __restrict__ keys, const Ray& ray,
                                          Slot& s, const Scratch& sc) {
  const int R = a.R;
  s.step += 1;
  const uint32_t* k = keys + static_cast<size_t>(s.step) * kKeyWords;
  const uint32_t ctr = static_cast<uint32_t>(s.id);
  const float v1 = tf::uniform(__ldg(k), __ldg(k + 1), ctr);
  const float v2 = tf::uniform(__ldg(k + 2), __ldg(k + 3), ctr);
  const float vrr = a.opt.mode_rr ? tf::uniform(__ldg(k + 4), __ldg(k + 5), ctr) : 0.0f;
  const SegState out = segment_after_select(rows, ray, s.tput, s.res, v1, v2, vrr,
                                            depth_flags(s.depth, a), a.opt);
  if (out.still) {  // res is unchanged on a path that goes on
    s.pos = out.pos;
    s.dir = out.dir;
    s.tput = out.tput;
    s.depth += 1;
  } else {
    const V3 acc = load3(sc.accum, R, s.id);
    store3(sc.accum, R, s.id,
           make(__fadd_rn(acc.x, out.res.x), __fadd_rn(acc.y, out.res.y),
                __fadd_rn(acc.z, out.res.z)));
    s.done += 1;
    if (s.done >= a.spp) {
      sc.lane_steps[s.id] = s.step;
      s.id = -1;
      return;
    }
    start_path(cam, a, k, s);
    s.depth = 0;
  }
  if (s.step + 1 >= a.max_steps) {  // the backstop, with a path live
    sc.lane_steps[s.id] = a.max_steps;
    s.id = -1;
  }
}

template <bool kCull>
__global__ void __launch_bounds__(kCull ? kCullThreads : kSelThreads)
regen_pass_kernel(const float* __restrict__ rows, const float* __restrict__ clo,
                   const float* __restrict__ chi, const float* __restrict__ cslack,
                   const float4* __restrict__ rec, const uint32_t* __restrict__ keys,
                   const float* __restrict__ cam, const float* __restrict__ omax_p,
                   const RegenArgs a, const Scratch sc) {
  constexpr int kThreads = kCull ? kCullThreads : kSelThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int kSlots = 2 * kThreads;
  __shared__ int votes[2][kWarps];  // a step's vote, double-buffered
  __shared__ WideRay wide_ray[kCull ? 1 : kWideMax];  // the tail's lanes
  __shared__ Hit wide_hit[kCull ? 1 : kWideMax];
  unsigned long long* stats = sc.stats;
  if (threadIdx.x == 0) atomicMax(stats + kStart, ~clock_ns());
  const bool whole = !kCull && a.T <= kWholeMax;
  const float omax = whole ? __ldg(omax_p) : 0.0f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const V3 zero = make(0.0f, 0.0f, 0.0f), d0 = make(0.0f, 0.0f, 1.0f);
  Slot sa, sb;
  sa.id = sb.id = -1;
  bool spent = false, seen_spent = false, staged = false;
  long long steps = 0, live_steps = 0, vote_chunks = 0;
  LeafCounts leaves = {0, 0};  // the culled instance's, per warp
  // Every thread reaches every barrier: the loop's exit is block-uniform.
  for (int par = 0;; par ^= 1) {
    fetch(sa, sb, spent, cam, a, keys, sc);
    const unsigned la = __ballot_sync(kAll, sa.id >= 0), lb = __ballot_sync(kAll, sb.id >= 0);
    const bool warp_spent = __any_sync(kAll, spent);
    if (lane == 0) votes[par][warp] = __popc(la) + __popc(lb) + (warp_spent ? 1 << 16 : 0);
    __syncthreads();
    int live = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = votes[par][w];
      live += v & 0xffff;
      spent = spent || v >> 16;
    }
    if (live == 0) break;  // the list is spent and the slots are empty
    if (spent && !seen_spent && threadIdx.x == 0) atomicMax(stats + kSpent, ~clock_ns());
    seen_spent = spent;
    if (whole && !staged) {
      stage_whole(rows, a.T, omax);
      staged = true;
    }
    const bool act_a = sa.id >= 0, act_b = sb.id >= 0;
    Ray ra = make_ray(act_a ? sa.pos : zero, act_a ? sa.dir : d0);
    Ray rb = make_ray(act_b ? sb.pos : zero, act_b ? sb.dir : d0);
    if constexpr (kCull) {
      int tested;
      select_culled<false, true>(rec, a.T, ra, act_a, rb, act_b, clo, chi, cslack, tested,
                                 &leaves);
      vote_chunks += static_cast<long long>(tested) * live;
    } else if (whole && spent && live <= kWideMax) {
      // The tail: the live lanes packed, g = kSelThreads / live threads (a
      // power of two, 1 to 32) a lane, each thread a strided share of the
      // table, and the group's least (t, index) the lane's winner. The
      // lanes' rays go through shared memory in the order of their slots.
      int below_warps = 0;
      for (int w = 0; w < warp; ++w) below_warps += votes[par][w] & 0xffff;
      const unsigned below = (1u << lane) - 1u;
      const int rank_a = below_warps + __popc(la & below);
      const int rank_b = below_warps + __popc(la) + __popc(lb & below);
      const bool fa = act_a && beyond_bound(ra.o, omax), fb = act_b && beyond_bound(rb.o, omax);
      if (fa || fb) atomicAdd(stats + kOverflow, static_cast<unsigned long long>(fa + fb));
      if (act_a) wide_ray[rank_a] = {ra.o, ra.d, fa};
      if (act_b) wide_ray[rank_b] = {rb.o, rb.d, fb};
      __syncthreads();
      int g = 32;
      while (g * live > kSelThreads) g >>= 1;
      const int j = threadIdx.x / g;
      Ray r = make_ray(zero, d0);
      if (j < live) {
        const WideRay w = wide_ray[j];
        r = make_ray(w.o, w.d);
        test_strided<false>(a.T, threadIdx.x % g, g, r, w.force);
      }
      wide_min(r.h, g);
      if (j < live && threadIdx.x % g == 0) wide_hit[j] = r.h;
      __syncthreads();
      if (act_a) ra.h = wide_hit[rank_a];
      if (act_b) rb.h = wide_hit[rank_b];
    } else if (whole) {
      const int over = select_staged<false>(a.T, omax, ra, act_a, rb, act_b);
      if (over) atomicAdd(stats + kOverflow, static_cast<unsigned long long>(over));
    } else {
      int tested_a, tested_b;
      select_two<false>(rows, a.T, ra, act_a, rb, act_b, tested_a, tested_b);
    }
    if (act_a) lane_step(rows, cam, a, keys, ra, sa, sc);
    if (act_b) lane_step(rows, cam, a, keys, rb, sb, sc);
    steps += 1;
    live_steps += live;
  }
  if (threadIdx.x == 0) atomicMax(stats + kEnd, clock_ns());
  if (threadIdx.x == 0 && steps > 0) {
    atomicAdd(stats + kBlockSteps, static_cast<unsigned long long>(steps));
    atomicAdd(stats + kSlotSteps, static_cast<unsigned long long>(steps) * kSlots);
    atomicAdd(stats + kLiveSteps, static_cast<unsigned long long>(live_steps));
    atomicAdd(stats + kVoteChunks, static_cast<unsigned long long>(vote_chunks));
    atomicAdd(stats + kBlocks, 1ull);
  }
  if (kCull && lane == 0 && leaves.visits > 0) {
    atomicAdd(stats + kLeafVisits, static_cast<unsigned long long>(leaves.visits));
    atomicAdd(stats + kPairLeaves, static_cast<unsigned long long>(leaves.pair));
  }
}

}  // namespace

// Blocks of the kernel that fit on the current card at once over a T-row
// table: the occupancy calculator's blocks per SM x the SMs; 0 on an
// error. A launch takes at most one block per 2 x threads lanes.
extern "C" long regen_pass_resident(int T, int cull) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err =
      cull ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, regen_pass_kernel<true>,
                                                           kCullThreads, cull_smem_bytes(T))
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, regen_pass_kernel<false>,
                                                           kSelThreads, select_smem_bytes(T));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return 0;
  return static_cast<long>(per_sm) * sms;
}

// Runs one regen pass on `stream` in `grid` blocks (the culled instance
// when `cull` is set, over the records `rec` of nearest_shade.cu's
// `cull_records_launch`): zeroes the counters `work` (u64[11] stats, then
// the list's i32 counter), then launches the kernel once. `omax` f32[1]
// is the bound on |o| the staged spheres cover; `order` i32[R], a
// permutation of the lanes, the order the work list hands them out in
// (null: 0 .. R-1). Returns the first CUDA
// error (cudaGetLastError() after the launch) so the caller can raise on
// a refused launch.
extern "C" int regen_pass_launch(const float* rows, const float* clo, const float* chi,
                                 const float* cslack, const float* rec, int cull,
                                 const uint32_t* keys, const float* cam, const float* omax,
                                 const RegenArgs* args, float* accum, int* lane_steps,
                                 const int* order, void* work, long grid, void* stream) {
  const RegenArgs a = *args;
  if (a.R <= 0) return static_cast<int>(cudaGetLastError());
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Scratch sc;
  sc.accum = accum;
  sc.lane_steps = lane_steps;
  sc.order = order;
  sc.stats = static_cast<unsigned long long*>(work);
  sc.head = reinterpret_cast<int*>(sc.stats + kStats);
  cudaError_t err = cudaMemsetAsync(work, 0, kStats * sizeof(unsigned long long) + sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = cull ? cull_smem_bytes(a.T) : select_smem_bytes(a.T);
  const auto* fn = reinterpret_cast<const float4*>(rec);
  if (cull)
    regen_pass_kernel<true><<<grid, kCullThreads, bytes, s>>>(rows, clo, chi, cslack, fn, keys,
                                                               cam, omax, a, sc);
  else
    regen_pass_kernel<false><<<grid, kSelThreads, bytes, s>>>(rows, clo, chi, cslack, fn, keys,
                                                               cam, omax, a, sc);
  return static_cast<int>(cudaGetLastError());
}

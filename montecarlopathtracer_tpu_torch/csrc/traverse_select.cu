// Nearest-hit selection for large scenes by a per-ray walk of a binary
// tree over runs of Morton-ordered triangles.
//
// Replaces the TPU kernel `_traverse_kernel`
// (montecarlopathtracer_tpu/ops/traverse_pallas.py, entry
// `traverse_select`), B5, whose tiles of rays walked per-tile lists of
// chunks (`tile_chunk_order`). The plain PyTorch version is
// `traverse_select_ref` in ops/traverse_walk.py: brute f32 selection over
// the same Morton-permuted table.
//
// The triangle axis is in Morton order, so leaf j (triangles leaf j ..
// leaf j + leaf - 1; 32 on the render path, the 128-triangle chunks when
// the wrapper builds the tables itself) is spatially tight and has a box
// [lo[j], hi[j]] (ops/traverse_walk.py's `walk_boxes` leaves the large
// triangles out of it and lists them apart). `traverse_tables_launch`
// (B5t) builds, once per table:
// - each triangle's 64-byte record: its widened bounding sphere
//   (sphere_select.cuh's `triangle_sphere_split`: center and radius K0 at
//   |o| = 0), then its three geometry rows;
// - an implicit binary tree over the leaf boxes: node 1 is the root, node
//   n has children 2n and 2n + 1, leaf j is node P + j (P the least power
//   of two >= the leaf count), so node n covers a contiguous run of
//   triangles. A leaf holds its box, `ext` = the largest slack K0 - rho of
//   its triangles' spheres (how far beyond a triangle the exact test can
//   accept a hit, for |o| = 0) and `grow` = the largest growth of their
//   radii per unit of |o|; a node holds the min/max box and the largest
//   ext and grow of its children. Padding nodes and node 0 are empty
//   (lo > hi, ext = grow = 0).
// It takes the place of the TPU walk's per-tile chunk lists
// (traverse_pallas.py's `tile_chunk_order`); its plain version is
// `walk_tables_ref`.
//
// B5t is one launch of one warp per leaf, P warps over the whole grid
// (`tables_kernel`): the warp's lanes build the records of the leaf's
// triangles (leaf / 32 each), shuffles reduce their slack and growth into
// ext and grow, and lane 0 writes leaf node P + j, then climbs: after a
// fence it counts its arrival at the parent (one int per node, zeroed by
// the launcher); the first of the two children to arrive stops, the
// second reads its sibling from L2 (`__ldcg`: the sibling's lane wrote it
// from another SM, and L1 is not coherent), writes the parent and climbs
// on. So every level is built by whichever warps finish last, on all the
// SMs. `fminf`/`fmaxf` are exact and the children are combined left
// first, so the tree is the same bits whatever the order of arrival. What
// bounds it on an H100: the records' arithmetic (~120 f32 operations a
// triangle) and bytes (48 read, 64 written a triangle) are a few µs for
// the bunny; the launch and the climb's chain of dependent L2 round trips
// (log2 P levels) are what is left. The earlier build, a record kernel
// and a tree kernel of one block (`traverse_tables_split_launch`), is
// reached by no path and kept to time and check B5t against.
//
// `traverse_kernel` walks the tree per ray, one lane per ray at a time, in
// persistent blocks: a lane whose walk ends takes the next ray from a
// counter. A ray first tests the large triangles (their hits bound the
// walk from the start), then walks with a stack of 24 entries in shared
// memory: at an interior node it slab-tests both children's boxes, widened
// by nearest_common.cuh's `box_margin` and by ext + grow |o| (`slab_box`),
// against the segment [0, best t], goes to the nearer child (by entry
// distance) and pushes the other with its entry distance; a popped node
// whose entry distance exceeds the best t by then is dropped (tn <= best t
// reaches, so an equal-t tie still reaches its leaf). The widening is the
// sphere's own slack: the exact test accepts a pair only at a point within
// that slack of the triangle (see `triangle_sphere`), so neither the tree
// nor the sphere test drops a pair that it accepts, even for a sliver
// whose accepted hits lie outside its vertices' box, and the f32 rounding
// of tn, which grows with |o|, stays inside the growth term. At a leaf the
// ray tests the sphere of eight triangles at a time (radius K0 + grow |o|,
// 19 operations, no division), then nearest_common.cuh's exact
// `pair_test` on the pairs inside a sphere; leaves come out of index
// order, so a hit wins on a strict `<` in t or an equal t and a smaller
// index: the least (t, index) pair, brute selection's rule. So the winners
// are B4's (nearest_shade.cu, every triangle) bit for bit. The lanes of a
// warp step through interior nodes together, then test their leaves
// together (the while-while loop of Aila and Laine); there is no barrier
// and no vote. Records and nodes come from global memory through the
// read-only path (the bunny's 81,932 records, 5.2 MB, and its tree stay in
// the 50 MB L2); the rays are Morton-sorted on this path, so neighbouring
// lanes share leaves and L1 lines.
//
// What bounds it on an H100: the f32 arithmetic of the pairs that the
// rays' reach needs (the sphere test on every triangle of every leaf
// reached, the exact test on the pairs inside a sphere) is a small part
// of its time; the longest walks' chains of dependent loads (a few hundred
// nodes and a hundred leaves for the rays that graze the bunny) set it.
//
// Contract: tree f32[2P, 8] (node n: lo xyz, ext, hi xyz, grow); tri
// f32[T, 16]; big i32[nbig]; pos/dir f32[3, R]; live bool[R]; next_ray
// an int set to 0. Output idx i32[R]: the winner's index in the Morton
// order, -1 for a miss and for a lane that is not live. With `visits`
// non-null, visits[r] is the number of interior nodes ray r expanded and
// visits[R + r] the number of leaves it tested (0 for a lane that is not
// live).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "nearest_common.cuh"
#include "segment_common.cuh"
#include "sphere_select.cuh"

namespace {

using namespace seg;
namespace cg = cooperative_groups;

constexpr int kThreads = 128;  // lanes per block of the walk
constexpr int kTableWarps = 8;  // leaves per block of B5t
constexpr int kTableThreads = 256;  // triangle records per block (the earlier build)
constexpr int kTreeThreads = 1024;  // the earlier build's tree block
constexpr int kStack = 24;     // stack entries per lane: a tree of up to 2^24 leaves
constexpr int kLeafBatch = 8;  // leaf triangles whose spheres are tested at once

// Triangle i's record in `tri` (sphere center and K0, then its three
// geometry rows); its radius growth e and its slack into e, slack.
__device__ __forceinline__ void triangle_record_split(const float* __restrict__ rows, size_t i,
                                                      float4* __restrict__ tri4, float& e,
                                                      float& slack) {
  const float4* g = reinterpret_cast<const float4*>(rows + i * 48);
  const float4 g0 = g[0], g1 = g[1], g2 = g[2];
  float4 s;
  triangle_sphere_split(g0, g1, g2, s, e, slack);
  float4* rec = tri4 + 4 * i;
  rec[0] = s;
  rec[1] = g0;
  rec[2] = g1;
  rec[3] = g2;
}

__device__ __forceinline__ void store_node(float4* tree4, int n, float4 lo, float4 hi) {
  tree4[2 * n] = lo;
  tree4[2 * n + 1] = hi;
}

// Node n of children a = 2n (left) and b = 2n + 1, in the kernels' one
// order of operands.
__device__ __forceinline__ void join_nodes(float4 la, float4 ha, float4 lb, float4 hb,
                                           float4& lo, float4& hi) {
  lo = make_float4(fminf(la.x, lb.x), fminf(la.y, lb.y), fminf(la.z, lb.z), fmaxf(la.w, lb.w));
  hi = make_float4(fmaxf(ha.x, hb.x), fmaxf(ha.y, hb.y), fmaxf(ha.z, hb.z), fmaxf(ha.w, hb.w));
}

// B5t: one warp per leaf j < P, the records of its triangles and leaf
// node P + j, then lane 0 climbs while it is the second child to arrive.
__global__ void __launch_bounds__(kTableWarps * 32)
tables_kernel(const float* __restrict__ rows, int T, int leaf, const float* __restrict__ clo,
              const float* __restrict__ chi, int nc, int P, float4* __restrict__ tri4,
              float4* tree4, int* __restrict__ arrivals) {
  const int j = blockIdx.x * kTableWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (j >= P) return;
  float ext = 0.0f, grow = 0.0f;
  if (j < nc) {
    const size_t base = static_cast<size_t>(j) * leaf;
    const size_t end = min(static_cast<size_t>(T), base + leaf);
    for (size_t i = base + lane; i < end; i += 32) {
      float e, slack;
      triangle_record_split(rows, i, tri4, e, slack);
      ext = fmaxf(ext, slack);
      grow = fmaxf(grow, e);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, off));
    grow = fmaxf(grow, __shfl_xor_sync(0xffffffffu, grow, off));
  }
  if (lane != 0) return;
  float4 lo = make_float4(kBig, kBig, kBig, 0.0f), hi = make_float4(-kBig, -kBig, -kBig, 0.0f);
  if (j == 0) store_node(tree4, 0, lo, hi);  // node 0 is not used
  if (j < nc) {
    lo = make_float4(clo[3 * j], clo[3 * j + 1], clo[3 * j + 2], ext);
    hi = make_float4(chi[3 * j], chi[3 * j + 1], chi[3 * j + 2], grow);
  }
  int n = P + j;
  store_node(tree4, n, lo, hi);
  while (n > 1) {
    __threadfence();  // node n is written before its arrival counts
    if (atomicAdd(arrivals + n / 2, 1) == 0) return;  // the sibling builds the parent
    __threadfence();
    const int sib = n ^ 1;
    const float4 ls = __ldcg(tree4 + 2 * sib), hs = __ldcg(tree4 + 2 * sib + 1);
    if (n & 1) {
      join_nodes(ls, hs, lo, hi, lo, hi);
    } else {
      join_nodes(lo, hi, ls, hs, lo, hi);
    }
    n /= 2;
    store_node(tree4, n, lo, hi);
  }
}

// The earlier build, first launch: one triangle per thread.
__global__ void __launch_bounds__(kTableThreads)
triangle_records_kernel(const float* __restrict__ rows, int T, float4* __restrict__ tri4,
                        float* __restrict__ e_out, float* __restrict__ slack_out) {
  const int i = blockIdx.x * kTableThreads + threadIdx.x;
  if (i < T) triangle_record_split(rows, i, tri4, e_out[i], slack_out[i]);
}

// The earlier build, second launch, one block: the leaves (box j; ext =
// the largest slack and grow = the largest e of its triangles, a warp per
// leaf), then the levels, each node the min/max box and the largest ext
// and grow of its children.
__global__ void __launch_bounds__(kTreeThreads)
tree_kernel(const float* __restrict__ clo, const float* __restrict__ chi, int T, int leaf,
            int nc, int P, const float* __restrict__ e, const float* __restrict__ slack,
            float4* __restrict__ tree4) {
  const float4 elo = make_float4(kBig, kBig, kBig, 0.0f);
  const float4 ehi = make_float4(-kBig, -kBig, -kBig, 0.0f);
  if (threadIdx.x == 0) store_node(tree4, 0, elo, ehi);  // node 0 is not used
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < P; j += kTreeThreads / 32) {
    float ext = 0.0f, grow = 0.0f;
    for (int i = j * leaf + lane; i < min(T, (j + 1) * leaf); i += 32) {
      ext = fmaxf(ext, slack[i]);
      grow = fmaxf(grow, e[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, off));
      grow = fmaxf(grow, __shfl_xor_sync(0xffffffffu, grow, off));
    }
    if (lane == 0) {
      if (j < nc) {
        store_node(tree4, P + j, make_float4(clo[3 * j], clo[3 * j + 1], clo[3 * j + 2], ext),
                   make_float4(chi[3 * j], chi[3 * j + 1], chi[3 * j + 2], grow));
      } else {
        store_node(tree4, P + j, elo, ehi);
      }
    }
  }
  __syncthreads();
  for (int len = P / 2; len >= 1; len /= 2) {
    for (int k = threadIdx.x; k < len; k += kTreeThreads) {
      const int n = len + k;
      float4 lo, hi;
      join_nodes(tree4[4 * n], tree4[4 * n + 1], tree4[4 * n + 2], tree4[4 * n + 3], lo, hi);
      store_node(tree4, n, lo, hi);
    }
    __syncthreads();
  }
}

// Whether the ray's segment [0, tmax] reaches the box of node n widened
// for a ray with |o| = on, and its entry distance tn.
__device__ __forceinline__ bool node_reach(const float4* __restrict__ tree4, int n,
                                           const Slab& s, float on, float tmax, float& tn) {
  const float4 lo = __ldg(tree4 + 2 * n), hi = __ldg(tree4 + 2 * n + 1);
  if (lo.x > hi.x) return false;  // a padding node
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
  return slab_box(s, l, h, fmaf(hi.w, on, lo.w), tmax, tn);
}

// The sphere test of record i, with the radius K0 + grow |o| (grow >= the
// triangle's own e).
__device__ __forceinline__ bool record_sphere(const float4* __restrict__ tri4, int i,
                                              float grow, float on, const Ray& r) {
  const float4 s = __ldg(tri4 + 4 * static_cast<size_t>(i));
  const float K = fmaf(grow, on, s.w);
  return sphere_hit(s.x, s.y, s.z, K * K, r);
}

// The exact test of record i; the least (t, index) pair wins.
__device__ __forceinline__ void record_exact(const float4* __restrict__ tri4, int i, Ray& r) {
  const float4* g = tri4 + 4 * static_cast<size_t>(i) + 1;
  const Pair p = pair_test(__ldg(g), __ldg(g + 1), __ldg(g + 2), r.o, r.d);
  if (p.inside && (p.t < r.h.t || (p.t == r.h.t && i < r.h.i)))
    r.h = {p.t, p.beta, p.gamma, i};
}

// Test the ray against the n triangles base .. base + n - 1 of one leaf:
// the sphere tests of kLeafBatch triangles at once, then the exact tests
// of those inside their spheres.
__device__ __forceinline__ void test_leaf(const float4* __restrict__ tri4, int base, int n,
                                          float grow, float on, Ray& r) {
  for (int k = 0; k < n; k += kLeafBatch) {
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < kLeafBatch; ++j)
      if (k + j < n) m |= static_cast<unsigned>(record_sphere(tri4, base + k + j, grow, on, r)) << j;
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      record_exact(tri4, base + k + j, r);
    }
  }
}

// One lane's walk: its ray, and where the walk stands.
struct Walk {
  Ray ray;
  Slab slab;
  float on;     // |o|, for the spheres and the boxes' growth
  int node;     // the node to visit next
  int sp;       // entries on the lane's stack
  bool go;      // the walk has a node to visit
  int nodes, leaves;
};

// The next node on the lane's stack that the best t does not prune; the
// walk ends when there is none.
__device__ __forceinline__ void pop(Walk& w, int (*stack_n)[kThreads],
                                    float (*stack_t)[kThreads], int me) {
  w.go = false;
  while (w.sp > 0) {
    --w.sp;
    if (stack_t[w.sp][me] <= w.ray.h.t) {
      w.node = stack_n[w.sp][me];
      w.go = true;
      return;
    }
  }
}

// Persistent blocks: each lane takes the next ray from `next_ray` when its
// walk ends, so a long walk holds up no other lane and no block. Between
// fetches the lanes of a warp step through interior nodes together until
// each has a leaf to test (or its walk has ended), then test their leaves
// together (the while-while loop of Aila and Laine).
__global__ void __launch_bounds__(kThreads)
traverse_kernel(int T, int leaf, const float4* __restrict__ tree4, int P,
                const int* __restrict__ big, int nbig, const float4* __restrict__ tri4,
                const float* __restrict__ pos, const float* __restrict__ dir,
                const bool* __restrict__ live, int R, int* __restrict__ next_ray,
                int* __restrict__ idx_out, int* __restrict__ visits) {
  // The stacks, entry-major so that the lanes of a warp hit distinct banks.
  __shared__ int stack_n[kStack][kThreads];
  __shared__ float stack_t[kStack][kThreads];
  const int me = threadIdx.x;
  const float grow_all = __ldg(tree4 + 3).w;  // the root's: the largest e of all triangles
  int r = -1;
  Walk w;
  w.go = false;
  while (true) {
    if (!w.go) {
      if (r >= 0) {  // the lane's walk has ended
        idx_out[r] = w.ray.h.t < kBig ? w.ray.h.i : -1;
        if (visits != nullptr) {
          visits[r] = w.nodes;
          visits[R + r] = w.leaves;
        }
      }
      cg::coalesced_group g = cg::coalesced_threads();
      int base = 0;
      if (g.thread_rank() == 0) base = atomicAdd(next_ray, static_cast<int>(g.size()));
      r = g.shfl(base, 0) + static_cast<int>(g.thread_rank());
      if (r >= R) break;
      w.ray = make_ray(load3(pos, R, r), load3(dir, R, r));
      w.nodes = w.leaves = 0;
      if (!live[r]) continue;
      w.slab = make_slab(w.ray.o, w.ray.d);
      // |o| for the spheres; a NaN or overflowing |o| widens them to the
      // largest finite radius or more (the exact test decides).
      w.on = fminf(sqrtf(dot(w.ray.o, w.ray.o)), kBig);
      // The large triangles, which the tree's boxes leave out, first: their
      // hits bound the walk from the start.
      for (int k = 0; k < nbig; ++k) {
        const int i = __ldg(big + k);
        if (record_sphere(tri4, i, grow_all, w.on, w.ray)) record_exact(tri4, i, w.ray);
      }
      float tn;
      w.node = 1;
      w.sp = 0;
      w.go = node_reach(tree4, 1, w.slab, w.on, kBig, tn);
      continue;
    }
    while (w.go && w.node < P) {  // interior nodes: their children's boxes
      ++w.nodes;
      const int c = 2 * w.node;
      float t0, t1;
      const bool h0 = node_reach(tree4, c, w.slab, w.on, w.ray.h.t, t0);
      const bool h1 = node_reach(tree4, c + 1, w.slab, w.on, w.ray.h.t, t1);
      if (h0 && h1) {  // the nearer child now, the other on the stack
        const bool first0 = t0 <= t1;
        stack_n[w.sp][me] = first0 ? c + 1 : c;
        stack_t[w.sp][me] = first0 ? t1 : t0;
        ++w.sp;
        w.node = first0 ? c : c + 1;
      } else if (h0 || h1) {
        w.node = h0 ? c : c + 1;
      } else {
        pop(w, stack_n, stack_t, me);
      }
    }
    if (w.go) {  // a leaf: its triangles
      ++w.leaves;
      const int base = (w.node - P) * leaf;
      test_leaf(tri4, base, min(leaf, T - base), __ldg(tree4 + 2 * w.node + 1).w, w.on, w.ray);
      pop(w, stack_n, stack_t, me);
    }
  }
}

}  // namespace

// B5t: builds the triangle records tri f32[T, 16] and the tree f32[2P, 8]
// of a table on `stream` in one launch (arrivals: i32[P] scratch, zeroed
// here by a memset on the stream); returns cudaGetLastError().
extern "C" int traverse_tables_launch(const float* rows, int T, int leaf, const float* clo,
                                      const float* chi, int nc, int P, float* tree, float* tri,
                                      int* arrivals, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(arrivals, 0, sizeof(int) * static_cast<size_t>(P), st);
  tables_kernel<<<(P + kTableWarps - 1) / kTableWarps, kTableWarps * 32, 0, st>>>(
      rows, T, leaf, clo, chi, nc, P, reinterpret_cast<float4*>(tri),
      reinterpret_cast<float4*>(tree), arrivals);
  return static_cast<int>(cudaGetLastError());
}

// The earlier build of the same tables, reached by no path: `parts` 1 runs
// the record kernel (its e and slack into scratch f32[2, T]), 2 the tree
// kernel of one block (from scratch), 3 both; returns cudaGetLastError().
extern "C" int traverse_tables_split_launch(const float* rows, int T, int leaf,
                                            const float* clo, const float* chi, int nc, int P,
                                            float* tree, float* tri, float* scratch, int parts,
                                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* e = scratch;
  float* slack = scratch + T;
  if (parts & 1)
    triangle_records_kernel<<<(T + kTableThreads - 1) / kTableThreads, kTableThreads, 0, st>>>(
        rows, T, reinterpret_cast<float4*>(tri), e, slack);
  if (parts & 2)
    tree_kernel<<<1, kTreeThreads, 0, st>>>(clo, chi, T, leaf, nc, P, e, slack,
                                             reinterpret_cast<float4*>(tree));
  return static_cast<int>(cudaGetLastError());
}

// Launches the walk on `stream` (next_ray: an int set to 0, the rays'
// counter); returns cudaGetLastError() so the caller can raise on a
// refused launch.
extern "C" int traverse_select_launch(int T, int leaf, const float* tree, int P, const int* big,
                                      int nbig, const float* tri, const float* pos,
                                      const float* dir, const bool* live, int R, int* next_ray,
                                      int* idx, int* visits, void* stream) {
  static int resident = 0;  // blocks that fit on the card at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, traverse_kernel, kThreads, 0);
    resident = max(1, sms * per_sm);
  }
  if (R > 0) {
    const int blocks = min(resident, (R + kThreads - 1) / kThreads);
    traverse_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        T, leaf, reinterpret_cast<const float4*>(tree), P, big, nbig,
        reinterpret_cast<const float4*>(tri), pos, dir, live, R, next_ray, idx, visits);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scatter-add of per-ray row cotangents into the triangle row table:
// out[idx[r], k] += dvals[k, r] for every ray r with idx[r] >= 0.
//
// Replaces the TPU kernel `_scatter_rows_kernel`
// (montecarlopathtracer_tpu/ops/intersect_pallas.py, entry
// `scatter_rows`), which built the sum as a one-hot matmul on the MXU
// from a bf16 term split of the cotangents, one ray tile per sequential
// grid step. Here the sum is plain f32 or f64 addition. The plain
// PyTorch version is `scatter_rows_ref` in ops/scatter_rows.py
// (index_add_).
//
// What bounds it on an H100: contention, not bytes. An 800x600 segment
// reads 480,000 x 48 floats (92 MB), but in a Cornell box tens of
// thousands of rays hit the same few wall triangles, so atomics on the
// same 48 addresses serialize.
//
// What the design does about it:
// - when the whole table fits in one block's shared memory (T * 192
//   bytes; the 652-triangle Cornell box takes 125 KB of Hopper's 227 KB)
//   each block accumulates a private f32 copy there with shared-memory
//   atomics over a grid-stride loop of rays, then adds its nonzero
//   entries to the output once with global atomics; larger tables (the
//   81,932-triangle bunny's is 15.7 MB) take f64 global atomics directly
//   into a table `wide` that a second kernel rounds to f32. A chain of
//   f32 atomics into a row that tens of thousands of rays hit (the
//   bunny's floor and walls) loses more than 16 x eps32 x sum |dvals|
//   (PERF.md); in f64 only the warps' f32 partial sums of 32 rays and
//   the final rounding lose anything;
// - a warp whose 32 rays all hit the same triangle (neighbouring pixels
//   on a wall, the common case) sums each column with shuffles first and
//   issues one atomic instead of 32;
// - a warp reads dvals[k, r .. r+31] for one column k at a time, which
//   coalesces, and each thread issues its ray's 48 loads before its
//   first add, so that a block of 16 warps keeps enough reads in flight.
// Atomics add in no fixed order: the sums differ from index_add_'s in
// the last bits, and from run to run.
//
// Contract (that of scatter_rows): idx i32[R] (-1 = adds nothing),
// dvals f32[48, R]; out f32[T, 48]. With `wide` null (the table fits in
// shared memory) out is zeroed by the caller; otherwise `wide` is an f64
// [T, 48] table zeroed by the caller, and out is written whole.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 48;
constexpr unsigned kFull = 0xffffffffu;

// Adds ray r's 48 cotangents into acc[row * 48 + k] (f32 in shared
// memory, or f64 in global memory). Every lane of the warp calls it
// together. All 48 loads are issued before the first add, so one ray's
// reads are in flight together.
template <typename Acc>
__device__ __forceinline__ void add_ray(Acc* acc, int row, const float* __restrict__ dvals,
                                        int r, size_t R) {
  const int lead = __shfl_sync(kFull, row, 0);
  const bool uniform = __all_sync(kFull, row == lead);
  if (row < 0) return;  // in a uniform warp, every lane returns here
  float v[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) v[k] = dvals[k * R + r];
  if (uniform) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      float s = v[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if ((threadIdx.x & 31) == 0) atomicAdd(acc + (size_t)row * kCols + k, Acc(s));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) atomicAdd(acc + (size_t)row * kCols + k, Acc(v[k]));
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_shared_kernel(const int* __restrict__ idx, const float* __restrict__ dvals, int R,
                           int T, float* __restrict__ out) {
  extern __shared__ float acc[];
  const int n = T * kCols;
  for (int i = threadIdx.x; i < n; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  // base is the same for every thread of the block, so whole warps
  // enter add_ray together.
  for (int base = blockIdx.x * kThreads; base < R; base += gridDim.x * kThreads) {
    const int r = base + threadIdx.x;
    add_ray(acc, r < R ? idx[r] : -1, dvals, r, R);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(out + i, v);
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_global_kernel(const int* __restrict__ idx, const float* __restrict__ dvals, int R,
                           double* __restrict__ wide) {
  const int base = blockIdx.x * kThreads;
  const int r = base + threadIdx.x;
  add_ray(wide, r < R ? idx[r] : -1, dvals, r, R);
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_round_kernel(const double* __restrict__ wide, size_t n, float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads)
    out[i] = static_cast<float>(wide[i]);
}

}  // namespace

// Launches the scatter on `stream` into `out`: through a private table in
// shared memory when `wide` is null, through the f64 table `wide`
// otherwise (see the contract above). Returns the first CUDA error, so
// the caller can raise on a refused launch or a table that does not fit.
extern "C" int scatter_rows_launch(const int* idx, const float* dvals, int R, int T, float* out,
                                   double* wide, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ray_blocks = (R + kThreads - 1) / kThreads;
  if (wide != nullptr) {
    if (R > 0) scatter_rows_global_kernel<<<ray_blocks, kThreads, 0, s>>>(idx, dvals, R, wide);
    const size_t n = (size_t)T * kCols, want = (n + kThreads - 1) / kThreads;
    scatter_rows_round_kernel<<<(int)(want < 4096 ? want : 4096), kThreads, 0, s>>>(wide, n, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A table larger than the block's shared memory fails here.
  const size_t bytes = (size_t)T * kCols * sizeof(float);
  err = cudaFuncSetAttribute(scatter_rows_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_rows_shared_kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One private table per resident block: enough blocks to fill the
  // card, no more, since each one flushes a whole table.
  const int blocks = ray_blocks < sms * per_sm ? ray_blocks : sms * (per_sm > 0 ? per_sm : 1);
  scatter_rows_shared_kernel<<<blocks, kThreads, bytes, s>>>(idx, dvals, R, T, out);
  return static_cast<int>(cudaGetLastError());
}

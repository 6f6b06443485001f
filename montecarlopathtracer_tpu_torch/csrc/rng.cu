// Uniform draws of counter-based random streams, bit-equal to JAX's
// threefry on the CPU.
//
// Not the counterpart of a TPU kernel: the JAX package draws with
// `jax.random.uniform(jax.random.fold_in(key, stream), shape)`
// (montecarlopathtracer_tpu/ops/rng.py::stream_uniform), threefry-2x32 on
// the CPU and the `rbg` generator on a TPU. The plain PyTorch version is
// ops/rng.py's `stream_uniforms_ref` (the threefry as element-wise torch
// ops on int64 masked to 32 bits, ~170 launches per stream), which gives
// the same bits.
//
// Per lane i < n and stream s < k (k <= 4): the threefry-2x32 (20 rounds,
// key injection every 4) of the counter (0, i) under stream s's folded key
// (k0_s, k1_s), the xor of its two output words, then the 23 high bits as
// the mantissa of a float in [1, 2), minus one: out[s n + i], a row per
// stream (threefry.cuh, shared with the regen pass regen_pass.cu). uint32_t
// arithmetic wraps mod 2^32 exactly where the plain version masks: the
// third key word k0 ^ k1 ^ 0x1BD11BDA and the injections ks + i + 1.
//
// The stream keys come one of two ways, both in `Draw`, passed by value,
// so a call copies nothing to the device. With `base` null they are folded
// on the host (one threefry block each) and arrive in k0/k1. Otherwise the
// key lives on the card: `base` u32[2] in device memory, folded there with
// `n_folds` host words, then with each stream's id (one threefry block a
// fold, in each thread before its lanes), so a CUDA graph that holds the
// launch draws under whatever key the buffer holds when it replays.
//
// What bounds it on an H100: its integer operations, ~76 per lane and
// stream (60 in the rounds, ~10 in the injections, ~6 for the output)
// against 4 bytes written; a grid-stride loop in which each thread draws
// every stream of its lane keeps the rotations on `__funnelshift_l` (one
// instruction each) and needs no load.

#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

constexpr int kMaxStreams = 4;
constexpr int kMaxFolds = 3;

// A call's keys, passed by value (outside the unnamed namespace: the
// launcher's C interface takes it): each stream's folded key when the
// base key is on the host, else the `n_folds` words folded into the base
// key on the card and each stream's id.
struct Draw {
  uint32_t k0[kMaxStreams];
  uint32_t k1[kMaxStreams];
  uint32_t fold[kMaxFolds];
  uint32_t stream[kMaxStreams];
  int n_folds;
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
uniform_kernel(const uint32_t* __restrict__ base, const Draw d, int k, uint32_t n,
               float* __restrict__ out) {
  uint32_t k0[kMaxStreams], k1[kMaxStreams];
  if (base == nullptr) {
#pragma unroll
    for (int s = 0; s < kMaxStreams; ++s) k0[s] = d.k0[s], k1[s] = d.k1[s];
  } else {
    uint32_t b0 = base[0], b1 = base[1];
    for (int f = 0; f < d.n_folds; ++f) {
      uint32_t x0, x1;
      tf::threefry_block(b0, b1, d.fold[f], x0, x1);
      b0 = x0, b1 = x1;
    }
#pragma unroll
    for (int s = 0; s < kMaxStreams; ++s) {
      if (s < k) tf::threefry_block(b0, b1, d.stream[s], k0[s], k1[s]);
    }
  }
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
#pragma unroll
    for (int s = 0; s < kMaxStreams; ++s) {
      if (s < k) {
        out[static_cast<size_t>(s) * n + i] = tf::uniform(k0[s], k1[s], static_cast<uint32_t>(i));
      }
    }
  }
}

// Blocks that fit on the card at once.
int resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, uniform_kernel, kThreads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

int grid(uint32_t n, int resident) {
  const size_t want = (static_cast<size_t>(n) + kThreads - 1) / kThreads;
  return static_cast<int>(want < static_cast<size_t>(resident) ? want : resident);
}

}  // namespace

// Draws k rows of n uniforms into out f32[k, n] on `stream`, under the
// keys of `d` (from `base` u32[2] on the card when it is not null, see
// the top of the file); returns cudaGetLastError() so the caller can
// raise on a refused launch.
extern "C" int uniform_launch(const uint32_t* base, Draw d, int k, uint32_t n, float* out,
                              void* stream) {
  static const int resident = resident_blocks();
  if (n > 0 && k > 0) {
    uniform_kernel<<<grid(n, resident), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        base, d, k, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

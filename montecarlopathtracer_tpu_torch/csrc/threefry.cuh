// Threefry-2x32 (20 rounds) of one counter under a folded stream key,
// and the uniform float it makes: the draws of rng.cu (one stream per
// launch row) and of the regenerating wavefront's pass regen_pass.cu
// (every stream of every step inside one launch). Bit-equal to JAX's
// threefry on the CPU, `jax.random.uniform(fold_in(key, stream), (n,))`
// element i: the counter (0, i) under the stream's folded key, the xor of
// the two output words, its 23 high bits as the mantissa of a float in
// [1, 2), minus one. uint32_t arithmetic wraps mod 2^32 exactly where
// ops/rng.py's plain version masks.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tf {

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

// Threefry-2x32's two output words (x0, x1) for the counter (0, ctr)
// under the key (k0, k1): also `fold_in((k0, k1), ctr)`, a folded key.
__device__ __forceinline__ void threefry_block(uint32_t k0, uint32_t k1, uint32_t ctr,
                                               uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 = ks[0];
  x1 = ctr + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    } else {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// The 32-bit xor of threefry-2x32's two output words for the counter
// (0, ctr) under the key (k0, k1).
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1, uint32_t ctr) {
  uint32_t x0, x1;
  threefry_block(k0, k1, ctr, x0, x1);
  return x0 ^ x1;
}

// Uniform [0, 1) from 32 random bits: 23 mantissa bits under exponent 0,
// minus one (exact).
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Element `ctr` of the stream whose folded key is (k0, k1).
__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1, uint32_t ctr) {
  return unit_float(threefry_xor(k0, k1, ctr));
}

}  // namespace tf

// Vector helpers and the BSDF samplers of one path segment, shared by
// the forward kernel (segment_fused.cu) and its vjp
// (segment_backward.cu). Op for op the plain-torch samplers of
// ops/sampling.py: every conditional selects a branch, every square
// root and division is guarded.
//
// Compile without --use_fast_math: Ns = 1000 lobes and grazing Fresnel
// need the precise powf/sinf/cosf.

#pragma once

#include <cuda_runtime.h>

namespace seg {

constexpr float kBig = 3.0e38f;
constexpr float kEps = 1.19209290e-7f;  // FLT_EPSILON
constexpr float kTwoPi = 6.28318530717958647692f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 make(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// max(x, lo) that keeps a NaN x, like torch.clamp_min and jnp.maximum.
__device__ __forceinline__ float max_nan(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = sqrtf(max_nan(dot(v, v), kEps * kEps));
  return {v.x / n, v.y / n, v.z / n};
}

__device__ __forceinline__ V3 reflect(V3 indir, V3 normal) {
  const float s = 2.0f * dot(indir, normal);
  return {indir.x - normal.x * s, indir.y - normal.y * s, indir.z - normal.z * s};
}

__device__ __forceinline__ float sqrt_nonneg(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

// +Y-frame direction rotated into the frame of `normal`; exact special
// cases for normal = +-Y.
__device__ V3 rotate_to_frame(V3 local, V3 normal) {
  const float nx = normal.x, ny = normal.y, nz = normal.z;
  const float dx = local.x, dy = local.y, dz = local.z;
  const float s2 = max_nan(1.0f - ny * ny, kEps * kEps);
  const float inv_len = 1.0f / sqrtf(s2);
  const float len = sqrtf(s2);
  const V3 rotated = {(nz * dx + nx * ny * dz) * inv_len + nx * dy,
                      ny * dy - dz * len,
                      (-nx * dx + nz * ny * dz) * inv_len + nz * dy};
  const bool near_neg_y = fabsf(ny + 1.0f) < kEps;
  const bool near_pos_y = fabsf(ny - 1.0f) < kEps;
  return sel(near_neg_y, neg(local), sel(near_pos_y, local, rotated));
}

// Local direction from the cos^Ns lobe.
__device__ V3 lobe(float u1, float u2, float ns) {
  const float cos_t = powf(max_nan(u1, 1e-30f), 1.0f / (ns + 1.0f));
  const float sin_t = sqrt_nonneg(1.0f - cos_t * cos_t);
  const float phi = kTwoPi * u2;
  return {sin_t * cosf(phi), cos_t, sin_t * sinf(phi)};
}

__device__ V3 sample_hemi(float u1, float u2, V3 normal) {
  const float sin_t = sqrtf(u1);
  const float cos_t = sqrtf(max_nan(1.0f - u1, 0.0f));
  const float phi = kTwoPi * u2;
  return rotate_to_frame(make(sin_t * cosf(phi), cos_t, sin_t * sinf(phi)), normal);
}

__device__ V3 sample_phong(float u1, float u2, V3 normal, V3 indir, float ns) {
  const V3 half = rotate_to_frame(lobe(u1, u2, ns), normal);
  const float s = 2.0f * dot(indir, half);
  return {indir.x - half.x * s, indir.y - half.y * s, indir.z - half.z * s};
}

__device__ V3 sample_phong_reflect(float u1, float u2, V3 normal, V3 indir, float ns) {
  return rotate_to_frame(lobe(u1, u2, ns), reflect(indir, normal));
}

__device__ V3 sample_fresnel(float u, V3 normal, V3 indir, float tr, float ni) {
  const float ndoti = dot(indir, normal);
  const float tr_eff = tr * (1.0f - powf(1.0f - fabsf(ndoti), 5.0f));
  const bool refract = u < tr_eff;
  const bool entering = ndoti <= 0.0f;
  const V3 d_reflect = reflect(indir, normal);
  if (!refract) return d_reflect;
  if (entering) {
    const float in_rad = 1.0f - (1.0f - ndoti * ndoti) / (ni * ni);
    const float in_alpha = -ndoti / ni - sqrt_nonneg(in_rad);
    return normalize(make(normal.x * in_alpha + indir.x / ni,
                          normal.y * in_alpha + indir.y / ni,
                          normal.z * in_alpha + indir.z / ni));
  }
  const float test = 1.0f - (1.0f - ndoti * ndoti) * ni * ni;
  if (test < 0.0f) return d_reflect;  // total internal reflection
  const float out_alpha = -ndoti * ni + sqrt_nonneg(test);
  return normalize(make(normal.x * out_alpha + indir.x * ni,
                        normal.y * out_alpha + indir.y * ni,
                        normal.z * out_alpha + indir.z * ni));
}

}  // namespace seg

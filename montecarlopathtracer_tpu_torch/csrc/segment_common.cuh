// Vector helpers, the BSDF samplers and the epilogue of one path
// segment, shared by the forward kernels (segment_fused.cu,
// rows_segment.cu) and the vjp (segment_backward.cu). Op for op the
// plain-torch samplers of ops/sampling.py and `_epilogue` of
// ops/segment_fused.py: every conditional selects a branch, every square
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

// The predicates [final_gather, do_rr, hard_kill] of lane r: flags is
// f32[3, 1] (one set for the segment) or, with lane_flags, f32[3, R]
// (one set per lane, as the regenerating wavefront mixes path depths).
struct Flags {
  bool fg, do_rr, hard_kill;
};

__device__ __forceinline__ Flags read_flags(const float* flags, int lane_flags, int R, int r) {
  const size_t stride = lane_flags ? static_cast<size_t>(R) : 1;
  const size_t i = lane_flags ? static_cast<size_t>(r) : 0;
  return {flags[i] > 0.0f, flags[stride + i] > 0.0f, flags[2 * stride + i] > 0.0f};
}

// Segment options that are the same for every lane of a launch.
struct SegOptions {
  int mode_rr;
  float illum, eps_offset;
  int refract_kd, phong_reflect;
};

struct SegState {
  V3 pos, dir, tput, res;
  bool still;
};

// One live lane after its intersection: emission or final gather,
// Russian roulette, one BSDF sample and the state update (`_epilogue`
// in ops/segment_fused.py). The winner's t, beta, gamma and its 21
// shading values `sh` (n0 n1 n2 Ka Kd Ks Ns Tr Ni) are passed in; on a
// miss t = kBig, beta = gamma = 0 and sh is all zero, whose normals
// become +Y and whose Ni becomes 1.
__device__ __forceinline__ SegState segment_epilogue(V3 o, V3 d, V3 tp_in, V3 rs_in, bool hit,
                                                     float t, float beta, float gamma,
                                                     const float* sh, float v1, float v2,
                                                     float vrr, Flags f, SegOptions opt) {
  const V3 yhat = {0.0f, 1.0f, 0.0f};
  const V3 n0 = hit ? make(sh[0], sh[1], sh[2]) : yhat;
  const V3 n1 = hit ? make(sh[3], sh[4], sh[5]) : yhat;
  const V3 n2 = hit ? make(sh[6], sh[7], sh[8]) : yhat;
  const V3 ka = make(sh[9], sh[10], sh[11]);
  const V3 kd = make(sh[12], sh[13], sh[14]);
  const V3 ks = make(sh[15], sh[16], sh[17]);
  const float ns = sh[18], tr = sh[19];
  const float ni = hit ? sh[20] : 1.0f;

  // Emission, final gather and Russian roulette.
  V3 tp = tp_in;
  bool dead_now = !hit;
  if (opt.mode_rr) {
    const float p = max_nan(max_nan(tp.x, tp.y), tp.z);
    const bool survive = p > vrr;
    const float pm = max_nan(p, 1e-20f);
    if (f.do_rr && survive) tp = make(tp.x / pm, tp.y / pm, tp.z / pm);
    dead_now = dead_now || (f.do_rr && !survive) || f.hard_kill;
  }
  const bool is_emit = ka.x > 0.0f || ka.y > 0.0f || ka.z > 0.0f;
  const bool emit_now = !dead_now && (is_emit || f.fg);
  const float il = opt.illum;
  const V3 rs = emit_now ? make(tp.x * ka.x * il, tp.y * ka.y * il, tp.z * ka.z * il) : rs_in;
  const bool still = !dead_now && !emit_now;

  // Scatter: smooth normal, one BSDF sample, state update.
  const float w0 = 1.0f - beta - gamma;
  const V3 nrm = make(n0.x * w0 + n1.x * beta + n2.x * gamma,
                      n0.y * w0 + n1.y * beta + n2.y * gamma,
                      n0.z * w0 + n1.z * beta + n2.z * gamma);
  const float nn = sqrtf(max_nan(dot(nrm, nrm), kEps * kEps));
  const V3 normal = make(nrm.x / nn, nrm.y / nn, nrm.z / nn);

  V3 new_dir, albedo;
  if (tr > 0.0f) {
    new_dir = sample_fresnel(v1, normal, d, tr, ni);
    albedo = opt.refract_kd ? kd : make(1.0f, 1.0f, 1.0f);
  } else if (ns > 1.0f) {
    new_dir = opt.phong_reflect ? sample_phong_reflect(v1, v2, normal, d, ns)
                                : sample_phong(v1, v2, normal, d, ns);
    albedo = ks;
  } else {
    const V3 h = sample_hemi(v1, v2, normal);
    new_dir = dot(d, normal) > 0.0f ? neg(h) : h;  // two-sided diffuse
    albedo = kd;
  }
  const float th = hit ? t : 0.0f;
  const float e = opt.eps_offset;
  SegState out;
  out.tput = still ? make(tp.x * albedo.x, tp.y * albedo.y, tp.z * albedo.z) : tp;
  out.pos = still ? make(o.x + th * d.x + new_dir.x * e, o.y + th * d.y + new_dir.y * e,
                         o.z + th * d.z + new_dir.z * e)
                  : o;
  out.dir = still ? new_dir : d;
  out.res = rs;
  out.still = still;
  return out;
}

// Lane-major [3, R] loads and stores.
__device__ __forceinline__ V3 load3(const float* p, int R, int r) {
  return make(p[r], p[static_cast<size_t>(R) + r], p[2 * static_cast<size_t>(R) + r]);
}

__device__ __forceinline__ void store3(float* p, int R, int r, V3 v) {
  p[r] = v.x;
  p[static_cast<size_t>(R) + r] = v.y;
  p[2 * static_cast<size_t>(R) + r] = v.z;
}

}  // namespace seg

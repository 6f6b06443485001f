// One whole path segment per ray: nearest hit, BSDF sampling and state
// update, in one kernel launch.
//
// Replaces the TPU kernel `_mega_segment_kernel`
// (montecarlopathtracer_tpu/ops/segment_fused.py, entry
// `mega_segment_fwd`; its chunk loop is `_v4_init_tile` /
// `_v4_process_chunk` in ops/intersect_pallas.py) in its non-cull,
// scalar-flag form. The plain PyTorch version of the same function is
// `mega_segment_ref` in ops/segment_fused.py.
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
// straight from global memory once per ray. Selection runs in plain
// f32: no tensor cores (TF32 or bf16 picks wrong winners near edges),
// IEEE division and the precise powf/sinf/cosf (compile without
// --use_fast_math: Ns = 1000 lobes and grazing Fresnel need them).
//
// Contract (that of mega_segment_fwd): rows f32[T, 48] = geometry 12 |
// shading 32 | pad 4; pos/dir/tput/res f32[3, R]; live bool[R];
// u1/u2/urr f32[R]; flags f32[3] = [final_gather, do_rr, hard_kill].
// Outputs idx i32[R] (-1 = miss), npos/ndir/ntput/nres f32[3, R],
// still f32[R]. Lanes that are not live pass their state through with
// idx = -1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // rays per block
constexpr int kTriTile = 128;  // triangles per shared-memory tile
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
  const float sin_t = sqrtf(max_nan(1.0f - cos_t * cos_t, 0.0f));
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

__device__ __forceinline__ float sqrt_nonneg(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

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

__global__ void __launch_bounds__(kThreads)
mega_segment_kernel(const float* __restrict__ rows, int T,
                    const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ tput, const float* __restrict__ res,
                    const bool* __restrict__ live, const float* __restrict__ u1,
                    const float* __restrict__ u2, const float* __restrict__ urr,
                    const float* __restrict__ flags, int R, int mode_rr, float illum,
                    float eps_offset, int refract_kd, int phong_reflect,
                    int* __restrict__ idx_out, float* __restrict__ npos,
                    float* __restrict__ ndir, float* __restrict__ ntput,
                    float* __restrict__ nres, float* __restrict__ still_out) {
  __shared__ float4 geom[kTriTile * 3];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < R;
  const bool act = in_range && live[r];
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  if (in_range) {
    o = make(pos[r], pos[R + r], pos[2 * R + r]);
    d = make(dir[r], dir[R + r], dir[2 * R + r]);
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

  const V3 tp_in = make(tput[r], tput[R + r], tput[2 * R + r]);
  const V3 rs_in = make(res[r], res[R + r], res[2 * R + r]);
  if (!act) {
    idx_out[r] = -1;
    npos[r] = o.x, npos[R + r] = o.y, npos[2 * R + r] = o.z;
    ndir[r] = d.x, ndir[R + r] = d.y, ndir[2 * R + r] = d.z;
    ntput[r] = tp_in.x, ntput[R + r] = tp_in.y, ntput[2 * R + r] = tp_in.z;
    nres[r] = rs_in.x, nres[R + r] = rs_in.y, nres[2 * R + r] = rs_in.z;
    still_out[r] = 0.0f;
    return;
  }

  // Winner values; a miss has t = BIG, beta = gamma = 0 and an all-zero
  // shading row, whose normals become +Y and whose Ni becomes 1.
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
  const V3 yhat = {0.0f, 1.0f, 0.0f};
  const V3 n0 = hit ? make(sh[0], sh[1], sh[2]) : yhat;
  const V3 n1 = hit ? make(sh[3], sh[4], sh[5]) : yhat;
  const V3 n2 = hit ? make(sh[6], sh[7], sh[8]) : yhat;
  const V3 ka = make(sh[9], sh[10], sh[11]);
  const V3 kd = make(sh[12], sh[13], sh[14]);
  const V3 ks = make(sh[15], sh[16], sh[17]);
  const float ns = sh[18], tr = sh[19];
  const float ni = hit ? sh[20] : 1.0f;
  const float t = hit ? best_t : kBig;
  const float beta = hit ? best_b : 0.0f;
  const float gamma = hit ? best_g : 0.0f;
  const bool fg = flags[0] > 0.0f, do_rr = flags[1] > 0.0f, hard_kill = flags[2] > 0.0f;

  // Emission, final gather and Russian roulette.
  V3 tp = tp_in;
  bool dead_now = !hit;
  if (mode_rr) {
    const float p = max_nan(max_nan(tp.x, tp.y), tp.z);
    const bool survive = p > urr[r];
    const float pm = max_nan(p, 1e-20f);
    if (do_rr && survive) tp = make(tp.x / pm, tp.y / pm, tp.z / pm);
    dead_now = dead_now || (do_rr && !survive) || hard_kill;
  }
  const bool is_emit = ka.x > 0.0f || ka.y > 0.0f || ka.z > 0.0f;
  const bool emit_now = !dead_now && (is_emit || fg);
  const V3 rs = emit_now ? make(tp.x * ka.x * illum, tp.y * ka.y * illum, tp.z * ka.z * illum)
                         : rs_in;
  const bool still = !dead_now && !emit_now;

  // Scatter: smooth normal, one BSDF sample, state update.
  const float w0 = 1.0f - beta - gamma;
  const V3 nrm = make(n0.x * w0 + n1.x * beta + n2.x * gamma,
                      n0.y * w0 + n1.y * beta + n2.y * gamma,
                      n0.z * w0 + n1.z * beta + n2.z * gamma);
  const float nn = sqrtf(max_nan(dot(nrm, nrm), kEps * kEps));
  const V3 normal = make(nrm.x / nn, nrm.y / nn, nrm.z / nn);

  const float v1 = u1[r], v2 = u2[r];
  V3 new_dir, albedo;
  if (tr > 0.0f) {
    new_dir = sample_fresnel(v1, normal, d, tr, ni);
    albedo = refract_kd ? kd : make(1.0f, 1.0f, 1.0f);
  } else if (ns > 1.0f) {
    new_dir = phong_reflect ? sample_phong_reflect(v1, v2, normal, d, ns)
                            : sample_phong(v1, v2, normal, d, ns);
    albedo = ks;
  } else {
    const V3 h = sample_hemi(v1, v2, normal);
    new_dir = dot(d, normal) > 0.0f ? neg(h) : h;  // two-sided diffuse
    albedo = kd;
  }
  const V3 ntp = still ? make(tp.x * albedo.x, tp.y * albedo.y, tp.z * albedo.z) : tp;
  const float th = hit ? t : 0.0f;
  const V3 np = still ? make(o.x + th * d.x + new_dir.x * eps_offset,
                             o.y + th * d.y + new_dir.y * eps_offset,
                             o.z + th * d.z + new_dir.z * eps_offset)
                      : o;
  const V3 nd = still ? new_dir : d;

  npos[r] = np.x, npos[R + r] = np.y, npos[2 * R + r] = np.z;
  ndir[r] = nd.x, ndir[R + r] = nd.y, ndir[2 * R + r] = nd.z;
  ntput[r] = ntp.x, ntput[R + r] = ntp.y, ntput[2 * R + r] = ntp.z;
  nres[r] = rs.x, nres[R + r] = rs.y, nres[2 * R + r] = rs.z;
  still_out[r] = still ? 1.0f : 0.0f;
}

}  // namespace

// Launches one segment on `stream`; returns cudaGetLastError() so the
// caller can raise on a refused launch.
extern "C" int mega_segment_launch(const float* rows, int T, const float* pos,
                                   const float* dir, const float* tput, const float* res,
                                   const bool* live, const float* u1, const float* u2,
                                   const float* urr, const float* flags, int R, int mode_rr,
                                   float illum, float eps_offset, int refract_kd,
                                   int phong_reflect, int* idx, float* npos, float* ndir,
                                   float* ntput, float* nres, float* still, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    mega_segment_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, T, pos, dir, tput, res, live, u1, u2, urr, flags, R, mode_rr, illum, eps_offset,
        refract_kd, phong_reflect, idx, npos, ndir, ntput, nres, still);
  }
  return static_cast<int>(cudaGetLastError());
}

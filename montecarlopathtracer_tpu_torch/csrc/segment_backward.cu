// The vjp of one whole path segment at fixed winners, one ray per thread.
//
// Replaces the TPU kernel `_segment_bwd_kernel`
// (montecarlopathtracer_tpu/ops/segment_fused.py, entry
// `segment_backward`), which traced jax.vjp of `_segment_core_rows`
// inside the kernel. CUDA has no autodiff, so this kernel replays the
// segment forward per ray (the winner recompute and the epilogue of
// segment_fused.cu) and runs its reverse mode, derived by hand. The
// plain PyTorch version is `segment_backward_ref` in
// ops/segment_fused.py, torch.autograd.grad of `segment_core_rows`;
// each reverse step below names the forward op it inverts and follows
// torch's adjoint rules where they choose: torch.maximum splits a tie's
// cotangent in halves, torch.clamp_min passes it where x >= lo, the
// guarded sqrt passes none where x <= 0.
//
// Only the branch that a `where` selected receives the cotangent, and
// only lanes that the forward kept alive (`still`) run the sampler
// reverse, so no 0 * inf is ever formed: a lane whose geometry
// cotangent is zero gets an exact zero, never NaN.
//
// The kernel reads each lane's winner row `rows[idx]` itself, as
// rows_segment.cu does: the 21 shading floats of a hit lane and the 12
// geometry floats of a lane that goes on, as float4 loads through the
// read-only path, straight from the [T, 48] table, so no [48, R] copy of
// the winners' rows is made. A miss reads no row. JAX's contract, the
// gathered rows f32[48, R] and a hit mask, is served by the caller
// (`segment_backward` in ops/segment_fused.py) as the table full^T with
// idx = r where hit: the same floats, so the same outputs.
//
// What bounds it on an H100: memory. Per ray it reads 3 x 3 state and
// 4 x 3 cotangent floats, 3 uniforms, a mask and the winner index (or
// hit flag), and writes 4 x 3 + 48 floats: ~0.4 KB per ray, ~190 MB per
// 800x600 segment, against a few hundred flops of replay and reverse.
// The row reads, 84 B a hit lane and 48 B more a lane that goes on, are
// scattered over the table, which stays in L1 and L2 (6 KB for the
// 32-triangle Cornell box, 15.7 MB for the 81,932-triangle bunny); a
// gathered copy would coalesce them but cost a 92 MB write and read per
// 800x600 segment.
// The design keeps every intermediate in registers, reads and writes
// lane-major [k, R] arrays so that a warp's accesses coalesce, and
// writes d_full once per ray (zeros included, so no memset is needed).
//
// Contract (segment_backward_rows): pos/dir/tput/res f32[3, R]; act
// bool[R]; rows f32[T, 48], 16-byte aligned; idx i32[R] (-1 = miss);
// u1/u2/urr f32[R]; flags f32[3]; cotangents of npos/ndir/ntput/nres
// f32[3, R]. Outputs d_pos/d_dir/d_tput/d_res f32[3, R], d_full
// f32[48, R].

#include <cuda_runtime.h>

#include "segment_common.cuh"

namespace {

using namespace seg;

constexpr int kThreads = 128;  // rays per block

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 hadamard(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }

// torch.maximum(a, b)'s adjoint: all to the larger, halves on a tie.
__device__ __forceinline__ void max_bwd(float a, float b, float g, float& ga, float& gb) {
  const bool tie = a == b;
  ga = tie ? 0.5f * g : (a < b ? 0.0f : g);
  gb = tie ? 0.5f * g : (a > b ? 0.0f : g);
}

// normalize(v) = v / sqrt(max(v.v, eps^2)): the cotangent of v.
__device__ V3 normalize_bwd(V3 v, V3 g) {
  const float dd = dot(v, v);
  const float n = sqrtf(max_nan(dd, kEps * kEps));
  V3 gv = {g.x / n, g.y / n, g.z / n};
  if (dd >= kEps * kEps) {
    const float g_n = -dot(g, v) / (n * n);
    gv = add(gv, mul(v, 2.0f * (g_n * 0.5f / n)));
  }
  return gv;
}

// reflect(i, n) = i - n * (2 i.n): adds the cotangents of i and n.
__device__ void reflect_bwd(V3 indir, V3 normal, V3 g, V3& g_indir, V3& g_normal) {
  const float s = 2.0f * dot(indir, normal);
  const float g_dot = 2.0f * -dot(g, normal);
  g_indir = add(add(g_indir, g), mul(normal, g_dot));
  g_normal = add(add(g_normal, mul(g, -s)), mul(indir, g_dot));
}

// rotate_to_frame(local, normal): adds the cotangents of local and
// normal. At normal = -Y the forward is -local, at +Y it is local.
__device__ void rotate_to_frame_bwd(V3 local, V3 normal, V3 g, V3& g_local, V3& g_normal) {
  const float nx = normal.x, ny = normal.y, nz = normal.z;
  const float dx = local.x, dy = local.y, dz = local.z;
  if (fabsf(ny + 1.0f) < kEps) {
    g_local = add(g_local, neg(g));
    return;
  }
  if (fabsf(ny - 1.0f) < kEps) {
    g_local = add(g_local, g);
    return;
  }
  const float x = 1.0f - ny * ny;
  const float sq = sqrtf(max_nan(x, kEps * kEps));
  const float inv_len = 1.0f / sq;
  // rx = A * inv_len + nx dy, ry = ny dy - dz len, rz = C * inv_len + nz dy
  const float A = nz * dx + nx * ny * dz;
  const float C = -nx * dx + nz * ny * dz;
  const float gA = g.x * inv_len, gC = g.z * inv_len;
  const float g_inv = g.x * A + g.z * C;
  const float g_len = -g.y * dz;
  g_local.x += gA * nz - gC * nx;
  g_local.y += g.x * nx + g.y * ny + g.z * nz;
  g_local.z += gA * nx * ny + gC * nz * ny - g.y * sq;
  float g_ny = gA * nx * dz + gC * nz * dz + g.y * dy;
  if (x >= kEps * kEps) {  // s2 = max(1 - ny^2, eps^2); inv_len = 1/sqrt(s2), len = sqrt(s2)
    const float g_sq = g_len - g_inv * inv_len * inv_len;
    g_ny += (g_sq * 0.5f / sq) * (-2.0f * ny);
  }
  g_normal.x += gA * ny * dz - gC * dx + g.x * dy;
  g_normal.y += g_ny;
  g_normal.z += gA * dx + gC * ny * dz + g.z * dy;
}

// lobe(u1, u2, ns): the cotangent of ns (the uniforms carry none).
__device__ float lobe_bwd(float u1, float u2, float ns, V3 g) {
  const float b = max_nan(u1, 1e-30f);
  const float e = 1.0f / (ns + 1.0f);
  const float cos_t = powf(b, e);
  const float x = 1.0f - cos_t * cos_t;
  float g_cos = g.y;
  if (x > 0.0f) {  // sin_t = sqrt_nonneg(x): no adjoint where x <= 0
    const float phi = kTwoPi * u2;
    const float g_sin = g.x * cosf(phi) + g.z * sinf(phi);
    g_cos += (g_sin * 0.5f / sqrtf(x)) * (-2.0f * cos_t);
  }
  // cos_t = b^e, e = 1 / (ns + 1)
  return g_cos * cos_t * logf(b) * -(e * e);
}

// Blinn-Phong: out = i - h (2 i.h), h = rotate_to_frame(lobe, normal).
__device__ float sample_phong_bwd(float u1, float u2, V3 normal, V3 indir, float ns, V3 g,
                                  V3& g_normal, V3& g_indir) {
  const V3 local = lobe(u1, u2, ns);
  const V3 half = rotate_to_frame(local, normal);
  const float s = 2.0f * dot(indir, half);
  const float g_dot = 2.0f * -dot(g, half);
  g_indir = add(add(g_indir, g), mul(half, g_dot));
  const V3 g_half = add(mul(g, -s), mul(indir, g_dot));
  V3 g_local = {0.0f, 0.0f, 0.0f};
  rotate_to_frame_bwd(local, normal, g_half, g_local, g_normal);
  return lobe_bwd(u1, u2, ns, g_local);
}

// Classic Phong: out = rotate_to_frame(lobe, reflect(i, normal)).
__device__ float sample_phong_reflect_bwd(float u1, float u2, V3 normal, V3 indir, float ns,
                                          V3 g, V3& g_normal, V3& g_indir) {
  const V3 local = lobe(u1, u2, ns);
  const V3 r = reflect(indir, normal);
  V3 g_local = {0.0f, 0.0f, 0.0f}, g_r = {0.0f, 0.0f, 0.0f};
  rotate_to_frame_bwd(local, r, g, g_local, g_r);
  reflect_bwd(indir, normal, g_r, g_indir, g_normal);
  return lobe_bwd(u1, u2, ns, g_local);
}

// Cosine hemisphere: only the frame's normal takes a cotangent.
__device__ void sample_hemi_bwd(float u1, float u2, V3 normal, V3 g, V3& g_normal) {
  const float sin_t = sqrtf(u1);
  const float cos_t = sqrtf(max_nan(1.0f - u1, 0.0f));
  const float phi = kTwoPi * u2;
  V3 g_local = {0.0f, 0.0f, 0.0f};
  rotate_to_frame_bwd(make(sin_t * cosf(phi), cos_t, sin_t * sinf(phi)), normal, g, g_local,
                      g_normal);
}

// Fresnel refract-or-reflect: adds the cotangents of normal and indir,
// returns that of ni (tr only picks the branch and takes none).
__device__ float sample_fresnel_bwd(float u, V3 normal, V3 indir, float tr, float ni, V3 g,
                                    V3& g_normal, V3& g_indir) {
  const float ndoti = dot(indir, normal);
  const float tr_eff = tr * (1.0f - powf(1.0f - fabsf(ndoti), 5.0f));
  const bool refract = u < tr_eff;
  const bool entering = ndoti <= 0.0f;
  const float X = 1.0f - ndoti * ndoti;
  float g_ndoti = 0.0f, g_ni = 0.0f;
  if (!refract) {
    reflect_bwd(indir, normal, g, g_indir, g_normal);
    return 0.0f;
  }
  if (entering) {
    // v = n * in_alpha + i / ni, in_alpha = -ndoti / ni - sqrt_nonneg(in_rad),
    // in_rad = 1 - X / ni^2
    const float Y = ni * ni;
    const float in_rad = 1.0f - X / Y;
    const float sq = sqrt_nonneg(in_rad);
    const float in_alpha = -ndoti / ni - sq;
    const V3 v = add(mul(normal, in_alpha), make(indir.x / ni, indir.y / ni, indir.z / ni));
    const V3 gv = normalize_bwd(v, g);
    g_normal = add(g_normal, mul(gv, in_alpha));
    const float g_ia = dot(gv, normal);
    g_indir = add(g_indir, make(gv.x / ni, gv.y / ni, gv.z / ni));
    g_ni += -dot(gv, indir) / Y;
    g_ndoti += -g_ia / ni;
    g_ni += g_ia * ndoti / Y;
    if (in_rad > 0.0f) {
      const float g_rad = -g_ia * 0.5f / sq;
      g_ndoti += (-g_rad / Y) * (-2.0f * ndoti);
      g_ni += (g_rad * X / (Y * Y)) * (2.0f * ni);
    }
  } else {
    // v = n * out_alpha + i * ni, out_alpha = -ndoti ni + sqrt_nonneg(test),
    // test = 1 - X ni ni
    const float test = 1.0f - X * ni * ni;
    if (test < 0.0f) {  // total internal reflection
      reflect_bwd(indir, normal, g, g_indir, g_normal);
      return 0.0f;
    }
    const float sq = sqrt_nonneg(test);
    const float out_alpha = -ndoti * ni + sq;
    const V3 v = add(mul(normal, out_alpha), mul(indir, ni));
    const V3 gv = normalize_bwd(v, g);
    g_normal = add(g_normal, mul(gv, out_alpha));
    const float g_oa = dot(gv, normal);
    g_indir = add(g_indir, mul(gv, ni));
    g_ni += dot(gv, indir);
    g_ndoti += -g_oa * ni;
    g_ni += -g_oa * ndoti;
    if (test > 0.0f) {
      const float g_test = g_oa * 0.5f / sq;
      g_ndoti += (-g_test * ni * ni) * (-2.0f * ndoti);
      g_ni += -g_test * X * 2.0f * ni;
    }
  }
  // ndoti = i . n
  g_indir = add(g_indir, mul(normal, g_ndoti));
  g_normal = add(g_normal, mul(indir, g_ndoti));
  return g_ni;
}

// Floats [kFirst, kFirst + kN) of row i of the [T, 48] table into
// `out`, float4 loads through the read-only path (kFirst a multiple of 4;
// `out` holds kN rounded up to 4).
template <int kFirst, int kN>
__device__ __forceinline__ void load_row(const float* __restrict__ rows, int i, float* out) {
  const float4* row = reinterpret_cast<const float4*>(rows + static_cast<size_t>(i) * 48 + kFirst);
#pragma unroll
  for (int q = 0; q < (kN + 3) / 4; ++q) {
    const float4 v = __ldg(row + q);
    out[4 * q] = v.x, out[4 * q + 1] = v.y, out[4 * q + 2] = v.z, out[4 * q + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_backward_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                        const float* __restrict__ tput, const float* __restrict__ res,
                        const bool* __restrict__ act_in, const float* __restrict__ rows,
                        const int* __restrict__ idx,
                        const float* __restrict__ u1, const float* __restrict__ u2,
                        const float* __restrict__ urr, const float* __restrict__ flags,
                        const float* __restrict__ cnp, const float* __restrict__ cnd,
                        const float* __restrict__ cnt, const float* __restrict__ cnr, int R,
                        int mode_rr, float illum,
                        float eps_offset, int refract_kd, int phong_reflect,
                        float* __restrict__ dpos, float* __restrict__ ddir,
                        float* __restrict__ dtput, float* __restrict__ dres,
                        float* __restrict__ dfull) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t sR = R;
  auto load3 = [&](const float* p) { return make(p[r], p[sR + r], p[2 * sR + r]); };
  auto store3 = [&](float* p, V3 v) {
    p[r] = v.x;
    p[sR + r] = v.y;
    p[2 * sR + r] = v.z;
  };
  const V3 o = load3(pos), d = load3(dir), tp_in = load3(tput);
  const V3 g_np = load3(cnp), g_nd = load3(cnd), g_nt = load3(cnt), g_nr = load3(cnr);
  const bool act = act_in[r];

  // Row cotangents: geometry 0..11, shading 12..32 (n0 n1 n2 Ka Kd Ks Ns
  // Tr Ni); Tr, the 11 free shading slots and the pad take none.
  float gf[33];
#pragma unroll
  for (int k = 0; k < 33; ++k) gf[k] = 0.0f;
  V3 d_o = {0.0f, 0.0f, 0.0f}, d_d = {0.0f, 0.0f, 0.0f};
  V3 d_tp = {0.0f, 0.0f, 0.0f}, d_rs = {0.0f, 0.0f, 0.0f};

  if (!act) {  // the segment passes the lane's state through
    d_o = g_np, d_d = g_nd, d_tp = g_nt, d_rs = g_nr;
  } else {
    // ---- forward replay: shading row and RR / emission decisions ----
    const int i = idx[r];
    const bool hit = i >= 0;
    float sh[24];
    if (hit) {
      load_row<12, 21>(rows, i, sh);
    } else {
#pragma unroll
      for (int k = 0; k < 24; ++k) sh[k] = 0.0f;
    }
    const V3 ka = make(sh[9], sh[10], sh[11]);
    const V3 kd = make(sh[12], sh[13], sh[14]);
    const V3 ks = make(sh[15], sh[16], sh[17]);
    const float ns = sh[18], tr = sh[19];
    const float ni = hit ? sh[20] : 1.0f;
    const bool fg = flags[0] > 0.0f, do_rr = flags[1] > 0.0f, hard_kill = flags[2] > 0.0f;

    V3 tp = tp_in;
    bool dead_now = !hit, cond = false;
    float p = 0.0f, pm = 1.0f;
    if (mode_rr) {
      p = max_nan(max_nan(tp_in.x, tp_in.y), tp_in.z);
      const bool survive = p > urr[r];
      pm = max_nan(p, 1e-20f);
      cond = do_rr && survive;
      if (cond) tp = make(tp_in.x / pm, tp_in.y / pm, tp_in.z / pm);
      dead_now = dead_now || (do_rr && !survive) || hard_kill;
    }
    const bool is_emit = ka.x > 0.0f || ka.y > 0.0f || ka.z > 0.0f;
    const bool emit_now = !dead_now && (is_emit || fg);
    const bool still = !dead_now && !emit_now;

    // ---- reverse ----
    V3 g_tp = {0.0f, 0.0f, 0.0f};
    // new_res = emit_now ? tp * ka * illum : res
    if (emit_now) {
      const V3 gi = mul(g_nr, illum);
      g_tp = hadamard(gi, ka);
      gf[21] += gi.x * tp.x, gf[22] += gi.y * tp.y, gf[23] += gi.z * tp.z;
    } else {
      d_rs = g_nr;
    }

    if (!still) {  // new_tput = tp, new_pos = pos, new_dir = dir
      g_tp = add(g_tp, g_nt);
      d_o = g_np;
      d_d = g_nd;
    } else {  // still implies hit
      // Replay the winner recompute and the smooth normal.
      float m[12];
      load_row<0, 12>(rows, i, m);
      float op[3], dp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        op[k] = m[4 * k] * o.x + m[4 * k + 1] * o.y + m[4 * k + 2] * o.z + m[4 * k + 3];
        dp[k] = m[4 * k] * d.x + m[4 * k + 1] * d.y + m[4 * k + 2] * d.z;
      }
      const bool safe = fabsf(dp[2]) > 1e-12f;
      const float t = safe ? -op[2] / dp[2] : kBig;
      const float beta = op[0] + t * dp[0];
      const float gamma = op[1] + t * dp[1];
      const V3 n0 = make(sh[0], sh[1], sh[2]);
      const V3 n1 = make(sh[3], sh[4], sh[5]);
      const V3 n2 = make(sh[6], sh[7], sh[8]);
      const float w0 = 1.0f - beta - gamma;
      const V3 nrm = add(add(mul(n0, w0), mul(n1, beta)), mul(n2, gamma));
      const V3 normal = normalize(nrm);

      const bool is_fresnel = tr > 0.0f;
      const bool is_phong = !is_fresnel && ns > 1.0f;
      const float v1 = u1[r], v2 = u2[r];
      V3 albedo;
      if (is_fresnel) {
        albedo = refract_kd ? kd : make(1.0f, 1.0f, 1.0f);
      } else {
        albedo = is_phong ? ks : kd;
      }
      // new_tput = tp * albedo
      g_tp = add(g_tp, hadamard(g_nt, albedo));
      const V3 g_alb = hadamard(g_nt, tp);
      if (is_phong) {
        gf[27] += g_alb.x, gf[28] += g_alb.y, gf[29] += g_alb.z;
      } else if (!is_fresnel || refract_kd) {
        gf[24] += g_alb.x, gf[25] += g_alb.y, gf[26] += g_alb.z;
      }
      // new_pos = pos + t dir + new_dir eps; new_dir_out = new_dir
      const V3 g_newdir = add(g_nd, mul(g_np, eps_offset));
      d_o = g_np;
      d_d = mul(g_np, t);
      float g_t = dot(g_np, d);

      // new_dir = the selected sampler's output
      V3 g_normal = {0.0f, 0.0f, 0.0f};
      if (is_fresnel) {
        gf[32] += sample_fresnel_bwd(v1, normal, d, tr, ni, g_newdir, g_normal, d_d);
      } else if (is_phong) {
        gf[30] += phong_reflect
                      ? sample_phong_reflect_bwd(v1, v2, normal, d, ns, g_newdir, g_normal, d_d)
                      : sample_phong_bwd(v1, v2, normal, d, ns, g_newdir, g_normal, d_d);
      } else {
        const bool flip = dot(d, normal) > 0.0f;  // two-sided diffuse: -h
        sample_hemi_bwd(v1, v2, normal, flip ? neg(g_newdir) : g_newdir, g_normal);
      }

      // normal = normalize(n0 w0 + n1 beta + n2 gamma)
      const V3 g_nrm = normalize_bwd(nrm, g_normal);
      gf[12] += g_nrm.x * w0, gf[13] += g_nrm.y * w0, gf[14] += g_nrm.z * w0;
      gf[15] += g_nrm.x * beta, gf[16] += g_nrm.y * beta, gf[17] += g_nrm.z * beta;
      gf[18] += g_nrm.x * gamma, gf[19] += g_nrm.y * gamma, gf[20] += g_nrm.z * gamma;
      const float g_w0 = dot(g_nrm, n0);
      const float g_beta = dot(g_nrm, n1) - g_w0;
      const float g_gamma = dot(g_nrm, n2) - g_w0;

      // beta = op0 + t dp0, gamma = op1 + t dp1, t = -op2 / dp2 (if safe)
      g_t += g_beta * dp[0] + g_gamma * dp[1];
      float g_op[3] = {g_beta, g_gamma, 0.0f};
      float g_dp[3] = {g_beta * t, g_gamma * t, 0.0f};
      if (safe) {
        g_op[2] = -g_t / dp[2];
        g_dp[2] = g_t * op[2] / (dp[2] * dp[2]);
      }
      // op_k = m_k . o + m_k3, dp_k = m_k . d
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gf[4 * k] += g_op[k] * o.x + g_dp[k] * d.x;
        gf[4 * k + 1] += g_op[k] * o.y + g_dp[k] * d.y;
        gf[4 * k + 2] += g_op[k] * o.z + g_dp[k] * d.z;
        gf[4 * k + 3] += g_op[k];
        const V3 mk = make(m[4 * k], m[4 * k + 1], m[4 * k + 2]);
        d_o = add(d_o, mul(mk, g_op[k]));
        d_d = add(d_d, mul(mk, g_dp[k]));
      }
    }

    // tp = cond ? tput / pm : tput, pm = max(p, 1e-20), p = max(max(t0, t1), t2)
    if (cond) {
      d_tp = make(g_tp.x / pm, g_tp.y / pm, g_tp.z / pm);
      if (p >= 1e-20f) {
        const float g_pm = -dot(g_tp, tp_in) / (pm * pm);
        float g_m01, g_t0, g_t1, g_t2;
        max_bwd(max_nan(tp_in.x, tp_in.y), tp_in.z, g_pm, g_m01, g_t2);
        max_bwd(tp_in.x, tp_in.y, g_m01, g_t0, g_t1);
        d_tp = add(d_tp, make(g_t0, g_t1, g_t2));
      }
    } else {
      d_tp = g_tp;
    }
  }

  store3(dpos, d_o);
  store3(ddir, d_d);
  store3(dtput, d_tp);
  store3(dres, d_rs);
#pragma unroll
  for (int k = 0; k < 33; ++k) dfull[k * sR + r] = gf[k];
#pragma unroll
  for (int k = 33; k < 48; ++k) dfull[k * sR + r] = 0.0f;
}

}  // namespace

// Launch the segment vjp on `stream`; returns cudaGetLastError() so the
// caller can raise on a refused launch.
extern "C" int segment_backward_rows_launch(
    const float* pos, const float* dir, const float* tput, const float* res, const bool* act,
    const float* rows, const int* idx, const float* u1, const float* u2, const float* urr,
    const float* flags, const float* cnp, const float* cnd, const float* cnt, const float* cnr,
    int R, int mode_rr, float illum, float eps_offset, int refract_kd, int phong_reflect,
    float* dpos, float* ddir, float* dtput, float* dres, float* dfull, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    segment_backward_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pos, dir, tput, res, act, rows, idx, u1, u2, urr, flags, cnp, cnd, cnt, cnr, R, mode_rr,
        illum, eps_offset, refract_kd, phong_reflect, dpos, ddir, dtput, dres, dfull);
  }
  return static_cast<int>(cudaGetLastError());
}

"""One whole path segment: nearest hit, BSDF sampling and state update.

The counterpart of the forward half of
``montecarlopathtracer_tpu/ops/segment_fused.py`` (``mega_segment_fwd``,
whose Pallas kernel is ``_mega_segment_kernel``). For every ray of the
wavefront it finds the nearest accepted triangle (β > 0, γ > 0,
β + γ < 1, t > 0; ties go to the smallest index), reads the winner's
shading row, and runs the segment epilogue: emission or final gather,
Russian roulette, diffuse / Phong / Fresnel sampling from the given
uniforms, throughput and position update.

- :func:`mega_segment` is the entry point. For CUDA tensors it launches
  the hand-written kernel ``csrc/segment_fused.cu``; for CPU tensors it
  runs :func:`mega_segment_ref`. It never falls back from one to the
  other: a CUDA tensor that the kernel cannot take raises.
- :func:`mega_segment_ref` is the plain-torch version: brute f32
  selection, a gather of the winner row, and the epilogue on ``[3, R]``
  tensors with the samplers of :mod:`.sampling`.
- :func:`pack_rows_full` builds the per-triangle row table f32[T, 48]
  that both read: geometry 12 | shading 32 | pad 4, with the geometry
  block ``[m_k0 m_k1 m_k2 −m_a_k]`` for k = 0..2.

Data contract (that of the JAX function): ray state f32[3, R], ``live``
bool[R], uniforms f32[R], flags f32[3, 1] = [final_gather, do_rr,
hard_kill]. Returns (idx i32[R], new_pos, new_dir, new_tput, new_result
f32[3, R], still f32[R]); a miss has idx = −1. Lanes that are not live
come back with idx = −1 and their state passed through unchanged.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .intersect import triangle_transforms
from .sampling import (
    dot3,
    sample_fresnel,
    sample_hemi,
    sample_phong,
    sample_phong_reflect,
)

_BIG = 3.0e38  # "no hit yet" distance; an accepted t must be below it
_EPS = 1.19209290e-7  # FLT_EPSILON
_REF_RAY_CHUNK = 8192  # rays per step of the plain selection ([rays, T])
MODES = ("fixed", "rr")
PHONG_MODELS = ("blinn", "phong")


def pack_rows_full(scene) -> torch.Tensor:
    """Per-triangle rows f32[T, 48]:

        [m_0· −m_a0 | m_1· −m_a1 | m_2· −m_a2 | n0 n1 n2 Ka Kd Ks Ns Tr Ni
         | 0 × 11 | 0 × 4]

    The geometry block of an invalid (padding) triangle is zero, so its
    d'_z = 0 and it can never be accepted.
    """
    m, m_a = triangle_transforms(*scene.triangle_vertices())
    geom = torch.cat([m, -m_a[:, :, None]], dim=2).reshape(-1, 12)
    geom = geom * scene.tri_valid[:, None].to(geom.dtype)
    n0, n1, n2 = scene.triangle_normals()
    mid = scene.tri_mat.long()
    cols = [
        geom, n0, n1, n2,
        scene.mat_ka[mid], scene.mat_kd[mid], scene.mat_ks[mid],
        scene.mat_ns[mid][:, None], scene.mat_tr[mid][:, None],
        scene.mat_ni[mid][:, None],
    ]
    table = torch.cat(cols, dim=1)  # (T, 33)
    pad = torch.zeros(table.shape[0], 48 - table.shape[1], dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad], dim=1).contiguous()


def _select_ref(rows: torch.Tensor, pos3: torch.Tensor, dir3: torch.Tensor):
    """Nearest accepted triangle per ray, in plain f32: (best t f32[R]
    with _BIG for a miss, index i64[R], β, γ of the winner)."""
    g = rows[:, 0:12]
    T = rows.shape[0]
    cols = torch.arange(T, device=rows.device)
    out_t, out_i, out_b, out_g = [], [], [], []
    for s in range(0, pos3.shape[1], _REF_RAY_CHUNK):
        o = pos3[:, s:s + _REF_RAY_CHUNK, None]
        d = dir3[:, s:s + _REF_RAY_CHUNK, None]

        def prime(k):
            op = g[:, 4 * k] * o[0] + g[:, 4 * k + 1] * o[1] \
                + g[:, 4 * k + 2] * o[2] + g[:, 4 * k + 3]
            dp = g[:, 4 * k] * d[0] + g[:, 4 * k + 1] * d[1] \
                + g[:, 4 * k + 2] * d[2]
            return op, dp

        opx, dpx = prime(0)
        opy, dpy = prime(1)
        opz, w = prime(2)
        t = -opz / w
        beta = opx + t * dpx
        gamma = opy + t * dpy
        # Explicit comparisons: a NaN (w = 0 on a zero-geometry or
        # parallel triangle) fails every one of them.
        ok = (beta > 0.0) & (gamma > 0.0) & (t > 0.0) \
            & (1.0 - (beta + gamma) > 0.0)
        tm = torch.where(ok, t, _BIG)
        best = tm.amin(dim=1)
        # Ties go to the smallest index; a miss (all BIG) picks column 0.
        idx = torch.where(tm == best[:, None], cols, T).amin(dim=1)
        b = beta.gather(1, idx[:, None])[:, 0]
        gm = gamma.gather(1, idx[:, None])[:, 0]
        out_t.append(best)
        out_i.append(idx)
        out_b.append(b)
        out_g.append(gm)
    return torch.cat(out_t), torch.cat(out_i), torch.cat(out_b), torch.cat(out_g)


def _check_options(mode: str, phong_model: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if phong_model not in PHONG_MODELS:
        raise ValueError(
            f"phong_model must be one of {PHONG_MODELS}, got {phong_model!r}"
        )


def mega_segment_ref(
    rows, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """Plain-torch whole segment (see the module docstring for the
    contract). Mirrors ``_epilogue_core`` of the JAX package line by
    line on ``[3, R]`` tensors."""
    _check_options(mode, phong_model)
    best_t, best_i, best_b, best_g = _select_ref(rows, pos3, dir3)
    hit = best_t < _BIG
    hitf = hit.to(torch.float32)
    t = torch.where(hit, best_t, _BIG)
    beta = best_b * hitf
    gamma = best_g * hitf
    shade = rows[best_i, 12:44].T * hitf[None, :]  # (32, R)

    yhat = torch.tensor([[0.0], [1.0], [0.0]], device=rows.device)
    n0 = torch.where(hit[None, :], shade[0:3], yhat)
    n1 = torch.where(hit[None, :], shade[3:6], yhat)
    n2 = torch.where(hit[None, :], shade[6:9], yhat)
    ka, kd, ks = shade[9:12], shade[12:15], shade[15:18]
    ns, tr = shade[18], shade[19]
    ni = torch.where(hit, shade[20], 1.0)
    fg, do_rr, hard_kill = flags[0, 0] > 0.0, flags[1, 0] > 0.0, flags[2, 0] > 0.0

    act = live
    miss = ~hit
    is_emit = (ka > 0.0).any(dim=0)
    tp = tput
    if mode == "rr":
        p = tput.amax(dim=0)
        survive = p > urr
        rr_dead = do_rr & ~survive
        pm = torch.clamp_min(p, 1e-20)
        tp = torch.where((do_rr & survive)[None, :], tput / pm[None, :], tput)
        dead_now = miss | rr_dead | hard_kill
    else:
        dead_now = miss

    emit_now = act & ~dead_now & (is_emit | fg)
    new_res = torch.where(emit_now[None, :], tp * ka * illum, res)
    still = act & ~dead_now & ~emit_now

    w0 = 1.0 - beta - gamma
    nrm = n0 * w0 + n1 * beta + n2 * gamma
    nn = torch.sqrt(torch.clamp_min(dot3(nrm, nrm), _EPS * _EPS))
    normal = nrm / nn

    d_fresnel = sample_fresnel(u1, normal, dir3, tr, ni)
    phong_fn = sample_phong_reflect if phong_model == "phong" else sample_phong
    d_phong = phong_fn(u1, u2, normal, dir3, ns)
    d_hemi = sample_hemi(u1, u2, normal)
    flip = dot3(dir3, normal) > 0.0
    d_diff = torch.where(flip[None, :], -d_hemi, d_hemi)

    is_fresnel = (tr > 0.0)[None, :]
    is_phong = ~is_fresnel & (ns > 1.0)[None, :]
    new_dir = torch.where(is_fresnel, d_fresnel,
                          torch.where(is_phong, d_phong, d_diff))
    albedo_fresnel = kd if refract_kd else torch.ones_like(kd)
    albedo = torch.where(is_fresnel, albedo_fresnel,
                         torch.where(is_phong, ks, kd))
    still3 = still[None, :]
    new_tput = torch.where(still3, tp * albedo, tp)
    point = pos3 + (t * hitf)[None, :] * dir3
    new_pos = torch.where(still3, point + new_dir * eps_offset, pos3)
    new_dir = torch.where(still3, new_dir, dir3)
    # Lanes that are not live pass their whole state through.
    new_tput = torch.where(act[None, :], new_tput, tput)
    idx = torch.where(hit & act, best_i, -1).to(torch.int32)
    return idx, new_pos, new_dir, new_tput, new_res, still.to(torch.float32)


_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("segment_fused")
    fn = lib.mega_segment_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P, ctypes.c_int,  # rows, T
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # pos, dir, tput, res, live, u1, u2, urr, flags
        ctypes.c_int,  # R
        ctypes.c_int, ctypes.c_float, ctypes.c_float,  # mode_rr, illum, eps_offset
        ctypes.c_int, ctypes.c_int,  # refract_kd, phong_reflect
        _P, _P, _P, _P, _P, _P,  # idx, npos, ndir, ntput, nres, still
        _P,  # stream
    ]
    return lib


def _check_cuda_inputs(rows, vec3, vec1, live, flags) -> None:
    dev = rows.device
    R = vec3[0].shape[1]
    for x in (rows, *vec3, *vec1, live, flags):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    for x in (rows, *vec3, *vec1, flags):
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
    if live.dtype != torch.bool:
        raise TypeError(f"live must be bool, got {live.dtype}")
    if rows.dim() != 2 or rows.shape[1] != 48:
        raise ValueError(f"rows must be [T, 48], got {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned for float4 loads")
    for x in vec3:
        if tuple(x.shape) != (3, R):
            raise ValueError(f"expected [3, {R}], got {tuple(x.shape)}")
    for x in (*vec1, live):
        if tuple(x.shape) != (R,):
            raise ValueError(f"expected [{R}], got {tuple(x.shape)}")
    if tuple(flags.shape) != (3, 1):
        raise ValueError(f"flags must be [3, 1], got {tuple(flags.shape)}")
    if R >= 2**31 or rows.shape[0] >= 2**31:
        raise ValueError("R and T must fit in int32")


def _mega_segment_cuda(
    rows, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode, illum, eps_offset, refract_kd, phong_model,
):
    _check_options(mode, phong_model)
    _check_cuda_inputs(rows, (pos3, dir3, tput, res), (u1, u2, urr), live, flags)
    R = pos3.shape[1]
    dev = pos3.device
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    npos, ndir, ntput, nres = (torch.empty_like(pos3) for _ in range(4))
    still = torch.empty(R, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mega_segment_launch(
            rows.data_ptr(), rows.shape[0],
            pos3.data_ptr(), dir3.data_ptr(), tput.data_ptr(), res.data_ptr(),
            live.data_ptr(), u1.data_ptr(), u2.data_ptr(), urr.data_ptr(),
            flags.data_ptr(), R,
            int(mode == "rr"), float(illum), float(eps_offset),
            int(bool(refract_kd)), int(phong_model == "phong"),
            idx.data_ptr(), npos.data_ptr(), ndir.data_ptr(),
            ntput.data_ptr(), nres.data_ptr(), still.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"mega_segment kernel launch failed: cudaError {err}")
    mega_segment.launches += 1
    return idx, npos, ndir, ntput, nres, still


def mega_segment(
    rows, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """Whole-segment forward (see the module docstring). CUDA tensors
    launch the kernel and add one to ``mega_segment.launches``; CPU
    tensors run :func:`mega_segment_ref`."""
    kw = dict(mode=mode, illum=illum, eps_offset=eps_offset,
              refract_kd=refract_kd, phong_model=phong_model)
    args = (rows, pos3, dir3, tput, res, live, u1, u2, urr, flags)
    if pos3.device.type == "cuda":
        return _mega_segment_cuda(*args, **kw)
    if pos3.device.type == "cpu":
        return mega_segment_ref(*args, **kw)
    raise ValueError(f"no segment kernel for device {pos3.device}")


mega_segment.launches = 0

"""One whole path segment: nearest hit, BSDF sampling and state update,
and its gradient.

The counterpart of ``montecarlopathtracer_tpu/ops/segment_fused.py``.
For every ray of the wavefront the forward finds the nearest accepted
triangle (β > 0, γ > 0, β + γ < 1, t > 0; ties go to the smallest
index), reads the winner's shading row, and runs the segment epilogue:
emission or final gather, Russian roulette, diffuse / Phong / Fresnel
sampling from the given uniforms, throughput and position update.

Forward (JAX ``mega_segment_fwd``, Pallas kernel ``_mega_segment_kernel``):

- :func:`mega_segment` is the entry point. For CUDA tensors it launches
  the hand-written kernel ``csrc/segment_fused.cu``; for CPU tensors it
  runs :func:`mega_segment_ref`. It never falls back from one to the
  other: a CUDA tensor that the kernel cannot take raises. Flags may be
  per segment f32[3, 1] (B1) or per lane f32[3, R] (B1l, JAX
  ``lane_flags=True``, for the regenerating wavefront). Given the chunk
  boxes ``clo``, ``chi`` f32[ceil(T / 128), 3] of a Morton-ordered
  table, their slack ``cslack`` f32[ceil(T / 128), 2]
  (:func:`.cull.chunk_slack`) and the table's records ``crec`` f32[T,
  16] (:func:`.cull.cull_records`, built per call when not given), the
  kernel skips the 128-triangle chunks that no live ray of a warp (64
  rays) can reach with its current best t, and visits the others nearest
  first (B1c, JAX ``cull=True``); the winners are those of brute
  selection over the same table. In front of the exact pair test the kernel rejects a pair whose
  ray misses the triangle's widened bounding sphere, which changes no
  winner: B1, B1l and B1c pick the winners of ``nearest_shade_full``
  (B4, B4c) bit for bit.
- :func:`mega_segment_ref` is the plain-torch version: brute f32
  selection, a gather of the winner row, and :func:`_epilogue` (the
  chunk boxes only prune, so it takes none).
- :func:`pack_rows_full` builds the per-triangle row table f32[T, 48]
  that both read: geometry 12 | shading 32 | pad 4, with the geometry
  block ``[m_k0 m_k1 m_k2 −m_a_k]`` for k = 0..2.

Gradient (JAX ``segment_backward`` / ``_make_whole_segment``):

- :func:`segment_core_rows` is the differentiable segment at fixed
  winners: :func:`recompute_rows` (t, β, γ and the shading rows from the
  gathered 48-float winner rows) followed by the same :func:`_epilogue`.
- :func:`segment_backward_rows` is its vjp given the row table and the
  winner index: the hand-written kernel ``csrc/segment_backward.cu``,
  which reads each lane's row through the index (no [48, R] copy), for
  CUDA tensors; :func:`segment_backward_rows_ref`
  (:func:`segment_backward_ref` on :func:`gather_rows`) for CPU tensors.
- :func:`segment_backward` is the same vjp on the gathered winner rows
  (JAX's contract): for CUDA tensors the same kernel, over the gathered
  copy as a table of one row per lane; :func:`segment_backward_ref`
  (``torch.autograd.grad`` of :func:`segment_core_rows`) for CPU
  tensors.
- :class:`WholeSegment` / :func:`whole_segment_megakernel` is the
  differentiable segment: forward :func:`mega_segment`; backward
  :func:`segment_backward_rows` and :func:`.scatter_rows.scatter_rows` of
  the row cotangents into the table. The winner index is piecewise
  constant and carries no gradient.

Segment from known winners (JAX ``rows_segment_fwd``, Pallas kernel
``_rows_segment_kernel``; the traversal path's epilogue):

- :func:`rows_segment` launches ``csrc/rows_segment.cu`` for CUDA
  tensors (B6, or B6l with per-lane flags) and runs
  :func:`rows_segment_ref` (:func:`recompute_rows` + :func:`_epilogue`
  on ``rows[idx]``) for CPU tensors.
- :class:`WholeSegmentRows` / :func:`whole_segment_rows` is its
  differentiable form, with the backward of :class:`WholeSegment`.

Data contract (that of the JAX functions): ray state f32[3, R], ``live``
bool[R], uniforms f32[R], flags f32[3, 1] or f32[3, R] = [final_gather,
do_rr, hard_kill] (the vjp takes f32[3, 1] only: the regenerating
wavefront renders without gradients, in JAX too). The forward returns (idx i32[R], new_pos, new_dir,
new_tput, new_result f32[3, R], still f32[R]); a miss has idx = −1.
Lanes that are not live come back with idx = −1 and their state passed
through unchanged.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count_launch, in_primal
from . import cuda_build
from .intersect import triangle_transforms
from .sampling import (
    dot3,
    sample_fresnel,
    sample_hemi,
    sample_phong,
    sample_phong_reflect,
)
from .scatter_rows import scatter_rows

_BIG = 3.0e38  # "no hit yet" distance; an accepted t must be below it
_EPS = 1.19209290e-7  # FLT_EPSILON
_REF_RAY_CHUNK = 8192  # rays per step of the plain selection ([rays, T]),
_REF_PAIRS = 1 << 26  # fewer where rays x T would pass this many pairs
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


def _select_ref(rows: torch.Tensor, pos3: torch.Tensor, dir3: torch.Tensor, *,
                dz_test: bool = False):
    """Nearest accepted triangle per ray, in plain f32: (best t f32[R]
    with _BIG for a miss, index i64[R], β, γ of the winner). ``dz_test``
    also rejects |d'_z| <= 1e-12 explicitly."""
    g = rows[:, 0:12]
    T = rows.shape[0]
    cols = torch.arange(T, device=rows.device)
    out_t, out_i, out_b, out_g = [], [], [], []
    step = max(1, min(_REF_RAY_CHUNK, _REF_PAIRS // max(T, 1)))
    for s in range(0, pos3.shape[1], step):
        o = pos3[:, s:s + step, None]
        d = dir3[:, s:s + step, None]

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
        if dz_test:
            ok &= w.abs() > 1e-12
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


def _epilogue(
    pos3, dir3, tput, res, t, beta, gamma, shade, *, hit, act, u1, u2, urr,
    flags, mode, illum, eps_offset, refract_kd, phong_model,
):
    """One segment after the intersection, in plain torch on ``[3, R]``
    tensors: ``_epilogue_core`` of the JAX package line by line.

    ``t``, ``beta``, ``gamma`` f32[R] and ``shade`` f32[32, R] are the
    winner's values, already masked by ``hit``. Returns (new_pos,
    new_dir, new_tput, new_res, still bool[R]). Differentiable in the
    state, t, β, γ and shade; the masks and uniforms carry no gradient.
    """
    hitf = hit.to(torch.float32)
    yhat = torch.tensor([[0.0], [1.0], [0.0]], device=pos3.device)
    n0 = torch.where(hit[None, :], shade[0:3], yhat)
    n1 = torch.where(hit[None, :], shade[3:6], yhat)
    n2 = torch.where(hit[None, :], shade[6:9], yhat)
    ka, kd, ks = shade[9:12], shade[12:15], shade[15:18]
    ns, tr = shade[18], shade[19]
    ni = torch.where(hit, shade[20], 1.0)
    # flags f32[3, 1] or per lane f32[3, R]: either row broadcasts.
    fg, do_rr, hard_kill = flags[0] > 0.0, flags[1] > 0.0, flags[2] > 0.0

    miss = ~hit
    is_emit = (ka > 0.0).any(dim=0)
    tp = tput
    if mode == "rr":
        # Nested pairwise maxima, not amax: the value is the same, but a
        # tie splits the adjoint 0.25 / 0.25 / 0.5 as JAX's nested
        # jnp.maximum does (amax would split it in thirds).
        p = torch.maximum(torch.maximum(tput[0], tput[1]), tput[2])
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
    return new_pos, new_dir, new_tput, new_res, still


def mega_segment_ref(
    rows, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn", clo=None, chi=None,
    cslack=None, crec=None, tested=None,
):
    """Plain-torch whole segment (see the module docstring for the
    contract): brute selection, then :func:`_epilogue`. ``clo``, ``chi``,
    ``cslack``, ``crec`` are accepted and not needed: culling never
    changes the winners."""
    _check_options(mode, phong_model)
    if tested is not None:
        raise ValueError("chunk counts come from the kernel; the plain version "
                         "tests every triangle")
    best_t, best_i, best_b, best_g = _select_ref(rows, pos3, dir3)
    hit = best_t < _BIG
    hitf = hit.to(torch.float32)
    t = torch.where(hit, best_t, _BIG)
    shade = rows[best_i, 12:44].T * hitf[None, :]  # (32, R)
    new_pos, new_dir, new_tput, new_res, still = _epilogue(
        pos3, dir3, tput, res, t, best_b * hitf, best_g * hitf, shade,
        hit=hit, act=live, u1=u1, u2=u2, urr=urr, flags=flags, mode=mode,
        illum=illum, eps_offset=eps_offset, refract_kd=refract_kd,
        phong_model=phong_model,
    )
    idx = torch.where(hit & live, best_i, -1).to(torch.int32)
    return idx, new_pos, new_dir, new_tput, new_res, still.to(torch.float32)


def recompute_rows(full, hit, pos3, dir3):
    """Winner values from the gathered rows ``full`` f32[48, R] (JAX
    ``_recompute_rows``): (t, β, γ f32[R], shade f32[32, R]). Exact f32
    division where |d'_z| > 1e-12; on a miss t = _BIG, β = γ = 0 and the
    shading rows are 0."""
    hitf = hit.to(torch.float32)

    def prime(k):
        m = full[4 * k:4 * k + 3]
        op = m[0] * pos3[0] + m[1] * pos3[1] + m[2] * pos3[2] + full[4 * k + 3]
        dp = m[0] * dir3[0] + m[1] * dir3[1] + m[2] * dir3[2]
        return op, dp

    opx, dpx = prime(0)
    opy, dpy = prime(1)
    opz, dpz = prime(2)
    safe = dpz.abs() > 1e-12
    t_raw = torch.where(safe, -opz / torch.where(safe, dpz, 1.0), _BIG)
    beta = opx + t_raw * dpx
    gamma = opy + t_raw * dpy
    t = torch.where(hit, t_raw, _BIG)
    beta = torch.where(hit, beta, 0.0)
    gamma = torch.where(hit, gamma, 0.0)
    return t, beta, gamma, full[12:44] * hitf[None, :]


def segment_core_rows(
    pos3, dir3, tput, res, full, *, hit, act, u1, u2, urr, flags,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """The differentiable segment at fixed winners (JAX
    ``_segment_core_rows``): :func:`recompute_rows` + :func:`_epilogue`.
    Returns (new_pos, new_dir, new_tput, new_res) f32[3, R]."""
    t, beta, gamma, shade = recompute_rows(full, hit, pos3, dir3)
    return _epilogue(
        pos3, dir3, tput, res, t, beta, gamma, shade, hit=hit, act=act,
        u1=u1, u2=u2, urr=urr, flags=flags, mode=mode, illum=illum,
        eps_offset=eps_offset, refract_kd=refract_kd, phong_model=phong_model,
    )[:4]


def gather_rows(rows, idx):
    """The winners' rows, lane-major f32[48, R] (row 0 for a miss)."""
    return rows.detach().T.contiguous()[:, idx.clamp_min(0).long()]


def rows_segment_ref(
    rows, idx, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """Plain-torch segment from known winners ``idx`` i32[R] (−1 = miss)
    into ``rows`` f32[T, 48]: :func:`recompute_rows` and :func:`_epilogue`
    on ``rows[idx]``. Returns (new_pos, new_dir, new_tput, new_res f32[3, R],
    still f32[R])."""
    _check_options(mode, phong_model)
    hit = idx >= 0
    t, beta, gamma, shade = recompute_rows(gather_rows(rows, idx), hit, pos3, dir3)
    *out, still = _epilogue(
        pos3, dir3, tput, res, t, beta, gamma, shade, hit=hit, act=live,
        u1=u1, u2=u2, urr=urr, flags=flags, mode=mode, illum=illum,
        eps_offset=eps_offset, refract_kd=refract_kd, phong_model=phong_model,
    )
    return (*out, still.to(torch.float32))


def segment_backward_ref(
    pos3, dir3, tput, res, act, hit, full, u1, u2, urr, flags,
    ct_npos, ct_ndir, ct_ntput, ct_nres, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """Plain-torch segment vjp: ``torch.autograd.grad`` of
    :func:`segment_core_rows` with the given output cotangents. Returns
    (d_pos, d_dir, d_tput, d_res f32[3, R], d_full f32[48, R])."""
    _check_options(mode, phong_model)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in (pos3, dir3, tput, res, full)]
        outs = segment_core_rows(
            *xs, hit=hit, act=act, u1=u1, u2=u2, urr=urr, flags=flags,
            mode=mode, illum=illum, eps_offset=eps_offset,
            refract_kd=refract_kd, phong_model=phong_model,
        )
        grads = torch.autograd.grad(
            outs, xs, (ct_npos, ct_ndir, ct_ntput, ct_nres), allow_unused=True
        )
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads))


def segment_backward_rows_ref(
    pos3, dir3, tput, res, act, rows, idx, u1, u2, urr, flags,
    ct_npos, ct_ndir, ct_ntput, ct_nres, **kw,
):
    """Plain-torch :func:`segment_backward_rows`: :func:`segment_backward_ref`
    on the winners' rows gathered from ``rows`` f32[T, 48] by ``idx``
    i32[R] (−1 = miss)."""
    return segment_backward_ref(pos3, dir3, tput, res, act, idx >= 0, gather_rows(rows, idx),
                                u1, u2, urr, flags, ct_npos, ct_ndir, ct_ntput, ct_nres, **kw)


_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("segment_fused")
    fn = lib.mega_segment_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P, ctypes.c_int,  # rows, T
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # pos, dir, tput, res, live, u1, u2, urr, flags
        ctypes.c_int, ctypes.c_int,  # lane_flags, R
        ctypes.c_int, ctypes.c_float, ctypes.c_float,  # mode_rr, illum, eps_offset
        ctypes.c_int, ctypes.c_int,  # refract_kd, phong_reflect
        _P, _P, _P, _P, ctypes.c_int,  # clo, chi, cslack, rec, cull
        _P, _P, _P, _P, _P, _P,  # idx, npos, ndir, ntput, nres, still
        _P, _P,  # tested, stream
    ]
    return lib


@functools.cache
def _rows_lib() -> ctypes.CDLL:
    lib = cuda_build.load("rows_segment")
    fn = lib.rows_segment_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P, _P,  # rows, idx
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # pos, dir, tput, res, live, u1, u2, urr, flags
        ctypes.c_int, ctypes.c_int,  # lane_flags, R
        ctypes.c_int, ctypes.c_float, ctypes.c_float,  # mode_rr, illum, eps_offset
        ctypes.c_int, ctypes.c_int,  # refract_kd, phong_reflect
        _P, _P, _P, _P, _P,  # npos, ndir, ntput, nres, still
        _P,  # stream
    ]
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load("segment_backward")
    fn = lib.segment_backward_rows_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P, _P, _P, _P, _P, _P, _P,  # pos, dir, tput, res, act, rows, idx
        _P, _P, _P, _P,  # u1, u2, urr, flags
        _P, _P, _P, _P,  # cotangents of npos, ndir, ntput, nres
        ctypes.c_int,  # R
        ctypes.c_int, ctypes.c_float, ctypes.c_float,  # mode_rr, illum, eps_offset
        ctypes.c_int, ctypes.c_int,  # refract_kd, phong_reflect
        _P, _P, _P, _P, _P,  # d_pos, d_dir, d_tput, d_res, d_full
        _P,  # stream
    ]
    return lib


def _check_vectors(dev, R, vec3, vec1, masks, flags, lane_flags_ok=False) -> None:
    """Device, contiguity, dtype and shape checks shared by the kernel
    wrappers: f32[3, R] state, f32[R] uniforms, bool[R] masks, flags
    f32[3, 1] (or f32[3, R] where ``lane_flags_ok``)."""
    for x in (*vec3, *vec1, *masks, flags):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    for x in (*vec3, *vec1, flags):
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
    for x in masks:
        if x.dtype != torch.bool:
            raise TypeError(f"live/act/hit masks must be bool, got {x.dtype}")
    for x in vec3:
        if tuple(x.shape) != (3, R):
            raise ValueError(f"expected [3, {R}], got {tuple(x.shape)}")
    for x in (*vec1, *masks):
        if tuple(x.shape) != (R,):
            raise ValueError(f"expected [{R}], got {tuple(x.shape)}")
    shapes = ((3, 1), (3, R)) if lane_flags_ok else ((3, 1),)
    if tuple(flags.shape) not in shapes:
        raise ValueError(f"flags must be {' or '.join(map(str, shapes))}, "
                         f"got {tuple(flags.shape)}")
    if R >= 2**31:
        raise ValueError("R must fit in int32")


def _check_cuda_inputs(rows, vec3, vec1, live, flags) -> None:
    _check_vectors(vec3[0].device, vec3[0].shape[1], vec3, vec1, (live,), flags,
                   lane_flags_ok=True)
    _check_rows(rows, vec3[0].device)


def _check_rows(rows, dev) -> None:
    """The row table: a contiguous, 16-byte aligned f32[T, 48] on ``dev``
    (the kernels read it as float4)."""
    if rows.device != dev:
        raise ValueError(f"all inputs must be on {dev}, got {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("all inputs must be contiguous")
    if rows.dtype != torch.float32:
        raise TypeError(f"expected float32, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] != 48:
        raise ValueError(f"rows must be [T, 48], got {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned for float4 loads")
    if rows.shape[0] >= 2**31:
        raise ValueError("R and T must fit in int32")


def _check_idx(idx, R, dev) -> None:
    """The winner index: a contiguous int32 [R] on ``dev``."""
    if idx.device != dev or idx.dtype != torch.int32 \
            or tuple(idx.shape) != (R,) or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous int32 [{R}] tensor on {dev}")


def check_chunk_boxes(rows, clo, chi, cslack, chunk=128) -> None:
    """Chunk boxes f32[ceil(T / chunk), 3] and their slack f32[ceil(T /
    chunk), 2] (:func:`.cull.chunk_slack`) on the table's device, for the
    culling kernels (B1c, B4c)."""
    nc = -(-rows.shape[0] // chunk)
    if cslack is None:
        raise ValueError("chunk boxes need their slack cslack (ops.cull.chunk_slack)")
    for x, w in ((clo, 3), (chi, 3), (cslack, 2)):
        if x.device != rows.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"chunk boxes and slack must be contiguous float32 on "
                             f"{rows.device}")
        if tuple(x.shape) != (nc, w):
            raise ValueError(f"chunk boxes and slack must be [{nc}, 3] and [{nc}, 2] for "
                             f"{rows.shape[0]} triangles, got {tuple(x.shape)}")


def check_tested(tested, R, dev, block=128) -> None:
    """The per-block chunk counts: a contiguous int32 [ceil(R / block)] on ``dev``."""
    nb = -(-R // block)
    if tested.device != dev or tested.dtype != torch.int32 or tuple(tested.shape) != (nb,) \
            or not tested.is_contiguous():
        raise ValueError(f"tested must be a contiguous int32 [{nb}] tensor on {dev}")


def _mega_segment_cuda(
    rows, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode, illum, eps_offset, refract_kd, phong_model, clo, chi, cslack, crec, tested,
):
    from . import cull as CU

    _check_options(mode, phong_model)
    _check_cuda_inputs(rows, (pos3, dir3, tput, res), (u1, u2, urr), live, flags)
    R = pos3.shape[1]
    dev = pos3.device
    cull = clo is not None
    if cull:
        check_chunk_boxes(rows, clo, chi, cslack)
        if crec is None:
            crec = CU.cull_records(rows)
        CU.check_records(crec, rows)
    if tested is not None:
        check_tested(tested, R, dev)
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
            flags.data_ptr(), int(flags.shape[1] != 1), R,
            int(mode == "rr"), float(illum), float(eps_offset),
            int(bool(refract_kd)), int(phong_model == "phong"),
            *((clo.data_ptr(), chi.data_ptr(), cslack.data_ptr(), crec.data_ptr()) if cull
              else (None,) * 4),
            int(cull), idx.data_ptr(), npos.data_ptr(), ndir.data_ptr(),
            ntput.data_ptr(), nres.data_ptr(), still.data_ptr(),
            None if tested is None else tested.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mega_segment kernel launch failed: cudaError {err}")
    lane = flags.shape[1] != 1
    if lane:
        count_launch("B1l")
    if cull:
        count_launch("B1c")
    if not (lane or cull):
        count_launch("B1")
        if in_primal():
            count_launch("B1p")
    return idx, npos, ndir, ntput, nres, still


def mega_segment(
    rows, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn", clo=None, chi=None,
    cslack=None, crec=None, tested=None,
):
    """Whole-segment forward (see the module docstring). CUDA tensors
    launch the kernel and count it as B1 (and as B1p too inside
    :func:`..utils.profiling.primal`), or as B1l with per-lane flags
    and as B1c with chunk boxes (both with both); CPU tensors run
    :func:`mega_segment_ref`.

    ``tested``, on CUDA only: an int32 [ceil(R / 128)] tensor that the
    kernel fills with the 128-triangle chunks each group of 128 rays
    (rays ``128 g`` to ``128 g + 127``) tested."""
    kw = dict(mode=mode, illum=illum, eps_offset=eps_offset,
              refract_kd=refract_kd, phong_model=phong_model, clo=clo, chi=chi,
              cslack=cslack, crec=crec, tested=tested)
    args = (rows, pos3, dir3, tput, res, live, u1, u2, urr, flags)
    if pos3.device.type == "cuda":
        return _mega_segment_cuda(*args, **kw)
    if pos3.device.type == "cpu":
        return mega_segment_ref(*args, **kw)
    raise ValueError(f"no segment kernel for device {pos3.device}")


def _rows_segment_cuda(
    rows, idx, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode, illum, eps_offset, refract_kd, phong_model,
):
    _check_options(mode, phong_model)
    _check_cuda_inputs(rows, (pos3, dir3, tput, res), (u1, u2, urr), live, flags)
    R = pos3.shape[1]
    _check_idx(idx, R, pos3.device)
    npos, ndir, ntput, nres = (torch.empty_like(pos3) for _ in range(4))
    still = torch.empty(R, dtype=torch.float32, device=pos3.device)
    lib = _rows_lib()
    with torch.cuda.device(pos3.device):
        stream = torch.cuda.current_stream(pos3.device).cuda_stream
        err = lib.rows_segment_launch(
            rows.data_ptr(), idx.data_ptr(),
            pos3.data_ptr(), dir3.data_ptr(), tput.data_ptr(), res.data_ptr(),
            live.data_ptr(), u1.data_ptr(), u2.data_ptr(), urr.data_ptr(),
            flags.data_ptr(), int(flags.shape[1] != 1), R,
            int(mode == "rr"), float(illum), float(eps_offset),
            int(bool(refract_kd)), int(phong_model == "phong"),
            npos.data_ptr(), ndir.data_ptr(), ntput.data_ptr(), nres.data_ptr(),
            still.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"rows_segment kernel launch failed: cudaError {err}")
    count_launch("B6l" if flags.shape[1] != 1 else "B6")
    return npos, ndir, ntput, nres, still


def rows_segment(
    rows, idx, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """Segment from known winners (JAX ``rows_segment_fwd``): the winners
    ``idx`` i32[R] index ``rows`` f32[T, 48]; flags f32[3, 1] or f32[3, R].
    Returns (new_pos, new_dir, new_tput, new_res f32[3, R], still f32[R]).
    CUDA tensors launch ``csrc/rows_segment.cu`` (which reads the
    winners' rows itself) and count it as B6, or as B6l with per-lane
    flags; CPU tensors run :func:`rows_segment_ref`."""
    kw = dict(mode=mode, illum=illum, eps_offset=eps_offset,
              refract_kd=refract_kd, phong_model=phong_model)
    args = (rows, idx, pos3, dir3, tput, res, live, u1, u2, urr, flags)
    if pos3.device.type == "cuda":
        return _rows_segment_cuda(*args, **kw)
    if pos3.device.type == "cpu":
        return rows_segment_ref(*args, **kw)
    raise ValueError(f"no rows_segment kernel for device {pos3.device}")


def _segment_backward_cuda(
    pos3, dir3, tput, res, act, hit, full, u1, u2, urr, flags,
    ct_npos, ct_ndir, ct_ntput, ct_nres, **kw,
):
    """B2 on the gathered rows: the copy ``full`` f32[48, R] is itself a
    table, lane r's row at row r, read through the index r where ``hit``
    (the same floats, so the outputs are those of the gathered rows)."""
    R, dev = pos3.shape[1], pos3.device
    _check_vectors(dev, R, (), (), (hit,), flags)
    if full.device != dev or not full.is_contiguous():
        raise ValueError(f"full must be a contiguous tensor on {dev}")
    if full.dtype != torch.float32:
        raise TypeError(f"full must be float32, got {full.dtype}")
    if tuple(full.shape) != (48, R):
        raise ValueError(f"full must be [48, {R}], got {tuple(full.shape)}")
    idx = torch.where(hit, torch.arange(R, dtype=torch.int32, device=dev), -1).int()
    return segment_backward_rows(pos3, dir3, tput, res, act, full.T.contiguous(), idx,
                                 u1, u2, urr, flags, ct_npos, ct_ndir, ct_ntput, ct_nres, **kw)


def segment_backward(
    pos3, dir3, tput, res, act, hit, full, u1, u2, urr, flags,
    ct_npos, ct_ndir, ct_ntput, ct_nres, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """Whole-segment vjp (JAX ``segment_backward``): given the segment
    inputs, the gathered winner rows ``full`` f32[48, R] and the four
    output cotangents, returns (d_pos, d_dir, d_tput, d_res f32[3, R],
    d_full f32[48, R]). CUDA tensors run :func:`segment_backward_rows`
    with ``full`` as the table (B2, one launch); CPU tensors run
    :func:`segment_backward_ref`."""
    kw = dict(mode=mode, illum=illum, eps_offset=eps_offset,
              refract_kd=refract_kd, phong_model=phong_model)
    args = (pos3, dir3, tput, res, act, hit, full, u1, u2, urr, flags,
            ct_npos, ct_ndir, ct_ntput, ct_nres)
    if pos3.device.type == "cuda":
        return _segment_backward_cuda(*args, **kw)
    if pos3.device.type == "cpu":
        return segment_backward_ref(*args, **kw)
    raise ValueError(f"no segment backward kernel for device {pos3.device}")


def _segment_backward_rows_cuda(
    pos3, dir3, tput, res, act, rows, idx, u1, u2, urr, flags,
    ct_npos, ct_ndir, ct_ntput, ct_nres, *,
    mode, illum, eps_offset, refract_kd, phong_model,
):
    _check_options(mode, phong_model)
    R = pos3.shape[1]
    dev = pos3.device
    cts = (ct_npos, ct_ndir, ct_ntput, ct_nres)
    _check_vectors(dev, R, (pos3, dir3, tput, res, *cts), (u1, u2, urr), (act,), flags)
    _check_rows(rows, dev)
    _check_idx(idx, R, dev)
    d_pos, d_dir, d_tput, d_res = (torch.empty_like(pos3) for _ in range(4))
    d_full = torch.empty(48, R, dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_backward_rows_launch(
            *(x.data_ptr() for x in (pos3, dir3, tput, res, act, rows, idx, u1, u2, urr, flags,
                                     *cts)), R,
            int(mode == "rr"), float(illum), float(eps_offset),
            int(bool(refract_kd)), int(phong_model == "phong"),
            d_pos.data_ptr(), d_dir.data_ptr(), d_tput.data_ptr(),
            d_res.data_ptr(), d_full.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_backward kernel launch failed: cudaError {err}")
    count_launch("B2")
    return d_pos, d_dir, d_tput, d_res, d_full


def segment_backward_rows(
    pos3, dir3, tput, res, act, rows, idx, u1, u2, urr, flags,
    ct_npos, ct_ndir, ct_ntput, ct_nres, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """Whole-segment vjp from the row table ``rows`` f32[T, 48] and the
    winner index ``idx`` i32[R] (−1 = miss) in place of
    :func:`segment_backward`'s ``hit`` and ``full``; the same outputs.
    CUDA tensors launch ``csrc/segment_backward.cu``, which reads each
    lane's row through the index, and count it as B2; CPU tensors run
    :func:`segment_backward_rows_ref`."""
    kw = dict(mode=mode, illum=illum, eps_offset=eps_offset,
              refract_kd=refract_kd, phong_model=phong_model)
    args = (pos3, dir3, tput, res, act, rows, idx, u1, u2, urr, flags,
            ct_npos, ct_ndir, ct_ntput, ct_nres)
    if pos3.device.type == "cuda":
        return _segment_backward_rows_cuda(*args, **kw)
    if pos3.device.type == "cpu":
        return segment_backward_rows_ref(*args, **kw)
    raise ValueError(f"no segment backward kernel for device {pos3.device}")


class WholeSegment(torch.autograd.Function):
    """The differentiable whole segment (JAX ``_make_whole_segment``).

    Forward: :func:`mega_segment` (B1, or B1c given chunk boxes), saving
    the winner index and the inputs. Backward: :func:`segment_backward_rows`
    (B2, reading the winners' rows through the index) and
    :func:`.scatter_rows.scatter_rows` into d_rows f32[T, 48]. The index,
    ``still``, the masks, the uniforms, the flags and the chunk boxes carry
    no gradient (the winner is piecewise constant in the geometry)."""

    @staticmethod
    def forward(ctx, rows, pos3, dir3, tput, res, live, u1, u2, urr, flags, clo, chi, cslack,
                crec, kw):
        out = mega_segment(rows, pos3, dir3, tput, res, live, u1, u2, urr, flags,
                           clo=clo, chi=chi, cslack=cslack, crec=crec, **kw)
        ctx.save_for_backward(out[0], rows, pos3, dir3, tput, res, live, u1, u2,
                              urr, flags)
        ctx.kw = kw
        ctx.mark_non_differentiable(out[0], out[5])
        return out

    @staticmethod
    def backward(ctx, _idx, ct_npos, ct_ndir, ct_ntput, ct_nres, _still):
        d_rows, d_state = _segment_vjp(ctx, (ct_npos, ct_ndir, ct_ntput, ct_nres))
        return (d_rows, *d_state, *(None,) * 10)


def _segment_vjp(ctx, cts):
    """The backward shared by :class:`WholeSegment` and
    :class:`WholeSegmentRows`: :func:`segment_backward_rows` (the winners'
    rows read through the index) and :func:`scatter_rows` when ``rows``
    needs a gradient. Returns (d_rows, (d_pos, d_dir, d_tput, d_res))."""
    idx, rows, pos3, dir3, tput, res, live, u1, u2, urr, flags = ctx.saved_tensors
    d_pos, d_dir, d_tput, d_res, d_full = segment_backward_rows(
        pos3, dir3, tput, res, live, rows, idx,
        u1, u2, urr, flags, *(c.contiguous() for c in cts), **ctx.kw,
    )
    d_rows = scatter_rows(idx, d_full, rows.shape[0]) if ctx.needs_input_grad[0] else None
    return d_rows, (d_pos, d_dir, d_tput, d_res)


def whole_segment_megakernel(
    rows, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn", clo=None, chi=None, cslack=None,
    crec=None,
):
    """Differentiable whole segment (JAX ``whole_segment_megakernel``):
    the outputs of :func:`mega_segment`, with gradients to ``rows`` and
    the ray state through :class:`WholeSegment`; chunk boxes ``clo``,
    ``chi``, their slack ``cslack`` and the records ``crec`` select the
    culling kernel B1c."""
    _check_options(mode, phong_model)
    kw = dict(mode=mode, illum=float(illum), eps_offset=float(eps_offset),
              refract_kd=bool(refract_kd), phong_model=phong_model)
    return WholeSegment.apply(rows, pos3, dir3, tput, res, live, u1, u2, urr,
                              flags, clo, chi, cslack, crec, kw)


class WholeSegmentRows(torch.autograd.Function):
    """The differentiable segment from known winners (JAX
    ``_make_whole_segment_rows``), the traversal path's: forward
    :func:`rows_segment` on the detached index, backward that of
    :class:`WholeSegment` (B2 through the index, and B3)."""

    @staticmethod
    def forward(ctx, rows, idx, pos3, dir3, tput, res, live, u1, u2, urr, flags, kw):
        out = rows_segment(rows, idx, pos3, dir3, tput, res, live, u1, u2,
                           urr, flags, **kw)
        ctx.save_for_backward(idx, rows, pos3, dir3, tput, res, live, u1, u2, urr, flags)
        ctx.kw = kw
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    def backward(ctx, ct_npos, ct_ndir, ct_ntput, ct_nres, _still):
        d_rows, d_state = _segment_vjp(ctx, (ct_npos, ct_ndir, ct_ntput, ct_nres))
        return (d_rows, None, *d_state, None, None, None, None, None, None)


def whole_segment_rows(
    rows, idx, pos3, dir3, tput, res, live, u1, u2, urr, flags, *,
    mode: str = "fixed", illum: float = 10.0, eps_offset: float = 0.01,
    refract_kd: bool = True, phong_model: str = "blinn",
):
    """Differentiable segment from known winners (JAX
    ``whole_segment_rows``): the outputs of :func:`rows_segment`, with
    gradients to ``rows`` and the ray state through
    :class:`WholeSegmentRows`. ``idx`` carries none."""
    _check_options(mode, phong_model)
    kw = dict(mode=mode, illum=float(illum), eps_offset=float(eps_offset),
              refract_kd=bool(refract_kd), phong_model=phong_model)
    return WholeSegmentRows.apply(rows, idx, pos3, dir3, tput, res, live, u1, u2,
                                  urr, flags, kw)

"""Intersectors of the split path: the nearest hit without the segment
epilogue, and the fused intersector's index.

The counterpart of the split-path half of
``montecarlopathtracer_tpu/ops/intersect_pallas.py``.

Nearest hit with the winner's values and shading row (JAX
``nearest_shade_full``, Pallas kernel ``_mega_kernel_v4``):

- :func:`nearest_shade_full` is the entry point. For CUDA tensors it
  launches ``csrc/nearest_shade.cu`` (B4; given the chunk boxes ``clo``,
  ``chi`` of a Morton-ordered table, the culling instance B4c); for CPU
  tensors it runs :func:`nearest_shade_full_ref`. It never falls back
  from one to the other.
- :func:`nearest_shade_full_ref` is the plain version: brute f32
  selection and a gather of the winner's row.
- :func:`recompute_winner` (JAX ``_recompute_winner``) is the same
  function of fixed winners, differentiable: a gather of the winner rows
  and :func:`.segment_fused.recompute_rows`; its backward scatters the
  row cotangents with :func:`.scatter_rows.scatter_rows` (B3). The
  traversal path's split intersector is B5's index followed by it.
- :class:`NearestShadeFull` / :func:`nearest_shade_full_diff` (JAX
  ``_make_diff_megakernel``) is the differentiable intersector: forward
  B4, backward that of :func:`recompute_winner` at the kernel's winners.

Nearest index only (JAX ``nearest_triangle``, Pallas kernel
``_nearest_kernel``), the fused intersector:

- :func:`nearest_triangle` launches ``csrc/nearest_triangle.cu`` (B7)
  for CUDA tensors and runs :func:`nearest_triangle_ref` for CPU ones,
  over the geometry table of :func:`pack_geom_rows`;
- :func:`intersect_fused` is B7's index, detached, then
  :func:`refine_hit`, the differentiable recompute of (t, β, γ, point)
  from the winner's transform, returning a :class:`.intersect.Hit`.

Data contract (that of the JAX functions): the outputs of
:func:`nearest_shade_full` are (idx i32[R] (−1 = miss), tbg f32[4, R] =
(t or 3e38, β·hit, γ·hit, hit), shade f32[32, R] = the winner's row
``rows[idx, 12:44]``, 0 on a miss). A lane that is not live comes back
as a miss.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .intersect import Hit
from .scatter_rows import scatter_rows
from .segment_fused import (
    _BIG,
    _select_ref,
    check_chunk_boxes,
    check_tested,
    gather_rows,
    recompute_rows,
)

_P = ctypes.c_void_p
_DET_EPS = 1e-12


def nearest_shade_full_ref(rows, pos3, dir3, live, clo=None, chi=None, *, tested=None,
                           dz_test=False):
    """Plain version of :func:`nearest_shade_full`: brute f32 selection
    over ``rows`` f32[T, 48] and a gather of the winner's shading row.
    ``clo``, ``chi`` are accepted and not needed: culling never changes
    the winners."""
    if tested is not None:
        raise ValueError("chunk counts come from the kernel; the plain version "
                         "tests every triangle")
    best_t, best_i, best_b, best_g = _select_ref(rows, pos3, dir3, dz_test=dz_test)
    hit = (best_t < _BIG) & live
    hitf = hit.to(torch.float32)
    idx = torch.where(hit, best_i, -1).to(torch.int32)
    tbg = torch.stack([torch.where(hit, best_t, _BIG), best_b * hitf, best_g * hitf, hitf])
    return idx, tbg, rows[best_i, 12:44].T * hitf[None, :]


@functools.cache
def _shade_lib() -> ctypes.CDLL:
    lib = cuda_build.load("nearest_shade")
    fn = lib.nearest_shade_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P, ctypes.c_int,  # rows, T
        _P, _P, _P, ctypes.c_int,  # pos, dir, live, R
        _P, _P, ctypes.c_int, ctypes.c_int,  # clo, chi, cull, dz_test
        _P, _P, _P, _P, _P,  # idx, tbg, shade, tested, stream
    ]
    return lib


def _check_rays(dev, R, pos3, dir3, live=None) -> None:
    for x in (pos3, dir3):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"pos3 and dir3 must be contiguous tensors on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
        if tuple(x.shape) != (3, R):
            raise ValueError(f"expected [3, {R}], got {tuple(x.shape)}")
    if live is not None:
        if live.device != dev or not live.is_contiguous() or tuple(live.shape) != (R,):
            raise ValueError(f"live must be a contiguous [{R}] tensor on {dev}")
        if live.dtype != torch.bool:
            raise TypeError(f"live must be bool, got {live.dtype}")
    if R >= 2**31:
        raise ValueError("R must fit in int32")


def _check_table(table, dev, width) -> None:
    if table.device != dev or not table.is_contiguous():
        raise ValueError(f"the triangle table must be a contiguous tensor on {dev}")
    if table.dtype != torch.float32:
        raise TypeError(f"the triangle table must be float32, got {table.dtype}")
    if table.dim() != 2 or table.shape[1] != width or not 0 < table.shape[0] < 2**31:
        raise ValueError(f"the triangle table must be [T, {width}], got {tuple(table.shape)}")
    if table.data_ptr() % 16:
        raise ValueError("the triangle table must be 16-byte aligned for float4 loads")


def _nearest_shade_full_cuda(rows, pos3, dir3, live, clo, chi, tested, dz_test):
    dev = pos3.device
    R = pos3.shape[1]
    _check_rays(dev, R, pos3, dir3, live)
    _check_table(rows, dev, 48)
    cull = clo is not None
    if cull:
        check_chunk_boxes(rows, clo, chi)
    if tested is not None:
        check_tested(tested, R, dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    tbg = torch.empty(4, R, device=dev)
    shade = torch.empty(32, R, device=dev)
    lib = _shade_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nearest_shade_launch(
            rows.data_ptr(), rows.shape[0], pos3.data_ptr(), dir3.data_ptr(),
            live.data_ptr(), R, clo.data_ptr() if cull else None,
            chi.data_ptr() if cull else None, int(cull), int(bool(dz_test)), idx.data_ptr(),
            tbg.data_ptr(), shade.data_ptr(), None if tested is None else tested.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"nearest_shade kernel launch failed: cudaError {err}")
    nearest_shade_full.launches += 1
    nearest_shade_full.cull_launches += cull
    return idx, tbg, shade


def nearest_shade_full(rows, pos3, dir3, live, clo=None, chi=None, *, tested=None,
                       dz_test=False):
    """Nearest hit per ray of ``pos3``, ``dir3`` f32[3, R] (``live``
    bool[R]) over ``rows`` f32[T, 48]: (idx, tbg, shade) as the module
    docstring says. CUDA tensors launch B4, or B4c given the chunk boxes
    ``clo``, ``chi`` f32[ceil(T / 128), 3] of a Morton-ordered table,
    and add one to
    ``nearest_shade_full.launches`` (and to ``.cull_launches`` for B4c);
    CPU tensors run :func:`nearest_shade_full_ref`. ``dz_test`` adds the
    explicit |d'_z| > 1e-12 test (JAX ``nearest_shade_culled``).

    ``tested``, on CUDA only: an int32 [ceil(R / 128)] tensor that the
    kernel fills with the 128-triangle chunks each block of 128 rays
    tested."""
    if pos3.device.type == "cuda":
        return _nearest_shade_full_cuda(rows, pos3, dir3, live, clo, chi, tested, dz_test)
    if pos3.device.type == "cpu":
        return nearest_shade_full_ref(rows, pos3, dir3, live, clo, chi, tested=tested,
                                      dz_test=dz_test)
    raise ValueError(f"no nearest_shade kernel for device {pos3.device}")


nearest_shade_full.launches = 0  # B4 and B4c
nearest_shade_full.cull_launches = 0  # of which with chunk culling (B4c)


def _winner_values(full, hit, pos3, dir3):
    """(tbg f32[4, R], shade f32[32, R]) from the gathered winner rows
    ``full`` f32[48, R] (JAX ``_recompute_from_full``): elementwise."""
    t, beta, gamma, shade = recompute_rows(full, hit, pos3, dir3)
    return torch.stack([t, beta, gamma, hit.to(torch.float32)]), shade


def _winner_vjp(ctx, ct_tbg, ct_shade):
    """Backward of :class:`RecomputeWinner` and :class:`NearestShadeFull`:
    one gather of the winner rows, torch's vjp of the elementwise
    :func:`_winner_values`, and :func:`scatter_rows` of the row
    cotangents into d_rows f32[T, 48] when ``rows`` needs a gradient.
    Returns (d_rows, d_pos, d_dir)."""
    idx, rows, pos3, dir3 = ctx.saved_tensors
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in (gather_rows(rows, idx), pos3, dir3)]
        outs = _winner_values(xs[0], idx >= 0, xs[1], xs[2])
        d_full, d_pos, d_dir = torch.autograd.grad(outs, xs, (ct_tbg, ct_shade),
                                                   allow_unused=True)
    d_rows = None
    if ctx.needs_input_grad[0]:
        d_rows = scatter_rows(idx, d_full.contiguous(), rows.shape[0])
    return d_rows, d_pos, d_dir


class RecomputeWinner(torch.autograd.Function):
    """:func:`recompute_winner` with the row gather's transpose as the row
    scatter B3 (JAX ``_recompute_winner_vjp``)."""

    @staticmethod
    def forward(ctx, rows, idx, pos3, dir3):
        ctx.save_for_backward(idx, rows, pos3, dir3)
        return _winner_values(gather_rows(rows, idx), idx >= 0, pos3, dir3)

    @staticmethod
    def backward(ctx, ct_tbg, ct_shade):
        d_rows, d_pos, d_dir = _winner_vjp(ctx, ct_tbg, ct_shade)
        return d_rows, None, d_pos, d_dir


def recompute_winner(rows, idx, pos3, dir3):
    """(tbg, shade) of :func:`nearest_shade_full` for fixed winners ``idx``
    i32[R] (−1 = miss) into ``rows`` f32[T, 48], differentiable in
    ``rows``, ``pos3`` and ``dir3``; ``idx`` carries no gradient."""
    return RecomputeWinner.apply(rows, idx, pos3, dir3)


class NearestShadeFull(torch.autograd.Function):
    """The differentiable intersector (JAX ``_make_diff_megakernel``):
    forward :func:`nearest_shade_full` (B4 or B4c); backward the vjp of
    :func:`recompute_winner` at its winners (a row gather, elementwise
    torch autograd, B3). The index, ``live`` and the chunk boxes carry no
    gradient."""

    @staticmethod
    def forward(ctx, rows, pos3, dir3, live, clo, chi):
        idx, tbg, shade = nearest_shade_full(rows, pos3, dir3, live, clo, chi)
        ctx.save_for_backward(idx, rows, pos3, dir3)
        ctx.mark_non_differentiable(idx)
        return idx, tbg, shade

    @staticmethod
    def backward(ctx, _idx, ct_tbg, ct_shade):
        d_rows, d_pos, d_dir = _winner_vjp(ctx, ct_tbg, ct_shade)
        return d_rows, d_pos, d_dir, None, None, None


def nearest_shade_full_diff(rows, pos3, dir3, live, clo=None, chi=None):
    """:func:`nearest_shade_full` with gradients to ``rows`` and the rays
    through :class:`NearestShadeFull`."""
    return NearestShadeFull.apply(rows, pos3, dir3, live, clo, chi)


def pack_geom_rows(m, m_a, tri_valid) -> torch.Tensor:
    """Geometry table f32[T, 12] (JAX ``pack_geom_rows``): row t is
    [m_k0 m_k1 m_k2 −m_a_k] for k = 0..2, zero for an invalid triangle
    (``rows[:, 0:12]`` of :func:`.segment_fused.pack_rows_full`)."""
    geom = torch.cat([m, -m_a[:, :, None]], dim=2).reshape(-1, 12)
    return (geom * tri_valid[:, None].to(geom.dtype)).contiguous()


def nearest_triangle_ref(geom, pos3, dir3):
    """Plain version of :func:`nearest_triangle`: brute f32 selection with
    JAX ``_nearest_kernel``'s accept test (|d'_z| > 1e-12, β > 0, γ > 0,
    β + γ < 1, t > 0; ties to the smallest index). Returns i32[R]."""
    T = geom.shape[0]
    cols = torch.arange(T, device=geom.device)
    out = []
    step = max(1, min(8192, (1 << 26) // max(T, 1)))
    for s in range(0, pos3.shape[1], step):
        o = pos3[:, s:s + step, None]
        d = dir3[:, s:s + step, None]
        op = [geom[:, 4 * k] * o[0] + geom[:, 4 * k + 1] * o[1] + geom[:, 4 * k + 2] * o[2]
              + geom[:, 4 * k + 3] for k in range(3)]
        dp = [geom[:, 4 * k] * d[0] + geom[:, 4 * k + 1] * d[1] + geom[:, 4 * k + 2] * d[2]
              for k in range(3)]
        dz_ok = dp[2].abs() > _DET_EPS
        t = torch.where(dz_ok, -op[2] / torch.where(dz_ok, dp[2], 1.0), -1.0)
        beta = op[0] + t * dp[0]
        gamma = op[1] + t * dp[1]
        ok = dz_ok & (beta > 0.0) & (gamma > 0.0) & (beta + gamma < 1.0) & (t > 0.0)
        tm = torch.where(ok, t, _BIG)
        best = tm.amin(dim=1)
        idx = torch.where(tm == best[:, None], cols, T).amin(dim=1)
        out.append(torch.where(best < _BIG, idx, -1))
    return torch.cat(out).to(torch.int32)


@functools.cache
def _triangle_lib() -> ctypes.CDLL:
    lib = cuda_build.load("nearest_triangle")
    fn = lib.nearest_triangle_launch
    fn.restype = ctypes.c_int
    # geom, T, pos, dir, R, idx, stream
    fn.argtypes = [_P, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P]
    return lib


def _nearest_triangle_cuda(geom, pos3, dir3):
    dev = pos3.device
    R = pos3.shape[1]
    _check_rays(dev, R, pos3, dir3)
    _check_table(geom, dev, 12)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    lib = _triangle_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nearest_triangle_launch(geom.data_ptr(), geom.shape[0], pos3.data_ptr(),
                                          dir3.data_ptr(), R, idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nearest_triangle kernel launch failed: cudaError {err}")
    nearest_triangle.launches += 1
    return idx


def nearest_triangle(geom, pos3, dir3):
    """Index i32[R] of the nearest accepted triangle of ``geom`` f32[T, 12]
    (:func:`pack_geom_rows`) per ray of ``pos3``, ``dir3`` f32[3, R], −1
    for a miss. CUDA tensors launch B7 and add one to
    ``nearest_triangle.launches``; CPU tensors run
    :func:`nearest_triangle_ref`."""
    if pos3.device.type == "cuda":
        return _nearest_triangle_cuda(geom, pos3, dir3)
    if pos3.device.type == "cpu":
        return nearest_triangle_ref(geom, pos3, dir3)
    raise ValueError(f"no nearest_triangle kernel for device {pos3.device}")


nearest_triangle.launches = 0


def refine_hit(m, m_a, origins, dirs, tri_id) -> Hit:
    """(t, β, γ, point) of the chosen triangles ``tri_id`` i32[R] (−1 =
    miss), differentiable in ``m`` f32[T, 3, 3], ``m_a`` f32[T, 3] and the
    rays ``origins``, ``dirs`` f32[R, 3] (JAX ``refine_hit``). Elementwise
    multiply-adds, never a matmul, so no TF32 path can touch it; a miss
    has t = inf, β = γ = 0 and point = origin."""
    tid = tri_id.clamp_min(0).long()
    mw = m[tid]  # (R, 3, 3)
    o_p = (mw * origins[:, None, :]).sum(dim=-1) - m_a[tid]
    d_p = (mw * dirs[:, None, :]).sum(dim=-1)
    dz = d_p[:, 2]
    safe = dz.abs() > _DET_EPS
    t = torch.where(safe, -o_p[:, 2] / torch.where(safe, dz, 1.0), torch.inf)
    beta = o_p[:, 0] + t * d_p[:, 0]
    gamma = o_p[:, 1] + t * d_p[:, 1]
    miss = tri_id < 0
    t = torch.where(miss, torch.inf, t)
    point = origins + torch.where(miss, 0.0, t)[:, None] * dirs
    return Hit(tri_id=tri_id, t=t, beta=torch.where(miss, 0.0, beta),
               gamma=torch.where(miss, 0.0, gamma), point=point)


def intersect_fused(m, m_a, tri_valid, origins, dirs, geom=None) -> Hit:
    """Drop-in for :func:`.intersect.intersect_brute` backed by B7 (JAX
    ``intersect_fused``): the winners from :func:`nearest_triangle` on the
    detached geometry table (``geom``, or :func:`pack_geom_rows` of the
    transforms), then :func:`refine_hit`, whose (t, β, γ, point) are
    differentiable in the transforms and the rays."""
    if geom is None:
        geom = pack_geom_rows(m.detach(), m_a.detach(), tri_valid)
    tri_id = nearest_triangle(geom.detach(), origins.detach().T.contiguous(),
                              dirs.detach().T.contiguous())
    return refine_hit(m, m_a, origins, dirs, tri_id)

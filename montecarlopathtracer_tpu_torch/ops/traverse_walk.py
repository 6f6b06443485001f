"""Nearest-hit selection for large scenes: a front-to-back walk over
Morton chunks of triangles, one ray tile at a time.

The counterpart of ``montecarlopathtracer_tpu/ops/traverse_pallas.py``
(Pallas kernel ``_traverse_kernel``, entry ``traverse_select``). The
triangle axis is in Morton order (:func:`.morton.morton_order`), so a
chunk of :data:`CHUNK` consecutive triangles is spatially tight and its
box (:func:`.morton.chunk_aabbs_padded`) culls well.

- :func:`tile_chunk_order` (torch ops, any device): for each tile of
  :data:`RAY_TILE` rays, the chunks that some live ray of the tile can
  reach, sorted front to back by a lower bound on the hit distance.
- :func:`traverse_select` is the entry point. For CUDA tensors it
  builds the lists and launches ``csrc/traverse_select.cu``, which walks
  each tile's list with a per-lane slab test and stops early; for CPU
  tensors it runs :func:`traverse_select_ref`. It never falls back from one to
  the other.
- :func:`traverse_select_ref` is the plain version: brute f32 selection
  over the same permuted table.

Both return the winner's index in the permuted order, −1 for a miss and
for a lane that is not live. The kernel's winner is the least (t, index)
pair, the brute selection's rule, so the two agree except where f32
rounding parts them (near-ties). The TPU kernel's lane groups, DMA depth
and walk unrolling are TPU knobs and are not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .segment_fused import _select_ref

CHUNK = 128  # triangles per Morton chunk
RAY_TILE = 128  # rays per tile: the kernel's block
_BIG = 3.0e38


def tile_chunk_order(pos3, dir3, live, clo, chi):
    """Per-tile front-to-back chunk lists (JAX ``tile_chunk_order`` with
    no lane groups).

    ``pos3``, ``dir3`` f32[3, R] with R a multiple of :data:`RAY_TILE`,
    ``live`` bool[R], chunk boxes ``clo``, ``chi`` f32[nc, 3]. Returns
    ``(order i32[nt, nc], tmin f32[nt, nc], n_reach i32[nt])``: tile i
    reaches the chunks ``order[i, :n_reach[i]]``, whose ``tmin`` (the
    distance between the box of the tile's live origins and the chunk's
    box) ascends.

    - reach: a chunk is dropped only on an axis where it lies strictly
      beyond the origin box and no live direction points towards it;
    - tmin lower-bounds the distance t of any hit in the chunk for unit
      directions, which makes the walk's early exit sound.
    """
    R = pos3.shape[1]
    if R % RAY_TILE:
        raise ValueError(f"{R} rays do not divide into tiles of {RAY_TILE}")
    nt = R // RAY_TILE
    lv = live.reshape(nt, 1, RAY_TILE)
    p = pos3.reshape(3, nt, RAY_TILE).transpose(0, 1)  # [nt, 3, rt]
    d = dir3.reshape(3, nt, RAY_TILE).transpose(0, 1)
    olo = torch.where(lv, p, _BIG).amin(dim=2)  # [nt, 3]
    ohi = torch.where(lv, p, -_BIG).amax(dim=2)
    dlo = torch.where(lv, d, _BIG).amin(dim=2)
    dhi = torch.where(lv, d, -_BIG).amax(dim=2)
    any_live = lv.any(dim=2)  # [nt, 1]

    g_hi = clo[None, :, :] - ohi[:, None, :]  # [nt, nc, 3]
    g_lo = olo[:, None, :] - chi[None, :, :]
    ax_ok = ~(((g_hi > 0.0) & (dhi[:, None, :] <= 0.0))
              | ((g_lo > 0.0) & (dlo[:, None, :] >= 0.0)))
    reach = ax_ok.all(dim=2) & any_live
    gap = torch.clamp_min(torch.maximum(g_hi, g_lo), 0.0)
    gap2 = gap * gap
    tmin = torch.sqrt(gap2[..., 0] + gap2[..., 1] + gap2[..., 2])

    key = torch.where(reach, tmin, _BIG)
    order = torch.argsort(key, dim=1, stable=True)
    tmins = torch.gather(key, 1, order)
    n_reach = reach.sum(dim=1, dtype=torch.int32)
    return order.to(torch.int32), tmins, n_reach


def traverse_select_ref(rows, clo, chi, pos3, dir3, live):
    """Plain version: brute f32 selection over the permuted table
    ``rows`` f32[T, 48] (the chunk boxes are not needed). Returns
    i32[R]."""
    best_t, best_i, _, _ = _select_ref(rows, pos3, dir3)
    return torch.where((best_t < _BIG) & live, best_i, -1).to(torch.int32)


_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("traverse_select")
    fn = lib.traverse_select_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P, ctypes.c_int, _P, _P, ctypes.c_int,  # rows, T, clo, chi, nc
        _P, _P, _P, ctypes.c_int,  # pos, dir, live, R
        _P, _P, _P,  # order, tmin, n_reach
        _P, _P, _P,  # idx, visits, stream
    ]
    return lib


def _check_cuda_inputs(rows, clo, chi, pos3, dir3, live, visits) -> None:
    dev = pos3.device
    for x in (rows, clo, chi, pos3, dir3, live):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    for x in (rows, clo, chi, pos3, dir3):
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
    if live.dtype != torch.bool:
        raise TypeError(f"live must be bool, got {live.dtype}")
    R = pos3.shape[1]
    T = rows.shape[0]
    nc = -(-T // CHUNK)
    if rows.dim() != 2 or rows.shape[1] != 48:
        raise ValueError(f"rows must be [T, 48], got {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned for float4 loads")
    if tuple(clo.shape) != (nc, 3) or tuple(chi.shape) != (nc, 3):
        raise ValueError(f"chunk boxes must be [{nc}, 3] for {T} triangles, got "
                         f"{tuple(clo.shape)} and {tuple(chi.shape)}")
    if tuple(pos3.shape) != (3, R) or tuple(dir3.shape) != (3, R) \
            or tuple(live.shape) != (R,):
        raise ValueError("pos3, dir3 must be [3, R] and live [R]")
    if R >= 2**31 or T >= 2**31:
        raise ValueError("R and T must fit in int32")
    if visits is not None and (visits.device != dev or visits.dtype != torch.int32
                               or tuple(visits.shape) != (2, -(-R // RAY_TILE))
                               or not visits.is_contiguous()):
        raise ValueError(f"visits must be a contiguous int32 [2, {-(-R // RAY_TILE)}] "
                         f"tensor on {dev}")


def _walk(rows, clo, chi, pos3, dir3, live, visits):
    """The tile lists of the wavefront (the tail of the last tile padded
    with lanes that are not live), then one launch of the walk kernel on
    inputs that :func:`_check_cuda_inputs` passed."""
    R = pos3.shape[1]
    dev = pos3.device
    pad = -R % RAY_TILE
    if pad:
        lists = tile_chunk_order(
            torch.cat([pos3, torch.zeros(3, pad, device=dev)], dim=1),
            torch.cat([dir3, torch.zeros(3, pad, device=dev)], dim=1),
            torch.cat([live, torch.zeros(pad, dtype=torch.bool, device=dev)]), clo, chi)
    else:
        lists = tile_chunk_order(pos3, dir3, live, clo, chi)
    order, tmin, n_reach = lists
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.traverse_select_launch(
            rows.data_ptr(), rows.shape[0], clo.data_ptr(), chi.data_ptr(), clo.shape[0],
            pos3.data_ptr(), dir3.data_ptr(), live.data_ptr(), R,
            order.data_ptr(), tmin.data_ptr(), n_reach.data_ptr(), idx.data_ptr(),
            None if visits is None else visits.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"traverse_select kernel launch failed: cudaError {err}")
    traverse_select.launches += 1
    return idx


def traverse_select(rows, clo, chi, pos3, dir3, live, *, visits=None):
    """Winner index i32[R] in the permuted order (−1 = miss or not
    live): for CUDA tensors the tile lists (:func:`tile_chunk_order`) and
    the walk kernel (adding one to ``traverse_select.launches``),
    :func:`traverse_select_ref` for CPU tensors. ``rows`` f32[T, 48] is
    the Morton-permuted row table and ``clo``, ``chi``
    f32[ceil(T / CHUNK), 3] its chunk boxes.

    ``visits``, on CUDA only: an int32 [2, ceil(R / RAY_TILE)] tensor that
    the kernel fills with each tile's walked list positions (row 0) and
    tested chunks (row 1)."""
    if pos3.device.type == "cuda":
        _check_cuda_inputs(rows, clo, chi, pos3, dir3, live, visits)
        return _walk(rows, clo, chi, pos3, dir3, live, visits)
    if pos3.device.type == "cpu":
        if visits is not None:
            raise ValueError("visit counts come from the kernel; the plain version "
                             "walks no list")
        return traverse_select_ref(rows, clo, chi, pos3, dir3, live)
    raise ValueError(f"no traverse_select kernel for device {pos3.device}")


traverse_select.launches = 0

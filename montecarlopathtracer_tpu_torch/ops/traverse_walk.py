"""Nearest-hit selection for large scenes: a per-ray walk of a binary
tree over runs of Morton-ordered triangles.

The counterpart of ``montecarlopathtracer_tpu/ops/traverse_pallas.py``
(Pallas kernel ``_traverse_kernel``, entry ``traverse_select``). The
triangle axis is in Morton order (:func:`.morton.morton_order`), so a
chunk of :data:`CHUNK` consecutive triangles is spatially tight and its
box (:func:`.morton.chunk_aabbs_padded`) culls well.

- :func:`walk_boxes` and :func:`walk_tables` (one kernel launch on CUDA,
  B5t, :func:`walk_tables_ref` on the CPU): once per table, the boxes of
  runs of :data:`LEAF` triangles with the large triangles listed apart,
  each triangle's widened bounding sphere, and the implicit binary tree
  over the boxes, each node widened by the slack of its triangles'
  spheres (:class:`WalkTables`). :func:`walk_tables_split` is the earlier
  two-kernel build of the same tables, reached by no path.
- :func:`traverse_select` is the entry point. For CUDA tensors it
  launches ``csrc/traverse_select.cu``, in which each ray walks the tree
  with its own stack, nearer child first, pruning by its best t, and
  tests the triangles of the leaves it reaches behind the sphere
  rejection; for CPU tensors it runs :func:`traverse_select_ref`. It
  never falls back from one to the other.
- :func:`traverse_select_ref` is the plain version: brute f32 selection
  over the same permuted table.
- :func:`tile_chunk_order` (torch ops, any device) is the JAX walk's
  per-tile chunk lists, kept as the counterpart of JAX's
  ``tile_chunk_order``; the walk no longer uses it.

Both return the winner's index in the permuted order, −1 for a miss and
for a lane that is not live. The kernel's winner is the least (t, index)
pair, the brute selection's rule, and its tree and sphere prune only
pairs that the exact test rejects, so on the card it gives the winners of
the split path's brute kernel B4 bit for bit; the plain version agrees
except where f32 rounding parts them (near-ties). The TPU kernel's lane
groups, DMA depth and walk unrolling are TPU knobs and are not ported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.profiling import count_launch
from . import cuda_build
from .morton import chunk_aabbs_padded
from .segment_fused import _select_ref

CHUNK = 128  # triangles per Morton chunk
RAY_TILE = 128  # rays per tile of tile_chunk_order (the JAX walk's)
LEAF = 32  # triangles per leaf of the walk's tree on the render path
BIG_WIDTH = 16.0  # a triangle wider than this many median widths is "large"
BIG_MAX = 1024  # at most this many large triangles (the widest) leave the boxes
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


def traverse_select_ref(rows, clo, chi, pos3, dir3, live, *, tables=None):
    """Plain version: brute f32 selection over the permuted table
    ``rows`` f32[T, 48] (the chunk boxes and the walk's ``tables`` are not
    needed). Returns i32[R]."""
    best_t, best_i, _, _ = _select_ref(rows, pos3, dir3)
    return torch.where((best_t < _BIG) & live, best_i, -1).to(torch.int32)


class WalkTables(NamedTuple):
    """What the walk reads besides the rows, built once per table by
    :func:`walk_tables`."""

    # f32[2P, 8]: node n = [lo xyz, ext, hi xyz, grow]; root 1, leaf j at P + j
    tree: torch.Tensor
    # f32[T, 16]: per triangle its sphere's center and radius at |o| = 0,
    # then its 12 geometry floats (rows[:, :12])
    tri: torch.Tensor
    leaf: int  # triangles per leaf: leaf j holds triangles leaf·j .. leaf·j + leaf − 1
    big: torch.Tensor  # i32[nb]: the large triangles, left out of the leaf boxes

    @property
    def leaves(self) -> int:
        """P, the tree's padded leaf count (node P + j is leaf j)."""
        return self.tree.shape[0] // 2


def tree_leaves(nc: int) -> int:
    """P: the least power of two >= nc leaves."""
    return 1 << max(nc - 1, 0).bit_length()


def tree_ref(clo, chi, ext, grow):
    """Plain version of the tree: f32[2P, 8] over the leaf boxes ``clo``,
    ``chi`` f32[nc, 3] with per-leaf widening ``ext`` and ``grow``
    f32[nc] (a ray with |o| = on widens a node's box by ext + grow·on).
    Leaves P .. P + nc - 1 are the boxes, padding leaves and the unused
    node 0 empty (lo = 3e38 > hi = −3e38, ext = grow = 0), and node n holds
    the min/max box and the largest ext and grow of its children 2n and
    2n + 1 (``fmin``/``fmax``, as the kernel's ``fminf``/``fmaxf``)."""
    nc = clo.shape[0]
    P = tree_leaves(nc)
    lo = torch.full((P, 4), _BIG, dtype=torch.float32, device=clo.device)
    hi = torch.full((P, 4), -_BIG, dtype=torch.float32, device=clo.device)
    lo[:, 3] = hi[:, 3] = 0.0
    lo[:nc, :3], lo[:nc, 3], hi[:nc, :3], hi[:nc, 3] = clo, ext, chi, grow
    levels = [(lo, hi)]
    while lo.shape[0] > 1:
        lo = torch.cat([torch.fmin(lo[0::2, :3], lo[1::2, :3]),
                        torch.fmax(lo[0::2, 3:], lo[1::2, 3:])], dim=1)
        hi = torch.fmax(hi[0::2], hi[1::2])
        levels.append((lo, hi))
    node0 = torch.tensor([[_BIG, _BIG, _BIG, 0.0, -_BIG, -_BIG, -_BIG, 0.0]],
                         device=clo.device)
    return torch.cat([node0] + [torch.cat(lv, dim=1) for lv in reversed(levels)])


def sphere_split_ref(rows):
    """Plain version of ``sphere_select.cuh::triangle_sphere_split`` on the
    geometry of ``rows`` f32[T, 48]: (sph f32[T, 4], sph_e f32[T], slack
    f32[T]). A ray with |o| = on tests a triangle against the sphere of
    center sph[:, :3] and radius sph[:, 3] + sph_e · on; slack = sph[:, 3]
    minus the exact sphere's radius ρ, how far beyond the triangle the
    exact test can accept a hit (for |o| = 0). An ill-conditioned
    (κ ≥ 2^16), singular or non-finite triangle gets an infinite radius
    and slack, and sph_e = 0. In f32, in the kernel's order of operations
    (without its FMAs)."""
    g = rows[:, :12].reshape(-1, 3, 4)
    r0, r1, r2 = g[:, 0, :3], g[:, 1, :3], g[:, 2, :3]
    a = -g[:, :, 3]
    cross = torch.linalg.cross
    c0, c1, c2 = cross(r1, r2), cross(r2, r0), cross(r0, r1)

    def dot(x, y):
        return x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1] + x[:, 2] * y[:, 2]

    inv = 1.0 / dot(r0, c0)
    ex, ey = c0 * inv[:, None], c1 * inv[:, None]
    va = a[:, 2:] * c2 + (a[:, 1:2] * c1 + a[:, :1] * c0)
    mid = (ex + ey) / 3.0
    ctr = va * inv[:, None] + mid
    db, dc = ex - mid, ey - mid
    rho = torch.sqrt(torch.fmax(dot(mid, mid), torch.fmax(dot(db, db), dot(dc, dc))))
    n_m = torch.sqrt(dot(r0, r0) + dot(r1, r1) + dot(r2, r2))
    n_inv = torch.sqrt(dot(c0, c0) + dot(c1, c1) + dot(c2, c2)) * inv.abs()
    E = n_m * n_inv * 2.0 ** -16
    slack = 1.0 + 2.0 ** -16
    K0 = (rho + E * (torch.sqrt(dot(ctr, ctr)) + rho + n_inv * (torch.sqrt(dot(a, a)) + 1.0))) \
        * slack
    ok = (n_m * n_inv < 2.0 ** 16) & (K0 < 2.0 ** 60)
    sph = torch.where(ok[:, None], torch.cat([ctr, K0[:, None]], dim=1),
                      torch.tensor([0.0, 0.0, 0.0, float("inf")], device=rows.device))
    return (sph.contiguous(), torch.where(ok, 2.0 * E * slack, 0.0),
            torch.where(ok, K0 - rho, float("inf")))


def walk_boxes(a, b, c, tri_valid, perm, leaf=LEAF):
    """The walk's leaf boxes and large triangles for a scene's corners
    ``a``, ``b``, ``c`` f32[T, 3] and Morton order ``perm``: (lo, hi
    f32[ceil(T / leaf), 3], big i32[nb]). A triangle wider (on its widest
    axis) than :data:`BIG_WIDTH` median widths, at most the
    :data:`BIG_MAX` widest, is left out of the boxes and listed in ``big``
    (its position in the Morton order, ascending): every ray tests it
    before the walk, and it no longer stretches its leaf's box and every
    box above it to its own size (a room's walls, a floor). A box with
    only such triangles is the point box at the origin."""
    width = (torch.maximum(torch.maximum(a, b), c)
             - torch.minimum(torch.minimum(a, b), c)).amax(1)
    big = tri_valid & (width > BIG_WIDTH * width[tri_valid].median())
    if int(big.sum()) > BIG_MAX:
        big = torch.zeros_like(big)
        big[torch.where(tri_valid, width, -1.0).topk(BIG_MAX).indices] = True
    lo, hi = chunk_aabbs_padded(a, b, c, tri_valid & ~big, perm, leaf)
    return lo, hi, torch.nonzero(big[perm])[:, 0].to(torch.int32)


def walk_tables_ref(rows, clo, chi, leaf=CHUNK, big=None) -> WalkTables:
    """Plain version of :func:`walk_tables`: the spheres, then each
    leaf's ext and grow (the largest slack and sph_e of its triangles),
    then the tree."""
    sph, sph_e, slack = sphere_split_ref(rows)
    pad = clo.shape[0] * leaf - rows.shape[0]
    ext, grow = (torch.nn.functional.pad(x, (0, pad)).reshape(-1, leaf).amax(1)
                 for x in (slack, sph_e))
    if big is None:
        big = torch.zeros(0, dtype=torch.int32, device=rows.device)
    tri = torch.cat([sph, rows[:, :12]], dim=1).contiguous()
    return WalkTables(tree_ref(clo, chi, ext, grow), tri, leaf, big)


_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("traverse_select")
    fn = lib.traverse_select_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,  # T, leaf, tree, P
        _P, ctypes.c_int, _P,  # big, nbig, tri
        _P, _P, _P, ctypes.c_int,  # pos, dir, live, R
        _P, _P, _P, _P,  # next_ray, idx, visits, stream
    ]
    fn = lib.traverse_tables_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P, ctypes.c_int, ctypes.c_int,  # rows, T, leaf
        _P, _P, ctypes.c_int, ctypes.c_int,  # clo, chi, nc, P
        _P, _P, _P, _P,  # tree, tri, arrivals, stream
    ]
    fn = lib.traverse_tables_split_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P, ctypes.c_int, ctypes.c_int,  # rows, T, leaf
        _P, _P, ctypes.c_int, ctypes.c_int,  # clo, chi, nc, P
        _P, _P, _P, ctypes.c_int, _P,  # tree, tri, scratch, parts, stream
    ]
    return lib


def _check_table_inputs(rows, clo, chi, leaf) -> None:
    dev = rows.device
    for x in (rows, clo, chi):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
    T = rows.shape[0]
    nc = -(-T // leaf)
    if rows.dim() != 2 or rows.shape[1] != 48 or not 0 < T < 2**31:
        raise ValueError(f"rows must be [T, 48] with 0 < T < 2**31, got {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned for float4 loads")
    if tuple(clo.shape) != (nc, 3) or tuple(chi.shape) != (nc, 3):
        raise ValueError(f"chunk boxes must be [{nc}, 3] for {T} triangles in boxes of "
                         f"{leaf}, got {tuple(clo.shape)} and {tuple(chi.shape)}")


def _empty_tables(rows, nc, leaf, big) -> WalkTables:
    dev, P = rows.device, tree_leaves(nc)
    return WalkTables(torch.empty(2 * P, 8, device=dev),
                      torch.empty(rows.shape[0], 16, device=dev), leaf, big)


def _tables_cuda(rows, clo, chi, leaf, big) -> WalkTables:
    dev = rows.device
    T, nc = rows.shape[0], clo.shape[0]
    tables = _empty_tables(rows, nc, leaf, big)
    arrivals = torch.empty(tables.leaves, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.traverse_tables_launch(
            rows.data_ptr(), T, leaf, clo.data_ptr(), chi.data_ptr(), nc, tables.leaves,
            tables.tree.data_ptr(), tables.tri.data_ptr(), arrivals.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"traverse_tables kernel launch failed: cudaError {err}")
    count_launch("B5t")
    return tables


def walk_tables_split(rows, clo, chi, leaf=CHUNK, big=None, *, parts=3, out=None):
    """The earlier build of :func:`walk_tables` on CUDA tensors, reached by
    no path and kept to time and check B5t against: ``parts`` 1 launches
    its record kernel (one triangle per thread), 2 its tree kernel (one
    block of 1,024 threads, from the records' slack and growth), 3 both.
    ``out``: the ``(tables, scratch)`` of an earlier call to write into (2
    needs the scratch of a call with 1). Returns ``(tables, scratch)``;
    counts no launch."""
    if big is None:
        big = torch.zeros(0, dtype=torch.int32, device=rows.device)
    _check_table_inputs(rows, clo, chi, leaf)
    if rows.device.type != "cuda" or parts not in (1, 2, 3):
        raise ValueError("the earlier tables build runs on CUDA tensors, parts 1, 2 or 3")
    T, nc = rows.shape[0], clo.shape[0]
    if out is None:
        out = (_empty_tables(rows, nc, leaf, big), torch.empty(2, T, device=rows.device))
    tables, scratch = out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = _lib().traverse_tables_split_launch(
            rows.data_ptr(), T, leaf, clo.data_ptr(), chi.data_ptr(), nc, tables.leaves,
            tables.tree.data_ptr(), tables.tri.data_ptr(), scratch.data_ptr(), parts, stream)
    if err != 0:
        raise RuntimeError(f"traverse_tables_split kernel launch failed: cudaError {err}")
    return out


def walk_tables(rows, clo, chi, leaf=CHUNK, big=None) -> WalkTables:
    """The walk's tree and spheres of the Morton-permuted row table
    ``rows`` f32[T, 48] with the boxes ``clo``, ``chi`` f32[ceil(T /
    leaf), 3] of its runs of ``leaf`` triangles (the chunk boxes for
    ``leaf`` = :data:`CHUNK`) and the large triangles ``big`` i32[nb]
    that the boxes leave out (none by default; :func:`walk_boxes` gives
    boxes and list): for CUDA tensors ``csrc/traverse_select.cu``'s
    ``traverse_tables_launch`` (one launch, a warp per leaf, counted as
    B5t), :func:`walk_tables_ref` for CPU
    tensors. Build once per table and pass to
    :func:`traverse_select`."""
    if big is None:
        big = torch.zeros(0, dtype=torch.int32, device=rows.device)
    if rows.device.type == "cuda":
        _check_table_inputs(rows, clo, chi, leaf)
        if big.device != rows.device or big.dtype != torch.int32 or big.dim() != 1 \
                or not big.is_contiguous():
            raise ValueError(f"big must be a contiguous int32 vector on {rows.device}")
        return _tables_cuda(rows, clo, chi, leaf, big)
    if rows.device.type == "cpu":
        return walk_tables_ref(rows, clo, chi, leaf, big)
    raise ValueError(f"no traverse_tables kernel for device {rows.device}")


def _check_cuda_inputs(rows, clo, chi, pos3, dir3, live, tables, visits) -> None:
    _check_table_inputs(rows, clo, chi, CHUNK)
    dev = rows.device
    for x in (pos3, dir3, live):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    for x in (pos3, dir3):
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
    if live.dtype != torch.bool:
        raise TypeError(f"live must be bool, got {live.dtype}")
    R, T = pos3.shape[1], rows.shape[0]
    if tuple(pos3.shape) != (3, R) or tuple(dir3.shape) != (3, R) \
            or tuple(live.shape) != (R,):
        raise ValueError("pos3, dir3 must be [3, R] and live [R]")
    if R >= 2**31:
        raise ValueError("R must fit in int32")
    if tables is not None:
        if not 0 < tables.leaf <= 2**20:
            raise ValueError(f"walk tables: leaf size {tables.leaf} out of range")
        P = tree_leaves(-(-T // tables.leaf))
        if P > 2**24:
            raise ValueError(f"walk tables: {P} leaves; the walk's stack holds 2**24")
        nb = tables.big.shape[0] if tables.big.dim() == 1 else -1
        want = {"tree": (2 * P, 8), "tri": (T, 16), "big": (nb,)}
        for name, shape in want.items():
            x = getattr(tables, name)
            dtype = torch.int32 if name == "big" else torch.float32
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                    or not x.is_contiguous():
                raise ValueError(f"walk tables: {name} must be a contiguous {dtype} "
                                 f"{list(shape)} tensor on {dev}")
    if visits is not None and (visits.device != dev or visits.dtype != torch.int32
                               or tuple(visits.shape) != (2, R)
                               or not visits.is_contiguous()):
        raise ValueError(f"visits must be a contiguous int32 [2, {R}] tensor on {dev}")


def _walk(rows, pos3, dir3, live, tables, visits):
    """One launch of the walk kernel on inputs that
    :func:`_check_cuda_inputs` passed."""
    R = pos3.shape[1]
    dev = pos3.device
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.traverse_select_launch(
            rows.shape[0], tables.leaf, tables.tree.data_ptr(), tables.leaves,
            tables.big.data_ptr(), tables.big.shape[0], tables.tri.data_ptr(),
            pos3.data_ptr(), dir3.data_ptr(), live.data_ptr(), R, next_ray.data_ptr(),
            idx.data_ptr(),
            None if visits is None else visits.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"traverse_select kernel launch failed: cudaError {err}")
    count_launch("B5")
    return idx


def traverse_select(rows, clo, chi, pos3, dir3, live, *, tables=None, visits=None):
    """Winner index i32[R] in the permuted order (−1 = miss or not
    live): for CUDA tensors the walk kernel (counted as B5),
    :func:`traverse_select_ref` for CPU
    tensors. ``rows`` f32[T, 48] is the Morton-permuted row table and
    ``clo``, ``chi`` f32[ceil(T / CHUNK), 3] its chunk boxes.

    ``tables``: the table's :class:`WalkTables` (:func:`walk_tables`; the
    render path's have leaves of :data:`LEAF` triangles), built here over
    the chunk boxes when not given; the plain version needs none.
    ``visits``, on CUDA only: an int32 [2, R] tensor that the kernel fills
    with each ray's expanded interior nodes (row 0) and tested leaves
    (row 1)."""
    if pos3.device.type == "cuda":
        _check_cuda_inputs(rows, clo, chi, pos3, dir3, live, tables, visits)
        if tables is None:
            tables = walk_tables(rows, clo, chi)
        return _walk(rows, pos3, dir3, live, tables, visits)
    if pos3.device.type == "cpu":
        if visits is not None:
            raise ValueError("visit counts come from the kernel; the plain version "
                             "walks no tree")
        return traverse_select_ref(rows, clo, chi, pos3, dir3, live)
    raise ValueError(f"no traverse_select kernel for device {pos3.device}")
